"""hubert-xlarge — encoder-only audio transformer; conv frontend stubbed.

Assigned: 48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504, encoder-only,
same backbone as wav2vec2. [arXiv:2106.07447]

Per the brief, the mel-spectrogram + conv feature extractor is a STUB: the
batch carries frame embeddings ``frames`` (B, n_frames, d_model) and their
cluster ``labels`` (B, n_frames). Training is
masked-frame cluster prediction over the 504-unit codebook. Encoder-only =>
no decode shapes (docs/architecture.md §4).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="hubert_xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    encoder_only=True,
    modality="audio",
    fl_clients=16,
    fl_local_steps=2,
    param_dtype="bfloat16",
    source="arXiv:2106.07447",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=64, fl_clients=4, remat=False,
    )
