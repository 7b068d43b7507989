"""llava-next-34b — VLM language decoder; vision frontend stubbed.

Assigned: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000, anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

Per the brief, the ViT/SigLIP encoder + projector is a STUB: the batch carries
pre-computed patch embeddings ``patches`` (B, n_patches, d_model) which the decoder
consumes as a prefix (anyres => 2880 patch tokens: 5 tiles x 576).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llava_next_34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    modality="vision_text",
    n_patches=2880,   # anyres: 4 tiles + base, 576 patches each
    fl_clients=16,
    fl_local_steps=1,
    fsdp=True,
    sequential_clients=True,
    param_dtype="bfloat16",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=384,
        vocab_size=512, n_patches=16, fl_clients=4, fsdp=False, remat=False,
    )
