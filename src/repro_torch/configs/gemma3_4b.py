"""gemma3-4b — dense decoder with 5:1 local:global sliding-window attention.

Assigned: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, 5:1 local:global,
128k context. [hf:google/gemma-3-1b-pt]

head_dim=256 per the Gemma-3 model card (not d_model/n_heads); local window 1024.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10_240,
    vocab_size=262_144,
    swa_window=1024,
    swa_pattern=6,          # 5 local : 1 global
    rope_theta=1_000_000.0, # long-context rope base for global layers
    fl_clients=16,
    fl_local_steps=2,
    param_dtype="bfloat16",
    source="hf:google/gemma-3-1b-pt",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, swa_window=16, swa_pattern=2,
        fl_clients=4, remat=False,
    )
