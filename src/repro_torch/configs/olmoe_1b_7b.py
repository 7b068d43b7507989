"""olmoe-1b-7b — fully-MoE decoder (64 experts, top-8).

Assigned: 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304, MoE 64e top-8.
[arXiv:2409.02060]
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="olmoe_1b_7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    n_experts=64,
    top_k=8,
    moe_d_ff=1024,
    fl_clients=16,
    fl_local_steps=2,
    param_dtype="bfloat16",
    source="arXiv:2409.02060",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=512, n_experts=4, top_k=2, moe_capacity_factor=2.0, moe_d_ff=96,
        fl_clients=4, remat=False,
    )
