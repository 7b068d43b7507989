"""moonshot-v1-16b-a3b — Moonlight-16B-A3B-style MoE decoder.

Assigned: 48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
[hf:moonshotai/Moonlight-16B-A3B]

Note: the assignment tags this [dense] but carries MoE fields; Moonlight-16B-A3B is a
DeepSeek-V3-style MoE (16B total / 3B active), so we implement it as an MoE with
64 routed experts, top-6, per-expert hidden 1408 (see docs/architecture.md §4).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="moonshot_v1_16b_a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    fl_clients=16,
    fl_local_steps=1,
    param_dtype="bfloat16",
    source="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=512, n_experts=4, top_k=2, moe_capacity_factor=2.0, moe_d_ff=96,
        fl_clients=4, remat=False,
    )
