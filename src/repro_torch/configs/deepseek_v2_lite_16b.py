"""deepseek-v2-lite-16b — DeepSeek-V2-Lite MoE with MLA attention.

Assigned: 27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6,
MLA kv_lora=512, 2 shared + routed experts top-6. [arXiv:2405.04434]

The bracket note mentions "160 routed" (the non-lite V2); the assigned fields say
64 experts top-6, so we follow the fields and add the 2 shared experts.
The first layer is dense (DeepSeek-V2 convention).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_v2_lite_16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # unused under MLA, kept for bookkeeping
    d_ff=1408,              # shared-expert / dense-layer hidden
    vocab_size=102_400,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    kv_lora_rank=512,
    q_lora_rank=0,          # v2-lite has no q compression
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    fl_clients=16,
    fl_local_steps=1,
    param_dtype="bfloat16",
    source="arXiv:2405.04434",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, d_ff=96, vocab_size=512,
        n_experts=4, top_k=2, moe_capacity_factor=2.0, n_shared_experts=1, moe_d_ff=96,
        first_dense_layers=1, kv_lora_rank=64, rope_head_dim=16,
        nope_head_dim=32, v_head_dim=32, fl_clients=4, remat=False,
    )
