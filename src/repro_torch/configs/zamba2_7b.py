"""zamba2-7b — hybrid Mamba2 backbone with shared attention blocks.

Assigned: 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64,
Mamba2 + shared attn blocks. [arXiv:2411.15242]

Zamba2 interleaves a *single shared* attention(+MLP) block into the Mamba2 backbone
(same parameters re-used at each insertion). We insert it every 6th layer.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="zamba2_7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    hybrid_attn_every=6,
    fl_clients=16,
    fl_local_steps=1,
    param_dtype="bfloat16",
    source="arXiv:2411.15242",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512, ssm_state=16, ssm_headdim=32, ssm_chunk=32,
        hybrid_attn_every=2, fl_clients=4, remat=False,
    )
