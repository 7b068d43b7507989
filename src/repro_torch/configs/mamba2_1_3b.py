"""mamba2-1.3b — attention-free SSM with SSD (state-space duality).

Assigned: 48L d_model=2048 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
[arXiv:2405.21060]
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_1_3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    fl_clients=16,
    fl_local_steps=2,
    param_dtype="bfloat16",
    source="arXiv:2405.21060",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, vocab_size=512, ssm_state=16,
        ssm_headdim=32, ssm_chunk=32, fl_clients=4, remat=False,
    )
