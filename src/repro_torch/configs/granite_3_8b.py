"""granite-3-8b — dense GQA decoder.

Assigned: 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base]
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="granite_3_8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12_800,
    vocab_size=49_155,
    fl_clients=16,
    fl_local_steps=2,
    param_dtype="bfloat16",
    source="hf:ibm-granite/granite-3.0-2b-base",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=384,
        vocab_size=512, fl_clients=4, remat=False,
    )
