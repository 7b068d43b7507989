"""qwen1.5-110b — large dense decoder with QKV bias.

Assigned: 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
[hf:Qwen/Qwen1.5-0.5B]

At 110B parameters this is the memory-limit case for MIFA's update array:
K=1 local steps (no transient diverged client params), 2-D FSDP x TP param
sharding, and the int8 update-memory option (docs/architecture.md §3).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen1_5_110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49_152,
    vocab_size=152_064,
    qkv_bias=True,
    fl_clients=16,
    fl_local_steps=1,
    fsdp=True,
    sequential_clients=True,
    inner_update_constraint=True,
    param_dtype="bfloat16",   # HBM budget at 110B (docs/architecture.md §3)
    memory_dtype="bfloat16",  # paper-faithful; int8 variant benchmarked separately
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=384,
        vocab_size=512, fl_clients=4, fsdp=False, remat=False,
    )
