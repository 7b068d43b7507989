"""Paper-scale non-convex model: 2-hidden-layer ReLU MLP.

Offline stand-in for the paper's LeNet-5/CIFAR-10 experiment (Section 7):
non-convex, 10 classes, N=100 clients, 2 classes/client, weight decay 1e-3.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="paper_mlp",
    family="tabular",
    n_layers=2,       # hidden layers
    d_model=256,      # feature dim
    n_heads=0,
    n_kv_heads=0,
    d_ff=128,         # hidden width
    vocab_size=10,
    encoder_only=True,
    modality="tabular",
    fl_clients=100,
    fl_local_steps=5,
    param_dtype="float32",
    compute_dtype="float32",
    source="paper §7 (CIFAR-10/LeNet-5), synthetic MLP stand-in",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(fl_clients=8, d_model=32, d_ff=16)
