"""Paper-scale strongly convex model: multinomial logistic regression.

Matches the paper's MNIST experiment structure (Section 7): 10 classes,
l2 regularization via weight decay 1e-3, N=100 clients, 2 classes/client.
Input: 64-d synthetic features (offline stand-in for 784-d MNIST).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="paper_logistic",
    family="tabular",
    n_layers=0,
    d_model=64,       # feature dim
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=10,    # n classes
    encoder_only=True,
    modality="tabular",
    fl_clients=100,
    fl_local_steps=5,
    param_dtype="float32",
    compute_dtype="float32",
    source="paper §7 (MNIST/logistic), synthetic stand-in",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(fl_clients=8)
