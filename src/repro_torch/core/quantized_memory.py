"""Int8 update storage with per-(row, leaf) absmax scales and stochastic
rounding (counterpart of `repro/core/quantized_memory.py`).

MIFA's server memory is O(N·d). Storing each G^i in int8 with an absmax
scale per row and *stochastic* rounding keeps the stored update an unbiased
estimator of the true one, which is what MIFA's analysis needs (rounding
adds zero-mean bounded noise, a slightly larger σ²).

    scale = max(absmax(x_row) / 127, 1e-12)
    q     = clip(floor(x/scale) + (u < frac(x/scale)), -127, 127),  u ~ U[0,1)

The uniform draws come from a `torch.Generator` on the tensor's device, so
on the card the noise is drawn there (and a CUDA graph that captures the
round replays it with a fresh offset each time, as an eager call would).
The reference draws from `jax.random`, whose bits torch cannot reproduce:
the two agree in distribution, not bit for bit. Plain PyTorch on both
devices: the reference's quantizer is plain `jnp` too, and no Pallas kernel
stands behind it.
"""
from __future__ import annotations

import torch

from repro_torch.sharding import params as placed
from repro_torch.tree import tree_map

SCALE_FLOOR = 1e-12


def _rows(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    """(N,) -> broadcastable to a (N, ...) leaf of `ndim` dims."""
    return scale.reshape((scale.shape[0],) + (1,) * (ndim - 1))


def quantize_leaf(gen: torch.Generator, x: torch.Tensor, clients=None,
                  spec=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, ...) f32 -> (q int8 (N, ...), scale f32 (N,)); `gen` lives on
    x's device.

    With `clients` (a `sharding.clients.ClientShard`) `x` is this rank's
    block of the whole (N, ...) leaf: rows [lo, hi) and, under `spec` (its
    placement, `clients.mesh`), a block of the param dims. The rank draws
    the uniforms of the whole leaf from `gen` and keeps its block, and a
    row's absmax is reduced over the ranks holding its other columns, so
    every block is the unsplit quantization's, bit for bit."""
    x = x.float()
    n = x.shape[0]
    absmax = x.reshape(n, -1).abs().amax(1)
    if spec is not None:
        placed.amax_(absmax, [a for d, axes in placed.split_dims(
            spec, clients.mesh) if d for a in axes], clients.mesh)
    # divide by a tensor: CUDA divides by a Python scalar as a multiply by
    # its rounded reciprocal, which can land one ulp off the quotient
    scale = (absmax / absmax.new_full((), 127.0)).clamp(min=SCALE_FLOOR)
    y = x / _rows(scale, x.ndim)
    lo = torch.floor(y)
    if clients is None:
        u = torch.rand(x.shape, generator=gen, device=x.device)
    elif spec is None:
        u = torch.rand((clients.n_rows,) + tuple(x.shape[1:]),
                       generator=gen, device=x.device)[clients.lo:clients.hi]
    else:
        u = placed.block(torch.rand(
            placed.whole_shape(tuple(x.shape), spec, clients.mesh),
            generator=gen, device=x.device), spec, clients.mesh,
            split=True)
    q = lo + (u < (y - lo)).float()
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q int8 (N, ...), scale (N,) -> f32 (N, ...)."""
    return q.float() * _rows(scale, q.ndim)


def quantize_tree(gen: torch.Generator, tree, clients=None):
    """Leaf by leaf, in `tree_map` order, one generator for all leaves;
    `clients` as `quantize_leaf` takes it, its `specs` (when set) the
    leaves' placements. Returns (tree of int8 leaves, tree of (N,)
    scales)."""
    if clients is not None and clients.specs is not None:
        pairs = tree_map(lambda leaf, s: quantize_leaf(gen, leaf, clients,
                                                       s),
                         tree, clients.specs)
    else:
        pairs = tree_map(lambda leaf: quantize_leaf(gen, leaf, clients),
                         tree)
    # a (q, scale) tuple is a leaf of the tree helpers
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def dequantize_tree(qtree, stree):
    return tree_map(dequantize_leaf, qtree, stree)
