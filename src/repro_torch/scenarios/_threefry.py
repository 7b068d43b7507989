"""Threefry-2x32 counter-based draws, bit-equal to `jax.random`.

The scenarios of `repro/scenarios` draw every round's uniforms as
``jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), t),
shape)``. Pinned against jax 0.9.0 with ``jax_threefry_partitionable =
True`` (its default), that call is:

  * the key: the words ``(0, seed mod 2**32)`` (with ``jax_enable_x64``
    off, its default, the seed's high word is dropped);
  * `fold_in`: one threefry2x32 of the key over the counter ``(0, t)``; its
    two output words are the round key;
  * `uniform`: one threefry2x32 of the round key over ``(0, i)`` for each
    flat element i, bits = x0 ^ x1, and the value
    ``bitcast_f32((bits >> 9) | 0x3F800000) - 1``.

Here the same arithmetic runs as int64 tensor ops with every sum masked to
32 bits: each value stays below 2**32 before a shift (the largest left
shift is 29), so int64 never overflows, and integer ops and the final
f32 subtraction are exact on every device. A round captured as a CUDA
graph takes `t` as a device tensor and gives the CPU's bits.

Keys are int64 tensors (..., 2). `t` is a Python int, a 0-d int64 tensor
or, for a fleet, a (K,) tensor beside (K, 2) keys: everything broadcasts
over the leading axes.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as
    `jax._src.prng.threefry2x32`: int64 tensors holding 32-bit words,
    broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def seed_key(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as a (2,) int64 CPU tensor."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def round_key(key: torch.Tensor, t) -> torch.Tensor:
    """`jax.random.fold_in(key, t)`: key (..., 2), t an int or an int64
    tensor broadcasting against key[..., 0]. Returns (..., 2)."""
    t = torch.as_tensor(t, dtype=torch.int64, device=key.device) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(t), t)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.uniform(key, (n,))` in [0, 1) as f32: key (..., 2) ->
    (..., n)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k0, k1 = key[..., 0:1], key[..., 1:2]
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    bits = x0 ^ x1
    one_bits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return one_bits.view(torch.float32) - 1.0
