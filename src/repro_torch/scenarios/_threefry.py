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

The simulator's draws build on the same bits (jax 0.9.0, partitionable):

  * `split`: ``split(key, n)[i]`` is threefry2x32 of the key over the
    counter ``(0, i)``, so it is `round_key(key, i)`;
  * `random_bits`: 32-bit bits ``x0 ^ x1`` over ``(0, i)``, the bits
    `uniform` maps to floats;
  * `permutation`: ``_shuffle`` of ``arange(n)``: for each of
    ``ceil(3·ln n / ln(2³²−1))`` rounds, ``key, sub = split(key)``, draw
    `random_bits(sub, n)` and stable-sort the current order by them;
  * `exponential`: ``-log1p(-u)`` of `uniform`'s u;
  * `normal`: ``sqrt(2)·erfinv(u)``, u uniform on ``[nextafter(-1, 0),
    1)`` as `jax.random.uniform` builds it from minval and maxval:
    ``max(lo, f·(hi − lo) + lo)`` with f in [0, 1) and every op in f32.

The integer draws (`split`, `random_bits`, `permutation`) are bit-equal to
jax on every device. `exponential` and `normal` apply the device's
`log1p` and `erfinv`, which can differ from XLA's by an ulp or a few: a
caller that needs two surfaces to agree runs both on one device.

Keys are int64 tensors (..., 2). `t` is a Python int, a 0-d int64 tensor
or, for a fleet, a (K,) tensor beside (K, 2) keys: everything broadcasts
over the leading axes.
"""
from __future__ import annotations

import math

import numpy as np
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


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split(key, n)`: key (..., 2) -> (..., n, 2)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(i),
                          i)
    return torch.stack([y0, y1], -1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,))` (32-bit) as int64 words: key (..., 2)
    -> (..., n)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(i),
                          i)
    return x0 ^ x1


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.uniform(key, (n,))` in [0, 1) as f32: key (..., 2) ->
    (..., n)."""
    one_bits = ((random_bits(key, n) >> 9) | 0x3F800000).to(torch.int32)
    return one_bits.view(torch.float32) - 1.0


def shuffle_rounds(n: int) -> int:
    """The sort rounds of `jax.random.permutation` over n items."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)` as int64: key (..., 2) -> (..., n).
    Each round stable-sorts the current order by fresh 32-bit bits."""
    perm = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        tuple(key.shape[:-1]) + (n,))
    for _ in range(shuffle_rounds(n)):
        keys = split(key)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(sub, n), dim=-1, stable=True).indices
        perm = torch.gather(perm, -1, order)
    return perm


def exponential(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.exponential(key, (n,))` as f32: ``-log1p(-u)``."""
    return -torch.log1p(-uniform(key, n))


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.normal(key, (n,))` as f32: ``sqrt(2)·erfinv(u)``, u
    uniform on [nextafter(-1, 0), 1) built in f32 as jax builds it."""
    f = uniform(key, n)
    f32 = dict(dtype=torch.float32, device=key.device)
    # 0-d fills, not copies from the host, so a captured round can draw
    lo = torch.full((), float(np.nextafter(np.float32(-1), np.float32(0))),
                    **f32)
    hi = torch.ones((), **f32)
    u = torch.maximum(lo, f * (hi - lo) + lo)
    return torch.full((), float(np.float32(np.sqrt(2))), **f32) \
        * torch.erfinv(u)
