"""Parity of the port's MLA (DeepSeek-V2's compressed-KV attention) with
the JAX package's, on the CPU, and `flash_attention` with a value head
dim of its own.

Each function takes the same numpy inputs (drawn from a seed, rounded to
the dtype under test on both sides) as its reference counterpart:
`mla_compress`, `mla_queries`, `mla_prefill` (through the training path's
`blockwise_attention` and through `prefill_attention`, the kernel's plain
version here) and the absorbed `mla_decode` with its cache writes. The
port's absorbed decode is held to its own decompressed prefill in f32.
`flash_attention_ref` with dv != hd is held to the reference's
`blockwise_attention`, which takes v at its own width (the reference's
Pallas kernel does not).

Tolerances: f32 rtol 2e-4, atol 2e-5 and bf16 rtol 3e-2, atol 0.1, as
`tests/test_torch_models.py` states them; attention alone at the bounds
`tests/test_torch_kernels.py` holds the plain version to (2e-5, 2e-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref,
                                                 served_bf16)
from repro_torch.models import attention

torch.set_num_threads(1)

TOL = {"float32": (2e-4, 2e-5), "bfloat16": (3e-2, 0.1)}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# deepseek-v2-lite-16b's smoke widths, with v narrower than q/k (48)
D, H, R, ROPE, NOPE, V = 128, 4, 64, 16, 32, 32
THETA = 10_000.0
B, S = 2, 24


def _params(seed=0) -> dict:
    """The reference's MLA leaves, `_dense_init`-scaled, as f32 numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"wq": (D, H * (NOPE + ROPE)), "w_dkv": (D, R),
              "w_kpe": (D, ROPE), "w_uk": (R, H * NOPE),
              "w_uv": (R, H * V), "wo": (H * V, D)}
    return {k: (rng.normal(size=shp) / np.sqrt(shp[0])).astype(np.float32)
            for k, shp in shapes.items()}


def _both(tree, dtype):
    """numpy -> (jax tree, torch tree) in `dtype`, rounded the same way."""
    j = {k: jnp.asarray(v, JAX_DT[dtype]) for k, v in tree.items()}
    t = {k: torch.from_numpy(v).to(TORCH_DT[dtype]) for k, v in tree.items()}
    return j, t


def _close(a, b, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), rtol=rtol,
                               atol=atol)


def _x(seed, s=S):
    return np.random.default_rng(seed).normal(size=(B, s, D)).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_compress_and_queries_match_reference(dtype):
    jp, tp = _both(_params(), dtype)
    jx, tx = _both({"x": _x(1)}, dtype)
    jpos, tpos = jnp.arange(S) + 5, torch.arange(S) + 5
    jc, jpe = jax_attn.mla_compress(jp, jx["x"], jpos, THETA)
    tc, tpe = attention.mla_compress(tp, tx["x"], tpos, THETA)
    jqn, jqp = jax_attn.mla_queries(jp, jx["x"], jpos, THETA, NOPE)
    tqn, tqp = attention.mla_queries(tp, tx["x"], tpos, THETA, NOPE)
    for a, b in ((jc, tc), (jpe, tpe), (jqn, tqn), (jqp, tqp)):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == TORCH_DT[dtype]
        _close(a, b, dtype)
    assert tuple(tc.shape) == (B, S, R) and tuple(tqp.shape) == (B, S, H,
                                                                 ROPE)


@pytest.mark.parametrize("attend", ["blockwise", "prefill"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_reference(dtype, causal, attend):
    """The decompressed prefill through the training path's
    `blockwise_attention` and through serving's `prefill_attention` (the
    kernel's plain version on the CPU): q/k head dim 48, v head dim 32."""
    jp, tp = _both(_params(), dtype)
    jx, tx = _both({"x": _x(2)}, dtype)
    fn = {"blockwise": attention.blockwise_attention,
          "prefill": attention.prefill_attention}[attend]
    jout, (jc, jpe) = jax_attn.mla_prefill(
        jp, jx["x"], jnp.arange(S), rope_theta=THETA, nope_hd=NOPE,
        causal=causal)
    tout, (tc, tpe) = attention.mla_prefill(
        tp, tx["x"], torch.arange(S), rope_theta=THETA, nope_hd=NOPE,
        causal=causal, attend=fn)
    assert tuple(tout.shape) == (B, S, D)
    for a, b in ((jout, tout), (jc, tc), (jpe, tpe)):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(dtype):
    """The absorbed step at position 9 of a 16-slot cache whose first 9
    rows are filled: the output and both caches, the new row written in
    place."""
    rng = np.random.default_rng(3)
    C, pos = 16, 9
    c = np.zeros((B, C, R), np.float32)
    pe = np.zeros((B, C, ROPE), np.float32)
    c[:, :pos] = rng.normal(size=(B, pos, R))
    pe[:, :pos] = rng.normal(size=(B, pos, ROPE))
    jp, tp = _both(_params(), dtype)
    js, ts = _both({"x": _x(4, 1), "c": c, "pe": pe}, dtype)
    jout, (jc, jpe) = jax_attn.mla_decode(
        jp, js["x"], jnp.int32(pos), js["c"], js["pe"], rope_theta=THETA,
        nope_hd=NOPE)
    tout, (tc, tpe) = attention.mla_decode(
        tp, ts["x"], pos, ts["c"], ts["pe"], rope_theta=THETA, nope_hd=NOPE)
    assert tc is ts["c"] and tpe is ts["pe"]      # written in place
    assert tout.dtype == TORCH_DT[dtype] and tuple(tout.shape) == (B, 1, D)
    for a, b in ((jout, tout), (jc, tc), (jpe, tpe)):
        _close(a, b, dtype)


def test_mla_decode_matches_prefill():
    """The port's absorbed decode over the compressed cache gives the last
    position of its decompressed prefill of the same tokens, f32, through
    both prefill attentions; three decode steps after a prefill of S - 3."""
    tp = {k: torch.from_numpy(v) for k, v in _params(5).items()}
    x = torch.from_numpy(_x(6))
    for fn in (attention.blockwise_attention, attention.prefill_attention):
        full, (c_full, pe_full) = attention.mla_prefill(
            tp, x, torch.arange(S), rope_theta=THETA, nope_hd=NOPE,
            attend=fn)
        c, pe = torch.zeros((B, S, R)), torch.zeros((B, S, ROPE))
        _, (c0, pe0) = attention.mla_prefill(
            tp, x[:, :S - 3], torch.arange(S - 3), rope_theta=THETA,
            nope_hd=NOPE, attend=fn)
        c[:, :S - 3], pe[:, :S - 3] = c0, pe0
        for pos in range(S - 3, S):
            out, _ = attention.mla_decode(tp, x[:, pos:pos + 1], pos, c, pe,
                                          rope_theta=THETA, nope_hd=NOPE)
            np.testing.assert_allclose(out[:, 0].numpy(),
                                       full[:, pos].numpy(), rtol=2e-4,
                                       atol=2e-5)
        np.testing.assert_allclose(c.numpy(), c_full.numpy(), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(pe.numpy(), pe_full.numpy(), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("hd,dv,s,t,causal", [
    (48, 32, 64, 64, True), (48, 32, 64, 40, False),
    (192, 128, 64, 64, True), (192, 128, 32, 80, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ref_value_head_dim_matches_blockwise(
        hd, dv, s, t, causal, dtype):
    """The kernel's plain version with v narrower than q and k (MLA's 192 /
    128 and the smoke 48 / 32) against the reference's
    `blockwise_attention`, scaled by q's head dim, causal (S == T) and
    not (S != T), GQA off as in MLA."""
    rng = np.random.default_rng(hd + s + t)
    arrays = {"q": rng.normal(size=(2, s, 4, hd)),
              "k": rng.normal(size=(2, t, 4, hd)),
              "v": rng.normal(size=(2, t, 4, dv))}
    j, tt = _both({k: v.astype(np.float32) for k, v in arrays.items()},
                  dtype)
    ref = jax_attn.blockwise_attention(j["q"], j["k"], j["v"],
                                       causal=causal)
    out = flash_attention(tt["q"], tt["k"], tt["v"], causal=causal)
    plain = flash_attention_ref(tt["q"], tt["k"], tt["v"], causal=causal)
    assert tuple(out.shape) == (2, s, 4, dv) and out.dtype == TORCH_DT[dtype]
    assert torch.equal(out, plain)
    np.testing.assert_allclose(np.asarray(ref, np.float32),
                               out.float().numpy(), atol=ATTN_TOL[dtype])


def test_flash_attention_value_head_dim_checks():
    """v's head dim is checked as hd is (a multiple of 8, at most 256) and
    v must match k's batch, keys and heads; the CPU takes any (hd, dv);
    the bf16 kernel serves dv == hd and MLA's narrower v."""
    rng = np.random.default_rng(7)
    q, k = (torch.from_numpy(rng.normal(size=(1, 16, 4, 64)).astype(
        np.float32)) for _ in range(2))
    v = lambda *shape: torch.zeros(shape)  # noqa: E731
    with pytest.raises(ValueError, match="v head dim 20 must be a multiple"):
        flash_attention(q, k, v(1, 16, 4, 20))
    with pytest.raises(ValueError, match="v head dim 264 .* at most 256"):
        flash_attention(q, k, v(1, 16, 4, 264))
    with pytest.raises(ValueError, match="shape mismatch: v"):
        flash_attention(q, k, v(1, 16, 2, 32))
    with pytest.raises(ValueError, match="q, k and v must be"):
        flash_attention(q, k, v(16, 4, 32))
    for dv in (8, 32, 200, 256):
        out = flash_attention(q, k, v(1, 16, 4, dv) + 1.0)
        assert tuple(out.shape) == (1, 16, 4, dv)
        assert torch.allclose(out, torch.ones_like(out))
    assert all(served_bf16(hd, hd, w) for hd in (8, 112, 192, 256)
               for w in (0, 1024))
    assert served_bf16(192, 128, 0) and served_bf16(136, 120, 0)
    assert not served_bf16(192, 128, 1024)
    assert not any(served_bf16(hd, dv, 0) for hd, dv in (
        (128, 64), (192, 64), (256, 128), (48, 32), (128, 192)))
