"""Head padding (`launch.specs.plan(pad_heads=True)`) in the port against
the JAX package, on the CPU.

`pad_heads` rounds `n_heads` and `n_kv_heads` up to multiples of 16
(`pad_q_heads`, `pad_kv_heads`); the training forward and the prefill
zero-pad q, k and v to those counts, attend, and drop the padded query
heads; decode never pads and caches hold the real kv heads. Attention
then groups heads by pad_q // pad_kv, not H // KV, so a real query head
whose group falls on a zero kv head reads zero keys and values: the padded
model computes other numbers than the unpadded one. That is the
reference's behaviour, and the port keeps it.

On the smoke configs of granite-3-8b, gemma3-4b (window 16, hd 32),
llava-next-34b (16 patches before the text) and qwen1.5-110b (QKV bias),
padded, with the reference's `init` params carried across
(`convert.params_from_jax`) and the same numpy tokens on both sides:
`loss_fn` and its gradients, the prefill's logits and every cache leaf,
and two decode steps after it hold the reference's at f32 rtol 2e-4 /
atol 2e-5 (gradients: atol scaled by the leaf's largest magnitude, as
`test_torch_loss.py` holds them) and bf16 rtol 3e-2 / atol 0.1
(`test_torch_models.py` states why). One test pins the finding on both
sides: padded ≠ unpadded, the cache holds the real kv heads, and a decode
step from the same cache is the unpadded model's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.specs import override_config
from repro_torch.models import build_model
from repro_torch.models.attention import blockwise_attention
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

ARCHS = ["granite_3_8b", "gemma3_4b", "llava_next_34b", "qwen1_5_110b"]
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (3e-2, 0.1)}
F32 = {"compute_dtype": "float32", "param_dtype": "float32"}
B, S, N_DECODE = 2, 32, 2


def _up(n):
    return ((n + 15) // 16) * 16


def _configs(arch, dtype, pad=True):
    """(reference config, port config), padded as the reference's `plan`
    pads them (`specs.py:101-104`) and the port's `override_config`."""
    jc, tc = jax_smoke(arch), get_smoke_config(arch)
    if dtype == "float32":
        jc, tc = jc.replace(**F32), tc.replace(**F32)
    if pad:
        jc = jc.replace(pad_q_heads=_up(jc.n_heads),
                        pad_kv_heads=_up(jc.n_kv_heads))
        tc = override_config(tc, pad_heads=True)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    """The reference's init as numpy; qwen's zero QKV biases made nonzero
    so they matter."""
    jc, _ = _configs(arch, dtype, pad=False)
    p = jax.tree.map(np.asarray, jax_build(jc).init(jax.random.PRNGKey(0)))
    if jc.qkv_bias:
        rng = np.random.default_rng(5)
        attn = p["segments"]["0"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = (0.1 * rng.standard_normal(attn[name].shape)
                          ).astype(attn[name].dtype)
    return p


def _batch(cfg, n_text, seed=1):
    """numpy tokens (B, n_text) and, for vision_text, patches (B, P, d)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, n_text)
                                  ).astype(np.int32)}
    if cfg.modality == "vision_text":
        out["patches"] = (0.02 * rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return out


def _sides(batch, jc, tc):
    """The batch as the reference's and the port's inputs (patches in
    each side's compute dtype)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "patches" in batch:
        jb["patches"] = jb["patches"].astype(jc.compute_dtype)
        tb["patches"] = tb["patches"].to(getattr(torch, tc.compute_dtype))
    return jb, tb


def _close(ref, got, dtype, scaled=False):
    rtol, atol = TOL[dtype]
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    if scaled:
        atol = atol * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_padded_loss_and_grads_match_reference(arch, dtype):
    jc, tc = _configs(arch, dtype)
    pnp = _params(arch, dtype)
    jb, tb = _sides(_batch(tc, S), jc, tc)
    (jl, _), jg = jax.jit(jax.value_and_grad(jax_build(jc).loss_fn,
                                             has_aux=True))(
        jax.tree.map(jnp.asarray, pnp), jb)
    tg, (tl, _) = grad_and_value(build_model(tc).loss_fn, has_aux=True)(
        params_from_jax(pnp, "cpu"), tb)
    _close(jl, tl, dtype)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert a.shape == tuple(b.shape)
        _close(a, b, dtype, scaled=True)


def _prefill_and_decode(jc, tc, pnp, batch, n_text):
    """Prefill of `n_text` tokens (after any patches) and N_DECODE decode
    steps on both sides. Returns the reference's and the port's (logits of
    the prefill and of each step, the cache after the prefill, the cache
    at the end)."""
    jm, tm = jax_build(jc), build_model(tc)
    jp, tp = jax.tree.map(jnp.asarray, pnp), params_from_jax(pnp, "cpu")
    off = tc.n_patches if tc.modality == "vision_text" else 0
    length = off + n_text + N_DECODE
    jb, tb = _sides(batch, jc, tc)
    toks = batch["tokens"]
    jb["tokens"], tb["tokens"] = jb["tokens"][:, :n_text], \
        tb["tokens"][:, :n_text]
    jl, jcache = jax.jit(jm.prefill)(jp, jb, jm.init_cache(B, length))
    tcache = tm.init_cache(B, length, device="cpu")
    tl, _ = tm.prefill(tp, tb, tcache)
    out = {"ref": [[jl], jax.tree.leaves(jcache)],
           "port": [[tl], [t.clone() for t in tree_leaves(tcache)]]}
    step = jax.jit(jm.decode_step)
    for i in range(N_DECODE):
        tok = toks[:, n_text + i:n_text + i + 1]
        jl, jcache = step(jp, jnp.asarray(tok), jnp.int32(off + n_text + i),
                          jcache)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok),
                                    off + n_text + i, tcache)
        out["ref"][0].append(jl)
        out["port"][0].append(tl)
    out["ref"].append(jax.tree.leaves(jcache))
    out["port"].append(tree_leaves(tcache))
    return out["ref"], out["port"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_cache_and_decode_match_reference(arch, dtype):
    jc, tc = _configs(arch, dtype)
    ref, port = _prefill_and_decode(jc, tc, _params(arch, dtype),
                                    _batch(tc, S + N_DECODE), S)
    for a, b in zip(ref[0], port[0]):          # prefill, then each step
        _close(a, b, dtype)
    for caches_ref, caches_port in zip(ref[1:], port[1:]):
        assert ([tuple(x.shape) for x in caches_ref]
                == [tuple(x.shape) for x in caches_port])
        for a, b in zip(caches_ref, caches_port):
            _close(a, b, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_padding_changes_outputs_on_both_sides(arch):
    """The finding, pinned on both sides (f32): the padded loss differs
    from the unpadded one by far more than the bounds in the reference and
    in the port, and the two padded losses agree; the port's padded
    prefill differs from its unpadded one, its cache holds the real kv
    heads, and a decode step from that cache is the same padded or not
    (decode never pads)."""
    cfg = get_smoke_config(arch)
    pnp = _params(arch, "float32")
    tp = params_from_jax(pnp, "cpu")
    batch = _batch(cfg, S + 1)
    off = cfg.n_patches if cfg.modality == "vision_text" else 0
    losses, logits, caches = {}, {}, {}
    for pad in (False, True):
        jc, tc = _configs(arch, "float32", pad)
        jb, tb = _sides(batch, jc, tc)
        jl, _ = jax.jit(jax_build(jc).loss_fn)(
            jax.tree.map(jnp.asarray, pnp), jb)
        tm = build_model(tc)
        losses[pad] = (float(jl), float(tm.loss_fn(tp, tb)[0]))
        tb["tokens"] = tb["tokens"][:, :S]
        caches[pad] = tm.init_cache(B, off + S + 1, device="cpu")
        logits[pad], _ = tm.prefill(tp, tb, caches[pad])
    for side in (0, 1):                        # the reference, the port
        assert abs(losses[True][side] - losses[False][side]) > 1e-3
    assert abs(losses[True][1] - losses[True][0]) <= (
        2e-4 * abs(losses[True][0]) + 2e-5)
    assert float((logits[True] - logits[False]).abs().max()) > 1e-3
    assert {x.shape[-2] for x in tree_leaves(caches[True])} == {
        cfg.n_kv_heads}
    tok = torch.from_numpy(batch["tokens"][:, S:S + 1])
    steps = [build_model(_configs(arch, "float32", pad)[1]).decode_step(
        tp, tok, off + S, tree_map(torch.clone, caches[True]))[0]
        for pad in (False, True)]
    assert torch.equal(*steps)


def test_real_heads_on_zero_kv_heads_get_zero_context():
    """The regrouping at its edge: with kv heads zero-padded, a real query
    head whose group falls on a padded kv head reads zero keys and values
    and gets ctx = 0, not NaN, in both the training attention and the
    prefill's plain kernel version."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    gen = torch.Generator().manual_seed(0)
    b, s, h, kv, hd, h_pad, kv_pad = 2, 24, 8, 2, 16, 16, 16
    q = torch.randn((b, s, h, hd), generator=gen)
    k = torch.randn((b, s, kv, hd), generator=gen)
    v = torch.randn((b, s, kv, hd), generator=gen)
    qp = torch.nn.functional.pad(q, (0, 0, 0, h_pad - h))
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, kv_pad - kv))
              for x in (k, v))
    for ctx in (blockwise_attention(qp, kp, vp, causal=True),
                flash_attention_ref(qp, kp, vp, causal=True)):
        assert bool(torch.isfinite(ctx).all())
        g = h_pad // kv_pad
        zero = [i for i in range(h) if i // g >= kv]
        assert zero and bool((ctx[:, :, zero] == 0).all())
        live = [i for i in range(h) if i // g < kv]
        assert bool((ctx[:, :, live].abs().amax(dim=(0, 1, 3)) > 0).all())


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attend_in_runs_of_slots_equals_one_pass(window, monkeypatch):
    """Decode scores taken over runs of cache slots (as a long cache takes
    them, `attention.DECODE_F32_CHUNK`) equal one pass over the cache
    within f32 rounding: each score is an f32 dot product of the same
    terms, summed in the order the batched product of that width picks."""
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(1)
    B_, C, H, KV, hd = 2, 24, 8, 2, 16
    q = torch.randn((B_, 1, H, hd), generator=gen)
    k = torch.randn((B_, C, KV, hd), generator=gen)
    v = torch.randn((B_, C, KV, hd), generator=gen)
    one = attention.decode_attend(q, k, v, 13, window=window)
    monkeypatch.setattr(attention, "DECODE_F32_CHUNK", 5 * B_ * KV * hd)
    torch.testing.assert_close(
        attention.decode_attend(q, k, v, 13, window=window), one,
        rtol=1e-6, atol=1e-6)
