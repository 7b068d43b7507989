"""Parity of the port's served models with the JAX package's, on the CPU.

Smoke configs of zamba2-7b (Mamba2 with a shared attention block, also
with `shared_attn_window=16`), mamba2-1.3b (SSM only), granite-3-8b (dense
GQA), gemma3-4b (sliding-window GQA: window 16, every second layer
global), olmoe-1b-7b and moonshot-v1-16b-a3b (GQA with MoE: 4 experts,
top 2, capacity factor 2, so C = T and nothing drops), olmoe at capacity
factor 1 (prefill drops, and a decode step of 2 tokens has one slot an
expert), and olmoe with a shared expert after a leading dense layer (an
mlp segment, then a moe segment), and deepseek-v2-lite-16b (MLA: a
compressed cache of `c` and `pe` leaves, the decompressed prefill with v
narrower than q and k, the absorbed decode; a dense first layer, then
MoE with a shared expert). The reference's `model.init` params
are carried across with `convert.params_from_jax`; the same numpy tokens
go to both. Prefill logits,
every cache leaf and four teacher-forced decode steps are compared; at
S=48 > 16 the windowed caches are rings that the prefill fills past their
end and every decode step wraps.

Tolerances:
* f32 (`compute_dtype=param_dtype="float32"`): rtol 2e-4, atol 2e-5, as
  `tests/test_serve_smoke.py` holds decode to prefill — both sides compute
  in f32 on the CPU with matmuls and reductions blocked differently.
* bf16 (as configured): rtol 3e-2, atol 0.1. The two packages round to
  bf16 at different places: the reference's attention scales q in bf16 and
  rounds the softmax to bf16 before P·V, where the port's attention keeps
  f32 to its output; elementwise chains (SiLU gates, the conv) round
  per op on one side and fused on the other. Each rounding moves a value by
  up to 2^-8 of it, and through the layers logits of magnitude 2–4 (a bf16
  step of 2^-7 to 2^-6) end a few steps apart: 0.1 is about six steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import attention, build_model
from repro_torch.models.transformer import build_segments
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ARCHS = ["zamba2_7b", "mamba2_1_3b", "granite_3_8b", "gemma3_4b",
         "olmoe_1b_7b", "moonshot_v1_16b_a3b", "deepseek_v2_lite_16b"]
# a served case that is a smoke config with a change: its arch and change
VARIANTS = {"zamba2_7b_window16": ("zamba2_7b", {"shared_attn_window": 16}),
            "olmoe_1b_7b_cf1": ("olmoe_1b_7b", {"moe_capacity_factor": 1.0}),
            "olmoe_1b_7b_shared": ("olmoe_1b_7b", {"n_shared_experts": 1,
                                                   "first_dense_layers": 1})}
# capacity is fixed per call from its token count, so where experts
# overflow, a prefill of S tokens and a decode step route under different
# capacities and cannot agree (the reference's semantics)
DROPPING = {"olmoe_1b_7b_cf1"}
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (3e-2, 0.1)}
B, S, N_DECODE = 2, 48, 4


def _configs(arch, dtype):
    arch, change = VARIANTS.get(arch, (arch, {}))
    jc = jax_smoke(arch).replace(**change)
    tc = get_smoke_config(arch).replace(**change)
    if dtype == "float32":
        kw = dict(compute_dtype="float32", param_dtype="float32")
        jc, tc = jc.replace(**kw), tc.replace(**kw)
    return jc, tc


def _models(arch, dtype, seed=0):
    jc, tc = _configs(arch, dtype)
    jm = jax_build(jc)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(tc), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def _close(a, b, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + list(VARIANTS))
def test_prefill_cache_and_decode_match_reference(arch, dtype):
    jm, jp, tm, tp = _models(arch, dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tm.cfg.vocab_size, (B, S + N_DECODE))
    jl, jcache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
        jm.init_cache(B, S + N_DECODE))
    tcache = tm.init_cache(B, S + N_DECODE, device="cpu")
    tl, tcache2 = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                             tcache)
    assert tcache2 is tcache            # filled in place
    _close(jl, tl, dtype)
    jleaves, tleaves = jax.tree.leaves(jcache), tree_leaves(tcache)
    assert ([tuple(x.shape) for x in jleaves]
            == [tuple(x.shape) for x in tleaves])
    for a, b in zip(jleaves, tleaves):
        _close(a, b, dtype)

    step = jax.jit(jm.decode_step)
    for i in range(N_DECODE):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = step(jp, jnp.asarray(tok, jnp.int32),
                          jnp.int32(S + i), jcache)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), S + i, tcache)
        _close(jl, tl, dtype)
    for a, b in zip(jax.tree.leaves(jcache), tree_leaves(tcache)):
        _close(a, b, dtype)


@pytest.mark.parametrize("arch", [a for a in ARCHS + list(VARIANTS)
                                  if a not in DROPPING])
def test_decode_matches_prefill(arch):
    """The reference's serving property, in the port: one decode step after
    a prefill of S-1 tokens gives the logits of a prefill of S tokens."""
    _, tc = _configs(arch, "float32")
    tm = build_model(tc)
    params = tm.init(1, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, tc.vocab_size, (B, S)))
    full, _ = tm.prefill(params, {"tokens": toks},
                         tm.init_cache(B, 64, device="cpu"))
    _, cache = tm.prefill(params, {"tokens": toks[:, :-1]},
                          tm.init_cache(B, 64, device="cpu"))
    dec, _ = tm.decode_step(params, toks[:, -1:], S - 1, cache)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_segments_and_param_tree_match_reference():
    from repro.models.transformer import build_segments as jax_segments
    for arch in ARCHS + list(VARIANTS):
        jc, tc = _configs(arch, "bfloat16")
        assert ([tuple(vars(s).values()) for s in build_segments(tc)]
                == [tuple(vars(s).values()) for s in jax_segments(jc)])
        jp = jax.eval_shape(jax_build(jc).init, jax.random.PRNGKey(0))
        tp = build_model(tc).init(0, device="cpu")
        assert ([(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jp)]
                == [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
                    for x in tree_leaves(tp)])
        assert (build_model(tc).param_count(tp)
                == jax_build(jc).param_count(jp))


def test_gemma3_layout_and_ring_caches():
    """34 layers: 29 local (window 1024) and 5 global, as the reference
    counts them; at a 2048-token cache a local layer keeps a ring of 1024
    slots and a global one all 2048, as the reference's `init_cache`."""
    from repro.models.transformer import init_cache as jax_init_cache
    from repro_torch.configs import get_config
    cfg = get_config("gemma3_4b")
    segs = build_segments(cfg)
    assert sum(s.n_layers for s in segs if s.kind == "local_attn") == 29
    assert sum(s.n_layers for s in segs if s.kind == "attn") == 5
    assert {s.window for s in segs if s.kind == "local_attn"} == {1024}
    small = cfg.replace(n_layers=6, d_model=64, n_heads=2, n_kv_heads=1,
                        head_dim=8, d_ff=64, vocab_size=64)
    jshapes = [x.shape for x in jax.tree.leaves(jax.eval_shape(
        lambda: jax_init_cache(small, 1, 2048, jnp.bfloat16)))]
    tshapes = [tuple(x.shape) for x in tree_leaves(build_model(
        small).init_cache(1, 2048, device="cpu"))]
    assert tshapes == jshapes == [(5, 1, 1024, 1, 8)] * 2 + [(1, 1, 2048, 1,
                                                              8)] * 2


def test_zamba2_layout():
    """81 layers: 68 Mamba2 layers and 13 insertions of one shared
    attention block, as the reference counts them."""
    from repro_torch.configs import get_config
    segs = build_segments(get_config("zamba2_7b"))
    assert sum(s.n_layers for s in segs if s.kind == "ssm") == 68
    assert sum(s.n_layers for s in segs if s.kind == "shared_attn") == 13


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attend_and_cache_write_match_reference(window):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 8 if window else 12, 2, 16)
                         ).astype(np.float32) for _ in range(2))
    kn, vn = (rng.normal(size=(2, 1, 2, 16)).astype(np.float32)
              for _ in range(2))
    pos = 10 if window else 6
    jk, jv = jax_attn.cache_write(jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.int32(pos), window=window)
    ref = jax_attn.decode_attend(jnp.asarray(q), jk, jv, jnp.int32(pos),
                                 window=window)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    attention.cache_write(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                          pos, window=window)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    out = attention.decode_attend(torch.from_numpy(q), tk, tv, pos,
                                  window=window)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_bf16_params_round_trip_bit_equal():
    """bf16 leaves cross `params_from_jax` and come back through
    `params_to_numpy` with every bit unchanged."""
    jp = jax.tree.map(np.asarray, jax_build(jax_smoke("zamba2_7b")).init(
        jax.random.PRNGKey(3)))
    tp = params_from_jax(jp, "cpu")
    dtypes = {str(t.dtype) for t in tree_leaves(tp)}
    assert dtypes == {"torch.bfloat16", "torch.float32"}
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("arch,change", [
    ("zamba2_7b", {"hybrid_attn_every": 3}),
    ("gemma3_4b", {"swa_pattern": 3}),
    ("olmoe_1b_7b", {"n_shared_experts": 1, "first_dense_layers": 1})])
def test_init_segments_bit_equal_to_list_then_stack(arch, change):
    """`init_segments` copies each layer into a stacked leaf allocated
    once; the params are those of drawing every layer into a list and
    stacking it (the generator order is unchanged), leaf by leaf. Six
    layers, so segments hold several layers."""
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map
    cfg = get_smoke_config(arch).replace(n_layers=6, **change)
    dtype = torch.bfloat16
    got = transformer.init_segments(torch.Generator().manual_seed(7), cfg,
                                    dtype)
    gen = torch.Generator().manual_seed(7)
    want: dict = {"segments": {}}
    segs = build_segments(cfg)
    shared = next((s for s in segs if s.kind == "shared_attn"), None)
    if shared is not None:
        want["shared_attn"] = transformer._layer_init(gen, shared, cfg, dtype)
    for seg in segs:
        layers = ([] if seg.kind == "shared_attn" else
                  [transformer._layer_init(gen, seg, cfg, dtype)
                   for _ in range(seg.n_layers)])
        want["segments"][str(seg.index)] = (
            tree_map(lambda *ls: torch.stack(ls), *layers) if layers else {})
    assert max(s.n_layers for s in segs) > 1
    assert tree_map(lambda t: (t.shape, t.dtype), got) == tree_map(
        lambda t: (t.shape, t.dtype), want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
