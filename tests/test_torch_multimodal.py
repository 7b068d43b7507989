"""Parity of the port's stub-frontend models with the JAX package's, on the
CPU: llava-next-34b (vision_text: patch embeddings prepended to the text)
and hubert-xlarge (audio: frames through `frontend_proj`, encoder-only,
non-causal), at their smoke configs.

The reference's `model.init` params are carried across with
`convert.params_from_jax`, and the same seeded numpy batches go to both
sides: `init`'s leaf structure, `loss_fn` (f32 and bf16, with the chunked
cross-entropy and without, so `_labels_mask` is held per modality) with its
f32 gradients, llava's prefill (logits, cache) and greedy decode through
`launch.serve.serve`, hubert's `make_encoder_step` score, one round of
`make_train_step` for each (hubert's vmap mode through the server step,
llava's sequential mode slicing its two batch leaves per client), and
`all_configs`. The reference's own serving driver sizes llava's cache
too short; that finding is pinned here too.

Tolerances are those of `test_torch_models.py`: f32 rtol 2e-4, atol 2e-5
(gradients and train-step leaves with atol scaled by each leaf's largest
|value|); bf16 rtol 3e-2, atol 0.1 (the two packages round to bf16 at
other places).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import make_encoder_step as jax_encoder_step
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import build_model as jax_build
from repro_torch.configs import all_configs, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import make_encoder_step, make_train_step
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

ARCHS = ["llava_next_34b", "hubert_xlarge"]
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (3e-2, 0.1)}
F32 = dict(compute_dtype="float32", param_dtype="float32")
B, S_TEXT, S_AUDIO = 2, 24, 32
# serving: prompt and new tokens (the cache holds n_patches + P + T)
P, T = 8, 4
# one training round: clients, local steps, minibatch, active clients, rate
N, K, MB, ETA = 3, 2, 2, 0.05
ACTIVE = np.array([True, False, True])


def _configs(arch, dtype, **change):
    jc, tc = jax_smoke(arch), get_smoke_config(arch)
    if dtype == "float32":
        jc, tc = jc.replace(**F32), tc.replace(**F32)
    return jc.replace(**change), tc.replace(**change)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, dtype):
    """The reference's init as numpy (bf16 leaves stay numpy bf16)."""
    jc, _ = _configs(arch, dtype)
    return jax.tree.map(np.asarray,
                        jax_build(jc).init(jax.random.PRNGKey(7)))


def _batch(cfg, lead=(B,), seed=0):
    """A seeded numpy batch of `cfg`'s modality with leading axes `lead`:
    tokens and patches (vision_text), or frames and labels (audio)."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "vision_text":
        return {"tokens": rng.integers(0, cfg.vocab_size, lead + (S_TEXT,)
                                       ).astype(np.int32),
                "patches": (0.02 * rng.normal(
                    size=lead + (cfg.n_patches, cfg.d_model))
                            ).astype(np.float32)}
    return {"frames": rng.normal(size=lead + (S_AUDIO, cfg.d_model)
                                 ).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, lead + (S_AUDIO,)
                                   ).astype(np.int32)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(ref, got, dtype="float32", scaled=False):
    rtol, atol = TOL[dtype]
    ref = np.asarray(ref, np.float32)
    if scaled:
        atol = atol * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_leaves_match_reference(arch):
    """Leaf keys, shapes and dtypes of `init` as the reference's, with
    hubert's `frontend_proj` (d_model, d_model) and the unused `embed` it
    keeps, as the reference does."""
    jc, tc = _configs(arch, "bfloat16")
    jp = jax.eval_shape(jax_build(jc).init, jax.random.PRNGKey(0))
    tp = build_model(tc).init(0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert ([(jax.tree_util.keystr(k), tuple(x.shape), str(x.dtype))
             for k, x in flat]
            == [(jax.tree_util.keystr(k), tuple(x.shape),
                 str(x.dtype).removeprefix("torch."))
                for k, x in jax.tree_util.tree_flatten_with_path(tp)[0]])
    assert ("frontend_proj" in tp) == (arch == "hubert_xlarge")
    assert "embed" in tp
    if arch == "hubert_xlarge":
        assert tuple(tp["frontend_proj"].shape) == (tc.d_model, tc.d_model)
    assert build_model(tc).param_count(tp) == jax_build(jc).param_count(jp)


def test_audio_frontend_is_drawn_after_the_text_leaves():
    """`frontend_proj` is drawn last: the same config as a text model
    draws every other leaf bit-equal."""
    cfg = get_smoke_config("hubert_xlarge")
    audio = build_model(cfg).init(3, device="cpu")
    text = build_model(cfg.replace(modality="text")).init(3, device="cpu")
    assert "frontend_proj" not in text
    del audio["frontend_proj"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(audio),
                                                 tree_leaves(text)))


@pytest.mark.parametrize("ce_chunk", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch, dtype, ce_chunk):
    """The loss (vision_text: the text after the patches; audio: every
    frame against its label), plain and chunked, and in f32 every
    gradient leaf."""
    jc, tc = _configs(arch, dtype, ce_chunk=ce_chunk)
    jm, tm = jax_build(jc), build_model(tc)
    pnp, batch = _ref_params(arch, dtype), _batch(tc)
    tparams = params_from_jax(pnp, "cpu")
    jparams = jax.tree.map(jnp.asarray, pnp)
    if dtype == "float32":
        (jl, jaux), jg = jax.jit(jax.value_and_grad(
            jm.loss_fn, has_aux=True))(jparams, _jnp(batch))
        tg, (tl, taux) = grad_and_value(tm.loss_fn, has_aux=True)(
            tparams, _torch(batch))
        jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
        assert len(jleaves) == len(tleaves)
        for a, b in zip(jleaves, tleaves):
            _close(a, b, dtype, scaled=True)
    else:
        jl, jaux = jax.jit(jm.loss_fn)(jparams, _jnp(batch))
        tl, taux = tm.loss_fn(tparams, _torch(batch))
    assert bool(torch.isfinite(tl))
    _close(jl, tl, dtype)
    _close(jaux["ce"], taux["ce"], dtype)
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_labels_mask_matches_reference(arch):
    """The chunked CE's full-length labels and mask, array-equal: audio's
    labels with a mask of ones; vision_text's P zero labels and mask
    entries before the shifted text, and a zero at the end."""
    jc, tc = _configs(arch, "float32")
    batch = _batch(tc)
    S = (tc.n_patches + S_TEXT if tc.modality == "vision_text"
         else S_AUDIO)
    jl, jmask = jax_build(jc)._labels_mask(_jnp(batch), S)
    tl, tmask = build_model(tc)._labels_mask(_torch(batch))
    assert tl.shape == tmask.shape == (B, S)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert np.array_equal(np.asarray(jmask, np.float32), tmask.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llava_prefill_and_decode_match_reference(dtype):
    """llava's prefill over n_patches + P positions (logits, every cache
    leaf) and T teacher-forced decode steps at n_patches + P + i against
    the reference's `Model.prefill` / `decode_step`, both with a cache of
    n_patches + P + T."""
    jc, tc = _configs("llava_next_34b", dtype)
    jm, tm = jax_build(jc), build_model(tc)
    pnp = _ref_params("llava_next_34b", dtype)
    batch = _batch(tc, seed=1)
    batch["tokens"] = batch["tokens"][:, :P]
    nxt = np.random.default_rng(2).integers(0, tc.vocab_size, (B, T))
    base, cache_len = tc.n_patches + P, tc.n_patches + P + T
    jl, jcache = jax.jit(jm.prefill)(jax.tree.map(jnp.asarray, pnp),
                                     _jnp(batch), jm.init_cache(B, cache_len))
    tp = params_from_jax(pnp, "cpu")
    tcache = tm.init_cache(B, cache_len, device="cpu")
    tl, _ = tm.prefill(tp, _torch(batch), tcache)
    _close(jl, tl, dtype)
    for a, b in zip(jax.tree.leaves(jcache), tree_leaves(tcache)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, dtype)
    step = jax.jit(jm.decode_step)
    for i in range(T):
        tok = nxt[:, i:i + 1]
        jl, jcache = step(jax.tree.map(jnp.asarray, pnp),
                          jnp.asarray(tok, jnp.int32), jnp.int32(base + i),
                          jcache)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), base + i,
                                    tcache)
        _close(jl, tl, dtype)


def test_llava_serve_greedy_tokens_match_reference():
    """`serve(..., device="cpu")` on the reference's params (f32): its
    prompts and patches, prefilled and decoded greedily by the reference
    with a cache of n_patches + P + T, give the same logits and tokens."""
    from repro_torch.launch.serve import report, serve
    jc, tc = _configs("llava_next_34b", "float32")
    pnp = _ref_params("llava_next_34b", "float32")
    out = serve(cfg=tc, batch=B, prompt_len=P, new_tokens=T, seed=3,
                device="cpu", params=params_from_jax(pnp, "cpu"))
    assert tuple(out["patches"].shape) == (B, tc.n_patches, tc.d_model)
    jm = jax_build(jc)
    jp = jax.tree.map(jnp.asarray, pnp)
    logits, cache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(out["prompts"].numpy(), jnp.int32),
             "patches": jnp.asarray(out["patches"].numpy())},
        jm.init_cache(B, tc.n_patches + P + T))
    _close(logits, out["logits"])
    step, toks = jax.jit(jm.decode_step), []
    tok = jnp.argmax(logits, -1)[:, None]
    for i in range(T):
        toks.append(np.asarray(tok))
        logits, cache = step(jp, tok, jnp.int32(tc.n_patches + P + i),
                             cache)
        tok = jnp.argmax(logits, -1)[:, None]
    assert np.array_equal(np.concatenate(toks, axis=1), out["tokens"].numpy())
    assert f"patches={tc.n_patches} prompt={P}" in report(out)[0]


def test_reference_serve_cache_is_too_short_for_llava():
    """The reference's driver sizes the cache P + T (`launch/serve.py:38`),
    but a llava prefill writes n_patches + P positions: at the smoke
    config (16 patches, P=8, T=4) its prefill raises on a cache of 12,
    while the port's `serve` sizes n_patches + P + T and runs."""
    from repro_torch.launch.serve import serve
    jc, tc = _configs("llava_next_34b", "bfloat16")
    jm = jax_build(jc)
    batch = _batch(tc)
    batch["tokens"] = batch["tokens"][:, :P]
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jax.jit(jm.prefill)(
            jax.tree.map(jnp.asarray, _ref_params("llava_next_34b",
                                                  "bfloat16")),
            _jnp(batch), jm.init_cache(B, P + T))
    out = serve("llava-next-34b", smoke=True, batch=B, prompt_len=P,
                new_tokens=T, device="cpu")
    assert tuple(out["tokens"].shape) == (B, T)
    assert bool(torch.isfinite(out["logits"].float()).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_encoder_score_matches_reference(dtype):
    """hubert's scoring forward (non-causal, no cache) through
    `make_encoder_step` against the reference's."""
    jc, tc = _configs("hubert_xlarge", dtype)
    pnp, batch = _ref_params("hubert_xlarge", dtype), _batch(tc, seed=4)
    ref = jax.jit(jax_encoder_step(jax_build(jc)))(
        jax.tree.map(jnp.asarray, pnp), _jnp(batch))
    got = make_encoder_step(build_model(tc))(params_from_jax(pnp, "cpu"),
                                             _torch(batch))
    _close(ref, got, dtype)


def test_hubert_attends_both_ways():
    """Encoder-only attention is non-causal: changing the last frame moves
    the first position's output (a causal model's would not move)."""
    from repro_torch.models import transformer
    _, tc = _configs("hubert_xlarge", "float32")
    params = params_from_jax(_ref_params("hubert_xlarge", "float32"), "cpu")
    x = torch.from_numpy(_batch(tc)["frames"])
    h0, _ = transformer.forward(params, x, torch.arange(S_AUDIO), tc)
    x[:, -1] += 1.0
    h1, _ = transformer.forward(params, x, torch.arange(S_AUDIO), tc)
    assert float((h1[:, 0] - h0[:, 0]).abs().max()) > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_round_matches_reference(arch):
    """One MIFA round of `make_train_step` (f32) against the reference's
    jitted step on a batch of leaves (N, K, mb, ...) in the layout of
    `repro/launch/specs.py::_train_batch`: hubert in vmap mode (frames
    and labels; the server step through `mifa_aggregate_tree`), llava in
    its configured sequential mode (tokens and patches, sliced per
    client)."""
    jc, tc = _configs(arch, "float32", fl_clients=N, fl_local_steps=K)
    assert tc.sequential_clients == (arch == "llava_next_34b")
    pnp = _ref_params(arch, "float32")
    batch = _batch(tc, lead=(N, K, MB), seed=5)
    jp = jax.tree.map(jnp.asarray, pnp)
    jstep = jax.jit(jax_train_step(jax_build(jc), jc, N, K))
    rp, rG, rm = jstep(jp, jax.tree.map(lambda p: jnp.zeros((N,) + p.shape),
                                        jp),
                       _jnp(batch), jnp.asarray(ACTIVE), jnp.float32(ETA))
    params = params_from_jax(pnp, "cpu")
    G = tree_map(lambda p: torch.zeros((N,) + tuple(p.shape)), params)
    tp, tG, tm = make_train_step(build_model(tc), tc, N, K)(
        params, G, _torch(batch), torch.from_numpy(ACTIVE), ETA)
    _close(rm["loss"], tm["loss"])
    for a, b in zip(jax.tree.leaves(rp) + jax.tree.leaves(rG),
                    tree_leaves(tp) + tree_leaves(tG)):
        _close(a, b, scaled=True)
    # the inactive client's memory stays zero
    assert all(bool((g[1] == 0).all()) for g in tree_leaves(tG))


def test_all_configs_match_reference():
    """All ten zoo configs, field for field, and `get_config` by the
    dashed names."""
    ref, got = jax_all_configs(), all_configs()
    assert list(got) == list(ref) and len(got) == 10
    for name in ref:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(ref[name])
    assert get_config("llava-next-34b") is got["llava_next_34b"]
    assert get_config("hubert-xlarge").encoder_only


@pytest.mark.parametrize("arch", ARCHS)
def test_train_entry_point_refuses_stub_frontends(arch):
    """`launch.train.train` draws token batches only; for these modalities
    it raises naming the modality (the reference's loop fails inside
    loss_fn) and points to `make_train_step`."""
    from repro_torch.launch.train import train
    modality = get_smoke_config(arch).modality
    with pytest.raises(ValueError, match=f"'{modality}'.*make_train_step"):
        train(arch, smoke=True, rounds=1, device="cpu")
