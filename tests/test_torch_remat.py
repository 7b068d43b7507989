"""Remat (`cfg.remat`, `models/remat.py`) on the port's training path, on
the CPU, at the smoke configs of one model of each family: dense GQA
(granite-3-8b), local window (gemma3-4b), MLA (deepseek-v2-lite-16b), MoE
(olmoe-1b-7b), hybrid SSM (zamba2-7b), encoder (hubert-xlarge) and vision
(llava-next-34b).

  * Remat changes memory and time, never numbers: the loss and every
    gradient with `remat=True` are bit-equal to `remat=False`, under
    `grad_and_value` and under `client_updates` (`vmap` of K `grad`
    steps, the training round's local update).
  * The port with `remat=True` is held to the reference with
    `remat=True` (its layers under `jax.checkpoint`), from the
    reference's params carried across (`convert.params_from_jax`), at the
    bounds of `tests/test_torch_models.py`: f32 rtol 2e-4 / atol 2e-5,
    bf16 rtol 3e-2 / atol 0.1 (gradients with atol scaled by each leaf's
    largest |value|).
  * The three functions that always rematerialize, as the reference's do
    (`blockwise_attention`'s query blocks, `chunked_lm_loss`'s chunks,
    `ssd_chunked`'s chunks), with more than one block or chunk: values and
    gradients bit-equal to the same loop with `checkpoint` replaced by a
    plain call.
  * A fake trace of a small `train_4k` plan (`roofline.analysis`) counts
    more FLOPs with `remat=True`, by the recomputed forward.
  * `checkpoint` has no second derivative: differentiating its backward
    pass again raises, while one derivative, nested checkpoints included,
    is bit-equal to the plain function's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.local_update import client_updates
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import attention, build_model, layers, ssm
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ARCHS = ["granite_3_8b", "gemma3_4b", "deepseek_v2_lite_16b",
         "olmoe_1b_7b", "zamba2_7b", "hubert_xlarge", "llava_next_34b"]
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (3e-2, 0.1)}
F32 = dict(compute_dtype="float32", param_dtype="float32")
# a batch: sequences, text tokens after llava's patches; clients and local
# steps of the vmapped update
B, S, N, K = 2, 32, 2, 2
# deepseek's bf16 router puts a token on other experts on the two sides
# at a near-tie (tests/test_torch_loss.py, BF16_ROUTING_TIE)
BF16_ROUTING_TIE = {"deepseek_v2_lite_16b"}


def _configs(arch, dtype, **change):
    jc, tc = jax_smoke(arch), get_smoke_config(arch)
    if dtype == "float32":
        jc, tc = jc.replace(**F32), tc.replace(**F32)
    return jc.replace(**change), tc.replace(**change)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, dtype):
    """The reference's init as numpy."""
    jc, _ = _configs(arch, dtype)
    return jax.tree.map(np.asarray,
                        jax_build(jc).init(jax.random.PRNGKey(7)))


def _batch(cfg, lead=(B,), seed=0):
    """A seeded numpy batch of `cfg`'s modality with leading axes `lead`."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio":
        return {"frames": rng.normal(size=lead + (S, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, lead + (S,))
                .astype(np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, lead + (S,))
           .astype(np.int32)}
    if cfg.modality == "vision_text":
        out["patches"] = (0.02 * rng.normal(
            size=lead + (cfg.n_patches, cfg.d_model))).astype(np.float32)
    return out


def _torch(batch, cfg):
    from repro_torch.models.model import DTYPES
    return {k: torch.from_numpy(v).to(DTYPES[cfg.compute_dtype])
            if v.dtype.kind == "f" else torch.from_numpy(v)
            for k, v in batch.items()}


def _flat(tree) -> list:
    if isinstance(tree, tuple):
        return [x for t in tree for x in _flat(t)]
    return tree_leaves(tree)


def _equal(a, b):
    la, lb = _flat(a), _flat(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_to_no_remat(arch):
    """Loss and gradients (`grad_and_value`), and K-step local updates and
    losses of N clients (`client_updates`: vmap of grad), with remat on
    and off."""
    _, cfg = _configs(arch, "bfloat16")
    params = params_from_jax(_ref_params(arch, "bfloat16"), "cpu")
    batch = _torch(_batch(cfg), cfg)
    rounds = _torch(_batch(cfg, (N, K, 1), seed=1), cfg)
    eta = torch.tensor(0.05)
    got = {}
    for remat in (False, True):
        model = build_model(cfg.replace(remat=remat))
        g, (loss, aux) = grad_and_value(model.loss_fn, has_aux=True)(
            params, batch)
        updates, losses = client_updates(model.loss_fn, params, rounds,
                                         eta, K=K)
        got[remat] = (g, loss, aux, updates, losses)
    for a, b in zip(got[False], got[True]):
        _equal(a, b)


@pytest.mark.parametrize("arch,dtype", [
    (a, d) for a in ARCHS for d in ("float32", "bfloat16")
    if not (d == "bfloat16" and a in BF16_ROUTING_TIE)])
def test_remat_matches_the_reference_with_remat(arch, dtype):
    jc, tc = _configs(arch, dtype, remat=True)
    pnp = _ref_params(arch, dtype)
    batch = _batch(tc)
    (jl, _), jg = jax.jit(jax.value_and_grad(jax_build(jc).loss_fn,
                                             has_aux=True))(
        jax.tree.map(jnp.asarray, pnp),
        jax.tree.map(jnp.asarray, batch))
    tg, (tl, _) = grad_and_value(build_model(tc).loss_fn, has_aux=True)(
        params_from_jax(pnp, "cpu"), _torch(batch, tc))
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol, atol=atol)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(
            b.float().numpy(), a, rtol=rtol,
            atol=atol * max(float(np.abs(a).max()), 1e-30))


def _plain(monkeypatch, *modules):
    """`checkpoint` in `modules` replaced by a plain call: the same loop
    with every activation kept."""
    for m in modules:
        monkeypatch.setattr(m, "checkpoint", lambda fn, *t: fn(*t))


def _grads_both_ways(monkeypatch, module, fn, args):
    """(value, grads) of fn with `module.checkpoint` and with a plain
    call, under grad_and_value and vmap over a leading axis of 2."""
    out = []
    for plain in (False, True):
        if plain:
            _plain(monkeypatch, module)
        g = grad_and_value(fn, argnums=tuple(range(len(args))))
        out.append((g(*args), vmap(g)(*(torch.stack([a, 0.5 * a])
                                         for a in args))))
    return out


@pytest.mark.parametrize("window,causal,dtype", [
    (0, True, torch.float32), (0, False, torch.bfloat16),
    (12, True, torch.float32), (7, False, torch.bfloat16)])
def test_blockwise_attention_blocks_are_rematerialized(monkeypatch, window,
                                                       causal, dtype):
    """Four query blocks of 12 (GQA g=2, S=48), windowed and not."""
    gen = torch.Generator().manual_seed(window)
    q = torch.randn((2, 48, 4, 8), generator=gen).to(dtype)
    k, v = (torch.randn((2, 48, 2, 8), generator=gen).to(dtype)
            for _ in range(2))
    ct = torch.randn((2, 48, 4, 8), generator=gen)

    def fn(q, k, v):
        return (attention.blockwise_attention(
            q, k, v, causal=causal, window=window, q_block=12).float()
            * ct).sum()

    remat, plain = _grads_both_ways(monkeypatch, attention, fn, (q, k, v))
    _equal(remat, plain)


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_lm_loss_chunks_are_rematerialized(monkeypatch, masked):
    """Three chunks of 16 over S=48."""
    gen = torch.Generator().manual_seed(3)
    h = torch.randn((2, 48, 16), generator=gen)
    w = torch.randn((16, 40), generator=gen) / 4
    labels = torch.randint(0, 40, (2, 48), generator=gen, dtype=torch.int32)
    mask = (torch.rand((2, 48), generator=gen) > 0.3).float() \
        if masked else None

    def fn(h, w):
        return layers.chunked_lm_loss(h, w, labels, mask, chunk=16)

    remat, plain = _grads_both_ways(monkeypatch, layers, fn, (h, w))
    _equal(remat, plain)


def test_ssd_chunked_chunks_are_rematerialized(monkeypatch):
    """Five chunks of 8 over S=40, the carried state's gradient through
    every chunk, and h_final's."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 40, 3, 4), generator=gen)
    dA = -0.1 * torch.rand((2, 40, 3), generator=gen) * torch.arange(1, 4)
    Bm, Cm = (torch.randn((2, 40, 5), generator=gen) for _ in range(2))
    ct, h_ct = torch.randn((2, 40, 3, 4)), torch.randn((2, 3, 4, 5))

    def fn(x, dA, Bm, Cm):
        y, h = ssm.ssd_chunked(x, dA, Bm, Cm, 8)
        return (y * ct).sum() + (h * h_ct).sum()

    remat, plain = _grads_both_ways(monkeypatch, ssm, fn, (x, dA, Bm, Cm))
    _equal(remat, plain)


def test_remat_adds_the_recomputed_forward_to_a_traced_plan():
    """granite-3-8b's smoke config at train_4k on a 1x1 abstract mesh: the
    fake trace finishes with remat on and off, and remat counts more
    FLOPs (each layer's forward runs again in the backward pass)."""
    from repro_torch.launch import specs
    from repro_torch.roofline import analysis
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    flops = {}
    for remat in (False, True):
        cfg = get_smoke_config("granite_3_8b").replace(remat=remat)
        a = analysis.analyze_plan(specs.plan_config(cfg, "train_4k", mesh),
                                  mesh)
        flops[remat] = a["flops_traced"]
    assert 0 < flops[False] < flops[True]


def _nested(x):
    """tanh(sin(x)·x)³ summed, with the inner product checkpointed inside
    the outer checkpoint."""
    from repro_torch.models.remat import checkpoint
    inner = lambda t: checkpoint(lambda u: torch.sin(u) * u, t)
    return checkpoint(lambda t: torch.tanh(inner(t)).pow(3), x).sum()


def _create_graph(fn, x):
    x = x.detach().requires_grad_()
    g, = torch.autograd.grad(fn(x), x, create_graph=True)
    return torch.autograd.grad(g.sum(), x)[0]


SECOND = {
    "grad_of_grad": lambda fn, x: torch.func.grad(
        lambda y: torch.func.grad(fn)(y).sum())(x),
    "jacrev_of_grad": lambda fn, x: torch.func.jacrev(torch.func.grad(fn))(x),
    "create_graph": _create_graph,
}


@pytest.mark.parametrize("how", sorted(SECOND))
def test_a_second_derivative_through_checkpoint_raises(how):
    """The plain function's second derivative exists; through
    `checkpoint` the same request raises rather than treating the
    recomputed part as a constant."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(3))
    plain = lambda t: torch.tanh(torch.sin(t) * t).pow(3).sum()
    assert torch.isfinite(SECOND[how](plain, x)).all()
    with pytest.raises(RuntimeError, match="no second derivative"):
        SECOND[how](_nested, x)


@pytest.mark.parametrize("how", ["grad", "vmap_grad", "autograd"])
def test_one_derivative_through_nested_checkpoints_is_the_plain_one(how):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(3))
    plain = lambda t: torch.tanh(torch.sin(t) * t).pow(3).sum()

    def d(fn):
        if how == "grad":
            return torch.func.grad(fn)(x)
        if how == "vmap_grad":
            return vmap(torch.func.grad(fn))(torch.stack([x, 0.5 * x]))
        y = x.detach().requires_grad_()
        return torch.autograd.grad(fn(y), y)[0]
    assert torch.equal(d(_nested), d(plain))
