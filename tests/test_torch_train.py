"""Parity of the port's federated training of the zoo's text models with the
JAX package's, on the CPU.

The same numpy inputs go to both packages: token streams and batches
(array-equal), the training model functions (`chunked_lm_loss`,
`blockwise_attention`, `ssd_chunked`) with their gradients, and five rounds
of `launch.train.train` against the reference's round loop
(`repro/launch/train.py:67-87`) for granite-3-8b, qwen1.5-110b,
olmoe-1b-7b and deepseek-v2-lite-16b.
`test_torch_loss.py` holds `loss_fn` and its gradients, and
`test_torch_steps.py` the step builders, with the helpers here. Params are
drawn by the port's init (the reference's `jax.random` draws are not
reproduced) and carried across as numpy, so both sides start from the same
weights.

Tolerances:
* f32: rtol 2e-4, atol 2e-5, the model bounds of `test_torch_models.py`:
  both sides compute in f32 on the CPU with matmuls and reductions blocked
  differently. Gradients are held at the same bounds, each leaf against its
  own magnitude (atol scaled by the leaf's largest |value|), because a
  leaf's entries span orders of magnitude.
* bf16 (as configured): rtol 3e-2, atol 0.1, as `test_torch_models.py`
  documents: the two sides round to bf16 at other places (fused against
  per-op elementwise chains), so values land a few bf16 steps apart.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value

from repro.configs import get_smoke_config as jax_smoke
from repro.core import MIFA as JMIFA
from repro.core import BernoulliParticipation as JBernoulli
from repro.core.local_update import client_updates as jax_client_updates
from repro.data import TokenBatcher as JTokenBatcher
from repro.data.synthetic import make_token_stream as jax_token_stream
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro.optim import inv_t as jax_inv_t
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.data import TokenBatcher, make_token_stream
from repro_torch.launch.train import main, train
from repro_torch.models import attention, build_model, layers, ssm
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

TOL = {"float32": (2e-4, 2e-5), "bfloat16": (3e-2, 0.1)}
F32 = dict(compute_dtype="float32", param_dtype="float32")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def close(ref, got, dtype="float32", scaled=False):
    rtol, atol = TOL[dtype]
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    if scaled:
        atol = atol * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@functools.lru_cache(maxsize=None)
def params_np(arch, dtype):
    """The port's init on the CPU as numpy (bf16 leaves by their bits);
    qwen's zero-initialised QKV biases made nonzero so they matter."""
    cfg = get_smoke_config(arch)
    if dtype == "float32":
        cfg = cfg.replace(**F32)
    p = build_model(cfg).init(3, device="cpu")
    if cfg.qkv_bias:
        gen = torch.Generator().manual_seed(5)
        for name in ("bq", "bk", "bv"):
            b = p["segments"]["0"]["attn"][name]
            b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    return params_to_numpy(p)


def configs(arch, dtype, **change):
    jc, tc = jax_smoke(arch), get_smoke_config(arch)
    if dtype == "float32":
        jc, tc = jc.replace(**F32), tc.replace(**F32)
    return jc.replace(**change), tc.replace(**change)


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("vocab,length,seed,shift", [
    (512, 4096, 0, 0), (49_155, 10_000, 3, 12_288), (97, 777, 11, 50)])
def test_make_token_stream_array_equal(vocab, length, seed, shift):
    ref = jax_token_stream(vocab, length, seed=seed, client_shift=shift)
    got = make_token_stream(vocab, length, seed=seed, client_shift=shift)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_token_batcher_array_equal():
    kw = dict(n_clients=5, vocab=512, seq_len=24, batch_size=3, k_steps=2,
              stream_len=2048, seed=4)
    ref, got = JTokenBatcher(**kw), TokenBatcher(**kw)
    for t in range(3):
        a, b = ref.sample_round(t), got.sample_round(t)
        assert b["tokens"].dtype == np.int32
        assert np.array_equal(a["tokens"], b["tokens"])
    ids = np.array([3, 0, 4])
    assert np.array_equal(ref.sample_round(2, client_ids=ids)["tokens"],
                          got.sample_round(2, client_ids=ids)["tokens"])


# --------------------------------------------------------------------------- #
# the training model functions, with their gradients
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("chunk,masked", [(16, True), (20, False),
                                          (512, True)])
def test_chunked_lm_loss_and_grads(chunk, masked):
    """S=48: chunk 16 divides it, 20 halves to 10, 5 and then 2, and 512
    clips to S."""
    rng = np.random.default_rng(chunk)
    B, S, d, V = 2, 48, 16, 40
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) / 4).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32) if masked else None

    def jloss(h, w):
        return jax_layers.chunked_lm_loss(
            h, w, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), chunk=chunk)

    def tloss(h, w):
        return layers.chunked_lm_loss(
            h, w, _t(labels), None if mask is None else _t(mask),
            chunk=chunk)

    jl, (jgh, jgw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        h, w)
    (tgh, tgw), tl = grad_and_value(tloss, argnums=(0, 1))(_t(h), _t(w))
    close(jl, tl)
    close(jgh, tgh, scaled=True)
    close(jgw, tgw, scaled=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,causal,q_block", [
    (4, 4, True, 0), (8, 2, True, 16), (8, 2, False, 0), (6, 3, True, 12)])
def test_blockwise_attention_and_grads(H, KV, causal, q_block, dtype):
    rng = np.random.default_rng(H * 10 + KV)
    B, S, hd = 2, 48, 16
    q, k, v, ct = (rng.normal(size=shape).astype(np.float32) for shape in (
        (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def jfn(q, k, v):
        out = jax_attn.blockwise_attention(
            q.astype(jdt), k.astype(jdt), v.astype(jdt), causal=causal,
            q_block=q_block)
        return (out.astype(jnp.float32) * ct).sum(), out

    def tfn(q, k, v):
        out = attention.blockwise_attention(
            q.to(tdt), k.to(tdt), v.to(tdt), causal=causal, q_block=q_block)
        return (out.float() * _t(ct)).sum(), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                               has_aux=True))(q, k, v)
    tg, (_, tout) = grad_and_value(tfn, argnums=(0, 1, 2),
                                   has_aux=True)(_t(q), _t(k), _t(v))
    close(jout.astype(jnp.float32), tout, dtype)
    for a, b in zip(jg, tg):
        close(a, b, dtype, scaled=True)


def test_blockwise_attention_window_raises():
    """A window needs queries and keys at the same positions (T == S), as
    the reference's windowed path assumes."""
    x = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="needs T == S"):
        attention.blockwise_attention(x, x[:, :6], x[:, :6], window=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,causal,q_block", [
    (1, True, 0), (5, True, 16), (16, True, 12), (64, True, 16),
    (7, False, 16)])
def test_blockwise_attention_window_and_grads(window, causal, q_block,
                                              dtype):
    """The windowed path (gemma3's local layers, `shared_attn_window`):
    values and gradients against the reference's, GQA g=2, S=48; windows
    of one key, inside a block, of one block and past S, and the
    reference's non-causal window (its keys end at the block's end)."""
    rng = np.random.default_rng(window * 3 + q_block)
    B, S, H, KV, hd = 2, 48, 4, 2, 16
    q, k, v, ct = (rng.normal(size=shape).astype(np.float32) for shape in (
        (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def jfn(q, k, v):
        out = jax_attn.blockwise_attention(
            q.astype(jdt), k.astype(jdt), v.astype(jdt), causal=causal,
            window=window, q_block=q_block)
        return (out.astype(jnp.float32) * ct).sum(), out

    def tfn(q, k, v):
        out = attention.blockwise_attention(
            q.to(tdt), k.to(tdt), v.to(tdt), causal=causal, window=window,
            q_block=q_block)
        return (out.float() * _t(ct)).sum(), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                               has_aux=True))(q, k, v)
    tg, (_, tout) = grad_and_value(tfn, argnums=(0, 1, 2),
                                   has_aux=True)(_t(q), _t(k), _t(v))
    close(jout.astype(jnp.float32), tout, dtype)
    for a, b in zip(jg, tg):
        close(a, b, dtype, scaled=True)


def _ssd_inputs(seed, b=2, S=40, H=3, P=4, N=5, dt=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, S, H, P)).astype(np.float32)
    # dA = dt·A with A = -1..-H, as mamba2_init's A_log gives
    dA = (-dt * rng.uniform(0.5, 1.5, (b, S, H))
          * np.arange(1, H + 1)).astype(np.float32)
    B = rng.normal(size=(b, S, N)).astype(np.float32)
    C = rng.normal(size=(b, S, N)).astype(np.float32)
    ct = rng.normal(size=(b, S, H, P)).astype(np.float32)
    return x, dA, B, C, ct


@pytest.mark.parametrize("chunk", [16, 12, 64])
def test_ssd_chunked_and_grads(chunk):
    """S=40: chunk 16 halves to 8, 12 halves to 6, 3 and then 1, and 64
    clips to S. The inputs keep every chunk's |dA| sum far below exp's
    overflow, where the reference's gradient is finite."""
    x, dA, B, C, ct = _ssd_inputs(chunk)
    h_ct = np.random.default_rng(1).normal(size=(2, 3, 4, 5)).astype(
        np.float32)

    def jfn(x, dA, B, C):
        y, h = jax_ssm.ssd_chunked(x, dA, B, C, chunk)
        return (y * ct).sum() + (h * h_ct).sum(), (y, h)

    def tfn(x, dA, B, C):
        y, h = ssm.ssd_chunked(x, dA, B, C, chunk)
        return (y * _t(ct)).sum() + (h * _t(h_ct)).sum(), (y, h)

    (_, (jy, jh)), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True))(x, dA, B, C)
    tg, (_, (ty, th)) = grad_and_value(
        tfn, argnums=(0, 1, 2, 3), has_aux=True)(*map(_t, (x, dA, B, C)))
    close(jy, ty)
    close(jh, th)
    for a, b in zip(jg, tg):
        assert np.isfinite(np.asarray(a)).all()
        close(a, b, scaled=True)


def test_segsum_exp_gradient_where_the_reference_is_nan(monkeypatch):
    """At zamba2-7b's full width (A down to -112) a chunk's |dA| sum passes
    exp's f32 overflow: the reference's `where(tril, exp(diff), 0)` then
    has a NaN gradient (0·inf) for dA. The port applies the mask before the
    exp: the same values, and a finite gradient equal to that of the
    reference's formula with the mask applied first."""
    x, dA, B, C, ct = _ssd_inputs(7, S=64, H=4, dt=2.0)

    def jref(dA):
        y, _ = jax_ssm.ssd_chunked(x, dA, B, C, 64)
        return (y * ct).sum()

    def jsafe_segsum(a):
        q = a.shape[-1]
        cum = jnp.cumsum(a, axis=-1)
        diff = cum[..., :, None] - cum[..., None, :]
        return jnp.exp(jnp.where(jnp.tril(jnp.ones((q, q), bool)), diff,
                                 -jnp.inf))


    def tfn(dA):
        y, _ = ssm.ssd_chunked(_t(x), dA, _t(B), _t(C), 64)
        return (y * _t(ct)).sum()

    ref_val, ref_grad = jax.jit(jax.value_and_grad(lambda d: jref(d)))(dA)
    assert np.isnan(np.asarray(ref_grad)).any()
    got_val, got = tfn(_t(dA)), grad(tfn)(_t(dA))
    close(ref_val, got_val)
    assert bool(torch.isfinite(got).all())
    monkeypatch.setattr(jax_ssm, "_segsum_exp", jsafe_segsum)
    close(jax.jit(jax.grad(lambda d: jref(d)))(dA), got, scaled=True)
    monkeypatch.undo()
    a = np.random.default_rng(0).normal(size=(3, 16)).astype(np.float32)
    close(jax_ssm._segsum_exp(a), ssm._segsum_exp(_t(a)))


# --------------------------------------------------------------------------- #
# train(): five rounds against the reference's loop
# --------------------------------------------------------------------------- #

N, K, MB, S, ROUNDS = 4, 2, 2, 32, 5


def _reference_rounds(jc, pnp, rounds=ROUNDS):
    """The reference's round loop (`repro/launch/train.py:67-87`) with
    array memory, from the given params, for `rounds` rounds."""
    model = jax_build(jc)
    params = jax.tree.map(jnp.asarray, pnp)
    batcher = JTokenBatcher(n_clients=N, vocab=jc.vocab_size, seq_len=S,
                            batch_size=MB, k_steps=K, seed=0)
    part = JBernoulli(np.linspace(0.3, 1.0, N), seed=1)
    algo = JMIFA(memory="array", memory_dtype="float32")
    state = algo.init_state(params, N)
    sched = jax_inv_t(0.25)

    @jax.jit
    def round_fn(state, params, batch, active, eta):
        updates, losses = jax_client_updates(model.loss_fn, params, batch,
                                             eta, K=K)
        return algo.round_step(state, params, updates, losses, active, eta)

    losses = []
    for t in range(rounds):
        active = part.sample(t)
        batch = {k: jnp.asarray(v)
                 for k, v in batcher.sample_round(t).items()}
        state, params, metrics = round_fn(state, params, batch,
                                          jnp.asarray(active),
                                          jnp.float32(sched(t + 1)))
        losses.append(float(metrics["loss"]))
    return losses, params


@pytest.mark.parametrize("arch", ["granite_3_8b", "qwen1_5_110b",
                                  "olmoe_1b_7b", "deepseek_v2_lite_16b"])
def test_train_matches_reference_loop(arch, capsys):
    """granite's, olmoe's and deepseek's rounds vmap every client (the MoE
    routes each client's tokens and MLA decompresses its keys and values
    under `torch.func.vmap`) and step the server
    through `MIFA.round_step`; qwen's (`sequential_clients`) go through
    `make_train_step`'s sequential mode. f32 smoke configs."""
    jc, tc = configs(arch, "float32")
    pnp = params_np(arch, "float32")
    ref_losses, ref_params = _reference_rounds(
        jc.replace(fl_clients=N, fl_local_steps=K), pnp)
    out = train(cfg=tc, rounds=ROUNDS, clients=N, k_steps=K, mb=MB, seq=S,
                device="cpu", params=params_from_jax(pnp, "cpu"),
                log_every=2)
    assert out["cfg"].sequential_clients == (arch == "qwen1_5_110b")
    np.testing.assert_allclose(out["losses"], ref_losses, rtol=2e-4,
                               atol=2e-5)
    assert out["final_loss"] == out["losses"][-1]
    for a, b in zip(jax.tree.leaves(ref_params),
                    tree_leaves(out["params"])):
        close(a, b, scaled=True)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={tc.name} params=")
    assert [ln.split()[1] for ln in lines[1:-1]] == ["0", "2", "4"]
    assert lines[-1].startswith('{"final_loss": ')


def test_train_cli_on_cpu(tmp_path, capsys):
    from repro_torch.checkpoint import load_pytree
    path = str(tmp_path / "params.npz")
    out = main(["--arch", "zamba2-7b", "--smoke", "--rounds", "2",
                "--clients", "3", "--seq", "16", "--memory", "int8",
                "--checkpoint", path, "--device", "cpu"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"saved params -> {path}"
    back = load_pytree(path, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(out["params"])):
        assert torch.equal(a, b)
