"""Parity of the port's training loss with the JAX package's, on the CPU:
`Model.loss_fn` and its gradients on the smoke configs of granite-3-8b,
zamba2-7b, mamba2-1.3b, qwen1.5-110b, gemma3-4b (window 16 over 32
tokens), olmoe-1b-7b (MoE: the load-balance loss and the router's
gradient) and deepseek-v2-lite-16b (MLA's decompressed attention through
`blockwise_attention`, a dense layer then MoE; f32 only, see
`BF16_ROUTING_TIE`), in f32 and in bf16, with the chunked cross-entropy
(`ce_chunk`) on two of them, and two rounds of gemma3-4b's `train()` against the
reference's loop. The same params (the port's init, as numpy) and tokens
go to both sides; tolerances as `test_torch_train.py` states them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.models import build_model as jax_build
from repro_torch.convert import params_from_jax
from repro_torch.launch.train import train
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves
from test_torch_train import (MB, K, N, S, _reference_rounds, close, configs,
                              params_np)

torch.set_num_threads(1)

ARCHS = ["granite_3_8b", "zamba2_7b", "mamba2_1_3b", "qwen1_5_110b",
         "gemma3_4b", "olmoe_1b_7b", "deepseek_v2_lite_16b"]
# deepseek's bf16 case routes token 0 of these tokens to other experts on
# the two sides: its router input lies one bf16 step apart in 89 of 128
# entries (the packages round elementwise chains at other places), and the
# reference's second and third router logits are 1.1e-4 apart, so the
# flip moves that token's whole gradient. Its f32 case holds every leaf.
BF16_ROUTING_TIE = {"deepseek_v2_lite_16b"}


@pytest.mark.parametrize("arch,dtype,ce_chunk", [
    (a, d, 0) for a in ARCHS for d in ("float32", "bfloat16")
    if not (d == "bfloat16" and a in BF16_ROUTING_TIE)]
    + [("granite_3_8b", "float32", 8), ("zamba2_7b", "float32", 16)])
def test_loss_fn_and_grads_match_reference(arch, dtype, ce_chunk):
    jc, tc = configs(arch, dtype, ce_chunk=ce_chunk)
    jm, tm = jax_build(jc), build_model(tc)
    pnp = params_np(arch, dtype)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 32)
                                             ).astype(np.int32)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, pnp), {"tokens": jnp.asarray(toks)})
    tg, (tl, taux) = grad_and_value(tm.loss_fn, has_aux=True)(
        params_from_jax(pnp, "cpu"), {"tokens": torch.from_numpy(toks)})
    assert set(taux) == {"loss", "ce", "aux"}
    assert (float(taux["aux"]) > 0) == tc.is_moe
    close(jl, tl, dtype)
    close(jaux["ce"], taux["ce"], dtype)
    close(jaux["aux"], taux["aux"], dtype)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert a.shape == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        close(np.asarray(a, np.float32), b, dtype, scaled=True)


def test_gemma3_train_matches_reference_loop():
    """Two rounds of `launch.train.train` on gemma3-4b's f32 smoke config
    (every client vmapped, the windowed training forward) against the
    reference's round loop: losses and params at the f32 bounds."""
    jc, tc = configs("gemma3_4b", "float32")
    pnp = params_np("gemma3_4b", "float32")
    ref_losses, ref_params = _reference_rounds(
        jc.replace(fl_clients=N, fl_local_steps=K), pnp, rounds=2)
    out = train(cfg=tc, rounds=2, clients=N, k_steps=K, mb=MB, seq=S,
                device="cpu", params=params_from_jax(pnp, "cpu"),
                log_every=1)
    np.testing.assert_allclose(out["losses"], ref_losses, rtol=2e-4,
                               atol=2e-5)
    for a, b in zip(jax.tree.leaves(ref_params),
                    tree_leaves(out["params"])):
        close(a, b, scaled=True)
