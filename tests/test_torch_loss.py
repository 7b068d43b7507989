"""Parity of the port's training loss with the JAX package's, on the CPU:
`Model.loss_fn` and its gradients on the smoke configs of granite-3-8b,
zamba2-7b, mamba2-1.3b and qwen1.5-110b, in f32 and in bf16, with the
chunked cross-entropy (`ce_chunk`) on two of them. The same params (the
port's init, as numpy) and tokens go to both sides; tolerances as
`test_torch_train.py` states them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.models import build_model as jax_build
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves
from test_torch_train import close, configs, params_np

torch.set_num_threads(1)

ARCHS = ["granite_3_8b", "zamba2_7b", "mamba2_1_3b", "qwen1_5_110b"]


@pytest.mark.parametrize("arch,dtype,ce_chunk", [
    (a, d, 0) for a in ARCHS for d in ("float32", "bfloat16")]
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
    assert set(taux) == {"loss", "ce", "aux"} and float(taux["aux"]) == 0.0
    close(jl, tl, dtype)
    close(jaux["ce"], taux["ce"], dtype)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert a.shape == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        close(np.asarray(a, np.float32), b, dtype, scaled=True)
