"""Params placed over mesh axes (`sharding.params`) in a world of 4 CPU
ranks, against the same runs without a mesh, and the unsplit scan run
against the JAX package's `run_fl`.

No test here opens a process group: a module-scoped fixture runs
`python tests/torch_world.py --world 4 --cases params` once, in a
subprocess of its own under its own timeout (its ranks on one thread each,
meeting on a `FileStore` in the fixture's temporary directory). Each rank
runs every case twice, placed on a mesh and without one, compares its
blocks of every output with its blocks of the unplaced run's, and rank 0
writes every rank's verdict. Granite-3-8b's and qwen1.5-110b's smoke
configs (2 layers), f32, N = 4 clients of `TokenBatcher` streams, 3
rounds in scan chunks of 2:

  (a) qwen's sequential `make_train_step` under its fsdp update
      constraint on 2x2 (`launch.specs.run_placed`);
  (b) granite's vmap step on 2x2, `model` splitting its leaves: the step
      computes on the blocks (split products, `sharding.tensor_parallel`),
      so its sums are taken in another order than the unsplit step's, as
      the reference's meshed program differs from its unmeshed one;
  (c) `run_fl(engine="scan", mesh=2x2, cfg=granite)`, MIFA(array);
  (d) BankedMIFA(DenseBank(mesh=, cfg=)) on 2x2, and the bank alone;
  (e) a K = 4 fleet with `cfg` on 4x1 and on 2x2;
  (f) `checkpoint=` after round 2 on 2x2, resumed on 4 ranks and on 1:
      N = 3 (the data extent does not divide it: only `model` splits, each
      data rank computing every client on its model blocks) and N = 4
      (data splits too); the snapshot has the unsplit run's members, each
      of its dtype and shape;
  (g) MIFA(memory="int8") on 4x1 and on 2x2.

Tolerance: bit-equal where the compute is whole (the bank alone; the 4x1
cases, which split no product) and for a run resumed on 4 ranks against
the uninterrupted split run; where the client axis' sums are all-reduced over data and no product
is split, rtol 2e-5 / atol 1e-6, the bounds of
`tests/test_torch_sharded_scan.py`. Every round on the 2x2 mesh computes
its local update on the rank's blocks (split products,
`sharding.tensor_parallel`), so its sums are taken in another order than
the unsplit run's, as the reference's meshed program differs from its
unmeshed one: (b), (c), (d), the fleet on 2x2 (each trial's local update
on the blocks, `sharding.params.FleetPlacement`), (f)'s snapshots and the
runs resumed on one rank are held at the f32 training bound (rtol 2e-4, atol 2e-5 of each
leaf's largest magnitude), and int8 memory on 2x2 at rtol 2e-2 and atol
2e-2 of each leaf's largest magnitude (a stochastic rounding whose input
moved by f32 rounding may land a quantum away). int8 gathers its rows for
the mean, so it is bit-equal split over data alone (4x1). Integers
(rounds, n_active, a snapshot's integer members) are exact, and each
case's specs split a leaf over the axes it is about.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import MIFA as JMIFA
from repro.core import BernoulliParticipation as JBernoulli
from repro.core import run_fl as jax_run_fl
from repro.data import TokenBatcher as JTokenBatcher
from repro.models import build_model as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_to_numpy
from repro_torch.core import MIFA, BernoulliParticipation, run_fl
from repro_torch.data import TokenBatcher
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves

HELPER = Path(__file__).resolve().parent / "torch_world.py"
TIMEOUT = 300
F32 = dict(compute_dtype="float32", param_dtype="float32")
N, T, CHUNK, S = 4, 3, 2, 16
DM = {"data", "model"}
# case -> (bit-equal or within the bounds, the axes its specs split)
CASES = {
    "a_sequential_update_spec": ("exact", DM),
    "b_vmap_step": ("bounds", {"model"}),
    "c_scan_mifa_array": ("bounds", DM),
    "d_dense_bank": ("bounds", DM),
    "d_bank_round_trip": ("exact", DM),
    "e_fleet_4x1": ("exact", {"data"}),
    "e_fleet_2x2": ("bounds", DM),
    "f_checkpoint_model_snapshot": ("bounds", {"model"}),
    "f_checkpoint_model_resumed_on_4": ("exact", {"model"}),
    "f_checkpoint_model_resumed_on_1": ("bounds", set()),
    "f_checkpoint_data_snapshot": ("bounds", DM),
    "f_checkpoint_data_resumed_on_4": ("exact", DM),
    "f_checkpoint_data_resumed_on_1": ("bounds", set()),
    "g_int8_4x1": ("exact", {"data"}),
    "g_int8_2x2": ("bounds", DM),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("world_params")
    proc = subprocess.Popen([sys.executable, str(HELPER), "--world", "4",
                             "--cases", "params", "--out", str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the world of 4 ranks ran past {TIMEOUT} s")
    assert proc.returncode == 0, log[-4000:]
    return json.loads((out / "results.json").read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_the_blocks_of_the_unsplit_run(world, case):
    kind, axes = CASES[case]
    ranks = world[case]
    assert len(ranks) == 4
    for r in ranks:
        assert set(r["axes"]) == axes, r
        assert r["ints"], r
        if kind == "exact":
            assert r["eq"], r
        else:
            assert r["err"] <= 1.0, r


def test_snapshots_and_step_cases(world):
    """The N = 3 and N = 4 snapshots have the unsplit run's members, each
    of its dtype and shape (their values in the cases above: the split
    products round in another order); (a) runs the plan's two sequential
    clients, (b) the data extent's two vmap clients."""
    assert world["f_checkpoint_model_keys_equal"]
    assert world["f_checkpoint_model_layout_equal"]
    assert world["f_checkpoint_data_keys_equal"]
    assert world["f_checkpoint_data_layout_equal"]
    assert world["a_sequential_update_spec_n_clients"] == 2
    assert world["b_vmap_step_n_clients"] == 2


def test_unsplit_scan_run_matches_the_reference():
    """Case (c) without a mesh: the port's `run_fl(engine="scan")` against
    the reference's from the same params, batches and masks, at the f32
    training bounds (rtol 2e-4, atol 2e-5 scaled by each leaf's largest
    magnitude)."""
    cfg = get_smoke_config("granite_3_8b").replace(**F32)
    jcfg = jax_smoke("granite_3_8b").replace(**F32)
    params = build_model(cfg).init(0, device="cpu")
    pnp = params_to_numpy(params)
    kw = dict(n_clients=N, vocab=cfg.vocab_size, seq_len=S, batch_size=1,
              k_steps=1, stream_len=4096, seed=0)
    probs = np.linspace(0.4, 1.0, N)
    got, ghist = run_fl(model=build_model(cfg), algo=MIFA(memory="array"),
                        batcher=TokenBatcher(**kw),
                        participation=BernoulliParticipation(probs, seed=1),
                        schedule=lambda t: 0.05, n_rounds=T, params=params,
                        engine="scan", scan_chunk=CHUNK, device="cpu")
    want, whist = jax_run_fl(
        model=jax_build(jcfg), algo=JMIFA(memory="array"),
        batcher=JTokenBatcher(**kw),
        participation=JBernoulli(probs, seed=1), schedule=lambda t: 0.05,
        n_rounds=T, params=jax.tree.map(jnp.asarray, pnp), engine="scan",
        scan_chunk=CHUNK)
    np.testing.assert_array_equal(ghist.n_active, whist.n_active)
    np.testing.assert_allclose(ghist.train_loss, whist.train_loss,
                               rtol=2e-4, atol=2e-5)
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(
            b.numpy(), a, rtol=2e-4,
            atol=2e-5 * max(float(np.abs(a).max()), 1e-30))
    assert torch.isfinite(torch.tensor(ghist.train_loss)).all()
