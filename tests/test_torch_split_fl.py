"""Split matrix products in the federated round
(`run_fl(engine="scan", mesh=, cfg=)`, `sharding.params.StepPlacement.split`):
each client's local update on this rank's param blocks, the updates moved
straight into the server step's blocks, in worlds of CPU ranks, against
the port's unsplit run and the JAX package's unmeshed run.

No test here opens a process group: a module-scoped fixture runs
`python tests/torch_world.py --world 2|4 --cases fl` (both worlds at once,
each in a subprocess of its own under its own timeout) and, while they
run, the JAX package's `RoundRunner` and `ScanDriver` (what its `run_fl`
drives) on the same params, batches and masks. Every case takes the
port's params of a smoke config (f32, seed 0), N = 4 clients of
`TokenBatcher` streams (K = 2 local steps of 2 x 16 tokens), Bernoulli
availability (a round with an inactive client among them), 3 rounds in
scan chunks of 2:

  (a) granite-3-8b, MIFA(array), on 1x2; again at vocab 511 (the head
      whole, as granite's vocab of 49155 on the card);
  (b) the same on 2x2 (clients over data, products over model);
  (c) BankedMIFA(DenseBank(mesh=, cfg=)) on 1x2 and on 2x2;
  (d) BankedMIFA(PagedDeviceBank), held whole on every rank, on 1x2;
  (e) MIFA(memory="int8") on 1x2;
  (f) `checkpoint=` after round 2 on 1x2, resumed on 1x2 (bit-equal to
      run (a)) and on one rank;
  (g) gemma3-4b's smoke config on 1x2 (a local and a global layer, the
      vocab split across the head);
  (h) FedAR, a dense baseline with `clients=` whose per-client memory is
      placed as the update array, on 1x2;
  (i) olmoe-1b-7b's experts over `model` (two of E = 4 a rank) with
      MIFA(array) and with BankedMIFA(DenseBank(mesh=, cfg=)) on 1x2: the
      expert leaves' updates move from the params' E blocks into G's
      layout (whole or split over the layer axis, as the reference
      places them), and each rank's training forward routes as the
      unsplit forward does ((E, C) tables and drops bit-equal, the same
      on every rank).

Each rank holds its blocks of the params, and the whole state (G, the bank
rows and G_sum, FedAR's memory), against the port's unsplit run at the f32
training bound (rtol 2e-4, atol 2e-5 of each leaf's largest magnitude;
int8 memory at rtol 2e-2, atol 2e-2 of it: a stochastic rounding whose
input moved by f32 rounding may land a quantum away), with rounds and
n_active exact, no params gathered whole inside a round, and bytes moved
by every kind of collective, the relayout into G's blocks included (G's
param dims split elsewhere than the params', `src/repro/sharding/
rules.py:196-199`). Rank 0's split run gathered whole is held to the JAX
package at the same bound; int8 memory is not (the reference's rounding
bits are not reproduced, ROADMAP ground rules). In-process, with no
process group: a mesh of model extent 1 gives today's run bit for bit,
the eager-round rule of the scan engine, and what the split leaves for
later raises on CUDA tensors naming its ROADMAP entry.
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
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.bank import BankedMIFA as JBankedMIFA
from repro.bank import DenseBank as JDenseBank
from repro.configs import get_smoke_config as jax_smoke
from repro.core import MIFA as JMIFA
from repro.core import BernoulliParticipation as JBernoulli
from repro.core import FedAR as JFedAR
from repro.core.runner import RoundRunner as JRoundRunner
from repro.core.scan_engine import ScanDriver as JScanDriver
from repro.data import TokenBatcher as JTokenBatcher
from repro.models import build_model as jax_build
from repro_torch.bank import BankedMIFA, DenseBank
from repro_torch.convert import params_to_numpy
from repro_torch.core import MIFA, BernoulliParticipation, run_fl
from repro_torch.core.scan_engine import runs_eager
from repro_torch.data import TokenBatcher
from repro_torch.models import build_model
from repro_torch.sharding import rules
from repro_torch.sharding.params import (FleetPlacement, StepPlacement,
                                         block_shape, take_tree)
from repro_torch.tree import tree_leaves, tree_map
from torch_world import (FCHUNK, FK, FL_CASES, FL_CHANGES, FMB, FN, FS, FT,
                         fl_cfg, flat_tree, smoke)

torch.set_num_threads(1)

HELPER = Path(__file__).resolve().parent / "torch_world.py"
TIMEOUT = 240
RTOL, ATOL = 2e-4, 2e-5
# the JAX package's run each case is held to (int8 memory: none)
REFS = {"mifa_array": "mifa_array", "banked_dense": "banked_dense",
        "banked_paged": "banked_dense", "fedar": "fedar"}


def _params(arch: str):
    return build_model(fl_cfg(arch)).init(0, device="cpu")


def _jax_run(arch: str, name: str) -> dict:
    """The JAX package's unmeshed scan run of a case from the port's
    params: its params, state view (as `torch_world.fl_state_view`) and
    history, flattened to numpy."""
    base, change = FL_CHANGES.get(arch, (arch, {}))
    jc = jax_smoke(base).replace(compute_dtype="float32",
                                 param_dtype="float32", **change)
    algo = {"mifa_array": lambda: JMIFA(memory="array"),
            "banked_dense": lambda: JBankedMIFA(JDenseBank()),
            "fedar": JFedAR}[name]()
    runner = JRoundRunner(
        model=jax_build(jc), algo=algo,
        batcher=JTokenBatcher(n_clients=FN, vocab=jc.vocab_size, seq_len=FS,
                              batch_size=FMB, k_steps=FK, stream_len=4096,
                              seed=0),
        schedule=lambda t: 0.05 / (1 + t), cohort_capacity=FN,
        params=jax.tree.map(jnp.asarray, params_to_numpy(_params(arch))))
    JScanDriver(runner, scan_chunk=FCHUNK).run(
        FT, participation=JBernoulli(np.linspace(0.4, 1.0, FN), seed=1))
    st = runner.state
    view = ({"G": st["G"]} if name == "mifa_array" else
            {"U": st["U"]} if name == "fedar" else
            {"rows": jax.tree.map(lambda r: r[:FN], st["bank"]["rows"]),
             "g_sum": st["bank"]["g_sum"]})
    out = flat_tree(jax.tree.map(np.asarray, {"params": runner.params,
                                              **view}))
    out["loss"] = np.asarray(runner.hist.train_loss, np.float64)
    out["n_active"] = np.asarray(runner.hist.n_active, np.float64)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("world_fl")
    procs = {}
    for w in (2, 4):
        d = out / f"w{w}"
        d.mkdir()
        procs[w] = subprocess.Popen(
            [sys.executable, str(HELPER), "--world", str(w), "--cases", "fl",
             "--out", str(d)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    # the reference's runs while the worlds run
    ref = {(arch, REFS[name]): _jax_run(arch, REFS[name])
           for arch, name, _ in FL_CASES.values() if name in REFS}
    info, arrays = {}, {}
    for w, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
            pytest.fail(f"the world of {w} ranks ran past {TIMEOUT} s")
        assert proc.returncode == 0, log[-4000:]
        info.update(json.loads((out / f"w{w}" / "results.json").read_text()))
        with np.load(out / f"w{w}" / "results.npz") as z:
            arrays.update({k: z[k] for k in z.files})
    return info, arrays, ref


@pytest.mark.parametrize("case", list(FL_CASES))
def test_each_rank_holds_the_blocks_of_the_unsplit_run(worlds, case):
    """Each rank's blocks of the params and the whole state within the
    case's bound of the unsplit run, the integers exact, the local update
    on the blocks: no params gathered whole but by a restore (the resumed
    run), bytes in every kind of collective, no round captured or run
    eagerly on the CPU."""
    info, _, _ = worlds
    ranks = info[case]
    _, _, shape = FL_CASES[case]
    assert len(ranks) == shape[0] * shape[1]
    for r in ranks:
        assert r["err"] <= 1.0, r
        assert r["ints"], r
        assert r["wholes"] == (case == "f_resumed_on_1x2"), r
        assert not r["eager"] and r["replays"] == 0 \
            and r["eager_rounds"] == 0, r
        if case == "f_resumed_on_1":
            continue
        assert r["axes"] == ["model"] and r["g_differs"], r
        assert all(v > 0 for v in r["moved"].values()), r
        if case.startswith("i_olmoe"):
            route = r["routing"]
            assert route["tables"] and route["same"], r
            assert route["calls"] == fl_cfg("olmoe_1b_7b").n_layers, r
            assert set(map(tuple, r["experts"].values())) == {(2, True)}, r
        else:
            assert "routing" not in r, r
    if case == "f_resumed_on_1x2":
        assert all(r["exact"] for r in ranks), ranks


@pytest.mark.parametrize("case", [c for c, (_, name, _) in FL_CASES.items()
                                  if name in REFS])
def test_split_round_matches_the_reference(worlds, case):
    """The split run gathered whole against the JAX package's unmeshed run
    on the same params, batches and masks: params, G (FedAR's memory, the
    bank's rows and G_sum) and losses at the f32 training bound, n_active
    exact and with an inactive client in some round."""
    _, arrays, ref = worlds
    arch, name, _ = FL_CASES[case]
    want = ref[(arch, REFS[name])]
    got = {k[len(case) + 1:]: v for k, v in arrays.items()
           if k.startswith(case + "/")}
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["n_active"], want["n_active"])
    assert min(want["n_active"]) < FN
    for k, a in want.items():
        np.testing.assert_allclose(
            got[k], a, rtol=RTOL,
            atol=ATOL * max(float(np.abs(a).max()), 1e-30), err_msg=k)


class _FakeMesh:
    """A DeviceMesh's surface without a process group: its shape, names,
    this rank's coordinate and a group of None."""

    def __init__(self, data: int, model: int, device_type: str = "cuda"):
        self.mesh_dim_names = ("data", "model")
        self.shape = (data, model)
        self.device_type = device_type

    def get_coordinate(self):
        return [0, 0]

    def get_group(self, axis):
        return None


def _run(algo, mesh=None, cfg=None):
    c = smoke("granite_3_8b")
    return run_fl(model=build_model(c), algo=algo,
                  batcher=TokenBatcher(n_clients=FN, vocab=c.vocab_size,
                                       seq_len=FS, batch_size=FMB,
                                       k_steps=FK, stream_len=4096, seed=0),
                  participation=BernoulliParticipation(
                      np.linspace(0.4, 1.0, FN), seed=1),
                  schedule=lambda t: 0.05 / (1 + t), n_rounds=FT,
                  params=_params("granite_3_8b"), cohort_capacity=FN,
                  engine="scan", scan_chunk=FCHUNK, device="cpu", mesh=mesh,
                  cfg=cfg)


@pytest.mark.parametrize("bank", [False, True])
def test_model_extent_one_is_today_s_run(bank):
    """A mesh whose model axis has extent 1 places nothing and splits
    nothing (`StepPlacement.split` None): `run_fl(mesh=1x1, cfg=)` is the
    run without a mesh, bit for bit."""
    cfg = smoke("granite_3_8b")
    mesh = _FakeMesh(1, 1, "cpu")
    assert StepPlacement(_params("granite_3_8b"), cfg, mesh, FN).split \
        is None

    def algo(m=None):
        return (BankedMIFA(DenseBank(mesh=m, cfg=None if m is None else cfg,
                                     device="cpu")) if bank
                else MIFA(memory="array"))
    want_p, want_h = _run(algo())
    got_p, got_h = _run(algo(mesh), mesh, cfg)
    for a, b in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert torch.equal(a, b)
    assert got_h.train_loss == want_h.train_loss
    assert got_h.n_active == want_h.n_active


def _fake_cuda(cfg):
    """The config's params as CUDA tensors of the FakeTensorMode the
    caller is in."""
    tree = build_model(cfg).init(0, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="cuda"), tree)


def test_eager_rule():
    """The scan engine runs every round uncaptured on the card where the
    round computes on CUDA blocks of a split (a model axis of extent > 1
    on a DeviceMesh of CUDA ranks), and captures it everywhere else: a
    split on CPU ranks, and no placement (model extent 1)."""
    cfg = smoke("granite_3_8b")
    with FakeTensorMode():
        on_card = StepPlacement(_fake_cuda(cfg), cfg, _FakeMesh(1, 2), FN)
    assert on_card.split is not None
    assert runs_eager(torch.device("cuda"), on_card)
    on_cpu = StepPlacement(_params("granite_3_8b"), cfg,
                           _FakeMesh(1, 2, "cpu"), FN)
    assert on_cpu.split is not None
    assert not runs_eager(torch.device("cpu"), on_cpu)
    assert not runs_eager(torch.device("cuda"), None)
    # a split's blocks on the card: the G layout of the vmap mode, also
    # for a config that trains sequentially in the launch driver
    qwen = smoke("qwen1_5_110b")
    assert qwen.sequential_clients
    with FakeTensorMode():
        pl = StepPlacement(_fake_cuda(qwen), qwen, _FakeMesh(1, 2), FN)
    assert pl.split.state_specs == rules.client_state_specs(
        _params("qwen1_5_110b"), qwen, _FakeMesh(1, 2), n_clients=FN)


@pytest.mark.parametrize("arch,change,mesh,entry", [
    ("olmoe_1b_7b", {"fsdp": True}, (2, 2), "12g"),
    ("deepseek_v2_lite_16b", {}, (1, 2), "12d"),
    ("zamba2_7b", {}, (1, 2), "12e"),
    ("hubert_xlarge", {}, (1, 2), "12f"),
    ("granite_3_8b", {"pad_q_heads": 16, "pad_kv_heads": 16}, (1, 2),
     "12f"),
    ("granite_3_8b", {"fsdp": True}, (2, 2), "12g"),
    ("granite_3_8b", {}, (2, 2), "12g"),
])
def test_cuda_rounds_the_split_leaves_for_later_raise(arch, change, mesh,
                                                      entry):
    """On fake CUDA tensors and a fake mesh (no card, no process group):
    the federated round of a config or mesh the split does not take raises
    NotImplementedError naming its ROADMAP entry when its placement is
    built, before any params are gathered whole; on CPU ranks the same
    config takes the gathering round, and granite's 2x2 mesh the split."""
    cfg = smoke(arch, **change)
    with FakeTensorMode():
        params = _fake_cuda(cfg)
        with pytest.raises(NotImplementedError, match=f"entry {entry}"):
            StepPlacement(params, cfg, _FakeMesh(*mesh), FN)
    cpu = StepPlacement(build_model(cfg).init(0, device="cpu"), cfg,
                        _FakeMesh(*mesh, "cpu"), FN)
    assert (cpu.split is None) == bool(change or arch != "granite_3_8b")


def test_fleets_on_cuda_blocks_raise_naming_12i():
    """A fleet's trial params split over `model` on CUDA tensors, which
    raised naming ROADMAP entry 12i until fleets computed on blocks, now
    build the fleet's split (`FleetPlacement`: one trial's blocks, the
    whole state), whose column blocks are cut on the card; a bare `take`
    of the same blocks, outside a split, names the entries that remain
    (12d-12f)."""
    cfg = smoke("granite_3_8b")
    mesh = _FakeMesh(1, 2)
    with FakeTensorMode():
        stacked = tree_map(lambda t: t.new_empty((2,) + tuple(t.shape)),
                           _fake_cuda(cfg))
        placement = FleetPlacement(stacked, cfg, mesh, FN)
        assert placement.split is not None
        cols = tree_map(lambda s: rules.P(None, *s[1:]),
                        rules.fleet_trial_specs(stacked, cfg, mesh))
        assert placement.param_specs == cols
        # a FakeTensor on cuda cannot be sliced on a CPU build: the block's
        # shape as `take` cuts it under the split
        wq = stacked["segments"]["0"]["attn"]["wq"]
        assert block_shape(
            tuple(wq.shape), cols["segments"]["0"]["attn"]["wq"], mesh,
            wq.device, split=placement.split is not None)[-1] \
            == wq.shape[-1] // 2
        with pytest.raises(NotImplementedError, match="entries 12d-12f"):
            take_tree(stacked, cols, mesh, "the trial params")
