"""Split matrix products in fleets (`run_fleet(mesh=, cfg=)`,
`sharding.params.FleetPlacement`): every trial's local update on this
rank's param blocks under vmap over trials, in worlds of CPU ranks,
against the port's unsplit fleet and, trial by trial, the JAX package's
sequential run of that trial.

No test here opens a process group: a module-scoped fixture runs
`python tests/torch_world.py --world 2|4 --cases fleet` (both worlds at
once, each in a subprocess of its own under its own timeout) and, while
they run, the JAX package's `RoundRunner` and `ScanDriver` (what its
`run_fl` drives) for each trial of each case on the same params, batches
and masks. Every case is a fleet of two trials (seeds 0 and 1: each
trial's params from its seed, Bernoulli availability of seed 100 + s, a
round with an inactive client among them) of a smoke config in f32,
N = 4 clients of `TokenBatcher` streams (K = 2 local steps of 2 x 16
tokens), 3 rounds in scan chunks of 2:

  (a) granite-3-8b, MIFA(array), on 1x2, on the scan and the loop engine
      (bit-equal to each other), and again at vocab 511 (the head whole,
      as granite's vocab of 49155 on the card);
  (b) the same on 2x2 (trials over data, products over model);
  (c) BankedMIFA(DenseBank) and (d) BankedMIFA(PagedDeviceBank) on 1x2,
      their rows whole on every rank;
  (e) a Gilbert-Elliott scenario fleet on 1x2 (the masks drawn in the
      round);
  (f) gemma3-4b's smoke config on 1x2 (a local and a global layer, the
      vocab split across the head);
  (g) granite with padded heads on 1x2, which the split leaves for later
      (ROADMAP entry 12f): its rounds gather the blocks whole, bit-equal
      to the unsplit fleet;
  (h) olmoe-1b-7b's experts over `model` (two of E = 4 a rank) on 1x2,
      each rank's training forward routing as the unsplit forward does
      ((E, C) tables and drops bit-equal, the same on every rank).

Every rank returns the whole fleet (all K trials), and holds the whole
state (G, the bank's rows and G_sum): both are held to the port's unsplit
fleet at the f32 training bound (rtol 2e-4, atol 2e-5 of each leaf's
largest magnitude), with rounds and n_active exact, no param gathered
whole or moved inside a local update, and bytes moved by every kind of
collective. Rank 0's fleet is held trial by trial to the JAX package's
sequential run at the same bound (the reference's own fleet is not
bit-exact for dense algorithms, ROADMAP Queue 3). In-process, with no
process group: the split collectives under vmap over vmap over `grad`
against the trial loop unrolled, bit for bit; the eager-round rule; and
what the split leaves for later raising on CUDA tensors naming its
ROADMAP entry.
"""
import json
import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.func import grad, vmap

from repro.bank import BankedMIFA as JBankedMIFA
from repro.bank import DenseBank as JDenseBank
from repro.configs import get_smoke_config as jax_smoke
from repro.core import MIFA as JMIFA
from repro.core import BernoulliParticipation as JBernoulli
from repro.core.runner import RoundRunner as JRoundRunner
from repro.core.scan_engine import ScanDriver as JScanDriver
from repro.data import TokenBatcher as JTokenBatcher
from repro.models import build_model as jax_build
from repro.scenarios import GilbertElliott as JGilbertElliott
from repro_torch.convert import params_to_numpy
from repro_torch.core.scan_engine import runs_eager
from repro_torch.models import build_model
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.params import FleetPlacement
from repro_torch.tree import tree_map
from torch_world import (FCHUNK, FK, FL_CHANGES, FLEET_CASES, FLEET_SEEDS,
                         FMB, FN, FS, FT, fl_cfg, flat_tree, smoke)

torch.set_num_threads(1)

HELPER = Path(__file__).resolve().parent / "torch_world.py"
TIMEOUT = 240
RTOL, ATOL = 2e-4, 2e-5
# the JAX package's algorithm each case's trials are held to
REFS = {"mifa_array": "mifa_array", "banked_dense": "banked_dense",
        "banked_paged": "banked_dense"}


def _jax_trial(arch: str, name: str, scenario: bool, seed: int) -> dict:
    """The JAX package's unmeshed scan run of one trial from the port's
    params of its seed: params, state view (as `torch_world.
    fleet_state_view` of one trial) and history, flattened to numpy."""
    base, change = FL_CHANGES.get(arch, (arch, {}))
    jc = jax_smoke(base).replace(compute_dtype="float32",
                                 param_dtype="float32", **change)
    algo = (JMIFA(memory="array") if name == "mifa_array"
            else JBankedMIFA(JDenseBank()))
    params = build_model(fl_cfg(arch)).init(seed, device="cpu")
    scen = (JGilbertElliott.from_rate_and_burst(0.5, 2.0, n=FN,
                                                seed=100 + seed)
            if scenario else None)
    runner = JRoundRunner(
        model=jax_build(jc), algo=algo,
        batcher=JTokenBatcher(n_clients=FN, vocab=jc.vocab_size, seq_len=FS,
                              batch_size=FMB, k_steps=FK, stream_len=4096,
                              seed=0),
        schedule=lambda t: 0.05 / (1 + t), cohort_capacity=FN,
        params=jax.tree.map(jnp.asarray, params_to_numpy(params)),
        scenario=scen)
    JScanDriver(runner, scan_chunk=FCHUNK).run(
        FT, participation=None if scenario else JBernoulli(
            np.linspace(0.4, 1.0, FN), seed=100 + seed))
    st = runner.state
    view = ({"G": st["G"]} if name == "mifa_array" else
            {"rows": jax.tree.map(lambda r: r[:FN], st["bank"]["rows"]),
             "g_sum": st["bank"]["g_sum"]})
    out = flat_tree(jax.tree.map(np.asarray, {"params": runner.params,
                                              **view}))
    out["loss"] = np.asarray(runner.hist.train_loss, np.float64)
    out["n_active"] = np.asarray(runner.hist.n_active, np.float64)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("world_fleet")
    procs = {}
    for w in (2, 4):
        d = out / f"w{w}"
        d.mkdir()
        procs[w] = subprocess.Popen(
            [sys.executable, str(HELPER), "--world", str(w), "--cases",
             "fleet", "--out", str(d)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    # the reference's runs while the worlds run, a few at once (XLA
    # compiles and runs without the GIL)
    keys = list(dict.fromkeys((arch, REFS[name], scenario, s)
                              for arch, name, _, _, scenario
                              in FLEET_CASES.values() for s in FLEET_SEEDS))
    with ThreadPoolExecutor(max_workers=3) as pool:
        runs = dict(zip(keys, pool.map(lambda k: _jax_trial(*k), keys)))
    ref = {}
    for (arch, name, scenario, _), run in runs.items():
        ref.setdefault((arch, name, scenario), []).append(run)
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


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_each_rank_returns_the_unsplit_fleet(worlds, case):
    """Every rank's fleet (all K trials, whole) and whole state within the
    f32 training bound of the unsplit fleet, the integers exact; the local
    updates on the blocks: no param gathered whole or moved inside one
    (the count's wrappers did run: the moves of the round), bytes in every
    kind of collective, the trial axis over data on 2x2, no round captured
    or run eagerly on the CPU; the loop engine's split fleet bit-equal to
    the scan engine's; a config the split leaves for later gathers its
    blocks for every round, bit-equal to the unsplit fleet."""
    info, _, _ = worlds
    ranks = info[case]
    _, _, shape, engine, _ = FLEET_CASES[case]
    gathered = case.startswith("g_gathered")
    assert len(ranks) == shape[0] * shape[1]
    for r in ranks:
        assert r["err"] <= 1.0, r
        assert r["ints"], r
        assert r["split"] != gathered and r["in_local"] == 0, r
        assert r["calls"] > 0, r
        assert r["axes"] == ["model"], r
        assert r["trials"] == (["data", "model"] if shape[0] > 1
                               else ["model"]), r
        if engine == "scan":
            assert r["eager"] is False and r["replays"] == 0 \
                and r["eager_rounds"] == 0, r
        if gathered or engine == "loop":
            assert r["exact"] is True, r
        if not gathered:
            assert all(v > 0 for v in r["moved"].values()), r
        if case.startswith("h_olmoe"):
            route = r["routing"]
            assert route["tables"] and route["same"], r
            assert route["calls"] == fl_cfg("olmoe_1b_7b").n_layers, r
            assert set(map(tuple, r["experts"].values())) == {(2, True)}, r
    assert ranks[0]["head_split"] == (
        None if gathered else case != "a_mifa_vocab511_1x2")


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_each_trial_matches_the_reference(worlds, case):
    """Each trial of the split fleet against the JAX package's sequential
    run of that trial on the same params, batches and masks: params, G
    (the bank's rows and G_sum) and losses at the f32 training bound,
    n_active exact and with an inactive client in some round."""
    _, arrays, ref = worlds
    arch, name, _, _, scenario = FLEET_CASES[case]
    got = {k[len(case) + 1:]: v for k, v in arrays.items()
           if k.startswith(case + "/")}
    assert min(got["n_active"].ravel()) < FN
    for k, want in enumerate(ref[(arch, REFS[name], scenario)]):
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["n_active"][k], want["n_active"])
        for key, a in want.items():
            np.testing.assert_allclose(
                got[key][k], a, rtol=RTOL,
                atol=ATOL * max(float(np.abs(a).max()), 1e-30),
                err_msg=f"trial {k} {key}")


class _StubAxis:
    """A model axis of two ranks without a process group: `sum` doubles,
    `gather` repeats the block; each asserts it was handed a plain tensor
    (one that vmap does not batch), as a collective needs storage."""

    size, rank = 2, 1

    def __init__(self):
        self.calls = 0

    def _plain(self, x):
        assert not torch._C._functorch.is_batchedtensor(x), \
            "a collective handed a tensor still batched by vmap"
        self.calls += 1

    def sum(self, x):
        self._plain(x)
        return (x.float() * 2).to(x.dtype)

    def gather(self, x, dim):
        self._plain(x)
        return torch.cat([x, x], dim=dim)


def _loss(w, x, axis):
    """A split loss through all three collectives: a gathered input, a
    replicated value into partitioned compute, partial sums out."""
    h = tp.gather_model(x, -1, axis)                  # (S, 2·d)
    h = tp.to_model(torch.tanh(h), axis) @ w          # (S, d)
    return tp.from_model(h, axis).square().sum()


def test_collectives_pass_vmap_over_vmap_over_grad():
    """`to_model`, `from_model` and `gather_model` under vmap over trials
    of vmap over clients of `grad` (a fleet's local update): every
    collective is handed a plain tensor, once for all trials and clients,
    and the gradients and values are bit-equal to the same calls with the
    trial loop unrolled (one vmap level, as PRs' single runs take it)."""
    gen = torch.Generator().manual_seed(0)
    K, N, S, d = 3, 2, 4, 5
    w = torch.randn((K, 2 * d, d), generator=gen)
    x = torch.randn((K, N, S, d), generator=gen)
    axis = _StubAxis()

    def per_client(wk, xc):
        return grad(_loss)(wk, xc, axis), _loss(wk, xc, axis)

    def per_trial(wk, xk):
        return vmap(per_client, in_dims=(None, 0))(wk, xk)

    got = vmap(per_trial)(w, x)
    nested_calls = axis.calls
    want = [per_trial(w[k], x[k]) for k in range(K)]
    assert nested_calls * K == axis.calls - nested_calls > 0
    for i in range(2):
        assert torch.equal(got[i], torch.stack([c[i] for c in want]))


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


def _stacked(cfg, device):
    """Two trials' params of `cfg` stacked, on `device` (fake CUDA tensors
    under the caller's FakeTensorMode)."""
    tree = build_model(cfg).init(0, device="cpu")
    return tree_map(lambda t: torch.empty((2,) + tuple(t.shape),
                                          dtype=t.dtype, device=device), tree)


def test_fleet_eager_rule_and_layouts():
    """A fleet on CUDA blocks of a model axis of extent > 1 holds a split
    of one trial's params (`fleet_trial_specs` without the trial axis) and
    the whole state's layout, and its rounds run uncaptured on the card;
    on CPU ranks it holds the same split and captures nothing; at model
    extent 1 nothing is placed."""
    cfg = smoke("granite_3_8b")
    with FakeTensorMode():
        on_card = FleetPlacement(_stacked(cfg, "cuda"), cfg, _FakeMesh(1, 2),
                                 FN)
    assert on_card.split is not None and on_card.placed
    assert runs_eager(torch.device("cuda"), on_card)
    on_cpu = FleetPlacement(_stacked(cfg, "cpu"), cfg,
                            _FakeMesh(1, 2, "cpu"), FN)
    assert not runs_eager(torch.device("cpu"), on_cpu)
    wq = on_cpu.split.param_specs["segments"]["0"]["attn"]["wq"]
    assert on_cpu.param_specs["segments"]["0"]["attn"]["wq"] == (None, *wq)
    assert "model" in str(wq)
    assert all(s == () for s in (
        on_cpu.split.state_specs["segments"]["0"]["attn"]["wq"],
        on_cpu.whole_specs["embed"]))
    assert not FleetPlacement(_stacked(cfg, "cpu"), cfg,
                              _FakeMesh(2, 1, "cpu"), FN).placed


@pytest.mark.parametrize("arch,change,mesh,entry", [
    ("olmoe_1b_7b", {}, (2, 2), "12g"),
    ("deepseek_v2_lite_16b", {}, (1, 2), "12d"),
    ("zamba2_7b", {}, (1, 2), "12e"),
    ("granite_3_8b", {"pad_q_heads": 16, "pad_kv_heads": 16}, (1, 2),
     "12f"),
    ("granite_3_8b", {}, (2, 2), "12g"),
])
def test_cuda_fleets_the_split_leaves_for_later_raise(arch, change, mesh,
                                                      entry):
    """On fake CUDA tensors and a fake mesh: a fleet of a config or mesh
    the split does not take raises NotImplementedError naming its ROADMAP
    entry when its placement is built (a trial axis over data ranks on the
    card is 12g); on CPU ranks the same config takes the gathering round
    (no split), and granite's 2x2 mesh the split."""
    cfg = smoke(arch, **change)
    with FakeTensorMode():
        with pytest.raises(NotImplementedError, match=f"entry {entry}"):
            FleetPlacement(_stacked(cfg, "cuda"), cfg, _FakeMesh(*mesh), FN)
    if entry == "12g":
        assert "trial axis" in tp.unsupported(
            cfg, _FakeMesh(*mesh), FN, train=True, fl_round=True,
            fleet=True)
    cpu = FleetPlacement(_stacked(cfg, "cpu"), cfg, _FakeMesh(*mesh, "cpu"),
                         FN)
    assert (cpu.split is None) == (entry != "12g")
