"""`run_fl(mesh=)` and `run_fleet(mesh=)` of the port in worlds of CPU
ranks, against the unmeshed scan and the JAX package's `run_fl`.

No test here opens a process group, builds a DeviceMesh or sets an
environment variable: a module-scoped fixture runs `tests/torch_world.py`
once for a world of 1 rank and once for a world of 4, each in a
subprocess of its own under a timeout (its ranks meet on a `FileStore` in
the fixture's temporary directory, with no TCP rendezvous), and the tests
compare what rank 0 wrote. The problem is the reference's
`tests/test_sharded_scan.py`: N = 8 clients of paper_logistic, T = 9
rounds under Gilbert–Elliott availability, scan chunks of 4.

Anchors, as the reference's (`tests/test_sharded_scan.py:61-83`):
  * a 1x1 mesh is bit-equal to no mesh (nothing is split, no collective);
  * 2x2 and 4x1 meshes are within rtol 2e-5 / atol 1e-6 of the unmeshed
    scan: each data rank sums its block of the client axis and the
    partial sums are all-reduced, so f32 rounding groups differently. The
    mask-derived integers (rounds, n_active, τ̄, τ_max) are exact, and
    every rank returns the same history and params;
  * the unmeshed scan is held to the reference's `run_fl(engine="scan")`
    at the same tolerance, from the same params;
  * scan_chunk ∈ {1, 4, T} on the 2x2 mesh is bit-exact; 2x2 and 4x1
    agree to the tolerance;
  * a K=4 fleet with its trial axis over 4x1 (loop and scan) matches four
    sequential `run_fl` runs.

BankedMIFA(PagedDeviceBank(page_size=4, n_slots=2)) runs under the data
ranks as the reference runs it: the whole bank on every rank, every rank
running the whole round, every rank's bank equal after the run; its
snapshot under 2x2 is the unmeshed run's, byte for byte, and resumes on
2x2. A HostBank under a mesh raises the reference's ValueError, word for
word.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.bank import BankedMIFA as JBankedMIFA
from repro.bank import DenseBank as JDenseBank
from repro.bank import HostBank as JHostBank
from repro.bank import PagedDeviceBank as JPagedDeviceBank
from repro.configs import get_config as jax_config
from repro.core import MIFA as JMIFA
from repro.core import BiasedFedAvg as JBiasedFedAvg
from repro.core import run_fl as jax_run_fl
from repro.data import ClientBatcher as JClientBatcher
from repro.launch.mesh import make_abstract_mesh as jax_mesh
from repro.models import build_model as jax_build
from repro.scenarios import GilbertElliott as JGilbertElliott
from repro_torch.core import MIFA, run_fl
from repro_torch.data import label_skew_partition, make_classification
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.sharding.clients import client_shard

HELPER = Path(__file__).resolve().parent / "torch_world.py"
N, T = 8, 9
ALGOS = ["mifa_array", "banked_dense", "fedavg", "banked_paged"]
SHARDED = ["2x2", "4x1"]
RTOL, ATOL = 2e-5, 1e-6


def _start_world(world: int, out: Path) -> tuple:
    """Run the helper for a world of `world` ranks into `out`, killing its
    whole process group if it outlives the timeout."""
    proc = subprocess.Popen([sys.executable, str(HELPER), "--world",
                             str(world), "--out", str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the world of {world} ranks ran past 300 s")
    assert proc.returncode == 0, log[-4000:]
    return (dict(np.load(out / "results.npz")),
            json.loads((out / "results.json").read_text()))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _start_world(1, tmp_path_factory.mktemp("world1"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _start_world(4, tmp_path_factory.mktemp("world4"))


def _run(res, key):
    """(params leaves, history arrays) of one run in a world's results."""
    params = [res[f"{key}/p{i}"] for i in range(2)]
    return params, {k: res[f"{key}/{k}"] for k in ("train_loss", "n_active",
                                                    "rounds", "tau")}


def _assert_close(a, b, *, exact):
    (pa, ha), (pb, hb) = a, b
    for x, y in zip(pa + [ha["train_loss"]], pb + [hb["train_loss"]]):
        if exact:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
    for k in ("rounds", "n_active", "tau"):
        np.testing.assert_array_equal(ha[k], hb[k])


@pytest.mark.parametrize("name", ALGOS)
def test_one_rank_mesh_is_bit_equal_to_no_mesh(world1, name):
    res, _ = world1
    _assert_close(_run(res, f"{name}/none"), _run(res, f"{name}/1x1"),
                  exact=True)


@pytest.mark.parametrize("mesh", SHARDED)
@pytest.mark.parametrize("name", ALGOS)
def test_sharded_scan_matches_one_rank(world4, name, mesh):
    res, info = world4
    _assert_close(_run(res, f"{name}/none"), _run(res, f"{name}/{mesh}"),
                  exact=False)
    assert info["same_on_every_rank"][f"{name}/{mesh}"]


def _jax_algo(name):
    return {"mifa_array": lambda: JMIFA(memory="array"),
            "banked_dense": lambda: JBankedMIFA(JDenseBank()),
            "fedavg": JBiasedFedAvg,
            "banked_paged": lambda: JBankedMIFA(JPagedDeviceBank(
                page_size=4, n_slots=2))}[name]()


@pytest.mark.parametrize("name", ALGOS)
def test_unmeshed_scan_matches_the_reference(world1, name):
    res, _ = world1
    cfg = jax_config("paper_logistic").replace(fl_clients=N)
    X, y = make_classification(10, cfg.d_model, 40, noise=1.0, seed=0)
    idx, _ = label_skew_partition(y, N, seed=0)
    init = {"w": jax.numpy.asarray(res["init/p1"]),
            "b": jax.numpy.asarray(res["init/p0"])}
    params, hist = jax_run_fl(
        model=jax_build(cfg), algo=_jax_algo(name),
        batcher=JClientBatcher(X, y, idx, batch_size=8, k_steps=2, seed=0),
        scenario=JGilbertElliott.from_rate_and_burst(0.5, 3.0, n=N,
                                                     seed=100),
        schedule=lambda t: 0.1 / (1 + t), n_rounds=T, weight_decay=1e-3,
        seed=0, cohort_capacity=8, params=init, engine="scan", scan_chunk=4)
    ref = ([np.asarray(p) for p in jax.tree.leaves(params)],
           {"train_loss": np.asarray(hist.train_loss, np.float64),
            "n_active": np.asarray(hist.n_active, np.float64),
            "rounds": np.asarray(hist.rounds),
            "tau": np.asarray([hist.tau_bar, hist.tau_max], np.float64)})
    _assert_close(ref, _run(res, f"{name}/none"), exact=False)


@pytest.mark.parametrize("chunk", [1, 4, T])
def test_chunk_invariance_on_the_2x2_mesh(world4, chunk):
    res, _ = world4
    _assert_close(_run(res, "mifa_array/2x2"), _run(res, f"chunk{chunk}/2x2"),
                  exact=True)


def test_mesh_shape_invariance(world4):
    """2x2 and 4x1 draw the same masks and agree to the tolerance."""
    res, _ = world4
    for name in ALGOS:
        _assert_close(_run(res, f"{name}/2x2"), _run(res, f"{name}/4x1"),
                      exact=False)


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_fleet_over_4x1_matches_sequential_runs(world4, engine):
    """K=4 trials, one a data rank, gathered on every rank: each trial is
    its sequential `run_fl` (params and losses to the tolerance, masks
    exact)."""
    res, info = world4
    assert info[f"fleet_{engine}_labels"] == [f"seed{s}" for s in range(4)]
    for s in range(4):
        params, hist = _run(res, f"seq{s}/none")
        for i, p in enumerate(params):
            np.testing.assert_allclose(res[f"fleet_{engine}/p{i}"][s], p,
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res[f"fleet_{engine}/train_loss"][s],
                                   hist["train_loss"], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(res[f"fleet_{engine}/n_active"][s],
                                      hist["n_active"])


def test_bank_rows_pad_and_each_rank_holds_its_block(world4):
    """DenseBank(mesh=) pads N+1 = 9 rows to 10 (2x2) and 12 (4x1); each
    data rank holds its block of every leaf, the model ranks of one data
    coordinate the same block; a scatter of rows owned by different ranks
    reads back whole on every rank, with G_sum whole."""
    _, info = world4
    for key, n_rows, blocks in (
            ("2x2", 10, [(0, 5), (0, 5), (5, 10), (5, 10)]),
            ("4x1", 12, [(0, 3), (3, 6), (6, 9), (9, 12)])):
        got = info["bank_layouts"][key]
        assert [(r, n, lo, hi) for r, n, lo, hi, _ in got] == [
            (rank, n_rows, lo, hi) for rank, (lo, hi) in enumerate(blocks)]
        assert all(shape == [hi - lo, 64, 10]
                   for _, _, lo, hi, shape in got)
        assert info["bank_round_trips"][key]


def test_paged_bank_is_whole_and_equal_on_every_rank(world4):
    """After T rounds every rank holds the same whole bank: pool, page
    table, G_sum and the host mirror's page table, faults and
    evictions."""
    _, info = world4
    assert info["paged_bank_same_on_every_rank"] == {"2x2": True,
                                                     "4x1": True}


def test_paged_bank_snapshot_under_data_ranks(world4):
    """checkpoint= on 2x2: the snapshot after round 8 is the unmeshed
    run's byte for byte, the directory holds only the snapshots (one
    writer), and the run resumed from it on 2x2 matches the unmeshed
    run."""
    res, info = world4
    assert info["paged_snapshot_equal"]
    assert info["paged_snapshot_files"] == ["ckpt_r00000004.npz",
                                            "ckpt_r00000008.npz"]
    _assert_close(_run(res, "banked_paged/none"),
                  _run(res, "banked_paged/resumed_2x2"), exact=False)


def test_run_fl_wires_the_mesh_into_a_meshless_bank(world4):
    _, info = world4
    assert info["wired"] == {"mesh_is_run_mesh": True, "n_rows": 10}


def test_placements_and_the_world_size_check(world4):
    _, info = world4
    assert info["placements"] == ["Shard(dim=0)", "Replicate()"]
    assert info["host_mesh_error"].startswith(
        "make_host_mesh(3, 1) needs a world of 3 ranks but the default "
        "process group has 4 ranks; start a world of 3 ranks")


def _tiny_kw():
    from repro_torch.configs import get_config
    from repro_torch.data import ClientBatcher
    from repro_torch.models import build_model
    from repro_torch.scenarios import GilbertElliott
    cfg = get_config("paper_logistic").replace(fl_clients=N)
    X, y = make_classification(10, cfg.d_model, 40, noise=1.0, seed=0)
    idx, _ = label_skew_partition(y, N, seed=0)
    return dict(model=build_model(cfg), algo=MIFA(),
                batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                      seed=0),
                scenario=GilbertElliott.from_rate_and_burst(0.5, 3.0, n=N),
                schedule=lambda t: 0.1, n_rounds=1, device="cpu")


@pytest.mark.parametrize("case", ["loop", "sim", "host_bank"])
def test_run_fl_mesh_errors_are_the_reference_s(case):
    """mesh= under engine='loop' and with sim= raise the reference's
    ValueErrors, before any mesh is used (abstract 1x1 meshes); so does
    BankedMIFA(HostBank) under a 2x1 mesh on the scan engine (its rows
    live on the host, so it cannot scan and a mesh cannot fall back to
    the loop)."""
    from repro.sim import SimSpec as JSimSpec
    from repro_torch.bank import BankedMIFA, HostBank
    from repro_torch.sim import SimSpec
    kw = _tiny_kw()
    shape = (2, 1) if case == "host_bank" else (1, 1)
    extra = {"loop": {"engine": "loop"},
             "sim": {"engine": "scan",
                     "sim": SimSpec(policy=None, latency=None)},
             "host_bank": {"engine": "scan",
                           "algo": BankedMIFA(HostBank(device="cpu"))}}[case]
    with pytest.raises(ValueError) as got:
        run_fl(mesh=make_abstract_mesh(shape, ("data", "model")),
               **{**kw, **extra})
    cfg = jax_config("paper_logistic").replace(fl_clients=N)
    X, y = make_classification(10, cfg.d_model, 40, noise=1.0, seed=0)
    idx, _ = label_skew_partition(y, N, seed=0)
    jextra = {"loop": {"engine": "loop", "algo": JMIFA()},
              "sim": {"engine": "scan", "algo": JMIFA(),
                      "sim": JSimSpec(policy=None, latency=None)},
              "host_bank": {"engine": "scan",
                            "algo": JBankedMIFA(JHostBank())}}[case]
    with pytest.raises(ValueError) as want:
        jax_run_fl(model=jax_build(cfg),
                   batcher=JClientBatcher(X, y, idx, batch_size=8,
                                          k_steps=2, seed=0),
                   scenario=JGilbertElliott.from_rate_and_burst(0.5, 3.0,
                                                                n=N),
                   schedule=lambda t: 0.1, n_rounds=1,
                   mesh=jax_mesh(shape, ("data", "model")), **jextra)
    assert str(got.value) == str(want.value)


def test_a_split_axis_raises_for_cuda_and_abstract_meshes():
    """Data extent > 1 runs on CPU ranks: CUDA tensors raise (one card has
    no second rank), and an abstract mesh places nothing; extent 1 or an
    axis the extent does not divide splits nothing."""
    mesh = make_abstract_mesh((2, 1), ("data", "model"))
    with pytest.raises(NotImplementedError, match="CUDA tensors"):
        client_shard(mesh, N, torch.device("cuda"))
    with pytest.raises(ValueError, match="abstract mesh places nothing"):
        client_shard(mesh, N, torch.device("cpu"))
    assert client_shard(mesh, N + 1, torch.device("cuda")) is None
    assert client_shard(make_abstract_mesh((1, 4), ("data", "model")), N,
                        torch.device("cuda")) is None
