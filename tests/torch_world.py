"""A world of CPU ranks that runs the port's meshed cases and writes what
`tests/test_torch_sharded_scan.py` compares.

    python tests/torch_world.py --world 1|4 --out DIR
    python tests/torch_world.py --world 4 --cases params --out DIR
    python tests/torch_world.py --world 2|4 --cases serve --out DIR
    python tests/torch_world.py --world 2|4 --cases train --out DIR
    python tests/torch_world.py --world 2|4 --cases fl --out DIR
    python tests/torch_world.py --world 2|4 --cases fleet --out DIR

`torch.multiprocessing.spawn` starts the ranks. They meet on a `FileStore`
under DIR (no TCP rendezvous) and talk gloo over the loopback device, with
a timeout on every collective. Every rank runs every case of its world
(the collectives need all of them) and destroys its process group in
`finally`; rank 0 writes `results.npz` (params, losses and the integer
history of each run) and `results.json` (bank layouts, checks made inside
the world) into DIR. A failing rank makes `spawn` raise, and the script
exits non-zero.

This is a helper script, not a test file: the test module's fixture runs
it in a subprocess of its own, under a timeout, so no pytest worker opens
a process group, builds a DeviceMesh or sets an environment variable.

The problem of the default cases (`--cases paper`) is
`tests/test_sharded_scan.py`'s: N = 8 label-skewed clients of
paper_logistic, T = 9 rounds under Gilbert–Elliott availability (rate
0.5, bursts of 3), cohorts pinned to 8, scan chunks of 4. Its algorithms
are MIFA(array), BankedMIFA(DenseBank), biased FedAvg and
BankedMIFA(PagedDeviceBank(page_size=4, n_slots=2)), the last held whole
on every rank.

`--cases serve` (`tests/test_torch_tensor_parallel.py`, worlds of 2 and 4)
serves the smoke configs of SERVE_CASES through the split prefill and decode
steps (`sharding.tensor_parallel`) on the params the test writes into DIR
(`params_<case>.npz`): each rank compares its blocks with its blocks of the
unsplit run, and rank 0 writes the split run gathered whole into
`results.npz` for the test's comparison with the JAX package.

`--cases train` (`tests/test_torch_split_train.py`, worlds of 2 and 4)
runs the MIFA train step of the smoke configs of TRAIN_CASES on each
rank's blocks (`make_train_step(mesh=)`, split products) for TR rounds, on
the params the test writes into DIR (`params_<case>.npz`): each rank
compares its blocks of the params, G and the loss with its blocks of the
unsplit step's, and rank 0 writes the split run gathered whole into
`results.npz` for the test's comparison with the JAX package.

`--cases fl` (`tests/test_torch_split_fl.py`, worlds of 2 and 4) runs
`run_fl(engine="scan", mesh=, cfg=)` for the smoke configs of FL_CASES, the
local update on each rank's blocks (split products in the federated
round): each rank compares its blocks of the params, and the whole state,
with the unsplit run's, counts the params gathered whole inside the
rounds, and rank 0 writes the split run gathered whole into `results.npz`
for the test's comparison with the JAX package.

`--cases fleet` (`tests/test_torch_split_fleet.py`, worlds of 2 and 4)
runs `run_fleet(mesh=, cfg=)` for the smoke configs of FLEET_CASES, every
trial's local update on each rank's blocks under vmap over trials: each
rank compares the fleet it returns (whole, all K) and its whole state with
the unsplit fleet's, counts the params gathered whole inside the local
updates, and rank 0 writes the split fleet into `results.npz` for the
test's comparison with the JAX package's sequential runs.

`--cases params` (`tests/test_torch_param_placement_world.py`) places the
params of granite-3-8b's and qwen1.5-110b's smoke configs (f32) over the
mesh axes (`sharding.params`): each rank compares its blocks of every
output with its blocks of the same run without a mesh, which it runs too,
and rank 0 writes every rank's verdicts into `results.json`.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

N, T, CHUNK = 8, 9, 4
ALGOS = ("mifa_array", "banked_dense", "fedavg", "banked_paged")
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
FLEET_K = 4


def problem():
    from repro_torch.configs import get_config
    from repro_torch.data import (ClientBatcher, label_skew_partition,
                                  make_classification)
    from repro_torch.models import build_model
    cfg = get_config("paper_logistic").replace(fl_clients=N)
    X, y = make_classification(10, cfg.d_model, 40, noise=1.0, seed=0)
    idx, _ = label_skew_partition(y, N, seed=0)
    return build_model(cfg), ClientBatcher(X, y, idx, batch_size=8,
                                           k_steps=2, seed=0)


def make_algo(name: str):
    """`banked_paged`: two resident pages of four rows, held whole on
    every rank under a mesh."""
    from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
    from repro_torch.core import MIFA, BiasedFedAvg
    return {"mifa_array": lambda: MIFA(memory="array"),
            "banked_dense": lambda: BankedMIFA(DenseBank(device="cpu")),
            "fedavg": BiasedFedAvg,
            "banked_paged": lambda: BankedMIFA(PagedDeviceBank(
                page_size=4, n_slots=2, device="cpu"))}[name]()


def ge(seed: int = 0):
    from repro_torch.scenarios import GilbertElliott
    return GilbertElliott.from_rate_and_burst(0.5, 3.0, n=N, seed=100 + seed)


def run_kw(model, batcher, **over) -> dict:
    kw = dict(model=model, batcher=batcher,
              schedule=lambda t: 0.1 / (1 + t), n_rounds=T,
              weight_decay=1e-3, seed=0, cohort_capacity=8, engine="scan",
              scan_chunk=CHUNK, device="cpu")
    kw.update(over)
    return kw


def flat(params) -> list:
    from repro_torch.tree import tree_leaves
    return [p.detach().numpy().copy() for p in tree_leaves(params)]


def record(out: dict, key: str, params, hist) -> None:
    for i, p in enumerate(flat(params)):
        out[f"{key}/p{i}"] = p
    out[f"{key}/train_loss"] = np.asarray(hist.train_loss, np.float64)
    out[f"{key}/n_active"] = np.asarray(hist.n_active, np.float64)
    out[f"{key}/rounds"] = np.asarray(hist.rounds)
    out[f"{key}/tau"] = np.asarray([hist.tau_bar, hist.tau_max], np.float64)


def paged_bank_summary(model, batcher, mesh) -> list:
    """The bank after T rounds of BankedMIFA(PagedDeviceBank) on the scan
    engine under `mesh`, driven as `run_fl(engine="scan", mesh=)` drives
    it: its device state (pool, page table, G_sum) and its host mirror
    (page table, faults, evictions), as lists."""
    from repro_torch.core.runner import RoundRunner
    from repro_torch.core.scan_engine import ScanDriver
    from repro_torch.tree import tree_leaves
    kw = run_kw(model, batcher)
    runner = RoundRunner(model=model, algo=make_algo("banked_paged"),
                         batcher=batcher, schedule=kw["schedule"],
                         weight_decay=kw["weight_decay"], seed=kw["seed"],
                         cohort_capacity=kw["cohort_capacity"],
                         scenario=ge(), device="cpu")
    driver = ScanDriver(runner, scan_chunk=CHUNK, mesh=mesh)
    driver.run(T)
    bank = runner.algo.bank
    return ([t.tolist() for t in tree_leaves(runner.state["bank"])]
            + [bank._pt.tolist(), bank.faults, bank.evictions])


def same_on_every_rank(value) -> bool:
    """All ranks of the world hold `value` (a picklable summary)."""
    import torch.distributed as dist
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, value)
    return all(p == parts[0] for p in parts)


def world_of_one(out: dict, info: dict) -> None:
    from repro_torch.core import run_fl
    from repro_torch.launch.mesh import make_host_mesh
    model, batcher = problem()
    mesh = make_host_mesh(1, 1, device="cpu")
    out["init/p0"], out["init/p1"] = flat(model.init(0, device="cpu"))
    for name in ALGOS:
        record(out, f"{name}/none", *run_fl(algo=make_algo(name),
                                            scenario=ge(),
                                            **run_kw(model, batcher)))
        record(out, f"{name}/1x1", *run_fl(algo=make_algo(name),
                                           scenario=ge(), mesh=mesh,
                                           **run_kw(model, batcher)))


def world_of_four(out: dict, info: dict, out_dir: str) -> None:
    import torch
    from repro_torch.bank import BankedMIFA, DenseBank
    from repro_torch.checkpoint import CheckpointSpec
    from repro_torch.core import MIFA, run_fl
    from repro_torch.fleet import Trial, run_fleet
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import P, placements
    model, batcher = problem()
    rank = torch.distributed.get_rank()
    meshes = {k: make_host_mesh(*s, device="cpu")
              for k, s in MESHES.items()}
    same = {}
    for name in ALGOS:
        record(out, f"{name}/none", *run_fl(algo=make_algo(name),
                                            scenario=ge(),
                                            **run_kw(model, batcher)))
        for key, mesh in meshes.items():
            params, hist = run_fl(algo=make_algo(name), scenario=ge(),
                                  mesh=mesh, **run_kw(model, batcher))
            record(out, f"{name}/{key}", params, hist)
            same[f"{name}/{key}"] = same_on_every_rank(
                (hist.train_loss, hist.n_active,
                 [p.tolist() for p in flat(params)]))
    info["same_on_every_rank"] = same
    # BankedMIFA(PagedDeviceBank): every rank's whole bank the same
    info["paged_bank_same_on_every_rank"] = {
        key: same_on_every_rank(paged_bank_summary(model, batcher, mesh))
        for key, mesh in meshes.items()}
    # its snapshot after round 8 on 2x2 (rank 0 writes it) against the
    # unmeshed run's, byte for byte; then resumed on 2x2 to round T
    ck_mesh = os.path.join(out_dir, "paged_ckpt_2x2")
    ck_none = os.path.join(out_dir, f"paged_ckpt_none_{rank}")
    for mesh, ck in ((meshes["2x2"], ck_mesh), (None, ck_none)):
        run_fl(algo=make_algo("banked_paged"), scenario=ge(), mesh=mesh,
               checkpoint=CheckpointSpec(every=CHUNK, dir=ck),
               **run_kw(model, batcher, n_rounds=2 * CHUNK))
    name = f"ckpt_r{2 * CHUNK:08d}.npz"
    with np.load(os.path.join(ck_mesh, name)) as a, \
            np.load(os.path.join(ck_none, name)) as b:
        info["paged_snapshot_equal"] = a.files == b.files and all(
            a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            and a[k].tobytes() == b[k].tobytes() for k in a.files)
    info["paged_snapshot_files"] = sorted(os.listdir(ck_mesh))
    torch.distributed.barrier()
    record(out, "banked_paged/resumed_2x2", *run_fl(
        algo=make_algo("banked_paged"), scenario=ge(), mesh=meshes["2x2"],
        checkpoint=CheckpointSpec(every=CHUNK, dir=ck_mesh, resume=True),
        **run_kw(model, batcher)))
    # chunk invariance on the 2x2 mesh, each against the run above
    for chunk in (1, CHUNK, T):
        record(out, f"chunk{chunk}/2x2", *run_fl(
            algo=MIFA(memory="array"), scenario=ge(), mesh=meshes["2x2"],
            **run_kw(model, batcher, scan_chunk=chunk)))
    # a K=4 fleet with its trial axis over the 4x1 mesh, on both engines,
    # against four sequential runs
    for engine in ("loop", "scan"):
        trials = [Trial(seed=s, scenario=ge(s)) for s in range(FLEET_K)]
        kw = run_kw(model, batcher, engine=engine)
        del kw["seed"], kw["cohort_capacity"]
        params, hist = run_fleet(algo=MIFA(memory="array"), trials=trials,
                                 mesh=meshes["4x1"], **kw)
        for i, p in enumerate(flat(params)):
            out[f"fleet_{engine}/p{i}"] = p
        stacked = hist.stacked()
        out[f"fleet_{engine}/train_loss"] = stacked["train_loss"]
        out[f"fleet_{engine}/n_active"] = stacked["n_active"]
        info[f"fleet_{engine}_labels"] = hist.labels
    for s in range(FLEET_K):
        record(out, f"seq{s}/none", *run_fl(
            algo=MIFA(memory="array"), scenario=ge(s),
            **run_kw(model, batcher, seed=s, cohort_capacity=None)))
    # the bank's layout: padded rows, each rank its block
    import torch.distributed as dist
    from repro_torch.tree import tree_map
    layouts, round_trips = {}, {}
    gen = torch.Generator().manual_seed(0)
    ids = np.array([1, 4, 7])           # rows of different ranks
    for key, mesh in meshes.items():
        bank = DenseBank(mesh=mesh, device="cpu")
        state = bank.init(model.init(0, device="cpu"), N)
        mine = (dist.get_rank(), bank.n_rows, bank.shard.lo, bank.shard.hi,
                list(state["rows"]["w"].shape))
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, mine)
        layouts[key] = parts
        # a scatter through the host ids, then every row read back
        upd = tree_map(lambda p: torch.randn((len(ids),) + tuple(p.shape),
                                             generator=gen), state["g_sum"])
        state = bank.scatter(state, ids, upd)
        rows = bank.gather(state, np.arange(N))
        want = tree_map(lambda u: torch.zeros((N,) + tuple(u.shape[1:]))
                        .index_copy(0, torch.from_numpy(ids), u), upd)
        round_trips[key] = all(
            torch.equal(rows[k], want[k])
            and torch.allclose(state["g_sum"][k], upd[k].sum(0), atol=1e-6)
            for k in rows)
    info["bank_layouts"] = layouts
    info["bank_round_trips"] = round_trips
    # run_fl(mesh=) hands its mesh to a DenseBank built without one
    algo = BankedMIFA(DenseBank(device="cpu"))
    run_fl(algo=algo, scenario=ge(), mesh=meshes["2x2"],
           **run_kw(model, batcher))
    info["wired"] = {"mesh_is_run_mesh": algo.bank.mesh is meshes["2x2"],
                     "n_rows": algo.bank.n_rows}
    info["placements"] = [repr(p) for p in placements(P("data", None),
                                                      meshes["2x2"])]
    try:
        make_host_mesh(3, 1, device="cpu")
    except ValueError as e:
        info["host_mesh_error"] = str(e)
    torch.distributed.barrier()


# --------------------------------------------------------------------------- #
# --cases params: params placed over the mesh axes
# --------------------------------------------------------------------------- #

PN, PT, PCHUNK, PS = 4, 3, 2, 16


def smoke(arch: str, **change):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).replace(compute_dtype="float32",
                                          param_dtype="float32", **change)


def tokens(cfg, n: int):
    from repro_torch.data import TokenBatcher
    return TokenBatcher(n_clients=n, vocab=cfg.vocab_size, seq_len=PS,
                        batch_size=1, k_steps=1, stream_len=4096, seed=0)


# the fp32 bounds of tests/test_torch_sharded_scan.py
PRTOL, PATOL = 2e-5, 1e-6


def gap(got, want) -> tuple:
    """(bit-equal, worst |got - want| / (PATOL + PRTOL·|want|)) over two
    trees of tensors, arrays or lists of floats."""
    import torch
    from repro_torch.tree import tree_leaves
    eq, worst = True, 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        a = torch.as_tensor(a).detach().double()
        b = torch.as_tensor(b).detach().double()
        if a.shape != b.shape:
            return False, float("inf")
        eq = eq and torch.equal(a, b)
        if a.numel():
            worst = max(worst, float(((a - b).abs() / (
                PATOL + PRTOL * b.abs())).max()))
    return eq, worst


def verdict(info: dict, case: str, got, want, ints=None, axes=(),
            train_bound: bool = False, int8_bound: bool = False) -> None:
    """Every rank's (bit-equal, worst gap, integers equal, split axes)
    for `case`, gathered into `info`; with `train_bound` the gap is over
    the f32 training bound (`train_gap`) instead of PRTOL / PATOL, with
    `int8_bound` over int8 memory's (`INT8_TOL`)."""
    import torch.distributed as dist
    eq, worst = gap(got, want)
    if train_bound:
        worst = train_gap(got, want)[1]
    if int8_bound:
        worst = train_gap(got, want, *INT8_TOL)[1]
    same = True if ints is None else all(
        np.array_equal(np.asarray(a), np.asarray(b)) for a, b in ints)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, {"eq": eq, "err": worst, "ints": same,
                                   "axes": sorted(axes)})
    info[case] = parts


def hist_ints(h) -> list:
    return [np.asarray(h.rounds), np.asarray(h.n_active)]


def bernoulli(n: int):
    from repro_torch.core.participation import BernoulliParticipation
    return BernoulliParticipation(np.linspace(0.4, 1.0, n), seed=1)


def fl_run(arch_cfg, params, algo, n: int, rounds: int = PT, **kw):
    from repro_torch.core import run_fl
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    return run_fl(model=build_model(arch_cfg), algo=algo,
                  batcher=tokens(arch_cfg, n),
                  participation=bernoulli(n), schedule=lambda t: 0.05,
                  n_rounds=rounds, params=tree_map(lambda p: p.clone(),
                                                   params),
                  engine="scan", scan_chunk=PCHUNK, device="cpu", **kw)


def step_args(cfg, n: int, seed: int):
    import torch
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    params = build_model(cfg).init(seed, device="cpu")
    G = tree_map(lambda p: torch.full((n,) + tuple(p.shape), 0.25), params)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (n, cfg.fl_local_steps, 2, PS)).astype(
            np.int32))}
    active = torch.tensor([True, False] + [True] * (n - 2))
    return params, G, batch, active, 0.05


def placed_step_case(info: dict, case: str, cfg, mesh,
                     train_bound: bool = False, **plan_kw) -> None:
    """A train_4k plan's step through `launch.specs.run_placed` on this
    rank's blocks of small arguments, against the same config's unsplit
    step on the whole arguments (the plan's own where it does not split);
    `train_bound` as in `verdict`."""
    import dataclasses
    from repro_torch.launch.specs import plan_config, run_placed
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.params import place
    from repro_torch.tree import tree_leaves, tree_map
    p = plan_config(cfg, "train_4k", mesh, **plan_kw)
    n = p.meta["n_clients"]
    args = step_args(cfg, n, 3)
    bspec = rules.named(mesh, rules.batch_specs(
        args[2], mesh, sequential_clients=p.meta["sequential"]))
    p = dataclasses.replace(p, in_shardings=(
        p.in_shardings[:2] + (bspec,) + p.in_shardings[3:]))
    whole_fn = p.fn
    if getattr(p.fn, "split", None) is not None:
        whole_fn = make_train_step(build_model(cfg), cfg, n,
                                   p.meta["k_steps"])
    want = whole_fn(*tree_map(lambda a: a.clone(), list(args[:4])), args[4])
    got = run_placed(p, *place(args, p.in_shardings))
    axes = rules.sharded_axes([s.spec for s in tree_leaves(
        p.in_shardings[0])], mesh)
    verdict(info, case, list(got), list(place(want, p.out_shardings)),
            axes=axes, train_bound=train_bound)
    info[case + "_n_clients"] = n


def world_of_params(out: dict, info: dict, out_dir: str) -> None:
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch.bank import BankedMIFA, DenseBank
    from repro_torch.checkpoint import CheckpointSpec
    from repro_torch.core import MIFA
    from repro_torch.fleet import Trial, run_fleet
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.scenarios import GilbertElliott
    from repro_torch.sharding import rules
    from repro_torch.sharding.params import take_tree
    from repro_torch.tree import tree_map
    rank = dist.get_rank()
    meshes = {k: make_host_mesh(*s, device="cpu")
              for k, s in MESHES.items()}
    m22 = meshes["2x2"]
    granite = smoke("granite_3_8b")
    qwen = smoke("qwen1_5_110b", fsdp=True, fl_clients=2)

    # (a) qwen's sequential step under its fsdp update constraint, (b)
    # granite's vmap step, each on the 2x2 mesh
    placed_step_case(info, "a_sequential_update_spec", qwen, m22,
                     inner_update_constraint=True)
    placed_step_case(info, "b_vmap_step", granite, m22, train_bound=True)

    params = build_model(granite).init(0, device="cpu")
    pspecs = rules.param_specs(params, granite, m22)

    def blocks(tree, mesh=m22):
        return take_tree(tree, rules.param_specs(tree, granite, mesh), mesh)

    # (c) the scan engine with MIFA(array): rows over data, params and the
    # update array's param dims over model
    want = fl_run(granite, params, MIFA(memory="array"), PN)
    got = fl_run(granite, params, MIFA(memory="array"), PN, mesh=m22,
                 cfg=granite)
    verdict(info, "c_scan_mifa_array", [got[0], got[1].train_loss],
            [blocks(want[0]), want[1].train_loss],
            ints=zip(hist_ints(got[1]), hist_ints(want[1])),
            axes=rules.sharded_axes([pspecs, rules.client_state_specs(
                params, granite, m22, n_clients=PN)], m22),
            train_bound=True)

    # (d) BankedMIFA(DenseBank(mesh=, cfg=)): rows over data and model
    want = fl_run(granite, params, BankedMIFA(DenseBank(device="cpu")), PN,
                  cohort_capacity=PN)
    algo = BankedMIFA(DenseBank(mesh=m22, cfg=granite, device="cpu"))
    got = fl_run(granite, params, algo, PN, cohort_capacity=PN, mesh=m22,
                 cfg=granite)
    verdict(info, "d_dense_bank", [got[0], got[1].train_loss],
            [blocks(want[0]), want[1].train_loss],
            ints=zip(hist_ints(got[1]), hist_ints(want[1])),
            axes=rules.sharded_axes([algo.bank.row_specs,
                                     algo.bank.sum_specs], m22),
            train_bound=True)
    # the bank alone: a scatter, every row read back as this rank's
    # column block, G_sum as its block of the whole sum
    bank = DenseBank(mesh=m22, cfg=granite, device="cpu")
    state = bank.init(params, PN)
    gen = torch.Generator().manual_seed(0)
    ids = np.array([0, 2, 3])
    upd = tree_map(lambda p: torch.randn((len(ids),) + tuple(p.shape),
                                         generator=gen), params)
    state = bank.scatter(state, ids, upd)
    rows = bank.gather(state, np.arange(PN))
    whole_rows = tree_map(lambda u: torch.zeros((PN,) + tuple(u.shape[1:]))
                          .index_copy(0, torch.from_numpy(ids), u), upd)
    verdict(info, "d_bank_round_trip", [rows, state["g_sum"]],
            [take_tree(whole_rows, tree_map(lambda s: rules.P(None, *s[1:]),
                                            bank.row_specs), m22),
             take_tree(tree_map(lambda u: u.sum(0), upd), bank.sum_specs,
                       m22)],
            axes=rules.sharded_axes(bank.row_specs, m22))

    # (e) a K=4 fleet with cfg: the trial axis over 4x1, and over 2x2
    # with the param dims over model (every trial's local update on the
    # rank's blocks, split products: the f32 training bound)
    def fleet(mesh=None):
        trials = [Trial(seed=s, scenario=GilbertElliott.from_rate_and_burst(
            0.5, 2.0, n=PN, seed=100 + s)) for s in range(FLEET_K)]
        return run_fleet(model=build_model(granite), batcher=tokens(
            granite, PN), schedule=lambda t: 0.05, n_rounds=PT,
            algo=MIFA(memory="array"), trials=trials, mesh=mesh,
            cfg=None if mesh is None else granite, engine="scan",
            scan_chunk=PCHUNK, device="cpu")
    want = fleet()
    for key in ("4x1", "2x2"):
        got = fleet(meshes[key])
        verdict(info, f"e_fleet_{key}",
                [got[0], got[1].stacked()["train_loss"]],
                [want[0], want[1].stacked()["train_loss"]],
                ints=[(got[1].stacked()["n_active"],
                       want[1].stacked()["n_active"])],
                axes=rules.sharded_axes(rules.fleet_trial_specs(
                    want[0], granite, meshes[key]), meshes[key]),
                train_bound=key == "2x2")

    # (f) checkpoint= after round 2 of 3 on 2x2: N = 3 (the data extent
    # does not divide it: the rows are whole, the products split over
    # model) and N = 4 (the rows over data too); the snapshot has the
    # unsplit run's members, within the f32 training bound; resumed on 4
    # ranks (bit-equal to the uninterrupted split run) and on 1 (within
    # the bound of the unsplit run)
    for n, case in ((3, "f_checkpoint_model"), (PN, "f_checkpoint_data")):
        full = fl_run(granite, params, MIFA(memory="array"), n)
        full_split = fl_run(granite, params, MIFA(memory="array"), n,
                            mesh=m22, cfg=granite)
        split_dir = os.path.join(out_dir, f"ckpt_{n}_split")
        whole_dir = os.path.join(out_dir, f"ckpt_{n}_whole_{rank}")
        fl_run(granite, params, MIFA(memory="array"), n, rounds=2,
               mesh=m22, cfg=granite,
               checkpoint=CheckpointSpec(every=2, dir=split_dir))
        fl_run(granite, params, MIFA(memory="array"), n, rounds=2,
               checkpoint=CheckpointSpec(every=2, dir=whole_dir))
        name = "ckpt_r00000002.npz"
        with np.load(os.path.join(split_dir, name)) as a, \
                np.load(os.path.join(whole_dir, name)) as b:
            keys = (a.files, b.files)
            snap = ([a[k] for k in a.files], [b[k] for k in b.files])
        info[case + "_keys_equal"] = keys[0] == keys[1]
        info[case + "_layout_equal"] = all(
            x.dtype == y.dtype and x.shape == y.shape
            for x, y in zip(*snap))
        floats = [(x, y) for x, y in zip(*snap) if x.dtype.kind == "f"]
        verdict(info, case + "_snapshot", [x for x, _ in floats],
                [y for _, y in floats],
                ints=[(x, y) for x, y in zip(*snap)
                      if x.dtype.kind not in "fU"],
                axes=rules.sharded_axes([pspecs, rules.client_state_specs(
                    params, granite, m22, n_clients=n)], m22),
                train_bound=True)
        one_dir = os.path.join(out_dir, f"ckpt_{n}_one_{rank}")
        shutil.copytree(split_dir, one_dir)
        dist.barrier()
        for key, kw in (("4", {"mesh": m22, "cfg": granite,
                               "dir": split_dir}),
                        ("1", {"dir": one_dir})):
            ck = CheckpointSpec(every=2, dir=kw.pop("dir"), resume=True)
            got = fl_run(granite, params, MIFA(memory="array"), n,
                         checkpoint=ck, **kw)
            ref = full_split if key == "4" else full
            verdict(info, f"{case}_resumed_on_{key}",
                    [got[0], got[1].train_loss], [ref[0], ref[1].train_loss],
                    ints=zip(hist_ints(got[1]), hist_ints(ref[1])),
                    axes=rules.sharded_axes([pspecs, rules.client_state_specs(
                        params, granite, m22, n_clients=n)], m22)
                    if key == "4" else (), train_bound=key == "1")
        dist.barrier()

    # (g) MIFA(memory="int8"): the rows over 4x1, and over 2x2 with the
    # param dims over model
    want = fl_run(granite, params, MIFA(memory="int8"), PN)
    for key in ("4x1", "2x2"):
        mesh = meshes[key]
        got = fl_run(granite, params, MIFA(memory="int8"), PN, mesh=mesh,
                     cfg=granite)
        verdict(info, f"g_int8_{key}", [got[0], got[1].train_loss],
                [blocks(want[0], mesh), want[1].train_loss],
                ints=zip(hist_ints(got[1]), hist_ints(want[1])),
                axes=rules.sharded_axes([rules.param_specs(
                    params, granite, mesh), rules.client_state_specs(
                    params, granite, mesh, n_clients=PN)], mesh),
                int8_bound=key == "2x2")
    dist.barrier()


# --------------------------------------------------------------------------- #
# --cases serve: split products on the serving path
# --------------------------------------------------------------------------- #

class RouteLog:
    """While active, records every `models.moe.route` call's (E, C)
    table (cloned) and the count of assignments it dropped."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route, self.calls = moe, moe.route, []

        def recording(*a):
            r = self.route(*a)
            self.calls.append((r.table.clone(), int((~r.kept()).sum())))
            return r
        moe.route = recording
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def routing_verdict(want: RouteLog, got: RouteLog) -> dict:
    """Whether the split run's routing calls (`got`) gave the unsplit
    run's (E, C) tables and drops bit for bit, and the same on every rank
    of the world; with the count of calls and their drops."""
    import torch
    import torch.distributed as dist
    eq = len(want.calls) == len(got.calls) and all(
        torch.equal(a, b) and m == n
        for (a, m), (b, n) in zip(want.calls, got.calls))
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, [digests([t])[0] + f"/{n}"
                                   for t, n in got.calls])
    return {"tables": eq, "same": all(x == parts[0] for x in parts),
            "calls": len(got.calls), "drops": [n for _, n in got.calls]}


def expert_blocks(params, split) -> dict:
    """The experts in this rank's block of each MoE segment (its w1's E
    dim), and each segment's split, by segment."""
    return {i: (params["segments"][i]["moe"]["w1"].shape[-3],
                split.segment(int(i)).experts)
            for i in params["segments"] if "moe" in params["segments"][i]}


def train_routing(model, params, split, mesh, batch) -> dict:
    """For an MoE config: the training forward (`loss_fn`) of one
    client's minibatch `batch`, unsplit on the whole `params` and on this
    rank's blocks of them under `split` (a `TrainSplit`), its routing
    compared (`routing_verdict`); {} without MoE."""
    import torch
    from repro_torch.sharding.params import take_tree
    if not model.cfg.n_experts:
        return {}
    with torch.no_grad():
        with RouteLog() as want:
            model.loss_fn(params, batch)
        blocks = take_tree(params, split.param_specs, mesh)
        with RouteLog() as got:
            model.loss_fn(blocks, batch, split=split)
    return {"routing": routing_verdict(want, got),
            "experts": expert_blocks(blocks, split)}


# batch, prompt length and greedy decode steps of every serve case
SB, SS, ST = 2, 24, 3
# case -> (arch, config change, mesh (data, model), cache length): granite
# with its kv heads over the model axis (KV 2 % 2 = 0) and its vocab over
# it, and with a vocab of 511 (the head whole, as granite's 49155 on the
# card); qwen (qkv bias); granite and gemma on 4 model ranks (KV 2 % 4 != 0:
# the caches split over their slots; gemma's ring of 16 over 4 ranks, its
# global layer's 30 slots whole); granite on data and model; olmoe's
# experts over `model` (E = 4: two a rank on 1x2, one on 1x4 at a capacity
# factor of 1.0, which drops assignments in prefill and decode), with a
# shared SwiGLU, with 6 experts on 1x4 (whole on every rank), and
# moonshot's
SERVE_CASES = {
    "a_granite_1x2": ("granite_3_8b", {}, (1, 2), 28),
    "a_granite_vocab511_1x2": ("granite_3_8b", {"vocab_size": 511}, (1, 2),
                               28),
    "b_qwen_1x2": ("qwen1_5_110b", {}, (1, 2), 28),
    "c_granite_1x4": ("granite_3_8b", {}, (1, 4), 28),
    "d_gemma_1x4": ("gemma3_4b", {}, (1, 4), 30),
    "e_granite_2x2": ("granite_3_8b", {}, (2, 2), 28),
    "f_olmoe_1x2": ("olmoe_1b_7b", {}, (1, 2), 28),
    "f_olmoe_drops_1x4": ("olmoe_1b_7b", {"moe_capacity_factor": 1.0},
                          (1, 4), 28),
    "g_olmoe_shared_1x2": ("olmoe_1b_7b", {"n_shared_experts": 1}, (1, 2),
                           28),
    "h_olmoe_whole_experts_1x4": ("olmoe_1b_7b", {"n_experts": 6}, (1, 4),
                                  28),
    "i_moonshot_1x2": ("moonshot_v1_16b_a3b", {}, (1, 2), 28),
}
# the f32 bound of tests/test_torch_models.py
SRTOL, SATOL = 2e-4, 2e-5


def flat_tree(tree, prefix: str = "") -> dict:
    """A nested dict of arrays as {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflat_tree(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def serve_params_path(out_dir: str, case: str) -> str:
    return os.path.join(out_dir, f"params_{case}.npz")


def serve_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (SB, SS))


def serve_gap(got, want) -> tuple:
    """(shapes equal, worst |got - want| / (SATOL + SRTOL·|want|)) over
    two trees of tensors."""
    from repro_torch.tree import tree_leaves
    shapes, worst = True, 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        a, b = a.double(), b.double()
        shapes = shapes and a.shape == b.shape
        if shapes and a.numel():
            worst = max(worst, float(((a - b).abs() / (
                SATOL + SRTOL * b.abs())).max()))
    return shapes, worst


def serve_greedy(model, params, cache, toks, step_p=None, step_d=None,
                 whole_logits=lambda x: x):
    """A prefill of `toks` and ST greedy decode steps: (prefill logits,
    [decode logits], greedy tokens (B, ST), cache after prefill (cloned),
    the cache at the end). Unsplit without `step_p`/`step_d`."""
    import torch
    from repro_torch.tree import tree_map
    step_p = step_p or (lambda p, c, b: model.prefill(p, b, c))
    step_d = step_d or (lambda p, c, t, i: model.decode_step(p, t, i, c))
    logits, cache = step_p(params, cache, {"tokens": toks})
    after = tree_map(lambda t: t.clone(), cache)
    steps, greedy = [], []
    last = logits
    for i in range(ST):
        tok = whole_logits(last).argmax(-1, keepdim=True).to(torch.int32)
        greedy.append(tok)
        last, cache = step_d(params, cache, tok, SS + i)
        steps.append(last)
    return logits, steps, torch.cat(greedy, 1), after, cache


def serve_case(out: dict, info: dict, case: str, out_dir: str) -> None:
    """One serve case on this world: the unsplit run and the split steps
    (`launch.steps.make_prefill_step(model, mesh, ...)`), each rank's
    blocks against its blocks of the unsplit run; rank 0 records the split
    run's outputs gathered whole for the test's comparison with the JAX
    package."""
    import torch
    import torch.distributed as dist
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.params import take, take_tree, whole, whole_tree
    from repro_torch.tree import tree_leaves
    arch, change, shape, C = SERVE_CASES[case]
    cfg = smoke(arch, **change)
    model = build_model(cfg)
    mesh = make_host_mesh(*shape, device="cpu")
    with np.load(serve_params_path(out_dir, case)) as z:
        params = params_from_jax(unflat_tree(dict(z)), "cpu")
    toks = torch.from_numpy(serve_tokens(cfg))
    with RouteLog() as want_routes:
        want = serve_greedy(model, params,
                            model.init_cache(SB, C, device="cpu"), toks)

    step_p = make_prefill_step(model, mesh, batch=SB, cache_len=C)
    step_d = make_decode_step(model, mesh, batch=SB, cache_len=C)
    split = step_p.split
    bspec = rules.P(rules.data_axes(mesh), None)
    lspec = rules.P(*rules.sanitize((rules.data_axes(mesh), rules.MODEL),
                                    (SB, cfg.vocab_size), mesh))

    def blk(x, spec):
        return take(x, spec, mesh, split=True)

    def whole_logits(x):
        return whole(x, lspec, mesh, split=True)

    blocks = take_tree(params, split.param_specs, mesh, split=True)
    with RouteLog() as got_routes:
        got = serve_greedy(
            model, blocks, model.init_cache(SB, C, device="cpu", split=split),
            blk(toks, bspec), step_p, step_d,
            lambda x: blk(whole_logits(x), bspec))
    cspecs = split.cache_specs
    # the rank's blocks of the unsplit run
    ref = [blk(want[0], lspec), [blk(x, lspec) for x in want[1]],
           take_tree(want[3], cspecs, mesh, split=True),
           take_tree(want[4], cspecs, mesh, split=True)]
    eq, worst = serve_gap([got[0], got[1], got[3], got[4]], ref)
    greedy_eq = torch.equal(got[2], blk(want[2], bspec))
    # replicated values: every leaf and output the model axis leaves
    # whole, bit-equal over the rank's model group
    model_group = mesh.get_group(rules.MODEL)

    def whole_on_model(spec) -> bool:
        return rules.MODEL not in rules.sharded_axes([spec], mesh)
    repl = [x for x, s in zip(tree_leaves(blocks),
                              tree_leaves(split.param_specs))
            if whole_on_model(s)]
    repl += [x for x, s in zip(tree_leaves(got[4]), tree_leaves(cspecs))
             if whole_on_model(s)]
    if whole_on_model(lspec):
        repl += [got[0]] + list(got[1])
    digest = [hashlib.sha256(x.contiguous().view(torch.uint8).numpy()
                             .tobytes()).hexdigest() for x in repl]
    parts = [None] * dist.get_world_size(model_group)
    dist.all_gather_object(parts, digest, group=model_group)
    repl_eq = all(p == parts[0] for p in parts)
    layouts = {str(i): (g.cache, g.heads, g.kv_cols, g.mlp, g.experts)
               for i, g in split.segments.items()}
    routing = routing_verdict(want_routes, got_routes)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, {
        "routing": routing, "experts": expert_blocks(blocks, split),
        "shapes": eq, "err": worst, "greedy": greedy_eq,
        "replicated": repl_eq, "n_replicated": len(repl),
        "layouts": layouts, "embed": split.embed, "head": split.head,
        "moved": dict(split.axis.moved)})
    info[case] = parts
    # the split run gathered whole, for the comparison with the reference
    wl = [whole_logits(got[0])] + [whole_logits(x) for x in got[1]]
    greedy = whole_tree(got[2], bspec, mesh, split=True)
    cache = whole_tree(got[4], cspecs, mesh, split=True)
    out[f"{case}/tokens"] = toks.numpy()
    out[f"{case}/greedy"] = greedy.numpy()
    for i, x in enumerate(wl):
        out[f"{case}/logits{i}"] = x.numpy()
    for k, v in flat_tree({"cache": cache}).items():
        out[f"{case}/{k}"] = v.numpy()
    out[f"{case}/cache_len"] = np.asarray(C)


def placed_decode_case(info: dict, out_dir: str) -> None:
    """Granite's `decode_32k` plan on 1x2 through `launch.specs.run_placed`
    (its step split: the blocks go straight in) for one decode step after
    an unsplit prefill, on case (a)'s params and a small cache, against
    the unsplit step's blocks."""
    import torch
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import plan_config, run_placed
    from repro_torch.models import build_model
    from repro_torch.sharding.params import take, take_tree
    from repro_torch.tree import tree_map
    _, _, _, C = SERVE_CASES["a_granite_1x2"]
    cfg = smoke("granite_3_8b")
    model = build_model(cfg)
    mesh = make_host_mesh(1, 2, device="cpu")
    with np.load(serve_params_path(out_dir, "a_granite_1x2")) as z:
        params = params_from_jax(unflat_tree(dict(z)), "cpu")
    toks = torch.from_numpy(serve_tokens(cfg))
    _, cache = model.prefill(params, {"tokens": toks},
                             model.init_cache(SB, C, device="cpu"))
    before = tree_map(lambda t: t.clone(), cache)
    tok = toks[:, :1].to(torch.int32)
    want = model.decode_step(params, tok, SS, cache)
    p = plan_config(cfg, "decode_32k", mesh)
    pspecs, cspecs, tspec, _ = [tree_map(lambda s: s.spec, sh)
                                for sh in p.in_shardings]
    got = run_placed(p, take_tree(params, pspecs, mesh, split=True),
                     take_tree(before, cspecs, mesh, split=True),
                     take(tok, tspec, mesh, split=True), SS)
    ref = [take(want[0], p.out_shardings[0].spec, mesh, split=True),
           take_tree(want[1], cspecs, mesh, split=True)]
    shapes, worst = serve_gap(list(got), ref)
    parts = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(parts, {
        "split": p.fn.split is not None, "shapes": shapes, "err": worst,
        "blocks": list(got[0].shape)})
    info["placed_decode_1x2"] = parts


def world_of_serve(out: dict, info: dict, out_dir: str) -> None:
    import torch.distributed as dist
    world = dist.get_world_size()
    for case, (_, _, shape, _) in SERVE_CASES.items():
        if shape[0] * shape[1] == world:
            serve_case(out, info, case, out_dir)
    if world == 2:
        placed_decode_case(info, out_dir)
    dist.barrier()


# --------------------------------------------------------------------------- #
# --cases train: split products in the MIFA train step
# --------------------------------------------------------------------------- #

# clients, local steps, minibatch, sequence length and rounds of every
# train case
TN, TK, TMB, TS, TR = 4, 2, 2, 24, 2
# case -> (arch, config change, mesh (data, model), through a plan): the
# vmap step of granite on 1x2 (its vocab over `model`; again at vocab 511,
# the head whole), on 1x4 (KV 2 % 4 != 0: k and v gathered) and on 2x2
# (clients over data); gemma's local and global layers on 1x2; qwen's
# sequential step under its fsdp update constraint through `plan_config`
# and `run_placed` (qkv bias); llava's sequential step (patches
# replicated); granite with remat and the chunked cross-entropy; and one
# kv head of width 6 on 1x4 (k's and v's columns whole, every rank
# computing them, while the query heads split); olmoe's experts over
# `model` with remat on (each layer's recompute issues the MoE
# collectives again) and on 2x2
TRAIN_CASES = {
    "a_granite_1x2": ("granite_3_8b", {}, (1, 2), False),
    "a_granite_vocab511_1x2": ("granite_3_8b", {"vocab_size": 511}, (1, 2),
                               False),
    "b_granite_1x4": ("granite_3_8b", {}, (1, 4), False),
    "c_gemma_1x2": ("gemma3_4b", {}, (1, 2), False),
    "d_granite_2x2": ("granite_3_8b", {}, (2, 2), False),
    "e_qwen_sequential_1x2": ("qwen1_5_110b", {}, (1, 2), True),
    "f_llava_sequential_1x2": ("llava_next_34b", {}, (1, 2), False),
    "g_granite_remat_1x2": ("granite_3_8b", {"remat": True, "ce_chunk": 8},
                            (1, 2), False),
    "h_granite_mqa_1x4": ("granite_3_8b", {"n_kv_heads": 1, "head_dim": 6},
                          (1, 4), False),
    "i_olmoe_remat_1x2": ("olmoe_1b_7b", {"remat": True}, (1, 2), False),
    "j_olmoe_2x2": ("olmoe_1b_7b", {}, (2, 2), False),
}
# the f32 training bound: |got - want| <= TRTOL·|want| + TATOL·max|want|
TRTOL, TATOL = 2e-4, 2e-5
# int8 memory of a run on split products against the unsplit run: a
# stochastic rounding whose input moved by f32 rounding may land one
# quantum (absmax / 127 of a row) away; the rtol of the int8 losses in
# tests/test_torch_quantized_memory.py
INT8_TOL = (2e-2, 2e-2)


def train_cfg(case: str):
    """The case's smoke config (f32) with TN clients of TK local steps."""
    arch, change, _, _ = TRAIN_CASES[case]
    return smoke(arch, fl_clients=TN, fl_local_steps=TK, **change)


def train_inputs(cfg, params_np: dict) -> tuple:
    """G before round 0 (numpy, params' structure with a leading TN) and
    each round's (batch of numpy arrays, active mask, eta), drawn from
    seeds: TokenBatcher streams, a vision_text model's patches from a
    normal draw."""
    from repro_torch.data import TokenBatcher

    def tree(t, fn):
        return ({k: tree(v, fn) for k, v in t.items()} if isinstance(t, dict)
                else fn(t))
    rng = np.random.default_rng(11)
    G0 = tree(params_np, lambda a: (0.01 * rng.standard_normal(
        (TN,) + a.shape)).astype(np.float32))
    S = TS - cfg.n_patches if cfg.modality == "vision_text" else TS
    tb = TokenBatcher(n_clients=TN, vocab=cfg.vocab_size, seq_len=S,
                      batch_size=TMB, k_steps=TK, stream_len=4096, seed=0)
    masks = ([True, False, True, True], [False, True, True, False])
    rounds = []
    for t in range(TR):
        batch = tb.sample_round(t)
        if cfg.modality == "vision_text":
            batch["patches"] = rng.standard_normal(
                (TN, TK, TMB, cfg.n_patches, cfg.d_model)).astype(np.float32)
        rounds.append((batch, np.asarray(masks[t]), 0.05 / (1 + t)))
    return G0, rounds


def train_gap(got, want, rtol: float = TRTOL, atol: float = TATOL
              ) -> tuple:
    """(shapes equal, worst |got - want| over the f32 training bound of
    each leaf, or the bound |got - want| <= rtol·|want| + atol·max|want|)
    over two trees of tensors, arrays or lists of floats."""
    import torch
    from repro_torch.tree import tree_leaves
    shapes, worst = True, 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        a = torch.as_tensor(a).detach().double()
        b = torch.as_tensor(b).detach().double()
        shapes = shapes and a.shape == b.shape
        if shapes and b.numel():
            bound = rtol * b.abs() + atol * b.abs().max()
            worst = max(worst, float(((a - b).abs() / bound.clamp(
                min=1e-30)).max()))
    return shapes, worst


def digests(tensors) -> list:
    import torch
    return [hashlib.sha256(t.detach().reshape(-1).view(torch.uint8).numpy()
                           .tobytes()).hexdigest() for t in tensors]


def train_case(out: dict, info: dict, case: str, out_dir: str) -> None:
    """One train case on this world: the unsplit step on whole arguments
    and the split step (`make_train_step(model, cfg, n, k, mesh=)`, or a
    `train_4k` plan's through `run_placed`) on this rank's blocks, TR
    rounds each; every rank compares its blocks of the params, G and the
    loss after each round with its blocks of the unsplit run's, and rank 0
    records the split run gathered whole for the test's comparison with
    the JAX package."""
    import torch
    import torch.distributed as dist
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import plan_config, run_placed
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.params import take, take_tree, whole_tree
    from repro_torch.tree import tree_leaves, tree_map
    _, _, shape, planned = TRAIN_CASES[case]
    cfg = train_cfg(case)
    model = build_model(cfg)
    mesh = make_host_mesh(*shape, device="cpu")
    with np.load(serve_params_path(out_dir, case)) as z:
        params_np = unflat_tree(dict(z))
    params = params_from_jax(params_np, "cpu")
    G0, rounds = train_inputs(cfg, params_np)
    G0 = params_from_jax(G0, "cpu")

    def clone(t):
        return tree_map(lambda x: x.clone(), t)

    def batch_of(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}

    # the unsplit step, round by round
    step0 = make_train_step(model, cfg, TN, TK)
    want, p, G = [], clone(params), clone(G0)
    for b, act, eta in rounds:
        p, G, m = step0(p, G, batch_of(b), torch.from_numpy(act), eta)
        want.append((clone(p), clone(G), m["loss"].clone()))

    if planned:
        plan = plan_config(cfg, "train_4k", mesh,
                           inner_update_constraint=True)
        step = plan.fn
        ins, outs = ([tree_map(lambda s: s.spec, sh) for sh in shs[:2]]
                     for shs in (plan.in_shardings, plan.out_shardings))
    else:
        step = make_train_step(model, cfg, TN, TK, mesh=mesh)
    split = step.split
    pspecs, gspecs = split.param_specs, split.state_specs
    check = not planned or (ins == [pspecs, gspecs] and outs == ins)
    p = take_tree(params, pspecs, mesh)
    G = take_tree(G0, gspecs, mesh)
    errs, shapes_ok, same = [], True, []
    model_group = mesh.get_group(rules.MODEL)

    def on_model(spec) -> bool:
        return rules.MODEL in rules.sharded_axes([spec], mesh)
    for r, (b, act, eta) in enumerate(rounds):
        batch = batch_of(b)
        bspecs = rules.batch_specs(batch, mesh,
                                   sequential_clients=cfg.sequential_clients)
        args = (p, G, take_tree(batch, bspecs, mesh), torch.from_numpy(act),
                eta)
        p, G, m = run_placed(plan, *args) if planned else step(*args)
        wp, wG, wl = want[r]
        ok, err = train_gap([p, G, m["loss"]],
                            [take_tree(wp, pspecs, mesh),
                             take_tree(wG, gspecs, mesh), wl])
        shapes_ok = shapes_ok and ok
        errs.append(err)
        # replicated values bit-equal: the loss and the params the model
        # axis leaves whole over the world, G's such leaves over the rank's
        # model group (data ranks hold other clients)
        repl = [m["loss"]] + [x for x, s in zip(tree_leaves(p),
                                                tree_leaves(pspecs))
                              if not on_model(s)]
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, digests(repl))
        g_repl = [x for x, s in zip(tree_leaves(G), tree_leaves(gspecs))
                  if not on_model(s)]
        g_parts = [None] * dist.get_world_size(model_group)
        dist.all_gather_object(g_parts, digests(g_repl), group=model_group)
        same.append(all(x == parts[0] for x in parts)
                    and all(x == g_parts[0] for x in g_parts))
        whole_p = whole_tree(p, pspecs, mesh)
        whole_G = whole_tree(G, gspecs, mesh)
        # copies: the sequential step writes G's rows in place next round
        for k, v in flat_tree({"params": whole_p, "G": whole_G}).items():
            out[f"{case}/r{r}/{k}"] = v.numpy().copy()
        out[f"{case}/r{r}/loss"] = m["loss"].numpy().copy()
    layouts = {str(i): (g.cache, g.heads, g.kv_cols, g.mlp, g.experts)
               for i, g in split.segments.items()}
    b0, _, _ = rounds[0]
    moe = train_routing(model, params, split, mesh,
                        {k: torch.from_numpy(v[0, 0]) for k, v in b0.items()})
    # `TrainSplit.move` between two dims split over model (the all-to-all)
    # and back, against the tensor taken whole and cut; a rank puts in
    # (M - 1) / M of its block
    msize = split.axis.size
    x = torch.randn(3, 4 * msize, 6 * msize,
                    generator=torch.Generator().manual_seed(5))
    src, dst = rules.P(None, rules.MODEL, None), rules.P(None, None,
                                                          rules.MODEL)
    blk = take(x, src, mesh)
    before = split.axis.moved["relayout"]
    there = split.move(blk, src, dst)
    put_in = split.axis.moved["relayout"] - before
    back = split.move(there, dst, src)
    exchange = (torch.equal(there, take(x, dst, mesh))
                and torch.equal(back, blk)
                and put_in * msize == blk.numel() * 4 * (msize - 1))
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, {
        **moe, "exchange": exchange,
        "shapes": shapes_ok and check, "err": errs, "replicated": same,
        "layouts": layouts, "embed": split.embed, "head": split.head,
        "sequential": cfg.sequential_clients,
        "moved": dict(split.axis.moved),
        "relayout_axes": sorted(rules.sharded_axes(
            [gspecs], mesh))})
    info[case] = parts


def world_of_train(out: dict, info: dict, out_dir: str) -> None:
    import torch.distributed as dist
    world = dist.get_world_size()
    for case, (_, _, shape, _) in TRAIN_CASES.items():
        if shape[0] * shape[1] == world:
            train_case(out, info, case, out_dir)
    dist.barrier()


# --------------------------------------------------------------------------- #
# --cases fl: split products in the federated round
# --------------------------------------------------------------------------- #

# clients, rounds, scan chunk, sequence length, minibatch and local steps of
# every fl case
FN, FT, FCHUNK, FS, FMB, FK = 4, 3, 2, 16, 2, 2
# an fl case's arch names a smoke config, or one changed as FL_CHANGES says
# (a vocab of 511: the head whole, as granite's 49155 on the card)
FL_CHANGES = {"granite_3_8b_vocab511": ("granite_3_8b", {"vocab_size": 511}),
              "granite_3_8b_padded": ("granite_3_8b", {"pad_q_heads": 16,
                                                       "pad_kv_heads": 16})}


def fl_cfg(arch: str):
    """The smoke config (f32) an fl case's arch names."""
    base, change = FL_CHANGES.get(arch, (arch, {}))
    return smoke(base, **change)
# case -> (arch, algorithm, mesh (data, model)): granite's smoke config
# with MIFA(array) on 1x2 and 2x2 (clients over data), DenseBank(mesh=,
# cfg=) on both, PagedDeviceBank (whole on every rank), int8 memory, FedAR
# (a dense baseline whose per-client memory is placed as the update
# array), gemma3-4b's (local attention, vocab-split head); checkpoint=
# after round 2 on 1x2, resumed on 1x2 and on one rank; olmoe's experts over
# `model` with MIFA(array) and DenseBank(mesh=, cfg=)
FL_CASES = {
    "a_mifa_1x2": ("granite_3_8b", "mifa_array", (1, 2)),
    "a_mifa_vocab511_1x2": ("granite_3_8b_vocab511", "mifa_array", (1, 2)),
    "b_mifa_2x2": ("granite_3_8b", "mifa_array", (2, 2)),
    "c_dense_bank_1x2": ("granite_3_8b", "banked_dense", (1, 2)),
    "c_dense_bank_2x2": ("granite_3_8b", "banked_dense", (2, 2)),
    "d_paged_bank_1x2": ("granite_3_8b", "banked_paged", (1, 2)),
    "e_int8_1x2": ("granite_3_8b", "mifa_int8", (1, 2)),
    "f_resumed_on_1x2": ("granite_3_8b", "mifa_array", (1, 2)),
    "f_resumed_on_1": ("granite_3_8b", "mifa_array", (1, 2)),
    "g_gemma_1x2": ("gemma3_4b", "mifa_array", (1, 2)),
    "h_fedar_1x2": ("granite_3_8b", "fedar", (1, 2)),
    "i_olmoe_mifa_1x2": ("olmoe_1b_7b", "mifa_array", (1, 2)),
    "i_olmoe_dense_bank_1x2": ("olmoe_1b_7b", "banked_dense", (1, 2)),
}


def fl_algo(name: str, mesh=None, cfg=None):
    from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
    from repro_torch.core import MIFA, FedAR
    return {"mifa_array": lambda: MIFA(memory="array"),
            "mifa_int8": lambda: MIFA(memory="int8"),
            "fedar": FedAR,
            "banked_dense": lambda: BankedMIFA(DenseBank(
                mesh=mesh, cfg=None if mesh is None else cfg, device="cpu")),
            "banked_paged": lambda: BankedMIFA(PagedDeviceBank(
                page_size=2, n_slots=2, device="cpu"))}[name]()


def fl_batcher(cfg):
    from repro_torch.data import TokenBatcher
    return TokenBatcher(n_clients=FN, vocab=cfg.vocab_size, seq_len=FS,
                        batch_size=FMB, k_steps=FK, stream_len=4096, seed=0)


class DriverLog:
    """Records every `ScanDriver` that `run_fl` builds and counts calls
    of `StepPlacement.whole` (params gathered whole)."""

    def __init__(self):
        from repro_torch.core import scan_engine
        from repro_torch.sharding import params as placed
        self.drivers, self.wholes = [], 0
        log, base = self, scan_engine.ScanDriver
        whole = placed.StepPlacement.whole

        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                log.drivers.append(self)

        def counted(placement, params):
            log.wholes += 1
            return whole(placement, params)
        scan_engine.ScanDriver = Recorded
        placed.StepPlacement.whole = counted


def fl_run_fl(log, cfg, params, algo, mesh=None, rounds: int = FT, **kw):
    """`run_fl(engine="scan")` of an fl case; returns (params, history,
    its ScanDriver, the calls of StepPlacement.whole it made)."""
    from repro_torch.core import run_fl
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    before = log.wholes
    params, hist = run_fl(
        model=build_model(cfg), algo=algo, batcher=fl_batcher(cfg),
        participation=bernoulli(FN), schedule=lambda t: 0.05 / (1 + t),
        n_rounds=rounds, params=tree_map(torch_clone, params),
        cohort_capacity=FN, engine="scan", scan_chunk=FCHUNK, device="cpu",
        mesh=mesh, cfg=None if mesh is None else cfg, **kw)
    return params, hist, log.drivers[-1], log.wholes - before


def torch_clone(t):
    return t.clone()


def fl_state_view(name: str, algo, state) -> dict:
    """The float state a case compares, whole: MIFA's G (int8 memory
    dequantized), FedAR's U, a bank's first N rows and G_sum."""
    from repro_torch.core import quantized_memory as qm
    from repro_torch.tree import tree_map
    if name == "mifa_array":
        return {"G": state["G"]}
    if name == "mifa_int8":
        return {"G": qm.dequantize_tree(state["G_q"], state["G_scale"])}
    if name == "fedar":
        return {"U": state["U"]}
    if name == "banked_paged":
        rows = algo.bank.gather(state["bank"], np.arange(FN))
    else:
        rows = tree_map(lambda r: r[:FN].float(), state["bank"]["rows"])
    return {"rows": rows, "g_sum": state["bank"]["g_sum"]}


def fl_case(out: dict, info: dict, case: str, log, out_dir: str,
            split_runs: dict) -> None:
    """One fl case on this world: the unsplit run and the split run
    (`run_fl(engine="scan", mesh=, cfg=)`), each rank's blocks of the
    params and its whole state against the unsplit run's; rank 0 records
    the split run gathered whole for the test's comparison with the JAX
    package."""
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.params import take_tree
    from repro_torch.tree import tree_leaves
    arch, name, shape = FL_CASES[case]
    cfg = fl_cfg(arch)
    params = build_model(cfg).init(0, device="cpu")
    mesh = make_host_mesh(*shape, device="cpu")
    want_p, want_h, want_d, _ = fl_run_fl(log, cfg, params, fl_algo(name))
    want_s = fl_state_view(name, want_d.r.algo, want_d.r.state)
    algo = fl_algo(name, mesh, cfg)
    ck = {}
    if case.startswith("f_"):
        # snapshot after round 2 on 1x2 (rank 0 writes it), then resumed
        ck_dir = os.path.join(out_dir, f"{case}_ckpt")
        fl_run_fl(log, cfg, params, fl_algo(name, mesh, cfg), mesh, rounds=2,
                  checkpoint=CheckpointSpec(every=2, dir=ck_dir))
        dist.barrier()
        if case == "f_resumed_on_1":
            mine = os.path.join(out_dir, f"{case}_ckpt_{dist.get_rank()}")
            shutil.copytree(ck_dir, mine)
            ck_dir, mesh = mine, None
        ck = {"checkpoint": CheckpointSpec(every=2, dir=ck_dir, resume=True)}
    got_p, got_h, drv, wholes = fl_run_fl(log, cfg, params, algo, mesh, **ck)
    if case == "a_mifa_1x2":
        split_runs["a"] = (got_p, got_h)
    placement = drv.placement
    split = None if placement is None else placement.split
    whole_s, whole_p = drv.whole_carry()
    got_s = fl_state_view(name, algo, whole_s)
    bound = INT8_TOL if name == "mifa_int8" else (TRTOL, TATOL)
    if mesh is None:
        # resumed on one rank: rounds 0-1 split, round 2 unsplit
        _, err = train_gap([got_p, got_s, got_h.train_loss],
                           [want_p, want_s, want_h.train_loss], *bound)
        exact = None
    else:
        ref_p = take_tree(want_p, placement.param_specs, mesh)
        _, err = train_gap([got_p, got_s, got_h.train_loss],
                           [ref_p, want_s, want_h.train_loss], *bound)
        exact = None
        if case == "f_resumed_on_1x2":
            sp, sh = split_runs["a"]
            exact = gap([got_p, got_h.train_loss], [sp, sh.train_loss])[0]
    ints = all(np.array_equal(a, b) for a, b in zip(hist_ints(got_h),
                                                    hist_ints(want_h)))
    verdicts = {"err": err, "ints": ints, "exact": exact,
                "wholes": wholes, "eager": drv.eager,
                "replays": drv.replays, "eager_rounds": drv.eager_rounds}
    if split is not None:
        verdicts.update(train_routing(
            build_model(cfg), params, split, mesh,
            {k: torch.from_numpy(v[0, 0])
             for k, v in fl_batcher(cfg).sample_round(0).items()}))
        verdicts.update(
            moved=dict(split.axis.moved),
            g_differs=any(rules.P(*s[1:]) != p for s, p in zip(
                tree_leaves(placement.state_specs),
                tree_leaves(placement.param_specs))),
            axes=sorted(rules.sharded_axes([placement.param_specs], mesh)))
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, verdicts)
    info[case] = parts
    for k, v in flat_tree({"params": whole_p, **got_s}).items():
        out[f"{case}/{k}"] = v.detach().numpy().copy()
    out[f"{case}/loss"] = np.asarray(got_h.train_loss, np.float64)
    out[f"{case}/n_active"] = np.asarray(got_h.n_active, np.float64)
    dist.barrier()


def world_of_fl(out: dict, info: dict, out_dir: str) -> None:
    import torch.distributed as dist
    world = dist.get_world_size()
    log, split_runs = DriverLog(), {}
    for case, (_, _, shape) in FL_CASES.items():
        if shape[0] * shape[1] == world:
            fl_case(out, info, case, log, out_dir, split_runs)
    dist.barrier()


# --------------------------------------------------------------------------- #
# --cases fleet: split products in fleets
# --------------------------------------------------------------------------- #

# the trials' seeds (params, generators, participation seeds 100 + s)
FLEET_SEEDS = (0, 1)
# case -> (arch, algorithm, mesh (data, model), engine, scenario): granite's
# smoke config with MIFA(array) on 1x2 on both engines and at vocab 511 (the
# head whole), on 2x2 (trials over data, products over model);
# BankedMIFA(DenseBank) and BankedMIFA(PagedDeviceBank), their rows whole on
# every rank; a Gilbert-Elliott scenario fleet; gemma3-4b's (local
# attention, vocab-split head); granite with padded heads, which the split
# leaves for later (ROADMAP entry 12f): its rounds gather the blocks whole;
# olmoe's experts over `model`
FLEET_CASES = {
    "a_mifa_1x2": ("granite_3_8b", "mifa_array", (1, 2), "scan", False),
    "a_mifa_loop_1x2": ("granite_3_8b", "mifa_array", (1, 2), "loop",
                        False),
    "a_mifa_vocab511_1x2": ("granite_3_8b_vocab511", "mifa_array", (1, 2),
                            "scan", False),
    "b_mifa_2x2": ("granite_3_8b", "mifa_array", (2, 2), "scan", False),
    "c_dense_bank_1x2": ("granite_3_8b", "banked_dense", (1, 2), "scan",
                         False),
    "d_paged_bank_1x2": ("granite_3_8b", "banked_paged", (1, 2), "scan",
                         False),
    "e_scenario_1x2": ("granite_3_8b", "mifa_array", (1, 2), "scan", True),
    "f_gemma_1x2": ("gemma3_4b", "mifa_array", (1, 2), "scan", False),
    "g_gathered_padded_1x2": ("granite_3_8b_padded", "mifa_array", (1, 2),
                              "scan", False),
    "h_olmoe_1x2": ("olmoe_1b_7b", "mifa_array", (1, 2), "scan", False),
}


def fleet_trials(scenario: bool) -> list:
    """The fleet's trials: Bernoulli availability of seed 100 + s (as
    `bernoulli`'s probabilities), or a Gilbert-Elliott scenario of it."""
    from repro_torch.core.participation import BernoulliParticipation
    from repro_torch.fleet import Trial
    from repro_torch.scenarios import GilbertElliott
    if scenario:
        return [Trial(seed=s, scenario=GilbertElliott.from_rate_and_burst(
            0.5, 2.0, n=FN, seed=100 + s)) for s in FLEET_SEEDS]
    return [Trial(seed=s, participation=BernoulliParticipation(
        np.linspace(0.4, 1.0, FN), seed=100 + s)) for s in FLEET_SEEDS]


def fleet_params(cfg):
    """The trials' params stacked (K, ...): each trial's `init(seed)`."""
    from repro_torch.models import build_model
    from repro_torch.tree import tree_stack
    return tree_stack([build_model(cfg).init(s, device="cpu")
                       for s in FLEET_SEEDS])


class FleetLog:
    """Records every `FleetRunner` and `FleetScanDriver` that `run_fleet`
    builds, and counts the params gathered whole while a local update runs
    (`sharding.params.whole` and `TrainSplit.move` inside
    `client_updates`)."""

    def __init__(self):
        from repro_torch.fleet import executor
        from repro_torch.sharding import params as placed
        from repro_torch.sharding import tensor_parallel as tp
        self.runners, self.drivers, self.in_local, self.calls = [], [], 0, 0
        self._local = False
        log = self

        class Runner(executor.FleetRunner):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                # `finalize` drops the placement once the params are whole
                self.placed_as = self.placement
                log.runners.append(self)

        class Driver(executor.FleetScanDriver):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                log.drivers.append(self)

        def local(*a, **kw):
            log._local = True
            try:
                return updates(*a, **kw)
            finally:
                log._local = False

        def counted(fn):
            def wrapped(*a, **kw):
                log.calls += 1
                log.in_local += log._local
                return fn(*a, **kw)
            return wrapped
        updates = executor.client_updates
        executor.client_updates = local
        executor.FleetRunner, executor.FleetScanDriver = Runner, Driver
        placed.whole = tp.whole = counted(placed.whole)
        tp.TrainSplit.move = counted(tp.TrainSplit.move)


def fleet_state_view(name: str, algo, state) -> dict:
    """The float state a fleet case compares, whole, (K, ...) leaves: G, or
    a bank's first N rows of every trial and G_sum."""
    from repro_torch.tree import tree_map
    if name == "mifa_array":
        return {"G": state["G"]}
    if name == "banked_paged":
        ids = np.tile(np.arange(FN), (len(FLEET_SEEDS), 1))
        rows = algo.bank.gather_fleet(state["bank"], ids)
    else:
        rows = tree_map(lambda r: r[:, :FN].float(), state["bank"]["rows"])
    return {"rows": rows, "g_sum": state["bank"]["g_sum"]}


def fleet_run(log, cfg, params, name: str, engine: str, scenario: bool,
              mesh=None) -> tuple:
    """`run_fleet` of a fleet case; returns (params, history, its runner,
    its scan driver or None, (params gathered whole or moved inside its
    local updates, and in all))."""
    from repro_torch.fleet import run_fleet
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    before, calls, n_drivers = log.in_local, log.calls, len(log.drivers)
    params, hist = run_fleet(
        model=build_model(cfg), batcher=fl_batcher(cfg),
        schedule=lambda t: 0.05 / (1 + t), n_rounds=FT,
        algo=fl_algo(name), trials=fleet_trials(scenario),
        params=tree_map(torch_clone, params), cohort_capacity=FN,
        engine=engine, scan_chunk=FCHUNK, device="cpu", mesh=mesh,
        cfg=None if mesh is None else cfg)
    drv = log.drivers[-1] if len(log.drivers) > n_drivers else None
    return (params, hist, log.runners[-1], drv,
            (log.in_local - before, log.calls - calls))


def fleet_case(out: dict, info: dict, case: str, log,
               split_runs: dict) -> None:
    """One fleet case on this world: the unsplit fleet and the split one
    (`run_fleet(mesh=, cfg=)`), the split run's whole params, state and
    history (every rank returns all K) against the unsplit run's, and the
    loop engine's split run against the scan engine's, bit for bit; rank
    0 records the split run for the test's comparison with the JAX
    package's sequential runs."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_map
    arch, name, shape, engine, scenario = FLEET_CASES[case]
    cfg = fl_cfg(arch)
    params = fleet_params(cfg)
    want_p, want_h, want_r, _, _ = fleet_run(log, cfg, params, name, engine,
                                             scenario)
    want_s = fleet_state_view(name, want_r.algo, want_r.state)
    mesh = make_host_mesh(*shape, device="cpu")
    got_p, got_h, runner, drv, (in_local, calls) = fleet_run(
        log, cfg, params, name, engine, scenario, mesh)
    if case == "a_mifa_1x2":
        split_runs["a"] = (got_p, got_h)
    exact = None
    if case == "a_mifa_loop_1x2":
        sp, sh = split_runs["a"]
        exact = gap([got_p, got_h.stacked()["train_loss"]],
                    [sp, sh.stacked()["train_loss"]])[0]
    got_s = fleet_state_view(name, runner.algo, runner.state)
    split = runner.placed_as.split
    sg, sw = got_h.stacked(), want_h.stacked()
    _, err = train_gap([got_p, got_s, sg["train_loss"]],
                       [want_p, want_s, sw["train_loss"]])
    if split is None:
        # the gathering round computes on whole params: bit-equal
        exact = gap([got_p, got_s, sg["train_loss"]],
                    [want_p, want_s, sw["train_loss"]])[0]
    verdicts = {
        "err": err, "ints": bool(np.array_equal(sg["n_active"],
                                                sw["n_active"])
                                 and np.array_equal(sg["rounds"],
                                                    sw["rounds"])),
        "in_local": in_local, "calls": calls, "exact": exact,
        "split": split is not None,
        "moved": None if split is None else dict(split.axis.moved),
        "axes": sorted(rules.sharded_axes(
            [runner.placed_as.param_specs], mesh)),
        "trials": sorted(rules.sharded_axes([rules.fleet_trial_specs(
            params, cfg, mesh)], mesh)),
        "head_split": None if split is None else split.head,
        "eager": None if drv is None else drv.eager,
        "replays": None if drv is None else drv.replays,
        "eager_rounds": None if drv is None else drv.eager_rounds}
    if split is not None:
        verdicts.update(train_routing(
            build_model(cfg), tree_map(lambda t: t[0], params), split, mesh,
            {k: torch.from_numpy(v[0, 0])
             for k, v in fl_batcher(cfg).sample_round(0).items()}))
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, verdicts)
    info[case] = parts
    for k, v in flat_tree({"params": got_p, **got_s}).items():
        out[f"{case}/{k}"] = v.detach().numpy().copy()
    out[f"{case}/loss"] = sg["train_loss"]
    out[f"{case}/n_active"] = sg["n_active"]
    dist.barrier()


def world_of_fleet(out: dict, info: dict, out_dir: str) -> None:
    import torch.distributed as dist
    world = dist.get_world_size()
    log, split_runs = FleetLog(), {}
    for case, (_, _, shape, _, _) in FLEET_CASES.items():
        if shape[0] * shape[1] == world:
            fleet_case(out, info, case, log, split_runs)
    dist.barrier()


def rank_main(rank: int, world: int, out_dir: str,
              cases: str = "paper") -> None:
    import torch
    import torch.distributed as dist
    # gloo's pairs on the loopback device; set in the rank's own process
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        out, info = {}, {}
        if cases == "params":
            world_of_params(out, info, out_dir)
        elif cases == "serve":
            world_of_serve(out, info, out_dir)
        elif cases == "train":
            world_of_train(out, info, out_dir)
        elif cases == "fl":
            world_of_fl(out, info, out_dir)
        elif cases == "fleet":
            world_of_fleet(out, info, out_dir)
        elif world == 1:
            world_of_one(out, info)
        else:
            world_of_four(out, info, out_dir)
        if rank == 0:
            np.savez(os.path.join(out_dir, "results.npz"), **out)
            with open(os.path.join(out_dir, "results.json"), "w") as f:
                json.dump(info, f)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, choices=(1, 2, 4), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", choices=("paper", "params", "serve", "train",
                                        "fl", "fleet"), default="paper")
    args = ap.parse_args()
    if args.cases == "params" and args.world != 4:
        ap.error("--cases params runs in a world of 4")
    if args.cases not in ("serve", "train", "fl", "fleet") and \
            args.world == 2:
        ap.error("a world of 2 runs --cases serve, train, fl or fleet")
    import torch.multiprocessing as mp
    mp.spawn(rank_main, args=(args.world, args.out, args.cases),
             nprocs=args.world, join=True)


if __name__ == "__main__":
    main()
