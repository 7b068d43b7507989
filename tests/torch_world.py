"""A world of CPU ranks that runs the port's meshed cases and writes what
`tests/test_torch_sharded_scan.py` compares.

    python tests/torch_world.py --world 1|4 --out DIR

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

The problem is `tests/test_sharded_scan.py`'s: N = 8 label-skewed clients
of paper_logistic, T = 9 rounds under Gilbert–Elliott availability (rate
0.5, bursts of 3), cohorts pinned to 8, scan chunks of 4.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

N, T, CHUNK = 8, 9, 4
ALGOS = ("mifa_array", "banked_dense", "fedavg")
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
    from repro_torch.bank import BankedMIFA, DenseBank
    from repro_torch.core import MIFA, BiasedFedAvg
    return {"mifa_array": lambda: MIFA(memory="array"),
            "banked_dense": lambda: BankedMIFA(DenseBank(device="cpu")),
            "fedavg": BiasedFedAvg}[name]()


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


def world_of_four(out: dict, info: dict) -> None:
    import torch
    from repro_torch.bank import BankedMIFA, DenseBank
    from repro_torch.core import MIFA, run_fl
    from repro_torch.fleet import Trial, run_fleet
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import P, placements
    model, batcher = problem()
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


def rank_main(rank: int, world: int, out_dir: str) -> None:
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
        (world_of_one if world == 1 else world_of_four)(out, info)
        if rank == 0:
            np.savez(os.path.join(out_dir, "results.npz"), **out)
            with open(os.path.join(out_dir, "results.json"), "w") as f:
                json.dump(info, f)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, choices=(1, 4), required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch.multiprocessing as mp
    mp.spawn(rank_main, args=(args.world, args.out), nprocs=args.world,
             join=True)


if __name__ == "__main__":
    main()
