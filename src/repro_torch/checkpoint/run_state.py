"""Whole-run checkpoint/resume for `run_fl`, counterpart of
`repro/checkpoint/run_state.py`.

A snapshot is ONE atomic npz (`checkpoint.io.save_pytree`) holding what
the scan engine's trajectory depends on at a chunk boundary:

  * the carry: params, the algorithm state (a bank's pages and page table
    included, since they live in `runner.state`), the round generators and,
    for a dense algorithm under a scenario, the scenario's state and key
    (for trace replay that holds the carried window of masks);
  * a bank's host bookkeeping (`MemoryBank.host_state`: the paged bank's
    page-table mirror, LRU stamps and spilled pages);
  * the τ statistics (`TauStats`) and the `FLHistory` so far;
  * the next round, the client count and a format tag.

The port's carry is not the reference's: where the reference splits a
threefry key, a run here keeps two torch generators (`RoundRunner.rng` on
the CPU, `RoundRunner.device_rng` on the run's device), so the snapshot
holds `rng` and `device_rng` as their `get_state()` bytes. Under the scan
engine the device generator is registered with the captured round and
each replay advances its offset, which `get_state()` reads. The format tag
is therefore the port's own, "repro-torch-run-v1": each package refuses
the other's run snapshots (pytree snapshots, `checkpoint.io`, are shared).

Resume: a run restored from the snapshot after round k and continued to T
gives the params and history of the uninterrupted T-round run bit for bit.
This reduces to the scan engine's invariance to chunk cuts and to every
source of randomness being in the snapshot (the generators, the scenario's
state and key) or replayed (`fast_forward_sampler` for host samplers).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.checkpoint.io import (_BF16_KEY, bf16_tensor, load_pytree,
                                       save_pytree)

_FORMAT = "repro-torch-run-v1"
_REFERENCE_FORMAT = "repro-run-v1"
_NAME_RE = re.compile(r"^ckpt_r(\d{8})\.npz$")


@dataclass(frozen=True)
class CheckpointSpec:
    """Checkpoint request for `run_fl(checkpoint=...)`.

    Attributes:
      every: snapshot after every `every` completed rounds (the scan
        engine cuts its chunks at these rounds, as at evals).
      dir: snapshot directory; files are ``ckpt_r<round:08d>.npz``.
      keep: retain only the newest `keep` snapshots (None: keep all).
      resume: when True, `run_fl` restores the latest snapshot in `dir`
        (if any) and continues from its round instead of round 0.
    """

    every: int
    dir: str
    keep: int | None = None
    resume: bool = False

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"checkpoint every must be >= 1, "
                             f"got {self.every}")
        if self.keep is not None and self.keep < 1:
            raise ValueError(f"checkpoint keep must be >= 1, "
                             f"got {self.keep}")


def checkpoint_path(dir: str, round: int) -> str:
    """Snapshot filename for the state AFTER `round` completed rounds."""
    return os.path.join(dir, f"ckpt_r{round:08d}.npz")


def list_checkpoints(dir: str) -> list[tuple[int, str]]:
    """(round, path) for every snapshot in `dir`, oldest first."""
    if not os.path.isdir(dir):
        return []
    out = []
    for name in os.listdir(dir):
        m = _NAME_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(dir, name)))
    return sorted(out)


def latest_checkpoint(dir: str) -> str | None:
    """Path of the newest snapshot in `dir`, or None when there is none."""
    found = list_checkpoints(dir)
    return found[-1][1] if found else None


def prune_checkpoints(dir: str, keep: int) -> None:
    """Delete all but the newest `keep` snapshots in `dir`."""
    for _, path in list_checkpoints(dir)[:-keep]:
        os.unlink(path)


def _hist_to_tree(hist) -> dict:
    """FLHistory -> arrays (float64/int64, exact round-trip)."""
    return {
        "rounds": np.asarray(hist.rounds, np.int64),
        "train_loss": np.asarray(hist.train_loss, np.float64),
        "n_active": np.asarray(hist.n_active, np.float64),
        "global_updates": np.asarray(hist.global_updates, np.float64),
        "eval_rounds": np.asarray([t for t, _ in hist.eval_loss], np.int64),
        "eval_loss": np.asarray([v for _, v in hist.eval_loss], np.float64),
        "eval_acc": np.asarray([v for _, v in hist.eval_acc], np.float64),
    }


def _hist_from_tree(hist, tree: dict) -> None:
    """Restore the list fields of an FLHistory from `_hist_to_tree`."""
    hist.rounds = [int(t) for t in tree["rounds"]]
    hist.train_loss = list(map(float, tree["train_loss"]))
    hist.n_active = list(map(float, tree["n_active"]))
    hist.global_updates = list(map(float, tree["global_updates"]))
    ev_t = [int(t) for t in tree["eval_rounds"]]
    hist.eval_loss = list(zip(ev_t, map(float, tree["eval_loss"])))
    hist.eval_acc = list(zip(ev_t, map(float, tree["eval_acc"])))


def _scenario_carry(runner) -> bool:
    """Does the runner carry a scenario's state on its device (a dense
    algorithm under a scenario)?"""
    return getattr(runner, "scen_state", None) is not None


def save_run(runner, spec: CheckpointSpec, round_next: int) -> str:
    """Snapshot `runner`'s full state after `round_next` completed rounds.

    The scan engine calls it at a flushed chunk boundary (statistics and
    history current through round ``round_next - 1``), before the next
    chunk is queued: the carry's tensors are copied to the host here and
    no reference to them is kept. Atomic through `save_pytree`; prunes to
    `spec.keep` afterwards. Returns the path.
    """
    s = runner.stats
    carry = {"state": runner.state, "params": runner.params,
             "rng": runner.rng.get_state(),
             "device_rng": runner.device_rng.get_state()}
    if _scenario_carry(runner):
        carry["scen_state"] = runner.scen_state
        carry["scen_key"] = runner.scen_key
    tree = {
        "format": _FORMAT,
        "round": np.int64(round_next),
        "n_clients": np.int64(runner.n_clients),
        "carry": carry,
        "stats": {"tau": s.tau, "tau_max_per_dev": s.tau_max_per_dev,
                  "sum_tau": np.float64(s.sum_tau),
                  "sum_tau_sq": np.float64(s.sum_tau_sq),
                  "rounds": np.int64(s.rounds)},
        "hist": _hist_to_tree(runner.hist),
    }
    bank = getattr(runner.algo, "bank", None)
    if bank is not None and hasattr(bank, "host_state"):
        tree["bank"] = bank.host_state()       # {} flattens to nothing
    path = save_pytree(checkpoint_path(spec.dir, round_next), tree)
    if spec.keep is not None:
        prune_checkpoints(spec.dir, spec.keep)
    return path


def _like(template, saved, bf16: set, key: str):
    """Tensors shaped and typed as `template` (the fresh runner's) from the
    snapshot's arrays `saved`, on the template's device; raises when the
    snapshot came from another configuration."""
    def one(t, a, k):
        src = bf16_tensor(a) if k in bf16 else torch.from_numpy(
            np.asarray(a, order="C"))
        if src.dtype != t.dtype or tuple(src.shape) != tuple(t.shape):
            raise ValueError(
                f"snapshot leaf {k}: {src.dtype}{tuple(src.shape)}, the run "
                f"has {t.dtype}{tuple(t.shape)} — refusing to resume")
        return src.to(t.device)

    def walk(t, a, k):
        if isinstance(t, dict):
            return {j: walk(t[j], a[j], f"{k}/{j}") for j in t}
        if isinstance(t, list):
            return [walk(x, a[i], f"{k}/#{i}") for i, x in enumerate(t)]
        return one(t, a, k)

    return walk(template, saved, key)


def restore_run(runner, spec: CheckpointSpec) -> int:
    """Restore `runner` from the latest snapshot in `spec.dir`.

    Returns the round to resume from (0 when no snapshot exists: a fresh
    run). Raises when the snapshot is not the port's (the reference's
    "repro-run-v1" carries a threefry key, not the port's generators) or
    when its client count or leaves do not match the runner.
    """
    path = latest_checkpoint(spec.dir)
    if path is None:
        return 0
    tree = load_pytree(path, as_torch=False)
    fmt = str(np.asarray(tree["format"]))
    if fmt != _FORMAT:
        hint = (" (a run snapshot of the JAX package: its carry holds a "
                "threefry key, not the port's generators)"
                if fmt == _REFERENCE_FORMAT else "")
        raise ValueError(f"{path}: unknown snapshot format {fmt!r} "
                         f"(expected {_FORMAT!r}){hint}")
    n = int(tree["n_clients"])
    if n != runner.n_clients:
        raise ValueError(f"{path}: snapshot has {n} clients, runner has "
                         f"{runner.n_clients} — refusing to resume")
    bf16 = set(np.asarray(tree.get(_BF16_KEY, [])).tolist())
    carry = tree["carry"]
    runner.state = _like(runner.state, carry["state"], bf16, "carry/state")
    runner.params = _like(runner.params, carry["params"], bf16,
                          "carry/params")
    runner.rng.set_state(torch.from_numpy(np.asarray(carry["rng"])))
    runner.device_rng.set_state(torch.from_numpy(
        np.asarray(carry["device_rng"])))
    if "scen_state" in carry:
        if not _scenario_carry(runner):
            raise ValueError(f"{path}: snapshot carries a scenario state, "
                             "the run has none — refusing to resume")
        runner.scen_state = _like(runner.scen_state, carry["scen_state"],
                                  bf16, "carry/scen_state")
        runner.scen_key = _like(runner.scen_key, carry["scen_key"], bf16,
                                "carry/scen_key")
    st = tree["stats"]
    runner.stats.tau = np.asarray(st["tau"], np.int64)
    runner.stats.tau_max_per_dev = np.asarray(st["tau_max_per_dev"],
                                              np.int64)
    runner.stats.sum_tau = float(st["sum_tau"])
    runner.stats.sum_tau_sq = float(st["sum_tau_sq"])
    runner.stats.rounds = int(st["rounds"])
    _hist_from_tree(runner.hist, tree["hist"])
    bank = getattr(runner.algo, "bank", None)
    if bank is not None and hasattr(bank, "load_host_state"):
        bank.load_host_state(tree.get("bank", {}))
    return int(tree["round"])


def fast_forward_sampler(sampler, start_round: int) -> None:
    """Replay a host availability sampler through rounds [0, start_round).

    Snapshots do not hold host sampler state (numpy generators, Markov
    chains); on resume the stream is re-derived by sampling the skipped
    rounds, which is deterministic, so the resumed rounds see exactly the
    masks the uninterrupted run drew. Skipped for stateless scenario
    samplers (random access by construction).
    """
    from repro_torch.scenarios.base import HostSampler
    if sampler is None or start_round <= 0:
        return
    if isinstance(sampler, HostSampler) and sampler.process.stateless:
        return
    for t in range(start_round):
        sampler.sample(t)

