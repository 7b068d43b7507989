"""Compiled runtime simulator: the heap engine's semantics as device work,
each simulated round on the card a replay of captured CUDA graphs.

Counterpart of `repro/sim/compiled.py`, which lifts the whole per-round
event flow into a `lax.scan` body. Here the flow is split into two device
functions over one carry (`make_sim_scan_body`):

  (a) `fill` — one epoch's availability draw: read `e_next` (a 0-d device
      tensor, or (K,) in a fleet), draw that epoch's mask from the
      scenario's device surface, write row ``e_next % (W+1)`` of the
      rolling (W+1, N) epoch window (W = `SimConfig.max_lookahead_epochs`)
      with a device-indexed scatter, advance `e_next`. A fleet lane draws
      only while its own ``e_next <= k0 + W`` (`torch.where` on its row,
      its chain state and its `e_next`).
  (b) `body` — the rest of the round: each device's dispatch start (now if
      available, else the start of its first active epoch in (k0, k0+W],
      one argmax over a uint8 view of the window, else inf), the round's
      RTTs (`sim.latency` device surface), the cohort and the close
      (`sim.policies.unified_select` / `unified_resolve`), the runner's
      round body with the applied mask (the staleness weights for a
      weight-aware algorithm), τ, and the next round's k0.

The reference fills the window with a `lax.while_loop` whose trip count
depends on the simulated clock, a device value; a CUDA graph cannot hold
a loop of data-dependent length, and nothing bounds how many epochs one
round may advance. So before each round the driver reads the round's k0
back (one small copy and one sync a round) and replays (a) ``k0 + W + 1 -
e_next`` times (W + 1 in round 0; the most over the lanes in a fleet),
then (b). Each epoch is drawn exactly once, in order, as the heap
engine's lazy epoch cache draws it, so the masks are the same.

Simulated time is f32 with the heap engine's op order: k0 is
``floor(now / epoch_s)`` with a 0-d tensor divisor (CUDA turns division
by a Python float into a multiply by its rounded reciprocal),
``next_epoch * epoch_s``, ``start + rtt``, ``close + overhead``. Close
times, masks, counters and τ are bit-equal to the heap engine's, and the
losses too wherever the round body is (`tests/test_torch_sim_compiled.py`,
`chip_smoke.py`). What a capture would freeze is staged per round (the
round index ``t``, both rates, the batch, any host draw).

On the card each function is captured once (`core.scan_engine.
CapturedRound`, which counts kernel launches per replay) and replayed; on
the CPU the driver calls the same functions eagerly. Chunks of rounds are
staged to the device in one copy and flushed one chunk late
(`run_pipelined_chunks`), as the scan engine does.

Carry: ``{"algo", "now", "k0", "e_next", "win", "scen_state",
"scen_key", "lat_state", "lat_key", "pp", "pstate", "tau", "tau_max"}``;
in a fleet every leaf has a leading (K,) axis.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core.runner import RoundRunner
from repro_torch.core.scan_engine import (CapturedRound, _eval_rounds,
                                          chunk_bounds, run_pipelined_chunks,
                                          stage_rounds)
from repro_torch.sim.engine import SimConfig
from repro_torch.sim.policies import (init_policy_state, policy_params,
                                      unified_resolve, unified_select)
from repro_torch.tree import tree_leaves, tree_map

# epoch windows larger than this many bools would dominate device memory
# (the window is per fleet lane); sized so W=512 still fits N=10^5
MAX_WINDOW_ELEMS = 1 << 26

# the scalar metrics of a simulated round, in the order the packed buffer
# holds them, then (under emit_masks) the cohort, applied and weights
# vectors
SIM_KEYS = ("loss", "n_active", "global_updates", "t_open", "t_close",
            "n_dispatched", "n_applied", "n_late", "n_never", "tau_sum",
            "tau_sq_sum")
MASK_KEYS = ("cohort", "applied", "weights")


@dataclass(frozen=True)
class SimSpec:
    """Simulation request for `run_fl(sim=...)`: the server `policy`, the
    `latency` model, and the temporal `config` (epoch length, server
    overhead, lookahead horizon). The compiled engine serves it when
    `sim_scan_supported` says yes; otherwise the heap engine does."""

    policy: object
    latency: object
    config: SimConfig = field(default_factory=SimConfig)


def sim_scan_supported(runner: RoundRunner, sim: SimSpec) -> tuple[bool, str]:
    """Can this (runner, sim) pair run on the compiled simulator? (ok,
    why). The blockers are the scan engine's plus the simulator's own:
    availability from a scenario (a device surface), latency and policy
    with device surfaces (`sample_fn`, `unified`), a window that fits."""
    if runner.scen_process is None:
        return False, ("the compiled simulator samples availability inside "
                       "the round; pass scenario= (host participation "
                       "processes have no device surface)")
    if getattr(runner.scen_process, "scan_window", None) is not None:
        return False, ("windowed scenarios (trace replay) page their "
                       "availability window in between chunks, but the "
                       "compiled simulator draws whole epochs on the device "
                       "with no host hook at epoch granularity")
    if runner.cohort_mode:
        return False, ("cohort-based algorithms assemble compact batches on "
                       "the host per round; the simulated clock cannot ride "
                       "their captured round")
    if runner.uses_update_clock:
        return False, ("update-clock schedules read the device-side "
                       "applied-update counter between rounds; the host "
                       "cannot precompute a chunk of learning rates")
    if not hasattr(sim.latency, "sample_fn"):
        return False, (f"{type(sim.latency).__name__} has no sample_fn "
                       "device surface; only host sampling is possible")
    if not hasattr(sim.policy, "unified"):
        return False, (f"{type(sim.policy).__name__} has no unified() "
                       "parametric form; only the heap engine can drive it")
    w = sim.config.max_lookahead_epochs
    if (w + 1) * runner.n_clients > MAX_WINDOW_ELEMS:
        return False, (
            f"the ({w + 1}, {runner.n_clients}) availability epoch window "
            f"exceeds {MAX_WINDOW_ELEMS} elements; lower "
            "SimConfig.max_lookahead_epochs for compiled runs")
    return True, ""


def _lanes(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-lane value x (…,) reshaped to broadcast against `like`."""
    return x.reshape(tuple(x.shape) + (1,) * (like.ndim - x.ndim))


def _rows(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` (…, R) of the window (…, W+1, N): (…, R, N)."""
    n = win.shape[-1]
    return torch.take_along_dim(
        win, idx.unsqueeze(-1).expand(tuple(idx.shape) + (n,)), dim=-2)


def make_sim_scan_body(round_body: Callable, scen_fn: Callable,
                       lat_fn: Callable, config: SimConfig, *,
                       weight_aware: bool, emit_masks: bool = False,
                       batch_fn: Callable | None = None
                       ) -> tuple[Callable, Callable]:
    """The simulator's two device functions, ``fill`` and ``body``, each
    ``(carry, params, x) -> (carry, params, metrics)`` (module docstring).

    `round_body` is the runner's dense body (`core.runner.
    make_round_body`, or `fleet.executor.make_fleet_body` for a fleet);
    `scen_fn` and `lat_fn` the scenario's and the latency model's device
    surfaces. `body`'s x carries ``t`` (0-d or (K,) int64), ``eta_loc``,
    ``eta_srv``, any host ``draw`` and ``batch`` unless `batch_fn(t)`
    draws it on the device (`data.pipeline.JitProceduralBatcher`). Its
    metrics are the round's plus ``t_open``, ``t_close``,
    ``n_dispatched``, ``n_applied``, ``n_late``, ``n_never``, ``tau_sum``,
    ``tau_sq_sum`` (and the ``cohort``, ``applied`` and ``weights``
    vectors under `emit_masks`).
    """
    w = config.max_lookahead_epochs

    def consts(ref: torch.Tensor):
        # 0-d fills, not copies from the host: they run inside a capture
        f32 = dict(dtype=torch.float32, device=ref.device)
        return (torch.full((), float(np.float32(config.epoch_s)), **f32),
                torch.full((), float(np.float32(config.server_overhead_s)),
                           **f32))

    def fill(carry, params, x):
        e, win = carry["e_next"], carry["win"]
        draw = e <= carry["k0"] + w
        mask, drawn = scen_fn(carry["scen_key"], e, carry["scen_state"])
        idx = (e % (w + 1)).unsqueeze(-1)                     # (…, 1)
        old = _rows(win, idx)
        win.scatter_(-2, idx.unsqueeze(-1).expand_as(old),
                     torch.where(_lanes(draw, old), mask.unsqueeze(-2), old))
        scen_state = {k: torch.where(_lanes(draw, v), drawn[k], v)
                      for k, v in carry["scen_state"].items()}
        return ({**carry, "scen_state": scen_state,
                 "e_next": e + draw.long()}, params, {})

    def body(carry, params, x):
        epoch_s, overhead_s = consts(carry["now"])
        inf = torch.full((), float("inf"), dtype=torch.float32,
                         device=epoch_s.device)
        now, win = carry["now"], carry["win"]
        k0 = torch.floor(now / epoch_s).long()
        # dispatch starts: now if available now, else the start of the
        # device's first active epoch in (k0, k0+W], else inf (never)
        avail_now = _rows(win, (k0 % (w + 1)).unsqueeze(-1)).squeeze(-2)
        ahead = torch.arange(1, w + 1, device=now.device)
        future = _rows(win, (k0.unsqueeze(-1) + ahead) % (w + 1))
        returns = future.any(-2)
        next_epoch = k0.unsqueeze(-1) + 1 + future.view(torch.uint8).argmax(
            -2)
        starts = torch.where(avail_now, now.unsqueeze(-1),
                             torch.where(returns,
                                         next_epoch.float() * epoch_s, inf))
        t = x["t"]
        rtt = lat_fn(carry["lat_key"], t, carry["lat_state"])
        cohort = unified_select(t, carry["pp"], carry["pstate"])
        arrivals = torch.where(cohort, starts + rtt, inf)
        close, applied, weights, pstate, info = unified_resolve(
            carry["pp"], carry["pstate"], cohort, avail_now, arrivals, now,
            epoch_s, t)
        rx = {k: v for k, v in x.items() if k != "t"}
        if batch_fn is not None:
            rx["batch"] = batch_fn(t.reshape(-1)[0])
        rx["active"] = weights if weight_aware else applied
        algo, params, metrics = round_body(carry["algo"], params, rx)
        tau = torch.where(applied, 0, carry["tau"] + 1)
        new_now = close + overhead_s
        tau64 = tau.long()
        out = {**carry, "algo": algo, "now": new_now,
               "k0": torch.floor(new_now / epoch_s).long(), "pstate": pstate,
               "tau": tau, "tau_max": torch.maximum(carry["tau_max"], tau)}
        # t_open is copied: a captured round writes the new clock into the
        # carry's `now` before the metrics are packed
        ys = {**metrics, "t_open": now.clone(), "t_close": close,
              "n_dispatched": cohort.sum(-1), "n_applied": applied.sum(-1),
              "n_late": info["n_late"], "n_never": info["n_never"],
              "tau_sum": tau64.sum(-1), "tau_sq_sum": (tau64 * tau64).sum(-1)}
        if emit_masks:
            ys.update(cohort=cohort, applied=applied, weights=weights)
        return out, params, ys

    return fill, body


def pack_sim_metrics(metrics: dict) -> tuple[torch.Tensor, list[str]]:
    """A simulated round's metrics as one f64 tensor: the scalars of
    SIM_KEYS present, then the MASK_KEYS vectors flattened, (S [+ 3N],
    …); f64 holds the f32 times and the integer counts exactly."""
    keys = [k for k in SIM_KEYS if k in metrics]
    parts = [torch.stack([metrics[k].double() for k in keys])]
    if "cohort" in metrics:
        masks = torch.stack([metrics[k].double() for k in MASK_KEYS])
        masks = masks.movedim(-1, 1)               # (3, N, …)
        parts.append(masks.reshape((-1,) + tuple(masks.shape[2:])))
    return torch.cat(parts), keys


def _no_metrics(metrics: dict):
    return None, []


class SimChunkRunner:
    """Runs a chunk of simulated rounds: before each round the (a) fills
    the lanes' clocks call for, then (b); on the card replays of the two
    captured graphs, on the CPU the functions themselves. Keeps the host
    mirrors of `e_next` and `k0` (read back once a round) and counts the
    fills, the replays and the seconds spent waiting on the read."""

    def __init__(self, fill: Callable, body: Callable, device: torch.device,
                 window: int, lanes: tuple = (), *, generators=()):
        self.fns = {"fill": fill, "body": body}
        self.device = device
        self.window = window
        self.generators = tuple(generators)
        self.graphs: dict[str, CapturedRound] = {}
        self.e_next = np.zeros(lanes, np.int64)
        self.k0 = np.zeros(lanes, np.int64)
        self.fills = 0
        self.syncs = 0
        self.sync_s = 0.0
        self.keys: list[str] | None = None

    @property
    def replays(self) -> dict:
        return {k: g.replays for k, g in self.graphs.items()}

    def stage(self, rounds: list):
        return stage_rounds(rounds, self.device)[0]

    def _call(self, name: str, carry, params, x):
        fn = self.fns[name]
        pack = pack_sim_metrics if name == "body" else _no_metrics
        if self.device.type != "cuda":
            carry, params, metrics = fn(carry, params, x)
            m, keys = pack(metrics)
        else:
            if name not in self.graphs:
                self.graphs[name] = CapturedRound(
                    fn, carry, params, x, generators=self.generators,
                    pack=pack)
            graph = self.graphs[name]
            m, keys = graph.replay(carry, params, x), graph.keys
        if name == "body":
            self.keys = keys
        return carry, params, m

    def run(self, carry, params, xs):
        """Every round of the staged chunk `xs` in order; returns (carry,
        params, (L, S [+ 3N], …) f64 metrics on the device)."""
        n_rounds = tree_leaves(xs)[0].shape[0]
        ys = None
        for j in range(n_rounds):
            n_fill = int(np.max(self.k0 + self.window + 1 - self.e_next))
            for _ in range(n_fill):
                carry, params, _ = self._call("fill", carry, params, {})
            self.fills += max(n_fill, 0)
            self.e_next = np.maximum(self.e_next, self.k0 + self.window + 1)
            carry, params, m = self._call(
                "body", carry, params, tree_map(lambda v: v[j], xs))
            if ys is None:
                ys = torch.empty((n_rounds,) + tuple(m.shape),
                                 dtype=torch.float64, device=m.device)
            ys[j].copy_(m)
            t0 = time.perf_counter()
            self.k0 = carry["k0"].cpu().numpy()
            self.sync_s += time.perf_counter() - t0
            self.syncs += 1
        return carry, params, ys


def unpack_sim_metrics(vals: np.ndarray, keys: list[str]) -> dict:
    """A flushed chunk (L, S [+ 3N], …) as {key: (L, …)}, the mask
    vectors as (L, …, N)."""
    out = {k: vals[:, i] for i, k in enumerate(keys)}
    rest = vals[:, len(keys):]
    if rest.shape[1]:
        n = rest.shape[1] // len(MASK_KEYS)
        rest = rest.reshape((rest.shape[0], len(MASK_KEYS), n)
                            + rest.shape[2:])
        for i, k in enumerate(MASK_KEYS):
            v = np.moveaxis(rest[:, i], 1, -1)     # (L, …, N)
            out[k] = v if k == "weights" else v.astype(bool)
    return out


def init_sim_carry(runner: RoundRunner, sim: SimSpec) -> dict:
    """The simulator's carry from a freshly constructed runner: the
    algorithm state, the clock (now = 0, k0 = 0), an empty epoch window,
    the scenario and latency streams and parameters, the policy's params
    and state, and τ counters, all on the runner's device."""
    r = runner
    dev = r.device
    n = r.n_clients
    w = sim.config.max_lookahead_epochs

    def vec(v):
        return torch.as_tensor(np.asarray(v), dtype=torch.int32).to(dev)

    return {"algo": r.state,
            "now": torch.zeros((), dtype=torch.float32, device=dev),
            "k0": torch.zeros((), dtype=torch.int64, device=dev),
            "e_next": torch.zeros((), dtype=torch.int64, device=dev),
            "win": torch.zeros((w + 1, n), dtype=torch.bool, device=dev),
            "scen_state": r.scen_state, "scen_key": r.scen_key,
            "lat_state": sim.latency.init_state(dev),
            "lat_key": sim.latency.key.to(dev),
            "pp": policy_params(sim.policy, n, dev),
            "pstate": init_policy_state(n, dev),
            "tau": vec(r.stats.tau), "tau_max": vec(r.stats.tau_max_per_dev)}


def round_record(t: int, y: dict, j: int, lane=()) -> dict:
    """The heap engine's per-round record from flushed metrics (row j,
    fleet lane `lane`)."""
    def v(k):
        return y[k][(j,) + lane]
    return {"round": t, "t_open": float(v("t_open")),
            "t_close": float(v("t_close")),
            "duration_s": float(np.float32(v("t_close"))
                                - np.float32(v("t_open"))),
            "n_dispatched": int(v("n_dispatched")),
            "n_applied": int(v("n_applied")), "n_late": int(v("n_late")),
            "n_never": int(v("n_never")), "train_loss": float(v("loss"))}


class SimScanDriver:
    """Drives a `RoundRunner` through T simulated rounds on the compiled
    simulator, the counterpart of the heap engine `sim.engine.FedSimEngine`.

    Constructed by `run_fl(sim=..., engine="scan")` after
    `sim_scan_supported` says yes. Chunks snap to eval rounds as the scan
    engine's do; history and τ statistics are written back, so
    `runner.finalize()` works unchanged, every round stamped in simulated
    seconds and evals stamped at close + server overhead, as the heap
    engine stamps them. `round_log` collects the heap engine's per-round
    records; with `emit_masks`, `applied_log` and `cohort_log` the
    vectors. `chunks` counts fills, replays and the per-round sync.
    """

    def __init__(self, runner: RoundRunner, sim: SimSpec, *,
                 scan_chunk: int = 64, emit_masks: bool = False):
        if scan_chunk < 1:
            raise ValueError(f"scan_chunk must be >= 1, got {scan_chunk}")
        self.r = r = runner
        self.sim = sim
        self.scan_chunk = scan_chunk
        self.emit_masks = emit_masks
        self.round_log: list[dict] = []
        self.applied_log: list[np.ndarray] = []
        self.cohort_log: list[np.ndarray] = []
        fill, body = make_sim_scan_body(
            r.body, r.scen_process.sample_fn(), sim.latency.sample_fn(),
            sim.config, weight_aware=getattr(r.algo, "weight_aware", False),
            emit_masks=emit_masks)
        gens = (r.device_rng,) if r.round_rng is r.device_rng else ()
        self.chunks = SimChunkRunner(fill, body, r.device,
                                     sim.config.max_lookahead_epochs,
                                     generators=gens)

    def _build_xs(self, t0: int, t1: int):
        return self.chunks.stage([self.r.round_inputs(t, None)
                                  for t in range(t0, t1)])

    def _chunk_fn(self, carry, xs):
        carry, params, ys = self.chunks.run(*carry, xs)
        # the chunk's τ vectors, copied before the next chunk's replays
        # write the carry's again
        return (carry, params), (ys, torch.stack([carry["tau"],
                                                  carry["tau_max"]]))

    def _writeback(self, carry) -> None:
        c, self.r.params = carry
        self.r.state, self.r.scen_state = c["algo"], c["scen_state"]

    def _flush(self, t0: int, t1: int, ys, carry) -> None:
        ys, taus = ys
        taus = taus.cpu().numpy()
        y = unpack_sim_metrics(ys.cpu().numpy(), self.chunks.keys)
        self.r.stats.absorb_scan(taus[0], taus[1], y["tau_sum"],
                                 y["tau_sq_sum"])
        for j, t in enumerate(range(t0, t1)):
            self.r.hist.record_round(
                t, {k: y[k][j] for k in ("loss", "n_active",
                                         "global_updates") if k in y},
                sim_time=y["t_close"][j])
            self.round_log.append(round_record(t, y, j))
            if self.emit_masks:
                self.applied_log.append(y["applied"][j])
                self.cohort_log.append(y["cohort"][j])

    def run(self, n_rounds: int, *, eval_fn: Callable | None = None,
            eval_every: int = 10, verbose: bool = False) -> None:
        """Simulate rounds [0, n_rounds), the runner updated in place;
        evals at the heap engine's cadence, stamped at close + overhead
        (a line printed at each under `verbose`)."""
        r = self.r
        overhead = np.float32(self.sim.config.server_overhead_s)
        evals = _eval_rounds(n_rounds, eval_every, eval_fn is not None)

        def on_sync(t):
            sim_t = float(np.float32(r.hist.sim_seconds[-1]) + overhead)
            el, ea = r.evaluate(t, eval_fn, sim_time=sim_t)
            if verbose:
                print(f"  round {t:5d} sim_t={sim_t:10.2f}s "
                      f"train={r.hist.train_loss[-1]:.4f} eval={el:.4f} "
                      f"acc={ea:.4f}")

        run_pipelined_chunks(
            (init_sim_carry(r, self.sim), r.params),
            chunk_bounds(n_rounds, self.scan_chunk, evals),
            chunk_fn=self._chunk_fn, build_xs=self._build_xs,
            writeback=self._writeback, flush=self._flush,
            sync_rounds=evals, on_sync=on_sync)


def run_sim_scan(runner: RoundRunner, sim: SimSpec, n_rounds: int, *,
                 scan_chunk: int = 64, eval_fn: Callable | None = None,
                 eval_every: int = 10, verbose: bool = False):
    """Drive `runner` through the compiled simulator and return `(params,
    FLHistory)`: the `run_fl(sim=...)` fast path, callable directly with
    a constructed runner."""
    t0 = time.time()
    SimScanDriver(runner, sim, scan_chunk=scan_chunk).run(
        n_rounds, eval_fn=eval_fn, eval_every=eval_every, verbose=verbose)
    runner.hist.wall_time = time.time() - t0
    return runner.finalize()
