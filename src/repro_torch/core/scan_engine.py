"""The scan engine: T rounds in chunks, each chunk's inputs staged at once,
each round on the card a replay of one captured CUDA graph.

Counterpart of `repro/core/scan_engine.py`, which compiles the rounds of a
chunk into one `lax.scan` program. Here a chunk is:

  1. `build_xs` (host): draw the chunk's masks (τ statistics as the loop
     keeps them; a scenario run with a dense algorithm stages each round's
     index `t` instead and draws its masks in the body), assemble every
     round's inputs as the loop does
     (`RoundRunner.round_inputs` / `cohort_inputs`, host draws in round
     order; a cohort padded to the run's one width), and stage them: every
     leaf of every round goes into ONE host buffer (pinned when the run is
     on the card), which goes to the device in one asynchronous copy
     (`stage_rounds`);
  2. `pre_chunk` (host): a paged bank pages the chunk's cohort union in;
     within the chunk its page table is fixed, so the logical rows staged
     in step 1 hold for every round of the chunk;
  3. `chunk_fn`: for each round, on the card, copy its slices of the staged
     buffer into the static input buffers of the captured round (device to
     device, on the stream) and replay the graph (`CapturedRound`); on the
     CPU, call the round body on the slices. The metrics go into a (L, ...)
     buffer on the device;
  4. `flush`, one chunk late: read that buffer once and record the history
     (and, in scenario mode, merge the chunk's τ statistics).

The body is `runner.make_round_body`'s, the one the loop engine calls, so
scan runs the loop's code on the loop's inputs: on the CPU the two are
bit-equal, and on the card too as long as no op of the body changes its
result under capture (the port's kernels sum in a fixed order).

What falls back to the loop (`scan_supported`): update-clock schedules (the
host would need the device-side update counter every round) and host banks
(`Int8PagedBank`: its rows live on the host, `on_device = False`). `run_fl`
warns once and loops for these under ``engine="scan"`` and raises under
``engine="scan_strict"``. `DenseBank` and `PagedDeviceBank` (f32, bf16,
int8) ride the scan.

What a capture must not freeze, and where each went: the learning rates
are 0-d device tensors in the staged inputs (the `mifa_aggregate` kernel
reads its rate from the card); masks, cohorts, batches and host draws
(`host_draw`) are staged inputs; range and duplicate checks run in
`build_xs`; page-ins run in `pre_chunk`; int8 rounding draws from the
run's device generator, registered with the graph so each replay draws
afresh. The kernels count their launches on the host, which a replay does
not reach: `CapturedRound` records each counter's increase during capture
and adds it on every replay.

Scenario mode (a dense algorithm under `run_fl(scenario=)`): the round
body draws its mask from the scenario's device surface, keyed by the
staged round index (a captured round must not freeze a Python `t`); the
carry's state is ``{"algo", "scen_state", "scen_key", "tau", "tau_max"}``,
so the chain state and the (N,) int32 τ and running max advance in the
graph, and each round's Σ τ and Σ τ² join the chunk's metrics buffer.
After a chunk its τ vectors are copied aside (the graph keeps writing the
carry's), and the flush merges them with `TauStats.absorb_scan`: the
statistics equal the loop's, which reads every mask back.

Windowed processes (trace replay): the scenario state carries W rounds of
masks, and `pre_chunk` re-points the window at each chunk it does not
cover. The captured round reads the window at fixed addresses, so the
process writes the new rows INTO the carried tensors on the run's stream
(`TraceReplay.load_window`), queued behind the previous chunk's replays.
A chunk wider than the window raises.

Checkpoints (`run(checkpoint=)`): every `checkpoint.every` rounds is a
chunk cut and a sync round; after the chunk's flush `checkpoint.save_run`
copies the carry to the host before the next chunk is queued (the replays
overwrite the carry in place). `start_round` continues a restored run.

Meshes (`ScanDriver(mesh=, cfg=)`, from `run_fl(mesh=, cfg=)`): the carry
is placed over the mesh's axes (`sharding.params`):
  * params by `param_specs` with `cfg` (the zoo's tensor parallelism over
    `model`, fsdp over `data`); replicated without `cfg`, as the paper
    models' specs are anyway;
  * the algorithm state's client-indexed leaves (the update array,
    per-client vectors) with their client axis over the data axes and,
    with `cfg`, their param dims by `client_state_specs`
    (`params.carry_state_specs`); a `DenseBank(mesh=)` places its rows
    and G_sum itself;
  * the O(N) leaves of the scenario and the τ statistics (the chain
    state, `tau`, `tau_max`) whole on every rank: every rank draws the
    same masks for all N clients with `_threefry` and keeps the same τ
    vectors, so no collective is needed for them.
  * a `PagedDeviceBank` whole on every rank (its pool, page table and
    G_sum, as the reference holds it): every rank runs the whole round,
    so the banks stay equal across ranks. A host bank raises, as the
    reference's does; any other bank raises naming itself.
Every rank stages the same batches and trains only the clients it owns.
Where `model` splits and the config is the GQA stack (dense or MoE)
(`params.StepPlacement.split`, `sharding.tensor_parallel`) a round's
local update runs on the rank's blocks of the params (split products)
and its updates move from those blocks straight into the server step's
(the update array's or the bank rows' column blocks); for any other
config the round gathers whole params for the local update, on CPU ranks
only. The server step runs on the rank's blocks (the new params taken
back to their placement), with the client axis' reductions (the update
sums, loss, n_active) all-reduced over the data group, so every rank
holds its blocks of the same params and the same history. Between rounds
each rank holds only its blocks. `run_fl` returns each rank's blocks of
the params. A checkpoint gathers the blocks and rank 0 writes the
snapshot an unsplit run writes; a run resumed on any mesh takes its
blocks from it (`restore`). Evaluation sees whole params. At extent 1
nothing is split and no collective is issued: the run is the mesh-less
run, bit for bit, with the same kernels and the same captured round.

On the card a split run is a world of ranks on one card, gloo carrying
the CUDA tensors through the host, and gloo's collectives cannot be
captured in a CUDA graph: `ScanDriver` decides once, from the placement
(`ScanDriver.eager`: CUDA params placed over an axis of extent > 1),
that every round runs the body itself (`ChunkRunner(eager=True)`,
counted in `eager_rounds`, none in `replays`). CUDA tensors under an
axis of extent > 1 raise for everything else (`sharding.params._check`,
the ROADMAP entry named).
"""
from __future__ import annotations

import inspect
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core.runner import RoundRunner, _pow2_bucket, make_round_body
from repro_torch.core.runner import pad_cohort as runner_pad_cohort
from repro_torch.kernels.ops import launch_counters
from repro_torch.sharding.clients import (ClientShard, check_data_ranks,
                                          client_shard)
from repro_torch.sharding.params import (StepPlacement, carry_state_specs,
                                         take_tree, whole_tree)
from repro_torch.sharding.rules import (data_axis_size, mesh_shape,
                                        sharded_axes)
from repro_torch.tree import tree_leaves, tree_map

# metrics a round body reports, in the order the chunk buffer stores them
METRIC_KEYS = ("loss", "n_active", "global_updates", "tau_sum",
               "tau_sq_sum")
TAU_KEYS = ("tau_sum", "tau_sq_sum")


def scan_supported(runner: RoundRunner) -> tuple[bool, str]:
    """Can this runner's configuration run on the scan engine? (ok, why)"""
    if runner.uses_update_clock:
        return False, ("update-clock schedules read the device-side "
                       "applied-update counter between rounds; the host "
                       "cannot precompute a chunk of learning rates")
    bank = getattr(runner.algo, "bank", None)
    if runner.cohort_mode and not bank.on_device:
        # the reference's words, so run_fl(mesh=) raises its error text
        return False, (
            f"{type(bank).__name__} is host-offloaded: its rows live "
            "outside jit by design and cannot ride a scan carry; scan-"
            "capable banks are DenseBank ('dense') and PagedDeviceBank "
            "('paged_device', bounded device bytes via a jit-native page "
            "table)")
    return True, ""


def _eval_rounds(n_rounds: int, eval_every: int, has_eval: bool) -> set:
    """The rounds after which the loop engine would run eval_fn."""
    if not has_eval:
        return set()
    pts = {t for t in range(n_rounds) if t % eval_every == 0}
    pts.add(n_rounds - 1)
    return pts


def chunk_bounds(n_rounds: int, scan_chunk: int, eval_rounds: set,
                 start: int = 0) -> list[tuple[int, int]]:
    """[t0, t1) segments over rounds [start, n_rounds): cut every
    `scan_chunk` rounds AND after each eval round, so evals land exactly
    where the loop engine runs them. The grid stays anchored at round 0
    whatever `start` is."""
    if scan_chunk < 1:
        raise ValueError(f"scan_chunk must be >= 1, got {scan_chunk}")
    cuts = {start, n_rounds}
    cuts.update(range(0, n_rounds, scan_chunk))
    cuts.update(t + 1 for t in eval_rounds if t < n_rounds)
    edges = sorted(c for c in cuts if start <= c <= n_rounds)
    return list(zip(edges[:-1], edges[1:]))


def pad_cohort(ids: np.ndarray, cap: int, n_clients: int,
               round_t: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad one cohort's ids to the scan capacity: (padded, valid).

    Pad slots point at the bank's dummy row `n_clients` with valid=False,
    as `RoundRunner.step_cohort` pads them. A captured round has ONE shape,
    so a cohort overflowing `cap` raises instead of widening per round the
    way the loop engine's power-of-two buckets do.
    """
    if len(ids) > cap:
        raise ValueError(
            f"round {round_t}: cohort of {len(ids)} overflows the scan "
            f"capacity {cap}; raise cohort_capacity (a captured round "
            "cannot widen per round the way the loop engine's pow-2 "
            "buckets do)")
    return runner_pad_cohort(ids, n_clients, cap)


def run_pipelined_chunks(carry, segments, *, chunk_fn, build_xs, writeback,
                         flush, sync_rounds=frozenset(), on_sync=None,
                         pre_chunk=None):
    """Chunk execution flushed one chunk late, shared by `ScanDriver` and
    `fleet.FleetScanDriver`: the next chunk's host-side inputs are built
    while the device runs the current one.

    ``build_xs(t0, t1)`` stages a chunk's inputs; ``pre_chunk(carry) ->
    carry``, when given, runs after it (which knows the chunk's working
    set) and right before the chunk runs; ``chunk_fn(carry, xs) -> (carry,
    ys)`` runs the chunk's rounds (on the card: enqueues them);
    ``writeback(carry)`` publishes the carry to the runner; ``flush(t0, t1,
    ys, carry)`` reads the chunk's results and records history. Rounds in
    `sync_rounds` (eval rounds) flush at once and call `on_sync(t)`.
    Returns the final carry.
    """
    pending = None
    for t0, t1 in segments:
        xs = build_xs(t0, t1)
        if pending is not None:
            flush(*pending)
        if pre_chunk is not None:
            carry = pre_chunk(carry)
        carry, ys = chunk_fn(carry, xs)
        writeback(carry)
        pending = (t0, t1, ys, carry)
        if (t1 - 1) in sync_rounds:
            flush(*pending)
            pending = None
            on_sync(t1 - 1)
    if pending is not None:
        flush(*pending)
    return carry


# --------------------------------------------------------------------------- #
# staging and capture
# --------------------------------------------------------------------------- #

_ALIGN = 256


def stage_rounds(rounds: list, device: torch.device):
    """Stack L rounds' input trees (numpy leaves of one structure) into one
    host buffer and move it to `device` in one copy (asynchronous from
    pinned memory on the card). Returns the tree of (L, ...) tensors, views
    of the device buffer, and the staged byte count."""
    n_rounds = len(rounds)
    first = rounds[0]
    leaves = []                      # (numpy dtype, per-round shape)
    tree_map(lambda v: leaves.append((np.asarray(v).dtype,
                                      np.shape(v))), first)
    offsets, total = [], 0
    for dt, shape in leaves:
        offsets.append(total)
        nbytes = n_rounds * int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        total += -(-nbytes // _ALIGN) * _ALIGN
    host = torch.empty(max(total, 1), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    host_np = host.numpy()

    def view_np(i):
        dt, shape = leaves[i]
        n = n_rounds * int(np.prod(shape, dtype=np.int64))
        return host_np[offsets[i]:offsets[i] + n * dt.itemsize].view(
            dt).reshape((n_rounds,) + shape)

    dests = [view_np(i) for i in range(len(leaves))]
    for j, rd in enumerate(rounds):
        it = iter(dests)
        tree_map(lambda v: next(it).__setitem__(j, v), rd)
    dev = (host.to(device, non_blocking=True) if device.type == "cuda"
           else host)

    def view_dev(i):
        dt, shape = leaves[i]
        n = n_rounds * int(np.prod(shape, dtype=np.int64))
        tdt = torch.from_numpy(np.empty(0, dt)).dtype
        return dev[offsets[i]:offsets[i] + n * dt.itemsize].view(
            tdt).view((n_rounds,) + shape)

    it = iter(range(len(leaves)))
    return tree_map(lambda _: view_dev(next(it)), first), total


def pack_metrics(metrics: dict) -> tuple[torch.Tensor, list[str]]:
    """The round's metrics in METRIC_KEYS order as one f64 tensor
    (n_metrics, ...) (a fleet's are (K,) each), and their keys. f64 holds
    the f32 metrics exactly and the τ sums as exact integers."""
    keys = [k for k in METRIC_KEYS if k in metrics]
    return torch.stack([metrics[k].double() for k in keys]), keys


def _copy_into(static, new) -> None:
    """Write `new` into the tensors of `static` (same structure), leaf by
    leaf, skipping leaves the step already wrote in place."""
    def put(dst, src):
        if (src.data_ptr() != dst.data_ptr() or src.shape != dst.shape
                or src.stride() != dst.stride()):
            dst.copy_(src)
    tree_map(put, static, new)


def _clone(tree):
    return tree_map(lambda v: v.clone() if isinstance(v, torch.Tensor)
                    else v, tree)


class CapturedRound:
    """`body(state, params, x)` captured once as a CUDA graph.

    The graph reads the round's inputs from static buffers (`static_x`)
    and the carry from `state` and `params` themselves, and ends by writing
    the new state and params back into those tensors, so replays chain.
    Before capture the body runs once on clones of the carry on a side
    stream (lazy initialisation outside the capture); the generators in
    `generators` are restored afterwards, so the warm-up leaves the run's
    numbers alone. Its kernel launches are real and stay counted. Every
    generator the body draws from is registered with the graph. The
    launch counters are host-side, so the capture's increase of each
    (`launches`) is taken back (the capture launched nothing) and added on
    every replay. `pack` (default `pack_metrics`) turns the body's metrics
    into the one tensor (or None) and the key list a replay returns.
    """

    def __init__(self, body: Callable, state, params, x, *,
                 generators=(), pack: Callable = None):
        self.static_x = _clone(x)
        counters = launch_counters()
        saved = [g.get_state() for g in generators]
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            body(_clone(state), _clone(params), self.static_x)
        main.wait_stream(side)
        torch.cuda.synchronize()
        for g, st in zip(generators, saved):
            g.set_state(st)
        warmed = {k: fn.launches for k, fn in counters.items()}
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph):
            new_state, new_params, metrics = body(state, params,
                                                  self.static_x)
            _copy_into(state, new_state)
            _copy_into(params, new_params)
            self.metrics, self.keys = (pack or pack_metrics)(metrics)
        self._carry = _tensor_ptrs(state, params)
        self.launches = {}
        for k, fn in counters.items():
            self.launches[k] = fn.launches - warmed[k]
            fn.launches = warmed[k]    # the capture launched nothing
        self._counters = counters
        self.replays = 0

    def replay(self, state, params, x) -> torch.Tensor:
        """Run the captured round on the carry it was captured with (the
        same tensors, updated in place since) and inputs `x` (device
        tensors of `static_x`'s shapes); returns the metrics buffer it
        wrote."""
        if _tensor_ptrs(state, params) != self._carry:
            raise RuntimeError("the carry is no longer in the tensors the "
                               "round was captured with; a pre-chunk hook "
                               "must update it in place")
        _copy_into(self.static_x, x)
        self.graph.replay()
        for k, n in self.launches.items():
            self._counters[k].launches += n
        self.replays += 1
        return self.metrics


def _tensor_ptrs(state, params) -> list:
    return [v.data_ptr() for v in tree_leaves([state, params])
            if isinstance(v, torch.Tensor)]


def _signature(x) -> tuple:
    return tuple((tuple(v.shape), v.dtype) for v in tree_leaves(x))


class ChunkRunner:
    """Runs a chunk's rounds: replays of a captured round on the card (one
    graph per input shape, captured at first use), the body itself on the
    CPU. Shared by `ScanDriver` and the fleet's `FleetScanDriver`.

    `eager` (`ScanDriver`'s rule, decided once: the body issues collectives,
    which a CUDA graph cannot capture) runs the body itself on the card
    too; `eager_rounds` counts those rounds, as `replays` counts the
    captured ones."""

    def __init__(self, body: Callable, device: torch.device, *,
                 generators=(), eager: bool = False):
        self.body = body
        self.device = device
        self.generators = tuple(generators)
        self.eager = eager
        self.eager_rounds = 0
        self.graphs: dict[tuple, CapturedRound] = {}
        self.staged_bytes = 0
        self.chunks = 0
        self.keys: list[str] | None = None    # the metrics' METRIC_KEYS

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.graphs.values())

    def stage(self, rounds: list):
        xs, nbytes = stage_rounds(rounds, self.device)
        self.staged_bytes += nbytes
        self.chunks += 1
        return xs

    def run(self, state, params, xs):
        """Every round of the staged chunk `xs` in order; returns (state,
        params, (L, n_metrics, ...) f64 metrics on the device)."""
        n_rounds = tree_leaves(xs)[0].shape[0]
        ys = None
        for j in range(n_rounds):
            x = tree_map(lambda v: v[j], xs)
            if self.device.type == "cuda" and not self.eager:
                key = _signature(x)
                if key not in self.graphs:
                    self.graphs[key] = CapturedRound(
                        self.body, state, params, x,
                        generators=self.generators)
                m = self.graphs[key].replay(state, params, x)
                self.keys = self.graphs[key].keys
            else:
                state, params, metrics = self.body(state, params, x)
                m, self.keys = pack_metrics(metrics)
                self.eager_rounds += self.device.type == "cuda"
            if ys is None:
                ys = torch.empty((n_rounds,) + tuple(m.shape),
                                 dtype=torch.float64, device=m.device)
            ys[j].copy_(m)
        return state, params, ys


def runs_eager(device: torch.device, placement) -> bool:
    """The scan engine's rule for a placed carry: every round runs the body
    itself, uncaptured, where the round computes on CUDA blocks of a split
    (`params.StepPlacement.split`, a fleet's `params.FleetPlacement.split`,
    `fleet.executor.FleetScanDriver`): its rounds issue gloo collectives,
    which a CUDA graph cannot capture. Not on the CPU (nothing is
    captured there), and not where no axis of extent > 1 places the
    params (`placement` None: the captured round of the mesh-less run)."""
    return (device.type == "cuda" and placement is not None
            and placement.split is not None)


class ScanDriver:
    """Drives a `RoundRunner` through T rounds on the scan engine.

    Constructed by `run_fl(engine="scan")` after `scan_supported` says yes.
    Uses the runner's params, state and generators, so the trajectory is
    the loop engine's; the runner's state, params, history and τ
    statistics are current after `run`, and `runner.finalize()` works
    unchanged. `replays`, `eager_rounds` and `staged_bytes` count the
    captured rounds run, the rounds run eagerly on the card and the bytes
    staged. A runner with a scenario and a dense algorithm runs in
    scenario mode (module docstring). `mesh` (and `cfg`) place the carry
    (module docstring, "Meshes"); `clients` is then this rank's block of
    the client axis (None where nothing is split), `placement` the
    params' (None where they are whole) and `eager` the rule that runs
    every round uncaptured on the card.
    """

    def __init__(self, runner: RoundRunner, *, scan_chunk: int = 64,
                 mesh=None, cfg=None):
        if scan_chunk < 1:
            raise ValueError(f"scan_chunk must be >= 1, got {scan_chunk}")
        self.r = r = runner
        self.scan_chunk = scan_chunk
        self.mesh = mesh
        self.clients = self.placement = None
        if mesh is not None:
            self._place(mesh, cfg)
        if r.cohort_mode:
            # one shape for every round: unpinned runs pad to the N-client
            # bucket (the loop's per-round buckets vary)
            self.cap = r.cohort_capacity or _pow2_bucket(r.n_clients)
        self.scenario_mode = (r.scen_process is not None
                              and not r.cohort_mode)
        # a windowed scenario: the window in the carry is re-pointed by
        # `_pre_chunk`; `_seg` is the upcoming chunk, `_win_start` the
        # origin of the carried window (None: load before the first chunk,
        # also after a restore)
        self._scan_window = (r.scen_process.scan_window
                             if self.scenario_mode else None)
        if self._scan_window is not None and scan_chunk > self._scan_window:
            raise ValueError(
                f"scan_chunk={scan_chunk} exceeds the scenario's carried "
                f"availability window ({self._scan_window} rounds): a chunk "
                "must be coverable by one window. Raise the scenario's "
                "window= or lower scan_chunk")
        self._seg = None
        self._win_start = None
        body = r.body
        if self.scenario_mode or self.split:
            body = make_round_body(
                r.model, r.algo, r.batcher.k_steps, r.weight_decay,
                cohort=r.cohort_mode, rng=r.round_rng,
                scen_fn=(r.scen_process.sample_fn() if self.scenario_mode
                         else None),
                track_tau=self.scenario_mode, clients=self.clients,
                placement=self.placement)
        # the body draws from the device generator only if the algorithm
        # names it; then the graph must own it
        gens = (r.device_rng,) if r.round_rng is r.device_rng else ()
        self.chunks = ChunkRunner(body, r.device, generators=gens,
                                  eager=self.eager)
        self._union = None

    @property
    def eager(self) -> bool:
        """Does every round run the body itself on the card
        (`runs_eager`)?"""
        return runs_eager(self.r.device, self.placement)

    @property
    def replays(self) -> int:
        return self.chunks.replays

    @property
    def eager_rounds(self) -> int:
        return self.chunks.eager_rounds

    @property
    def staged_bytes(self) -> int:
        return self.chunks.staged_bytes

    @property
    def split(self) -> bool:
        """Is any leaf of the carry split over the mesh?"""
        return self.clients is not None or self.placement is not None

    def _place(self, mesh, cfg) -> None:
        """Place the runner's carry under `mesh`: set `clients` (the block
        of the client axis the round body reduces over) and `placement`
        (the params' placement), each None where nothing is split."""
        r = self.r
        if cfg is not None:
            pl = StepPlacement(r.params, cfg, mesh, r.n_clients)
            if sharded_axes([pl.param_specs, pl.step_specs], mesh):
                self.placement = pl
        if r.cohort_mode:
            from repro_torch.bank.dense import DenseBank
            from repro_torch.bank.paged_device import PagedDeviceBank
            bank = r.algo.bank
            if data_axis_size(mesh) > 1:
                if isinstance(bank, PagedDeviceBank):
                    # the whole bank on every rank (pool, page table,
                    # G_sum), as the reference holds it: every rank runs
                    # the whole round, so the banks stay equal
                    check_data_ranks(mesh, r.device,
                                     what="a PagedDeviceBank's round")
                elif not isinstance(bank, DenseBank):
                    raise NotImplementedError(
                        f"{type(bank).__name__} under data ranks: "
                        "DenseBank(mesh=) shards its rows and "
                        "PagedDeviceBank is held whole on every rank; no "
                        "other bank runs under a mesh of data extent > 1")
                elif bank.mesh is None:
                    raise ValueError(
                        "the DenseBank was laid out without the mesh: build "
                        "it with DenseBank(mesh=) or let run_fl(mesh=) pass "
                        "its mesh to it")
                else:
                    self.clients = bank.shard
        else:
            self._state_specs = carry_state_specs(r.state, r.params, cfg,
                                                  mesh, r.n_clients)
            shard = client_shard(mesh, r.n_clients, r.device)
            if shard is None and self.placement is not None:
                shard = ClientShard(r.n_clients, 0, r.n_clients, None)
            if shard is not None and "clients" not in inspect.signature(
                    r.algo.round_step).parameters:
                raise NotImplementedError(
                    f"{type(r.algo).__name__}.round_step takes no clients=: "
                    "its client axis cannot be split over data ranks")
            if shard is not None and self.placement is not None:
                shard.specs, shard.mesh = self.placement.state_specs, mesh
            self.clients = shard
        # a DenseBank placed its rows when the runner initialised it
        self._put_carry(r.state, r.params, bank=False)

    @property
    def _bank_placed(self) -> bool:
        return getattr(self.r.algo.bank, "mesh", None) is not None

    def _put_carry(self, state, params, bank: bool = True) -> None:
        """The runner's carry as this rank's blocks of whole `state` and
        `params` (a bank's state with `bank`; the bank places it)."""
        r = self.r
        if r.cohort_mode:
            if bank and self._bank_placed:
                state = {**state,
                         "bank": r.algo.bank.place_state(state["bank"])}
        elif self.clients is not None:
            state = take_tree(state, self._state_specs, self.mesh,
                              "the client state", self.eager)
        if self.placement is not None:
            params = self.placement.place(params)
        r.state, r.params = state, params

    def whole_carry(self) -> tuple:
        """(state, params) of the runner, whole on every rank."""
        r = self.r
        state, params = r.state, r.params
        if r.cohort_mode:
            if self._bank_placed:
                state = {**state,
                         "bank": r.algo.bank.gather_state(state["bank"])}
        elif self.clients is not None:
            state = whole_tree(state, self._state_specs, self.mesh,
                               "the client state", self.eager)
        if self.placement is not None:
            params = self.placement.whole(params)
        return state, params

    def restore(self, checkpoint) -> int:
        """`checkpoint.restore_run` into the placed carry: the snapshot is
        the whole run's, and each rank takes its blocks from it. Returns
        the round to resume from."""
        from repro_torch.checkpoint.run_state import restore_run
        r = self.r
        if not self.split:
            return restore_run(r, checkpoint)
        r.state, r.params = self.whole_carry()
        start = restore_run(r, checkpoint)
        self._put_carry(r.state, r.params)
        return start

    def _save(self, checkpoint, round_next: int) -> None:
        """Snapshot the run: under a mesh of more than one rank every
        rank's blocks are gathered (where the carry is split) and rank 0
        writes the whole run's file."""
        from repro_torch.checkpoint.run_state import save_run
        r = self.r
        ranks = (1 if self.mesh is None
                 else math.prod(mesh_shape(self.mesh).values()))
        if ranks == 1:
            save_run(r, checkpoint, round_next)
            return
        import torch.distributed as dist
        placed = r.state, r.params
        r.state, r.params = self.whole_carry()
        try:
            if dist.get_rank() == 0:
                save_run(r, checkpoint, round_next)
        finally:
            r.state, r.params = placed
        dist.barrier()

    def _build_xs(self, t0: int, t1: int, participation):
        r = self.r
        self._seg = (t0, t1)
        if self.scenario_mode:
            return self.chunks.stage([r.round_inputs(t, None)
                                      for t in range(t0, t1)])
        if participation is None:
            participation = r._scen_sampler
        rounds, union = [], []
        for t in range(t0, t1):
            mask = np.asarray(participation.sample(t), bool)
            r.stats.update(mask)
            if not r.cohort_mode:
                rounds.append(r.round_inputs(t, mask))
                continue
            padded, valid = pad_cohort(np.flatnonzero(mask), self.cap,
                                       r.n_clients, t)
            rounds.append(r.cohort_inputs(t, padded, valid))
            union.append(padded[valid])
        if r.cohort_mode:
            self._union = np.concatenate(union)
        return self.chunks.stage(rounds)

    def _pre_chunk(self, carry):
        """Between chunks, on the host: page the chunk's cohort union in
        (identity for a dense bank; raises when it overflows the slots), or
        re-point a windowed scenario's carried window at the chunk, in
        place. Neither reads the carry back."""
        state, params = carry
        if self.r.cohort_mode:
            return self.r.algo.prepare_cohort(state, self._union), params
        w, (t0, t1) = self._scan_window, self._seg
        if (self._win_start is None or not self._win_start <= t0
                or t1 > self._win_start + w):
            self.r.scen_process.load_window(state["scen_state"], t0)
            self._win_start = self.r._scen_win_start = t0
        return carry

    def _init_carry(self):
        r = self.r
        if not self.scenario_mode:
            return r.state, r.params

        def vec(v):
            return torch.as_tensor(v, dtype=torch.int32).to(r.device)

        return ({**r.scenario_carry(), "tau": vec(r.stats.tau),
                 "tau_max": vec(r.stats.tau_max_per_dev)}, r.params)

    def _chunk_fn(self, carry, xs):
        state, params, ys = self.chunks.run(*carry, xs)
        if self.scenario_mode:
            # the chunk's τ vectors, copied before the next chunk's graph
            # replays write the carry's again
            ys = (ys, torch.stack([state["tau"], state["tau_max"]]))
        return (state, params), ys

    def _writeback(self, carry) -> None:
        state, self.r.params = carry
        if self.scenario_mode:
            self.r.state = state["algo"]
            self.r.scen_state = state["scen_state"]
        else:
            self.r.state = state

    def _flush(self, t0: int, t1: int, ys, carry) -> None:
        """Record the chunk's rounds from its metrics buffer: one read (and
        one of the τ vectors in scenario mode)."""
        keys = self.chunks.keys
        if self.scenario_mode:
            ys, taus = ys
            taus = taus.cpu().numpy()
        vals = ys.cpu().numpy()
        if self.scenario_mode:
            self.r.stats.absorb_scan(
                taus[0], taus[1], vals[:, keys.index("tau_sum")],
                vals[:, keys.index("tau_sq_sum")])
        for j, t in enumerate(range(t0, t1)):
            self.r.hist.record_round(
                t, {k: vals[j, i] for i, k in enumerate(keys)
                    if k not in TAU_KEYS})

    def run(self, n_rounds: int, *, participation=None,
            eval_fn: Callable | None = None, eval_every: int = 10,
            verbose: bool = False, checkpoint=None,
            start_round: int = 0) -> None:
        """Rounds [start_round, n_rounds), the runner updated in place.
        Without `participation` the runner's scenario draws the masks;
        `verbose` prints a line at each eval.
        `checkpoint` (a `checkpoint.CheckpointSpec`) snapshots the run
        after every `checkpoint.every` rounds, once the chunk is flushed;
        `start_round` > 0 continues a run `run_fl` restored."""
        r = self.r
        if participation is None and r.scen_process is None:
            raise ValueError("ScanDriver.run needs participation= or a "
                             "runner constructed with scenario=")
        if eval_fn is not None and self.placement is not None:
            placement, inner = self.placement, eval_fn

            def eval_fn(params):
                return inner(placement.whole(params))
        evals = _eval_rounds(n_rounds, eval_every, eval_fn is not None)
        ckpts = set()
        if checkpoint is not None:
            ckpts = {t for t in range(start_round, n_rounds)
                     if (t + 1) % checkpoint.every == 0}

        def on_sync(t):
            if t in evals:
                el, ea = r.evaluate(t, eval_fn)
                if verbose:
                    print(f"  round {t:5d} "
                          f"train={r.hist.train_loss[-1]:.4f} "
                          f"eval={el:.4f} acc={ea:.4f} "
                          f"active={int(r.hist.n_active[-1])}")
            if t in ckpts:
                self._save(checkpoint, t + 1)

        run_pipelined_chunks(
            self._init_carry(),
            chunk_bounds(n_rounds, self.scan_chunk, evals | ckpts,
                         start=start_round),
            chunk_fn=self._chunk_fn,
            build_xs=lambda t0, t1: self._build_xs(t0, t1, participation),
            writeback=self._writeback, flush=self._flush,
            sync_rounds=evals | ckpts, on_sync=on_sync,
            pre_chunk=(self._pre_chunk
                       if r.cohort_mode or self._scan_window is not None
                       else None))
