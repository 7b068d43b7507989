"""Trace replay: recorded device traces streamed from disk in windows, so
a (T, N) mask matrix is never materialised. Counterpart of
`repro/scenarios/trace_replay.py`, with the same file format and names.

The paper's regime is *arbitrary* unavailability, and a recorded trace is
the one non-synthetic availability the system has:

  * **Trace file format v1** (`write_trace` / `open_trace`): a ``.npy``
    payload of bit-packed masks (uint8, shape (T, ⌈N/8⌉), `np.packbits`
    along the client axis) plus a ``.json`` sidecar
    ``{"format": "repro-trace-v1", "n_clients": N, "n_rounds": T}``. The
    payload is read through a memmap: opening costs O(1), reading rounds
    [t0, t0+L) O(L·N/8) bytes; `write_trace` takes an iterator of row
    blocks for the same reason. Files are byte-equal to the reference's.
  * **`TraceReplay`** — an availability process whose device state is the
    current `window` rounds of masks, ``{"win": (W, N) bool, "win_t0":
    int32 0-d}``, and whose host surface pages the same windows on demand.
    The engines re-point the window between rounds (loop) or between
    chunks (the scan's `pre_chunk`) through the window protocol below.
    Masks are file contents, so every engine and every `scan_chunk` draws
    the same masks.

On the card a re-page writes INTO the window's tensors on the run's stream
(`load_window`): a captured round reads the carry at fixed addresses, so
the window must not move. The rows go up from a pinned host buffer by an
asynchronous copy that may still be queued behind the previous chunk's
replays; each buffer is reused only after an event recorded after its copy
has passed (a ring of two buffers a shape).

Replay semantics match `TraceParticipation`: rounds past the end of the
trace repeat the last recorded row, and round 0 is all-active (Definition
5.2(1)) whatever the file's first row says. `stationary_rate` and
`tau_bound` are post-hoc empirical, from one streamed pass over the file:
a recording admits no a-priori bound.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.scenarios.base import AvailabilityProcess, TauBound
from repro_torch.scenarios.processes import _col, _round, _row
from repro_torch.scenarios.registry import register

FORMAT = "repro-trace-v1"


def _sidecar(path: str) -> str:
    """Sidecar json path for a trace payload path."""
    return (path[:-4] if path.endswith(".npy") else path) + ".json"


def _atomic_bytes(path: str, data: bytes) -> None:
    """Write `data` to `path` via a same-directory temp file + rename."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_trace(path: str, masks, *, n_clients: int | None = None,
                n_rounds: int | None = None) -> str:
    """Write availability masks as a v1 trace file; returns the payload path.

    Args:
      path: payload destination; ``.npy`` is appended if missing, and the
        ``.json`` sidecar lands next to it. Both are written to temp files
        in the same directory and renamed (payload first), so a crash
        mid-write never leaves a torn trace.
      masks: a (T, N) bool array, or an *iterator of (L, N) bool blocks*
        (the streaming form converts long recordings without ever holding
        (T, N)).
      n_clients: required for the iterator form (the header is written
        before the first block); inferred from an array.
      n_rounds: required for the iterator form; the writer raises if the
        blocks do not sum to exactly this many rounds.
    """
    if not path.endswith(".npy"):
        path += ".npy"
    if hasattr(masks, "shape"):
        a = np.asarray(masks, bool)
        if a.ndim != 2:
            raise ValueError(f"masks must be (T, N), got shape {a.shape}")
        n_rounds, n_clients = a.shape
        blocks: Iterable = (a,)
    else:
        if n_clients is None or n_rounds is None:
            raise ValueError("write_trace(masks=<iterator>) needs explicit "
                             "n_clients= and n_rounds= (the npy header is "
                             "written before the first block)")
        blocks = masks
    n_bytes = -(-n_clients // 8)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".tmp")
    rows = 0
    try:
        with os.fdopen(fd, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "|u1", "fortran_order": False,
                    "shape": (int(n_rounds), n_bytes)})
            for block in blocks:
                b = np.asarray(block, bool)
                if b.ndim != 2 or b.shape[1] != n_clients:
                    raise ValueError(f"trace block must be (L, {n_clients}),"
                                     f" got shape {b.shape}")
                f.write(np.packbits(b, axis=1).tobytes())
                rows += b.shape[0]
        if rows != n_rounds:
            raise ValueError(f"trace blocks sum to {rows} rounds, header "
                             f"promised {n_rounds}")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _atomic_bytes(_sidecar(path), json.dumps(
        {"format": FORMAT, "n_clients": int(n_clients),
         "n_rounds": int(n_rounds)}).encode())
    return path


class TraceFile:
    """Read surface of a v1 trace: memmapped bit-packed masks.

    Attributes:
      path: the ``.npy`` payload path.
      n_clients: N, from the sidecar.
      n_rounds: T, from the sidecar.

    `read_block` is the only read primitive; windows and the statistics
    pass go through it, so host mask residency is bounded by the block
    length asked for.
    """

    def __init__(self, path: str):
        self.path = path
        with open(_sidecar(path)) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(f"{_sidecar(path)}: expected format {FORMAT!r},"
                             f" got {meta.get('format')!r}")
        self.n_clients = int(meta["n_clients"])
        self.n_rounds = int(meta["n_rounds"])
        self._mm = np.load(path, mmap_mode="r")
        expect = (self.n_rounds, -(-self.n_clients // 8))
        if self._mm.shape != expect:
            raise ValueError(f"{path}: payload shape {self._mm.shape} does "
                             f"not match sidecar (expected {expect})")

    def read_block(self, t0: int, length: int) -> np.ndarray:
        """Masks for rounds [t0, t0+length) as a (length, N) bool array.
        Rounds past the end repeat the last recorded row."""
        idx = np.clip(np.arange(t0, t0 + length), 0, self.n_rounds - 1)
        packed = np.asarray(self._mm[idx])
        return np.unpackbits(packed, axis=1,
                             count=self.n_clients).astype(bool)


def open_trace(path: str) -> TraceFile:
    """Open a v1 trace file (payload + sidecar) for memmapped reading."""
    if not path.endswith(".npy"):
        path += ".npy"
    return TraceFile(path)


def synthesize_trace(path: str, *, n: int, horizon: int, seed: int = 0,
                     rate: float = 0.5, burst: float = 4.0,
                     churn_frac: float = 0.0, block: int = 256) -> str:
    """Record a synthetic device trace to disk, streamed block by block.

    Drives the port's Gilbert–Elliott host sampler (`seed`-keyed, masks
    array-equal to the reference's; stationary activity `rate`, expected
    off-burst `burst` rounds) for `horizon` rounds of `n` devices, and ANDs
    in permanent departures: the first ``int(n * churn_frac)`` devices
    leave at evenly spaced rounds and never return. The bytes equal the
    reference's for the same recipe. Returns the payload path.
    """
    from repro_torch.scenarios.processes import GilbertElliott
    sampler = GilbertElliott.from_rate_and_burst(
        rate, burst, n=n, seed=seed).host_sampler()
    k = int(n * churn_frac)
    depart = np.full(n, np.iinfo(np.int64).max, np.int64)
    if k:
        depart[:k] = (np.arange(1, k + 1) * horizon) // (k + 1)

    def blocks():
        for t0 in range(0, horizon, block):
            length = min(block, horizon - t0)
            rows = sampler.sample_block(t0, length)
            t = np.arange(t0, t0 + length)[:, None]
            yield rows & (t < depart[None, :])

    return write_trace(path, blocks(), n_clients=n, n_rounds=horizon)


def cached_trace(*, n: int, horizon: int, seed: int = 0, rate: float = 0.5,
                 burst: float = 4.0, churn_frac: float = 0.0,
                 cache_dir: str | None = None) -> str:
    """Synthesize-once path for a parametrised trace. The filename is keyed
    by every recipe parameter (the reference's names, so both packages
    share a cache), and the atomic rename makes concurrent writers safe."""
    d = cache_dir or os.path.join(tempfile.gettempdir(), "repro_traces")
    name = (f"trace_n{n}_t{horizon}_s{seed}_r{rate:g}"
            f"_b{burst:g}_c{churn_frac:g}.npy")
    path = os.path.join(d, name)
    if not (os.path.exists(path) and os.path.exists(_sidecar(path))):
        synthesize_trace(path, n=n, horizon=horizon, seed=seed, rate=rate,
                         burst=burst, churn_frac=churn_frac)
    return path


class _PinnedRing:
    """Host buffers for window uploads to the card: two pinned buffers a
    shape, each refilled only after an event recorded after its last copy
    out has passed on the stream."""

    def __init__(self):
        self._slots: dict[tuple, list] = {}
        self._next: dict[tuple, int] = {}

    def upload(self, dst: torch.Tensor, rows: np.ndarray) -> None:
        """Write `rows` into `dst` in place: on the card asynchronously on
        the current stream, on the CPU at once."""
        src = torch.from_numpy(np.asarray(rows, order="C"))
        if dst.device.type != "cuda":
            dst.copy_(src)
            return
        key = tuple(src.shape)
        ring = self._slots.setdefault(key, [None, None])
        i = self._next.get(key, 0)
        self._next[key] = 1 - i
        if ring[i] is None:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        else:
            buf, done = ring[i]
            done.synchronize()
        buf.copy_(src)
        dst.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        ring[i] = (buf, done)


class TraceReplay(AvailabilityProcess):
    """Replay an on-disk trace through both scenario surfaces, windowed.

    Device state ``{"win": (W, N) bool, "win_t0": int32 0-d}``: the
    `window` rounds of masks in the carry. `sample_fn` indexes the window
    at ``clamp(t - win_t0, 0, W-1)``; re-pointing the window is the
    engines' job through the window protocol:

      * ``scan_window``                — W, the carried window length.
      * ``read_window(t0)``           — (W, N) bool rows from the file.
      * ``load_window(state, t0)``    — re-point the window at [t0, t0+W)
                                         by writing into its tensors on
                                         the run's stream; returns `state`.
                                         Reads nothing back, so the scan
                                         engine calls it while the previous
                                         chunk may still run.
      * ``load_window_fleet(state, procs, t0)`` — the stacked-trial form.

    The process is `stateless`: masks depend on (file, t) only, so host
    sampling is random access.
    """

    stateless = True

    def __init__(self, path: str, *, n: int | None = None, seed: int = 0,
                 window: int = 64):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.trace = open_trace(path)
        if n is not None and n != self.trace.n_clients:
            raise ValueError(
                f"trace {path!r} records {self.trace.n_clients} clients, "
                f"but n={n} was requested — trace replay cannot resize a "
                "recording")
        self.n = self.trace.n_clients
        self.seed = seed
        self.scan_window = int(window)
        self._stats_cache = None
        self._ring = _PinnedRing()

    # -- window protocol --------------------------------------------------- #
    def read_window(self, t0: int) -> np.ndarray:
        """(W, N) bool masks for rounds [t0, t0+W) (clamped past the end)."""
        return self.trace.read_block(t0, self.scan_window)

    def load_window(self, state: dict, t0: int) -> dict:
        """Re-point the carried window at [t0, t0+W), in place."""
        self._ring.upload(state["win"], self.read_window(t0))
        state["win_t0"].fill_(t0)
        return state

    def load_window_fleet(self, state: dict, procs, t0: int) -> dict:
        """Stacked-trial `load_window`: state leaves lead with the trial
        axis K; `procs` are the K trials' (same-window) processes."""
        self._ring.upload(state["win"],
                          np.stack([p.read_window(t0) for p in procs]))
        state["win_t0"].fill_(t0)
        return state

    # -- device surface ---------------------------------------------------- #
    def init_state(self, device="cpu") -> dict:
        """The window covering rounds [0, W) on `device`."""
        return {"win": torch.from_numpy(self.read_window(0)).to(device),
                "win_t0": torch.zeros((), dtype=torch.int32, device=device)}

    def sample_fn(self) -> Callable:
        """Pure window lookup; `key` only places the round index (replay
        is deterministic). Round 0 is all-active by a select, not a
        branch."""
        w = self.scan_window

        def sample(key, t, state):
            t = _round(t, key)
            row = _row(state["win"],
                       torch.clamp(t - state["win_t0"], 0, w - 1))
            return torch.where(_col(t == 0), torch.ones_like(row), row), \
                state

        return sample

    # -- host surface ------------------------------------------------------ #
    def init_state_host(self) -> dict:
        return {"win": self.read_window(0), "win_t0": np.int32(0)}

    def host_step(self, t: int, state: dict) -> tuple[np.ndarray, dict]:
        """numpy lookup, re-paging the window when t leaves it."""
        w = self.scan_window
        t0 = int(state["win_t0"])
        if not t0 <= t < t0 + w:
            t0 = (t // w) * w
            state = {**state, "win": self.read_window(t0),
                     "win_t0": np.int32(t0)}
        row = np.asarray(state["win"][t - t0], bool)
        return (np.ones(self.n, bool) if t == 0 else row), state

    # -- theory (post-hoc empirical) --------------------------------------- #
    def _scan_stats(self) -> dict:
        """One streamed pass over the trace: per-device activity counts,
        τ accumulators, the longest dark stretch, and whether any device
        is dark in the final row (=> dark forever under the clamp)."""
        if self._stats_cache is not None:
            return self._stats_cache
        T, n, w = self.trace.n_rounds, self.n, self.scan_window
        counts = np.zeros(n, np.int64)
        tau = np.zeros(n, np.int64)
        tau_sum = 0.0
        longest = 0
        last = np.ones(n, bool)
        for t0 in range(0, T, w):
            rows = self.trace.read_block(t0, min(w, T - t0))
            if t0 == 0:
                rows = rows.copy()
                rows[0] = True               # replay forces round 0 active
            for row in rows:
                counts += row
                tau = np.where(row, 0, tau + 1)
                tau_sum += float(tau.sum())
                longest = max(longest, int(tau.max()))
            last = rows[-1]
        self._stats_cache = {
            "rate": counts / max(T, 1), "mean_tau": tau_sum / max(T * n, 1),
            "longest_gap": longest, "dark_at_end": bool(~last.all())}
        return self._stats_cache

    def stationary_rate(self) -> np.ndarray:
        """(n,) empirical per-device activity rate over the recorded trace."""
        return self._scan_stats()["rate"]

    def tau_bound(self) -> TauBound:
        """Post-hoc empirical classification; devices dark in the final row
        stay dark forever under the replay clamp, so t0 = ∞ then."""
        s = self._scan_stats()
        t0 = np.inf if s["dark_at_end"] else float(s["longest_gap"])
        return TauBound(
            deterministic=not s["dark_at_end"], t0=t0,
            expected_tau=s["mean_tau"],
            note="post-hoc empirical from the recorded trace; no a-priori "
                 "bound exists — the arbitrary-unavailability regime")


@register("trace_replay")
def _trace_replay(*, n: int, seed: int = 0, path: str | None = None,
                  horizon: int = 256, rate: float = 0.5, burst: float = 4.0,
                  churn: float = 0.0, window: int = 64,
                  cache_dir: str | None = None) -> TraceReplay:
    """Registry factory: replay `path` if given, else synthesize-and-cache
    a Gilbert–Elliott + churn trace keyed by (n, horizon, seed, rate,
    burst, churn)."""
    if path is None:
        path = cached_trace(n=n, horizon=horizon, seed=seed, rate=rate,
                            burst=burst, churn_frac=churn,
                            cache_dir=cache_dir)
    return TraceReplay(path, n=n, seed=seed, window=window)
