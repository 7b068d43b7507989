"""Server round policies: who is dispatched, when the round closes, whose
updates are applied.

Counterpart of `repro/sim/policies.py`. The engine hands each policy the
cohort it selected, the availability mask at dispatch time and the (N,)
arrival-time vector (inf = never arrives within the lookahead horizon),
and gets back (close_time, applied_mask):

  * WaitForAll   — broadcast to every device; block until ALL respond.
  * WaitForS     — the paper's Eq. 3 protocol: sample S devices uniformly,
    block until all S respond.
  * Deadline     — broadcast (or over-select a cohort), close at a fixed
    deadline, drop late responders.
  * Impatient    — MIFA's server: close as soon as every device available
    at dispatch has responded; never wait for unavailable ones.
  * BufferedKofN — FedBuff-style buffered async: close at the K-th arrival,
    keep later responders in flight (they land in later rounds,
    staleness-discounted), never re-dispatch an in-flight device.

The host surface (`select` / `resolve`, and `init_pstate` /
`select_pending` / `resolve_pending` for the stateful BufferedKofN) is
numpy f32, copied from the reference; the heap engine drives it. Every
policy also lowers to one parametric form (`unified(n)`, `policy_params`)
and the tensor functions `unified_select` / `unified_resolve`, which the
compiled simulator runs inside a captured round; a fleet stacks the
params of different policies along a leading (K,) axis and runs them in
one program.

Cohorts are keyed by ``fold_in(PRNGKey(sel_seed), t)`` and drawn with
`_threefry.permutation`, `jax.random.permutation` bit for bit: the host
and device cohorts are equal to each other and to the reference's.
`unified_resolve`'s K-th arrival is a sort over f32 values with infs, and
the staleness weight 1/sqrt(1 + s) is correctly rounded on every device,
so close times, masks and weights are bit-equal across the surfaces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from repro_torch.scenarios import _threefry

_INF32 = np.float32(np.inf)


def _fold_in_cohort(sel_seed: int, t: int, n: int, k: int) -> np.ndarray:
    """Host cohort mask: the first k entries of the fold_in(sel_seed, t)
    permutation, the materialised twin of `unified_select`'s draw."""
    if k >= n:
        return np.ones(n, bool)
    key = _threefry.round_key(_threefry.seed_key(sel_seed), int(t))
    perm = _threefry.permutation(key, n).numpy()
    mask = np.zeros(n, bool)
    mask[perm[:k]] = True
    return mask


def _close_at_last_finite(arrivals: np.ndarray, mask: np.ndarray, now: float,
                          idle_s: float) -> tuple[np.float32, np.ndarray]:
    """Close at the last finite arrival in `mask` (float32), or idle one
    epoch if nobody in the wait set ever returns."""
    applied = mask & np.isfinite(arrivals)
    if not applied.any():
        return np.float32(now) + np.float32(idle_s), applied
    return np.float32(arrivals[applied].max()), applied


@dataclass(frozen=True)
class WaitForAll:
    """Fully synchronous server: broadcast, then block for every responder."""

    name: str = "wait_for_all"
    sel_seed: int = 0

    def select(self, t: int, n: int, rng) -> np.ndarray:
        """Dispatch round t to all n devices (`rng` is unused: selection is
        keyed, so both simulation surfaces agree)."""
        return np.ones(n, bool)

    def resolve(self, cohort, avail_now, arrivals, now, epoch_s):
        """Close when the LAST cohort arrival lands: (close_time, applied
        mask). Devices that never return (inf arrival) are dropped."""
        return _close_at_last_finite(arrivals, cohort, now, epoch_s)

    def unified(self, n: int) -> dict:
        """Broadcast (sel_k=0), wait for all finite arrivals
        (wait_mode=1), no deadline, unbuffered."""
        return dict(sel_k=0, wait_avail_only=False, wait_mode=1, buffer_k=0,
                    deadline_s=np.inf, buffered=False, sel_seed=self.sel_seed)


@dataclass(frozen=True)
class WaitForS:
    """The paper's Eq. 3 protocol: sample S devices, block for all S."""

    s: int
    name: str = "wait_for_s"
    sel_seed: int = 0

    def select(self, t: int, n: int, rng) -> np.ndarray:
        """Sample S of n devices uniformly, keyed by fold_in(sel_seed, t)."""
        return _fold_in_cohort(self.sel_seed, t, n, self.s)

    def resolve(self, cohort, avail_now, arrivals, now, epoch_s):
        """Block until every sampled device responds."""
        return _close_at_last_finite(arrivals, cohort, now, epoch_s)

    def unified(self, n: int) -> dict:
        """Sample sel_k=s, wait for all finite arrivals, unbuffered."""
        return dict(sel_k=self.s, wait_avail_only=False, wait_mode=1,
                    buffer_k=0, deadline_s=np.inf, buffered=False,
                    sel_seed=self.sel_seed)


@dataclass(frozen=True)
class Deadline:
    """Close at now + deadline_s; apply whoever arrived. cohort_size=None
    broadcasts to all devices."""

    deadline_s: float
    cohort_size: int | None = None
    name: str = "deadline"
    sel_seed: int = 0

    def select(self, t: int, n: int, rng) -> np.ndarray:
        """Broadcast, or over-select `cohort_size` devices."""
        if self.cohort_size is None or self.cohort_size >= n:
            return np.ones(n, bool)
        return _fold_in_cohort(self.sel_seed, t, n, self.cohort_size)

    def resolve(self, cohort, avail_now, arrivals, now, epoch_s):
        """Close exactly at now + deadline_s; late responders are dropped."""
        close = np.float32(now) + np.float32(self.deadline_s)
        return close, cohort & (arrivals <= close)

    def unified(self, n: int) -> dict:
        """Cohort of sel_k (0 = broadcast), deadline-only close
        (wait_mode=0), unbuffered."""
        k = 0 if self.cohort_size is None or self.cohort_size >= n \
            else self.cohort_size
        return dict(sel_k=k, wait_avail_only=False, wait_mode=0, buffer_k=0,
                    deadline_s=self.deadline_s, buffered=False,
                    sel_seed=self.sel_seed)


@dataclass(frozen=True)
class Impatient:
    """MIFA: wait only for devices available at dispatch time."""

    name: str = "impatient"
    sel_seed: int = 0

    def select(self, t: int, n: int, rng) -> np.ndarray:
        """Dispatch to every device."""
        return np.ones(n, bool)

    def resolve(self, cohort, avail_now, arrivals, now, epoch_s):
        """Close after the devices available AT DISPATCH respond."""
        return _close_at_last_finite(arrivals, cohort & avail_now, now,
                                     epoch_s)

    def unified(self, n: int) -> dict:
        """Broadcast, wait set restricted to devices available at dispatch
        (wait_avail_only), wait_mode=1, unbuffered."""
        return dict(sel_k=0, wait_avail_only=True, wait_mode=1, buffer_k=0,
                    deadline_s=np.inf, buffered=False, sel_seed=self.sel_seed)


@dataclass(frozen=True)
class BufferedKofN:
    """FedBuff-style buffered-async server: close each round at the K-th
    update arrival; slower responders stay in flight and merge into a
    later round's buffer with a staleness discount 1/sqrt(1 + s), s the
    merge round minus the dispatch round. In-flight devices are not
    re-dispatched. `deadline_s` caps how long the server blocks when fewer
    than K updates are in flight."""

    k: int
    deadline_s: float = np.inf
    name: str = "buffered"
    sel_seed: int = 0

    stateful: ClassVar[bool] = True

    def init_pstate(self, n: int) -> dict:
        """Fresh in-flight buffer: pending (N,) f32 arrival times (inf =
        nothing in flight) and pending_t (N,) dispatch rounds."""
        return {"pending": np.full(n, _INF32, np.float32),
                "pending_t": np.zeros(n, np.int64)}

    def select_pending(self, t: int, n: int, pstate: dict) -> np.ndarray:
        """Dispatch to every device with no update in flight."""
        return ~np.isfinite(pstate["pending"])

    def resolve_pending(self, pstate, cohort, avail_now, arrivals, now,
                        epoch_s, t):
        """Merge this round's arrivals with the in-flight buffer and close
        at the K-th smallest arrival (capped by deadline_s; idle one epoch
        if nothing is in flight). Returns (close, applied, staleness
        weights, new pstate): the float32 host mirror of
        `unified_resolve`'s buffered branch."""
        merged = np.where(cohort, arrivals.astype(np.float32),
                          pstate["pending"]).astype(np.float32)
        merged_t = np.where(cohort, t, pstate["pending_t"])
        finite = np.isfinite(merged)
        n_finite = int(finite.sum())
        k_eff = min(self.k, n_finite)
        idle = np.float32(now) + np.float32(epoch_s)
        if k_eff > 0:
            kth = np.sort(np.where(finite, merged, _INF32))[k_eff - 1]
        else:
            kth = idle
        close = np.minimum(np.float32(kth),
                           np.float32(now) + np.float32(self.deadline_s))
        applied = finite & (merged <= close)
        stale = (np.int64(t) - merged_t).astype(np.float32)
        weights = np.where(
            applied, np.float32(1.0) / np.sqrt(np.float32(1.0) + stale),
            np.float32(0.0)).astype(np.float32)
        pstate = {"pending": np.where(applied, _INF32,
                                      merged).astype(np.float32),
                  "pending_t": np.where(applied, 0, merged_t)}
        return close, applied, weights, pstate

    def unified(self, n: int) -> dict:
        """Broadcast minus in-flight, K-th-arrival close (wait_mode=2,
        buffer_k=k), buffered merges with staleness."""
        return dict(sel_k=0, wait_avail_only=False, wait_mode=2,
                    buffer_k=self.k, deadline_s=self.deadline_s,
                    buffered=True, sel_seed=self.sel_seed)


# --------------------------------------------------------------------- #
# The unified tensor surface: one (params, state) algebra covering every
# policy above. Params broadcast against the (..., N) vectors through a
# trailing axis, so a (K,) fleet of mixed policies runs as one program.
# --------------------------------------------------------------------- #

def policy_params(policy, n: int, device: str | torch.device = "cpu"
                  ) -> dict:
    """Lift `policy` into the unified parameter dict (0-d tensors on
    `device`, stackable along a trial axis): sel_k, wait_avail_only,
    wait_mode (0 = deadline only, 1 = all finite, 2 = buffer K), buffer_k,
    deadline_s, buffered, sel_key."""
    u = policy.unified(n)

    def t(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    return {"sel_k": t(u["sel_k"], torch.int64),
            "wait_avail_only": t(u["wait_avail_only"], torch.bool),
            "wait_mode": t(u["wait_mode"], torch.int64),
            "buffer_k": t(u["buffer_k"], torch.int64),
            "deadline_s": t(float(np.float32(u["deadline_s"])),
                            torch.float32),
            "buffered": t(u["buffered"], torch.bool),
            "sel_key": _threefry.seed_key(u["sel_seed"]).to(device)}


def init_policy_state(n: int, device: str | torch.device = "cpu") -> dict:
    """The policy state riding the compiled simulator's carry: the
    in-flight buffer (pending arrival times and dispatch rounds); inert
    for unbuffered policies, but one shape for every policy."""
    return {"pending": torch.full((n,), float("inf"), dtype=torch.float32,
                                  device=device),
            "pending_t": torch.zeros(n, dtype=torch.int64, device=device)}


def _col(x: torch.Tensor) -> torch.Tensor:
    """A per-run value (…,) as (…, 1), broadcasting against (…, N)."""
    return x.unsqueeze(-1)


def unified_select(t, pp: dict, pstate: dict) -> torch.Tensor:
    """Round t's cohort: the first sel_k entries of the fold_in(sel_key, t)
    permutation (sel_k = 0 broadcasts), minus in-flight devices when
    buffered. `t` is an int or a 0-d / (K,) int64 tensor. Bit-equal to the
    host policies' `select`."""
    pending = pstate["pending"]
    n = pending.shape[-1]
    perm = _threefry.permutation(_threefry.round_key(pp["sel_key"], t), n)
    pos = torch.empty_like(perm).scatter_(
        -1, perm, torch.arange(n, device=perm.device).expand_as(perm))
    sel_k = _col(pp["sel_k"])
    mask = torch.where(sel_k > 0, pos < sel_k, True)
    return mask & torch.where(_col(pp["buffered"]),
                              ~torch.isfinite(pending), True)


def unified_resolve(pp: dict, pstate: dict, cohort, avail_now, arrivals,
                    now, epoch_s, t):
    """Close round t for every policy at once: (close, applied, weights,
    new pstate, info). `arrivals` (…, N) f32 (inf = never returns), `now`
    (…,) f32, `epoch_s` a 0-d f32 tensor, `t` a 0-d or (…,) int64 tensor.
    Every branch of the algebra is computed and selected by the params: no
    Python control flow on tensors, nothing read back.

    Merge arrivals with the in-flight buffer (buffered only); the wait set
    is the finite arrivals or, for wait_avail_only (Impatient), the
    cohort devices available at dispatch; close at the K-th smallest
    waited arrival (K = all finite for wait_mode 1, buffer_k for 2, none
    for the deadline-only 0), capped by now + deadline_s. Applied = waited
    arrivals landed by close; weights 1, or the buffered staleness
    discount 1/sqrt(1 + s). `info` carries n_late (finite but dropped, the
    heap's LATE) and n_never (cohort devices past the lookahead horizon).
    """
    inf = torch.full((), float("inf"), dtype=torch.float32,
                     device=arrivals.device)
    t = torch.as_tensor(t, dtype=torch.int64, device=arrivals.device)
    buffered = _col(pp["buffered"])
    arr_in = torch.where(cohort, arrivals, inf)
    merged = torch.where(buffered,
                         torch.where(cohort, arrivals, pstate["pending"]),
                         arr_in)
    merged_t = torch.where(cohort, _col(t), pstate["pending_t"])
    finite = torch.isfinite(merged)
    waitset = torch.where(_col(pp["wait_avail_only"]), cohort & avail_now,
                          finite)
    wait_fin = waitset & finite
    wait_arr = torch.where(wait_fin, merged, inf)
    n_finite = wait_fin.sum(-1)
    k = torch.where(pp["wait_mode"] == 2,
                    torch.minimum(pp["buffer_k"], n_finite),
                    torch.where(pp["wait_mode"] == 1, n_finite,
                                torch.zeros_like(n_finite)))
    kth = torch.gather(torch.sort(wait_arr, dim=-1).values, -1,
                       _col((k - 1).clamp(min=0))).squeeze(-1)
    idle = now + epoch_s
    arr_close = torch.where(k > 0, kth, idle)
    ddl = now + pp["deadline_s"]
    close = torch.where(pp["wait_mode"] == 0, ddl,
                        torch.minimum(arr_close, ddl))
    applied = waitset & (merged <= _col(close))
    stale = (_col(t) - merged_t).float()
    one = torch.ones((), dtype=torch.float32, device=arrivals.device)
    w_buf = one / torch.sqrt(one + stale)
    weights = torch.where(applied, torch.where(buffered, w_buf, one),
                          torch.zeros_like(w_buf))
    keep = buffered & ~applied
    new_pstate = {"pending": torch.where(keep, merged, inf),
                  "pending_t": torch.where(keep, merged_t,
                                           torch.zeros_like(merged_t))}
    info = {"n_late": (finite & ~applied & ~buffered).sum(-1),
            "n_never": (cohort & ~torch.isfinite(arrivals)).sum(-1)}
    return close, applied, weights, new_pstate, info
