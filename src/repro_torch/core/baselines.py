"""FedAvg baselines under device unavailability (paper §3 / Algorithm 2).

Counterpart of `repro/core/baselines.py`, for the baselines of the paper's
Figure 2:

  * BiasedFedAvg      — average the *active* devices' updates only. Fast but
                        biased when availability correlates with data.
  * FedAvgIS          — importance sampling: weight active updates by 1/p_i.
                        Unbiased but needs the participation probabilities.
  * FedAvgSampling    — the original FedAvg protocol: sample S devices, then
                        *wait* across rounds until all S have responded; only
                        then apply a global update (paper Eq. 3). Its state
                        counts applied updates in `t_updates`, which the
                        runner's update clock reads.
  * SCAFFOLDSampling  — SCAFFOLD control variates on the S-device sampling
                        protocol.

All share MIFA's round API: init_state / round_step(state, params, updates,
losses, active, eta, rng=None), plain torch on the run's device; `eta` is
a float or a 0-d f32 tensor. The sampling baselines draw a fresh
selection every round, used or not, as the reference draws
`jax.random.permutation` every round. They draw on the host, from the
run's CPU round generator: the runner calls `host_draw(rng, n)` once a
round with the round's other inputs and passes the result as
`round_step(..., draw=)` (so a round captured as a CUDA graph does not
freeze the draw); called without `draw=`, `round_step` draws from `rng`
itself. Torch cannot reproduce the reference's threefry bits, so parity
tests inject the reference's selections through
`FedAvgSampling._resample`.

The competing memorisation / reweighting mechanisms of the related work:

  * FedBuffAvg        — buffered-async aggregation (FedBuff-style): the
                        round's `active` may be a float weight vector (the
                        staleness discounts of a buffered server policy) or
                        a bool mask, which makes it BiasedFedAvg. The
                        simulator (`repro_torch.sim`) feeds it weights.
  * FedAR             — local-update approximation + rectification: every
                        client's latest update is kept as its surrogate and
                        the surrogates are averaged with staleness-decayed,
                        re-normalised weights.
  * CAFed             — correlated-availability weighting: weights adapt to
                        online estimates of each client's availability chain
                        (EWMA activity and persistence), and clients whose
                        chain mixes too slowly are excluded.

Like the reference's plain `jnp`, these are plain tensor ops: no TPU kernel
stands behind them. Each `round_step` takes `clients=` (a
`sharding.clients.ClientShard`) under a mesh of data extent > 1: its
per-client state, updates, losses, mask and draw are then the rank's block
of the client axis, and every reduction over clients spans the data
group. The `assumes` tag names the availability regime each
mechanism needs: 'arbitrary' (Assumption 4 only), 'iid_known_probs',
'stationary_mixing' or 'none'.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from repro_torch.core.mifa import _bcast
from repro_torch.sharding.clients import LOCAL
from repro_torch.tree import tree_leaves, tree_map


def _apply(params, mean_g, eta: float):
    """w <- w - η·mean_G, in the params' dtype."""
    return tree_map(lambda w, g: (w - eta * g).to(w.dtype), params, mean_g)


def _active_loss(losses: torch.Tensor, act: torch.Tensor,
                 ax=LOCAL) -> torch.Tensor:
    """Mean local loss of the active devices (0 when none is active)."""
    return ax.total(losses * act) / ax.total(act).clamp(min=1.0)


def _zero_count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


@dataclass(frozen=True)
class BiasedFedAvg:
    assumes: ClassVar[str] = "none"

    def init_state(self, params, n_clients: int) -> dict:
        return {"t": _zero_count(_device_of(params))}

    def round_step(self, state, params, updates, losses, active, eta,
                   rng=None, clients=None):
        ax = clients or LOCAL
        act = active.float()
        denom = ax.total(act).clamp(min=1.0)
        mean_g = tree_map(lambda u: ax.sum(u * _bcast(act, u)) / denom,
                          updates)
        return ({"t": state["t"] + 1}, _apply(params, mean_g, eta),
                {"loss": ax.total(losses * act) / denom,
                 "n_active": ax.total(act)})


@dataclass(frozen=True)
class FedBuffAvg:
    """Buffered-async FedAvg (FedBuff-style). `active` is an f32 weight
    vector (staleness discounts, 0 for non-contributors) or a bool mask.
    The update is Σ w_i·u_i / |contributors|: dividing by the contributor
    count, not Σw, keeps the step comparable to synchronous FedAvg while
    stale updates are attenuated. With a bool mask it is `BiasedFedAvg`."""

    weight_aware: ClassVar[bool] = True
    assumes: ClassVar[str] = "none"

    def init_state(self, params, n_clients: int) -> dict:
        """Stateless aggregation: only the round counter `t`."""
        return {"t": _zero_count(_device_of(params))}

    def round_step(self, state, params, updates, losses, active, eta,
                   rng=None, clients=None):
        ax = clients or LOCAL
        w = active.float()
        contrib = (w > 0).float()
        denom = ax.total(contrib).clamp(min=1.0)
        mean_g = tree_map(lambda u: ax.sum(u * _bcast(w, u)) / denom,
                          updates)
        return ({"t": state["t"] + 1}, _apply(params, mean_g, eta),
                {"loss": ax.total(losses * contrib) / denom,
                 "n_active": ax.total(contrib)})


@dataclass(frozen=True)
class FedAvgIS:
    """Needs the true participation probabilities (N,).

    `probs` rides the algorithm state, as in the reference, so trials with
    different probability vectors stack along the fleet's trial axis.
    Zero-probability clients are excluded from the importance sum rather
    than divided by: a p_i = 0 device can never legitimately participate.
    """

    probs: tuple
    assumes: ClassVar[str] = "iid_known_probs"

    def __post_init__(self):
        object.__setattr__(
            self, "probs",
            tuple(float(p) for p in np.atleast_1d(np.asarray(self.probs))))

    def init_state(self, params, n_clients: int) -> dict:
        if len(self.probs) != n_clients:
            raise ValueError(f"FedAvgIS has {len(self.probs)} probabilities "
                             f"for {n_clients} clients")
        dev = _device_of(params)
        return {"t": _zero_count(dev),
                "probs": torch.tensor(self.probs, dtype=torch.float32,
                                      device=dev)}

    def round_step(self, state, params, updates, losses, active, eta,
                   rng=None, clients=None):
        ax = clients or LOCAL
        act = active.float()
        p = state["probs"]
        w_is = torch.where(p > 0, act / p.clamp(min=1e-12),
                           torch.zeros_like(p))
        n = ax.n(act)
        mean_g = tree_map(lambda u: ax.sum(u * _bcast(w_is, u)) / n,
                          updates)
        return ({"t": state["t"] + 1, "probs": p},
                _apply(params, mean_g, eta),
                {"loss": _active_loss(losses, act, ax),
                 "n_active": ax.total(act)})


@dataclass(frozen=True)
class FedAR:
    """FedAR-style local-update approximation + rectification (Jiang et
    al., arXiv 2407.19103):

        U^i_t = u^i_t if i ∈ A(t), else U^i_{t-1}        (surrogates)
        τ_i   = rounds since i last participated (0 when fresh)
        α_i   = decay^τ_i,  w_{t+1} = w_t − η · Σ_i α_i U^i_t / Σ_i α_i

    decay=1 is MIFA's uniform memory average, decay=0 BiasedFedAvg (0^0 =
    1 keeps the fresh updates). Needs no knowledge of the availability
    law, hence `assumes = 'arbitrary'`."""

    decay: float = 0.5
    assumes: ClassVar[str] = "arbitrary"

    def init_state(self, params, n_clients: int) -> dict:
        dev = _device_of(params)
        return {"U": tree_map(lambda p: torch.zeros(
                    (n_clients,) + tuple(p.shape), dtype=torch.float32,
                    device=dev), params),
                "tau": torch.zeros(n_clients, dtype=torch.int32, device=dev),
                "t": _zero_count(dev)}

    def round_step(self, state, params, updates, losses, active, eta,
                   rng=None, clients=None):
        ax = clients or LOCAL
        act = active.float()
        U = tree_map(lambda u_old, u: torch.where(_bcast(active, u), u, u_old),
                     state["U"], updates)
        tau = torch.where(active, 0, state["tau"] + 1)
        alpha = torch.pow(self.decay, tau.float())
        denom = ax.total(alpha).clamp(min=1.0)
        mean_g = tree_map(lambda u: ax.sum(u * _bcast(alpha, u)) / denom, U)
        return ({"U": U, "tau": tau, "t": state["t"] + 1},
                _apply(params, mean_g, eta),
                {"loss": _active_loss(losses, act, ax),
                 "n_active": ax.total(act)})


@dataclass(frozen=True)
class CAFed:
    """Correlated-availability weighting after Rodio et al., arXiv
    2301.04632 (CA-Fed). Per client, EWMAs with rate `rho` of the activity
    (pi_hat), of P(active | active before) (stay_up, updated after active
    rounds) and of P(inactive | inactive before) (stay_dn, updated after
    inactive rounds). Clients with stay_dn > d_max are excluded (unless
    that would exclude everyone); the rest are importance-weighted:

        w_{t+1} = w_t − η · Σ_{i incl} 1[i ∈ A(t)] u^i_t / clip(π̂_i,
                  pi_min, 1) / |{incl}|

    The chain must be estimable, hence `assumes = 'stationary_mixing'`."""

    rho: float = 0.1
    pi_min: float = 0.05
    d_max: float = 0.85
    assumes: ClassVar[str] = "stationary_mixing"

    def init_state(self, params, n_clients: int) -> dict:
        # neutral priors: π̂ at 1/2, both persistences at their iid values
        dev = _device_of(params)

        def half():
            return torch.full((n_clients,), 0.5, dtype=torch.float32,
                              device=dev)

        return {"pi_hat": half(), "stay_up": half(), "stay_dn": half(),
                "prev": torch.ones(n_clients, dtype=torch.bool, device=dev),
                "t": _zero_count(dev)}

    def round_step(self, state, params, updates, losses, active, eta,
                   rng=None, clients=None):
        ax = clients or LOCAL
        act = active.float()
        rho = self.rho
        pi_hat = state["pi_hat"] + rho * (act - state["pi_hat"])
        stay_up = torch.where(state["prev"],
                              state["stay_up"]
                              + rho * (act - state["stay_up"]),
                              state["stay_up"])
        stay_dn = torch.where(state["prev"], state["stay_dn"],
                              state["stay_dn"]
                              + rho * ((1.0 - act) - state["stay_dn"]))
        incl = (stay_dn <= self.d_max).float()
        # never let the exclusion rule empty the cohort entirely
        incl = torch.where(ax.total(incl) > 0, incl, torch.ones_like(incl))
        w = incl * act / pi_hat.clamp(self.pi_min, 1.0)
        denom = ax.total(incl).clamp(min=1.0)
        mean_g = tree_map(lambda u: ax.sum(u * _bcast(w, u)) / denom,
                          updates)
        new_state = {"pi_hat": pi_hat, "stay_up": stay_up,
                     "stay_dn": stay_dn, "prev": active,
                     "t": state["t"] + 1}
        return new_state, _apply(params, mean_g, eta), {
            "loss": _active_loss(losses, act, ax), "n_active": ax.total(act)}


@dataclass(frozen=True)
class FedAvgSampling:
    """FedAvg with device sampling: wait for the S selected devices."""

    s: int
    assumes: ClassVar[str] = "none"

    def init_state(self, params, n_clients: int) -> dict:
        dev = _device_of(params)
        return {
            "selected": torch.zeros(n_clients, dtype=torch.bool, device=dev),
            "received": torch.zeros(n_clients, dtype=torch.bool, device=dev),
            "U": tree_map(lambda p: torch.zeros(
                (n_clients,) + tuple(p.shape), dtype=torch.float32,
                device=dev), params),
            "t": _zero_count(dev),                 # communication rounds
            "t_updates": _zero_count(dev),         # applied global updates
            "need_resample": torch.ones((), dtype=torch.bool, device=dev),
        }

    def _resample(self, rng: torch.Generator, n: int) -> torch.Tensor:
        """(n,) bool CPU mask of S devices drawn without replacement."""
        perm = torch.randperm(n, generator=rng)
        mask = torch.zeros(n, dtype=torch.bool)
        mask[perm[:self.s]] = True
        return mask

    def host_draw(self, rng: torch.Generator, n: int) -> np.ndarray:
        """The round's fresh selection, drawn on the host: (n,) bool."""
        return self._resample(rng, n).numpy()

    def round_step(self, state, params, updates, losses, active, eta,
                   rng=None, draw=None, clients=None):
        """`draw` is this round's `host_draw` on the params' device; without
        it the selection is drawn from the CPU round generator `rng` (not
        under `clients`, whose block of the draw comes in `draw`)."""
        ax = clients or LOCAL
        n = active.shape[0]
        if draw is None:
            if rng is None:
                raise ValueError("FedAvgSampling needs the round generator "
                                 "(rng=) or the round's draw (draw=) to "
                                 "sample devices")
            draw = self._resample(rng, n).to(active.device)
        need = state["need_resample"]
        fresh = draw
        selected = torch.where(need, fresh, state["selected"])
        received = state["received"] & ~need

        newly = selected & active & ~received
        U = tree_map(lambda u_old, u: torch.where(_bcast(newly, u), u, u_old),
                     state["U"], updates)
        received = received | newly
        complete = ax.all(~selected | received)

        sel = selected.float()
        mean_g = tree_map(lambda u: ax.sum(u * _bcast(sel, u)) / self.s, U)
        new_params = tree_map(
            lambda w, g: torch.where(complete, (w - eta * g).to(w.dtype), w),
            params, mean_g)
        act = active.float()
        t_updates = state["t_updates"] + complete.int()
        new_state = {"selected": selected, "received": received, "U": U,
                     "t": state["t"] + 1, "t_updates": t_updates,
                     "need_resample": complete}
        return new_state, new_params, {
            "loss": _active_loss(losses, act, ax), "n_active": ax.total(act),
            "global_updates": t_updates.float()}


_SAMPLING_KEYS = ("selected", "received", "U", "t", "t_updates",
                  "need_resample")


@dataclass(frozen=True)
class SCAFFOLDSampling:
    """SCAFFOLD (Karimireddy et al. 2020) on the S-device sampling protocol.

    Control variates c_i (per device) and c (server). The corrected update
    of device i is u_i − K·(c_i − c); on completion
       c_i ← c_i + (u_i/K − c_i)·1[i∈S],   c ← c + (S/N)·mean_{i∈S}(Δc_i).
    """

    s: int
    k_steps: int
    assumes: ClassVar[str] = "none"

    def init_state(self, params, n_clients: int) -> dict:
        st = FedAvgSampling(self.s).init_state(params, n_clients)
        st["c_i"] = tree_map(lambda u: torch.zeros_like(u), st["U"])
        st["c"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        return st

    def host_draw(self, rng: torch.Generator, n: int) -> np.ndarray:
        return FedAvgSampling(self.s).host_draw(rng, n)

    def round_step(self, state, params, updates, losses, active, eta,
                   rng=None, draw=None, clients=None):
        ax = clients or LOCAL
        if rng is None and draw is None:
            raise ValueError("SCAFFOLDSampling needs the round generator "
                             "(rng=) or the round's draw (draw=) to sample "
                             "devices")
        n = ax.n(active)
        k = float(self.k_steps)
        vr_updates = tree_map(lambda u, ci, c: u - k * (ci - c[None]),
                              updates, state["c_i"], state["c"])
        sub = {key: state[key] for key in _SAMPLING_KEYS}
        new_sub, new_params, metrics = FedAvgSampling(self.s).round_step(
            sub, params, vr_updates, losses, active, eta, rng, draw,
            clients=clients)

        complete = new_sub["need_resample"]
        sel = new_sub["selected"]
        upd = sel & complete
        # U holds the corrected update; invert the (c - c_i) correction
        c_i_new = tree_map(
            lambda ui, ci, c: torch.where(_bcast(upd, ui),
                                          ui / k + (ci - c[None]), ci),
            new_sub["U"], state["c_i"], state["c"])
        sel32 = sel.float()
        dc = tree_map(lambda cin, ci: (cin - ci) * _bcast(sel32, cin),
                      c_i_new, state["c_i"])
        c_new = tree_map(
            lambda c, d: torch.where(complete, c + ax.sum(d) / n, c),
            state["c"], dc)
        new_state = dict(new_sub)
        new_state["c_i"] = tree_map(
            lambda a, b: torch.where(complete, a, b), c_i_new, state["c_i"])
        new_state["c"] = c_new
        return new_state, new_params, metrics
