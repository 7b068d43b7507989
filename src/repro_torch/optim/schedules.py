"""Learning-rate schedules from the paper (pure Python; same formulas as
`repro/optim/schedules.py`).

  * inv_t                — η_t = η0 / t, the paper's experimental schedule (§7).
  * paper_strongly_convex— η_t = 4 / (μ K (t + a)), a = max{100, 40 t0}(L/μ)^1.5
                           (Theorem 5.1).
  * nonconvex_fixed      — η = sqrt(N / (K T L (1 + ν̄))) (Theorem 6.1).
  * constant / cosine    — framework staples.
"""
from __future__ import annotations

import math


def constant(eta0: float):
    return lambda t: eta0


def inv_t(eta0: float):
    return lambda t: eta0 / max(t, 1)


def paper_strongly_convex(mu: float, L: float, K: int, t0: float = 0.0):
    a = max(100.0, 40.0 * t0) * (L / mu) ** 1.5
    return lambda t: 4.0 / (mu * K * (t + a))


def nonconvex_fixed(N: int, K: int, T: int, L: float, nu_bar: float = 0.0):
    eta_tilde = math.sqrt(N / (K * T * L * (1.0 + nu_bar)))
    return lambda t: eta_tilde / K  # paper states η (per-step); η̃ = Kη


def cosine(eta0: float, total: int, warmup: int = 0, floor: float = 0.0):
    def f(t):
        if t < warmup:
            return eta0 * (t + 1) / max(warmup, 1)
        p = (t - warmup) / max(total - warmup, 1)
        return floor + 0.5 * (eta0 - floor) * (1 + math.cos(math.pi * min(p, 1.0)))
    return f
