"""The port's `run_fl` against the JAX package's, end to end on the CPU.

Both packages run the paper's setup at smoke size (N=8 label-skewed clients,
K=5 local steps, label-correlated Bernoulli availability, inv_t(1.0), weight
decay 1e-3) for 20 rounds from the same params and the same participation
seed, with MIFA(array), MIFA(delta) and BankedMIFA(DenseBank()).

Tolerances: masks, n_active and τ statistics are numpy on both sides and
must be identical. Losses and params are fp32 on both sides with matmuls and
reductions blocked differently, so they agree to rtol 1e-4, atol 1e-6 after
20 rounds. Within the port, BankedMIFA(dense) equals MIFA(array) to rtol
1e-5, atol 1e-6: G_sum is kept incrementally instead of re-summed.

The bf16 memories (MIFA(memory_dtype="bfloat16"), its delta form and
BankedMIFA(DenseBank(dtype="bfloat16"))) are held to the reference's bf16
runs on paper_mlp: both round the stored G or bank rows to bf16 at the same
places, so only the fp32 reordering remains. The largest gaps measured over
the three were a relative loss gap of 3.9e-7 and an absolute param gap of
7.0e-6; the bounds are rtol 1e-6 on the losses and atol 1e-5 on the params
(|p| <= 1.13), both under what the f32 case allows (rtol 1e-4 of the
losses; 1e-6 + 1e-4·|p|, up to 1.1e-4, of the params).
"""
import jax
import numpy as np
import pytest
import torch

from repro.bank import BankedMIFA as JBankedMIFA
from repro.bank import DenseBank as JDenseBank
from repro.configs import get_smoke_config as jax_smoke
from repro.core import MIFA as JMIFA
from repro.core import run_fl as jax_run_fl
from repro.models import build_model as jax_build
from repro_torch.bank import BankedMIFA, DenseBank
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import (MIFA, BernoulliParticipation, RoundRunner,
                              label_correlated_probs, run_fl)
from repro_torch.core.runner import ROUND_PHASES
from repro_torch.data import (ClientBatcher, label_skew_partition,
                              make_classification)
from repro_torch.models import build_model
from repro_torch.optim import inv_t
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ROUNDS = 20
ALGOS = {
    "mifa_array": (lambda: JMIFA(memory="array"),
                   lambda: MIFA(memory="array")),
    "mifa_delta": (lambda: JMIFA(memory="delta"),
                   lambda: MIFA(memory="delta")),
    "banked_dense": (lambda: JBankedMIFA(JDenseBank()),
                     lambda: BankedMIFA(DenseBank(device="cpu"))),
}


def _problem(name):
    cfg = get_smoke_config(name)
    n = cfg.fl_clients
    X, y = make_classification(10, cfg.d_model, 40, noise=1.0, seed=0)
    Xte, yte = make_classification(10, cfg.d_model, 20, noise=1.0, seed=1000)
    idx, labels = label_skew_partition(y, n, seed=0)
    probs = label_correlated_probs(labels, p_min=0.1)
    batcher = ClientBatcher(X, y, idx, batch_size=8, k_steps=5, seed=0)
    return cfg, batcher, probs, (Xte.astype(np.float32), yte)


BF16_ALGOS = {
    "mifa_array": (lambda: JMIFA(memory_dtype="bfloat16"),
                   lambda: MIFA(memory_dtype="bfloat16")),
    "mifa_delta": (lambda: JMIFA(memory="delta", memory_dtype="bfloat16"),
                   lambda: MIFA(memory="delta", memory_dtype="bfloat16")),
    "banked_dense": (lambda: JBankedMIFA(JDenseBank(dtype="bfloat16")),
                     lambda: BankedMIFA(DenseBank(dtype="bfloat16",
                                                  device="cpu"))),
}


def _run_jax(name, algo, batcher, probs, test, params):
    import jax.numpy as jnp
    from repro.core import BernoulliParticipation as JBernoulli
    model = jax_build(jax_smoke(name))
    batch = {"x": jnp.asarray(test[0]), "y": jnp.asarray(test[1])}

    def eval_fn(p):
        loss, _ = model.loss_fn(p, batch)
        return float(loss), float(model.accuracy(p, batch))

    return jax_run_fl(model=model, algo=algo,
                      participation=JBernoulli(probs, seed=1),
                      batcher=batcher, schedule=inv_t(1.0), n_rounds=ROUNDS,
                      weight_decay=1e-3, params=params, eval_fn=eval_fn,
                      eval_every=5)


def _run_torch(cfg, algo, batcher, probs, test, params):
    model = build_model(cfg)
    batch = {"x": torch.from_numpy(test[0]), "y": torch.from_numpy(test[1])}

    def eval_fn(p):
        with torch.no_grad():
            loss, _ = model.loss_fn(p, batch)
            return float(loss), float(model.accuracy(p, batch))

    return run_fl(model=model, algo=algo,
                  participation=BernoulliParticipation(probs, seed=1),
                  batcher=batcher, schedule=inv_t(1.0), n_rounds=ROUNDS,
                  weight_decay=1e-3, params=params, eval_fn=eval_fn,
                  eval_every=5, device="cpu")


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", ["paper_logistic", "paper_mlp"])
def test_run_fl_matches_reference(name):
    cfg, batcher, probs, test = _problem(name)
    jparams = jax_build(jax_smoke(name)).init(jax.random.PRNGKey(0))
    p_np = jax.tree.map(np.asarray, jparams)
    finals = {}
    for key, (make_j, make_t) in ALGOS.items():
        pj, hj = _run_jax(name, make_j(), batcher, probs, test, jparams)
        pt, ht = _run_torch(cfg, make_t(), batcher, probs, test,
                            params_from_jax(p_np, "cpu"))
        assert ht.n_active == hj.n_active, key
        assert ht.tau_bar == hj.tau_bar and ht.tau_max == hj.tau_max, key
        assert ht.rounds == hj.rounds, key
        _close(ht.train_loss, hj.train_loss, 1e-4, 1e-6)
        assert [t for t, _ in ht.eval_loss] == [t for t, _ in hj.eval_loss]
        _close([v for _, v in ht.eval_loss], [v for _, v in hj.eval_loss],
               1e-4, 1e-6)
        for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
            assert tuple(a.shape) == b.shape, key
            _close(a.numpy(), np.asarray(b), 1e-4, 1e-6)
        finals[key] = (pt, ht)
    # the anchor property within the port
    (pa, ha), (pb, hb) = finals["mifa_array"], finals["banked_dense"]
    _close(hb.train_loss, ha.train_loss, 1e-5, 1e-6)
    for a, b in zip(tree_leaves(pb), tree_leaves(pa)):
        _close(a.numpy(), b.numpy(), 1e-5, 1e-6)


@pytest.mark.parametrize("key", sorted(BF16_ALGOS))
def test_bf16_memory_matches_reference(key):
    name = "paper_mlp"
    cfg, batcher, probs, test = _problem(name)
    jparams = jax_build(jax_smoke(name)).init(jax.random.PRNGKey(0))
    make_j, make_t = BF16_ALGOS[key]
    pj, hj = _run_jax(name, make_j(), batcher, probs, test, jparams)
    pt, ht = _run_torch(cfg, make_t(), batcher, probs, test,
                        params_from_jax(jax.tree.map(np.asarray, jparams),
                                        "cpu"))
    assert ht.n_active == hj.n_active
    assert ht.tau_bar == hj.tau_bar and ht.tau_max == hj.tau_max
    _close(ht.train_loss, hj.train_loss, 1e-6, 0.0)
    assert [t for t, _ in ht.eval_loss] == [t for t, _ in hj.eval_loss]
    _close([v for _, v in ht.eval_loss], [v for _, v in hj.eval_loss],
           1e-6, 0.0)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        _close(a.numpy(), np.asarray(b), 0.0, 1e-5)


def test_bf16_memory_runs_and_stays_close_to_f32():
    """memory_dtype='bfloat16' stores G in bf16 (the kernels' bf16 path on
    the card); the trajectory stays near the f32 one."""
    cfg, batcher, probs, test = _problem("paper_logistic")
    _, h32 = _run_torch(cfg, MIFA(), batcher, probs, test, None)
    p16, h16 = _run_torch(cfg, MIFA(memory_dtype="bfloat16"), batcher, probs,
                          test, None)
    _, hb16 = _run_torch(cfg, BankedMIFA(DenseBank(dtype="bfloat16",
                                                   device="cpu")),
                         batcher, probs, test, None)
    assert all(np.isfinite(h16.train_loss))
    _close(h16.train_loss, h32.train_loss, 2e-2, 1e-3)
    _close(hb16.train_loss, h16.train_loss, 1e-4, 1e-6)
    assert all(p.dtype == torch.float32 for p in tree_leaves(p16))


@pytest.mark.parametrize("key", ["mifa_array", "banked_dense"])
def test_round_phases_are_profiler_ranges(key):
    """`RoundRunner.step` marks each phase once per round, and the phase
    split of `scripts/profile_round.py` reads those ranges."""
    import importlib.util
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile
    path = Path(__file__).resolve().parents[1] / "scripts/profile_round.py"
    spec = importlib.util.spec_from_file_location("profile_round", path)
    profile_round = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile_round)

    cfg, batcher, probs, _ = _problem("paper_mlp")
    runner = RoundRunner(model=build_model(cfg), algo=ALGOS[key][1](),
                         batcher=batcher, schedule=inv_t(1.0), device="cpu")
    part = BernoulliParticipation(probs, seed=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in range(3):
            runner.step(t, part.sample(t))
    split = profile_round.phase_split(prof, ROUND_PHASES, 3)
    assert list(split) == list(ROUND_PHASES)
    for phase in split.values():
        assert phase["ranges"] == 3
        assert phase["host_ms"] > 0
    assert len(runner.hist.train_loss) == 3
