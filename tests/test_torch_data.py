"""Parity of the port's host-side numpy modules with the JAX package's:
synthetic data, label-skew partition, client batches, availability masks and
τ statistics must be array-equal (same values, same dtypes)."""
import numpy as np
import pytest

from repro.core import participation as jpart
from repro.data import partition as jpartition
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynth
from repro.optim import schedules as jsched
from repro_torch.core import participation as tpart
from repro_torch.data import partition as tpartition
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import synthetic as tsynth
from repro_torch.optim import schedules as tsched


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dim,n_per_class,seed", [(32, 20, 0), (64, 7, 3)])
def test_make_classification_equal(dim, n_per_class, seed):
    for a, b in zip(jsynth.make_classification(10, dim, n_per_class,
                                               noise=1.0, seed=seed),
                    tsynth.make_classification(10, dim, n_per_class,
                                               noise=1.0, seed=seed)):
        _eq(a, b)


@pytest.mark.parametrize("n_clients", [8, 20])
def test_label_skew_partition_equal(n_clients):
    _, y = jsynth.make_classification(10, 16, 30, seed=1)
    ji, jl = jpartition.label_skew_partition(y, n_clients, seed=2)
    ti, tl = tpartition.label_skew_partition(y, n_clients, seed=2)
    _eq(jl, tl)
    assert len(ji) == len(ti)
    for a, b in zip(ji, ti):
        _eq(a, b)


@pytest.mark.parametrize("client_ids", [None, [5, 0, 7, 0]])
def test_client_batcher_sample_round_equal(client_ids):
    X, y = jsynth.make_classification(10, 16, 30, seed=0)
    idx, _ = jpartition.label_skew_partition(y, 8, seed=0)
    kw = dict(batch_size=6, k_steps=3, seed=4)
    jb = jpipeline.ClientBatcher(X, y, idx, **kw)
    tb = tpipeline.ClientBatcher(X, y, idx, **kw)
    assert tb.n_clients == jb.n_clients and tb.dim == jb.dim
    for t in (0, 1, 9):
        jr = jb.sample_round(t, client_ids=client_ids)
        tr = tb.sample_round(t, client_ids=client_ids)
        assert jr.keys() == tr.keys()
        for k in jr:
            _eq(jr[k], tr[k])


def test_participation_and_tau_stats_equal():
    _, y = jsynth.make_classification(10, 16, 30, seed=0)
    _, labels = jpartition.label_skew_partition(y, 20, seed=0)
    jp = jpart.label_correlated_probs(labels, p_min=0.1)
    tp = tpart.label_correlated_probs(labels, p_min=0.1)
    _eq(jp, tp)
    jb = jpart.BernoulliParticipation(jp, seed=3)
    tb = tpart.BernoulliParticipation(tp, seed=3)
    js, ts = jpart.TauStats(20), tpart.TauStats(20)
    for t in range(30):
        jm, tm = jb.sample(t), tb.sample(t)
        _eq(jm, tm)
        js.update(jm)
        ts.update(tm)
        _eq(js.tau, ts.tau)
    for attr in ("tau_bar", "tau_max", "d_bar", "d_max_bar", "tau_max_bar"):
        assert getattr(js, attr) == getattr(ts, attr), attr


def test_tau_stats_first_round_check_equal():
    mask = np.array([True, False, True])
    with pytest.raises(ValueError, match="round 0 must be all-active"):
        tpart.TauStats(3).update(mask)
    js, ts = jpart.TauStats(3, strict=False), tpart.TauStats(3, strict=False)
    js.update(mask)
    ts.update(mask)
    _eq(js.tau, ts.tau)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("inv_t", (1.0,)),
    ("paper_strongly_convex", (0.1, 2.0, 5, 3.0)),
    ("nonconvex_fixed", (100, 5, 200, 2.0, 0.5)),
    ("cosine", (0.5, 40, 5, 0.01))])
def test_schedules_equal(name, args):
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for t in (0, 1, 2, 7, 39, 100):
        assert jf(t) == tf(t)
