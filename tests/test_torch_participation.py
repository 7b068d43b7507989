"""The port's host participation processes and τ matrix against the JAX
package's: `AdversarialParticipation`, `TraceParticipation`, `tau_matrix`.

Both sides are numpy, so masks and τ must be array-equal.
"""
import numpy as np
import pytest

from repro.core.participation import \
    AdversarialParticipation as JAdversarial
from repro.core.participation import TraceParticipation as JTrace
from repro.core.participation import tau_matrix as jtau_matrix
from repro_torch.core import (AdversarialParticipation, TauStats,
                              TraceParticipation, tau_matrix)

ROUNDS = 64


def _blackouts(n=7, seed=0):
    rng = np.random.default_rng(seed)
    periods = rng.integers(3, 11, n)
    offs = np.minimum(rng.integers(0, 6, n), periods - 1)
    return periods, offs, rng.integers(0, 10, n)


@pytest.mark.parametrize("with_phases", [False, True])
def test_adversarial_masks_and_tau_equal_reference(with_phases):
    periods, offs, phases = _blackouts()
    n = len(periods)
    ph = phases if with_phases else None
    port = AdversarialParticipation(n, periods, offs, ph)
    ref = JAdversarial(n, periods, offs, ph)
    masks = np.stack([port.sample(t) for t in range(ROUNDS)])
    want = np.stack([ref.sample(t) for t in range(ROUNDS)])
    np.testing.assert_array_equal(masks, want)
    assert masks.dtype == bool and masks[0].all()
    np.testing.assert_array_equal(tau_matrix(masks), jtau_matrix(want))
    # Assumption 4: τ never exceeds the longest blackout
    assert tau_matrix(masks).max() <= offs.max()


def test_adversarial_rejects_a_blackout_as_long_as_its_period():
    with pytest.raises(ValueError, match="offs < periods"):
        AdversarialParticipation(2, [3, 4], [3, 1])


def test_trace_replay_equals_reference():
    trace = np.random.default_rng(1).random((20, 9)) < 0.4
    port, ref = TraceParticipation(trace), JTrace(trace)
    for t in range(30):                        # past the end: the last row
        np.testing.assert_array_equal(port.sample(t), ref.sample(t))
    np.testing.assert_array_equal(port.sample(25), trace[-1])
    assert port.sample(0).all()                # row 0 forced all-active
    np.testing.assert_array_equal(port.sample(5), trace[5])
    assert port.n == 9


def test_trace_replay_does_not_write_its_input():
    trace = np.zeros((4, 5), bool)
    keep = trace.copy()
    TraceParticipation(trace)
    np.testing.assert_array_equal(trace, keep)


def test_tau_matrix_equals_reference_and_tau_stats():
    masks = np.random.default_rng(2).random((ROUNDS, 8)) < 0.5
    masks[0] = True
    tm = tau_matrix(masks)
    np.testing.assert_array_equal(tm, jtau_matrix(masks))
    assert tm.dtype == np.int64
    st = TauStats(8)
    for row in masks:
        st.update(row)
    assert st.tau_bar == pytest.approx(tm.mean())
    assert st.tau_max == tm.max()


def test_tau_matrix_strict_round_zero():
    masks = np.ones((5, 4), bool)
    masks[0, 2] = False
    with pytest.raises(ValueError, match="round 0 must be all-active"):
        tau_matrix(masks)
    with pytest.raises(ValueError, match="round 0 must be all-active"):
        jtau_matrix(masks)
    # the init convention: τ counts from a virtual round −1
    np.testing.assert_array_equal(tau_matrix(masks, strict=False),
                                  jtau_matrix(masks, strict=False))
    assert tau_matrix(masks, strict=False)[0, 2] == 1
    assert tau_matrix(np.zeros((0, 3), bool)).shape == (0, 3)
