"""The port's window estimators (settings C and E plan on them) against
:mod:`repro.core.estimator`: numpy on both sides, so every estimate is
held bitwise, including the edge cases of ``tests/test_estimator.py``
(more windows than rounds, T = 0, a single window, all-infinite
capacities)."""
import numpy as np
import pytest

from repro.core import costs as rc
from repro.core import estimator as rest
from repro_torch.core import estimator as pest


def _same_traces(got, want):
    for f in ("c_node", "c_link", "f_err", "cap_node", "cap_link"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("T,L", [(0, 5), (1, 5), (3, 5), (7, 1), (10, 5),
                                 (20, 5), (23, 4), (5, 9), (8, 0)])
def test_window_bounds_equal_reference(T, L):
    assert pest.window_bounds(T, L) == rest.window_bounds(T, L)


def test_default_windows_equal_reference():
    assert pest.DEFAULT_WINDOWS == rest.DEFAULT_WINDOWS


@pytest.mark.parametrize("T,L,prior", [(3, 5, 0.5), (10, 5, 0.25),
                                       (6, 1, 0.7), (9, 3, 2.0)])
def test_window_avg_bitwise(T, L, prior):
    arr = np.random.default_rng(T + L).random((T, 4, 3))
    np.testing.assert_array_equal(pest._window_avg(arr, T, L, prior),
                                  rest._window_avg(arr, T, L, prior))


@pytest.mark.parametrize("n,T,L,cap", [(4, 2, 5, np.inf), (5, 20, 5, 30.0),
                                       (3, 6, 1, 12.5), (6, 11, 4, np.inf)])
def test_estimate_traces_bitwise(n, T, L, cap):
    tr = rc.testbed_like_costs(n, T, np.random.default_rng(n * T), cap=cap)
    got = pest.estimate_traces(tr, L=L)
    _same_traces(got, rest.estimate_traces(tr, L=L))
    assert got.cap_link is not tr.cap_link       # copied, not aliased


def test_estimate_traces_mixed_capacities_bitwise():
    """Finite capacities are averaged, infinite ones stay infinite."""
    tr = rc.synthetic_costs(5, 9, np.random.default_rng(4))
    tr.cap_node[:, ::2] = 25.0 + np.arange(9)[:, None]
    got = pest.estimate_traces(tr, L=3)
    _same_traces(got, rest.estimate_traces(tr, L=3))
    assert np.isinf(got.cap_node[:, 1::2]).all()
    assert np.isfinite(got.cap_node[:, ::2]).all()


def test_estimate_traces_all_inf_capacity_stays_inf():
    tr = rc.synthetic_costs(3, 8, np.random.default_rng(2))   # cap = inf
    got = pest.estimate_traces(tr, L=4)
    assert np.isinf(got.cap_node).all()
    _same_traces(got, rest.estimate_traces(tr, L=4))


def test_estimate_traces_single_window_is_prior():
    tr = rc.synthetic_costs(3, 6, np.random.default_rng(1))
    got = pest.estimate_traces(tr, L=1, prior=0.25)
    assert np.all(got.c_node == 0.25) and np.all(got.c_link == 0.25)
    _same_traces(got, rest.estimate_traces(tr, L=1, prior=0.25))


@pytest.mark.parametrize("shape,L", [((2, 2), 9), ((20, 7), 5), ((6, 3), 1),
                                     ((0, 4), 5), ((13, 5), 4)])
def test_estimate_counts_bitwise(shape, L):
    D = np.random.default_rng(sum(shape)).poisson(9, shape).astype(float)
    got = pest.estimate_counts(D, L=L)
    assert got.shape == D.shape
    np.testing.assert_array_equal(got, rest.estimate_counts(D, L=L))
