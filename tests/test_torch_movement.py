"""The port's Theorem-3 planner and plan costing against the reference.

* ``greedy_linear(backend="numpy")`` is a bitwise copy of the
  reference's numpy backend (float64 adds);
* the port's device path on the CPU — the kernel's plain version, float32
  adds — equals the reference's device backends ``"jnp"`` and
  ``"pallas"`` (interpret mode), which cast to float32 the same way. It
  is not held bitwise to the numpy plan (float64 vs float32 adds);
* ``plan_cost`` dicts are equal.
"""
import numpy as np
import pytest
import torch

from repro.core import costs as rc
from repro.core import movement as rmv
from repro.core import schedule as rs
from repro.core import topology as rt
from repro_torch.core import movement as tmv
from repro_torch.core import schedule as ts


def _same_plan(got, want):
    e, f = got.edges, want.edges
    for a in ("t", "src", "dst", "qty"):
        np.testing.assert_array_equal(getattr(e, a), getattr(f, a))
    np.testing.assert_array_equal(got.r, want.r)


def _problem(T, n, rho, seed, kind="synthetic"):
    rng = np.random.default_rng(seed)
    mk = rc.testbed_like_costs if kind == "testbed" else rc.synthetic_costs
    tr = mk(n, T, rng)
    adj = rt.make_topology("random", n, rng, rho=rho)
    return tr, adj


@pytest.mark.parametrize("T,n,rho,seed,kind", [
    (1, 4, 1.0, 0, "synthetic"), (2, 8, 0.5, 1, "testbed"),
    (9, 16, 0.3, 2, "synthetic"), (30, 64, 0.7, 3, "testbed"),
])
def test_numpy_backend_plans_equal_reference(T, n, rho, seed, kind):
    tr, adj = _problem(T, n, rho, seed, kind)
    _same_plan(tmv.greedy_linear(tr, adj, backend="numpy"),
               rmv.greedy_linear(tr, adj, backend="numpy"))


def test_numpy_backend_time_varying_and_receiver_aware():
    rng = np.random.default_rng(5)
    T, n = 6, 10
    tr = rc.synthetic_costs(n, T, rng)
    adj3 = rng.random((T, n, n)) < 0.5
    _same_plan(tmv.greedy_linear(tr, adj3, backend="numpy"),
               rmv.greedy_linear(tr, adj3, backend="numpy"))
    adj = rt.random_graph(n, 0.6, rng)
    active = rng.random((T, n)) < 0.7
    _same_plan(tmv.greedy_linear(tr, ts.NetworkSchedule.constant(
        adj, T, active=active), backend="numpy"),
        rmv.greedy_linear(tr, rs.NetworkSchedule.constant(
            adj, T, active=active), backend="numpy"))


@pytest.mark.parametrize("ref_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("T,n,rho,seed", [(4, 128, 0.5, 6), (3, 256, 0.2, 7)])
def test_device_path_on_cpu_equals_reference_device_backends(
        ref_backend, T, n, rho, seed):
    tr, adj = _problem(T, n, rho, seed)
    want = rmv.greedy_linear(tr, adj, backend=ref_backend)
    got = tmv.greedy_linear(tr, adj, backend="cuda", device="cpu")
    _same_plan(got, want)


def test_device_path_receiver_mask_and_ragged_n():
    """n not a multiple of 128 and a churn-style active trace: the
    device operands (final round emptied, receivers gone at t+1 masked)
    give the reference's jnp-backend plan."""
    rng = np.random.default_rng(11)
    T, n = 5, 100
    tr = rc.synthetic_costs(n, T, rng)
    adj = rt.random_graph(n, 0.3, rng)
    active = rng.random((T, n)) < 0.8
    got = tmv.greedy_linear(tr, ts.NetworkSchedule.constant(
        adj, T, active=active), backend="cuda", device="cpu")
    want = rmv.greedy_linear(tr, rs.NetworkSchedule.constant(
        adj, T, active=active), backend="jnp")
    _same_plan(got, want)


def test_auto_backend_uses_numpy_on_cpu_and_below_kernel_n():
    tr, adj = _problem(3, 300, 0.3, 1)
    _same_plan(tmv.greedy_linear(tr, adj, device="cpu"),
               rmv.greedy_linear(tr, adj, backend="numpy"))
    tr, adj = _problem(3, 12, 0.5, 2)
    _same_plan(tmv.greedy_linear(tr, adj),        # n < 256: no device
               rmv.greedy_linear(tr, adj, backend="numpy"))
    with pytest.raises(ValueError):
        tmv.greedy_linear(tr, adj, backend="pallas")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is tested on it")
    tr, adj = _problem(2, 8, 0.5, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        tmv.greedy_linear(tr, adj, backend="cuda")


@pytest.mark.parametrize("setting", ["A", "B"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_cost_and_plan_views_equal(setting, seed):
    T, n = 7, 9
    tr, adj = _problem(T, n, 0.6, seed, "testbed")
    D = np.random.default_rng(seed).poisson(20, (T, n)).astype(float)
    if setting == "A":
        got, want = tmv.no_movement_plan(T, n), rmv.no_movement_plan(T, n)
    else:
        got = tmv.greedy_linear(tr, adj, backend="numpy")
        want = rmv.greedy_linear(tr, adj, backend="numpy")
    _same_plan(got, want)
    assert tmv.plan_cost(got, tr, D) == rmv.plan_cost(want, tr, D)
    for em in ("neg_G", "sqrt"):
        assert tmv.plan_cost(got, tr, D, error_model=em) == \
            rmv.plan_cost(want, tr, D, error_model=em)
    np.testing.assert_array_equal(got.s, want.s)
    np.testing.assert_array_equal(got.processed(D), want.processed(D))
    np.testing.assert_array_equal(got.offload_fraction(),
                                  want.offload_fraction())
    assert tmv.plans_equal(got, got)
    assert tmv.plans_equal(got, tmv.no_movement_plan(T, n)) == \
        (setting == "A")
