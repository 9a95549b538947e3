"""The port's capacity repair against the reference's.

``repair_capacities`` (streamed over the sparse plan),
``repair_capacities_dense`` and ``repair_capacities_loop`` are host
numpy copies with the reference's arithmetic order, so each is held
bitwise (edges and discard vector) to the reference's
``repair_capacities`` on the same input plan: greedy (bang-bang) plans
and fractional plans from the reference's convex solver (solved once,
its ``s, r`` fed to both packages), static, (T, n, n) and schedule
adjacency, rounds with no data or no edges, n ∈ {1, 7, 30}. The
repaired plans respect the capacities to 1e-6, as
``tests/test_movement.py`` checks for the reference.
"""
import functools

import numpy as np
import pytest

from repro.core import costs as rc
from repro.core import movement as rmv
from repro.core import schedule as rs
from repro.core import topology as rt
from repro_torch.core import movement as pmv
from repro_torch.core import schedule as ps


def _same_plan(got, want):
    e, f = got.edges, want.edges
    for a in ("t", "src", "dst", "qty"):
        np.testing.assert_array_equal(getattr(e, a), getattr(f, a),
                                      err_msg=a)
    np.testing.assert_array_equal(got.r, want.r)


def _port_plan(plan, fractional):
    """The reference plan as a port plan: dense for fractional plans,
    edges for greedy ones."""
    if fractional:
        return pmv.MovementPlan(s=plan.s.copy(), r=plan.r.copy())
    e = plan.edges
    return pmv.MovementPlan(r=plan.r.copy(), edges=pmv.PlanEdges(
        t=e.t.copy(), src=e.src.copy(), dst=e.dst.copy(),
        qty=e.qty.copy()), n=plan.n)


@functools.lru_cache(maxsize=None)
def _case(n, T, adj_kind, fractional, empty, seed):
    """Reference problem and input plan: the plan is solved without
    capacities and repaired against tight node and link capacities, so
    every repair stage fires; ``empty`` zeroes the counts of round 1 and
    makes round T-2 discard everything (no edges)."""
    rng = np.random.default_rng(seed)
    base = rc.testbed_like_costs(n, T, rng, f_err=0.9)
    tr = rc.with_capacity(base, cap_node=14.0, cap_link=6.0)
    D = rng.poisson(20, (T, n)).astype(float)
    if adj_kind == "static":
        adj = rt.make_topology("random", n, rng, rho=0.6)
    else:
        adj = rng.random((T, n, n)) < 0.6
    if fractional:
        plan = rmv.solve_convex(base, adj, D, error_model="neg_G",
                                iters=100)
    else:
        plan = rmv.greedy_linear(base, adj)
    if empty:
        D[1] = 0.0
        s, r = plan.s.copy(), plan.r.copy()
        s[T - 2], r[T - 2] = 0.0, 1.0
        plan = rmv.MovementPlan(s=s, r=r)
        if not fractional:
            plan = rmv.MovementPlan(r=r, edges=plan.edges, n=n)
    return tr, adj, D, plan


CASES = [(7, 8, "static", False, False), (30, 6, "static", False, False),
         (7, 5, "stack", False, False), (1, 4, "static", False, False),
         (7, 8, "static", True, False), (7, 5, "stack", True, False),
         (30, 6, "static", True, False), (1, 4, "static", True, False),
         (7, 6, "static", False, True), (7, 6, "stack", True, True)]


@pytest.mark.parametrize("variant", ["repair_capacities",
                                     "repair_capacities_dense",
                                     "repair_capacities_loop"])
@pytest.mark.parametrize("n,T,adj_kind,fractional,empty", CASES)
def test_repair_bitwise_equals_reference(variant, n, T, adj_kind,
                                         fractional, empty):
    tr, adj, D, plan = _case(n, T, adj_kind, fractional, empty, n + T)
    want = rmv.repair_capacities(plan, tr, adj, D)
    got = getattr(pmv, variant)(_port_plan(plan, fractional), tr, adj, D)
    _same_plan(got, want)
    # the reference variant of the same name agrees too
    _same_plan(got, getattr(rmv, variant)(plan, tr, adj, D))


@pytest.mark.parametrize("n,T,adj_kind,fractional,empty", CASES)
def test_repair_satisfies_capacities(n, T, adj_kind, fractional, empty):
    tr, adj, D, plan = _case(n, T, adj_kind, fractional, empty, n + T)
    got = pmv.repair_capacities(_port_plan(plan, fractional), tr, adj, D)
    got.check(adj)
    G = got.processed(D)
    assert np.all(G <= tr.cap_node + 1e-6), G.max()
    link_vol = got.s * (1 - np.eye(n))[None] * D[:, :, None]
    assert np.all(link_vol <= tr.cap_link + 1e-6)


@pytest.mark.parametrize("fractional", [False, True])
def test_repair_on_a_schedule_equals_reference(fractional):
    """A time-varying NetworkSchedule (each package's own class) gives
    the same repair as the (T, n, n) stack it holds."""
    tr, adj3, D, plan = _case(7, 5, "stack", fractional, False, 12)
    want = rmv.repair_capacities(plan, tr, rs.NetworkSchedule.full(adj3), D)
    got = pmv.repair_capacities(_port_plan(plan, fractional), tr,
                                ps.NetworkSchedule.full(adj3), D)
    _same_plan(got, want)


def test_round_dense_and_check_equal_reference():
    tr, adj, D, plan = _case(7, 8, "static", True, False, 15)
    port = _port_plan(plan, True)
    buf = np.full((7, 7), 9.0)
    for t in range(8):
        np.testing.assert_array_equal(port.round_dense(t, out=buf),
                                      plan.round_dense(t))
        np.testing.assert_array_equal(port.round_dense(t),
                                      plan.round_dense(t))
    port.check(adj)
    bad = pmv.MovementPlan(s=np.ones((2, 3, 3)), r=np.zeros((2, 3)))
    with pytest.raises(AssertionError):
        bad.check(np.ones((3, 3), bool))
