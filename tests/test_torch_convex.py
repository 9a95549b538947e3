"""The port's convex solver (Lemma 1: masked softmax over [s | r] +
Adam) and ``solve_setting`` against the reference.

The solver is float32 on both sides with different reduction orders,
so plans are held within tolerances: max |Δs|, |Δr| ≤ 1e-3 and the
objective (``plan_cost(...)["total"]`` under the same error model)
within rtol 1e-4, the port started from the reference's own ``z0``
(drawn here with ``jax.random``).

Where the capacity penalty binds and the error cost is linear in G
(``discard`` and ``neg_G`` on setting-D/E inputs at 800 iterations),
the descent is chaotic in the reference itself: moving its ``z0`` by
1e-7 relative moves its own plan by more than 1e-3. No reimplementation
can be held closer than that, so on those inputs the port is held to
twice the spread of the reference's own runs from ``z0·(1 + k·1e-7)``,
k = −2..2, and the test asserts that the spread exceeds the tolerance.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import costs as rc
from repro.core import estimator as rest
from repro.core import movement as rmv
from repro.core import schedule as rs
from repro.core import topology as rt
from repro.launch import train as rtrain
from repro_torch.core import movement as pmv
from repro_torch.core import schedule as ps
from repro_torch.launch import train as ptrain

ATOL_PLAN, RTOL_OBJ = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The solver's many small ops run on one thread: under the test
    workers' load, intra-op threads only wait for each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _problem(n, T, setting, seed=1, rho=0.5):
    """(planning traces, adj, planning counts): testbed costs, a random
    topology and Poisson counts; setting E adds capacities at the mean
    count and plans on window estimates."""
    rng = np.random.default_rng(seed)
    tr = rc.testbed_like_costs(n, T, rng)
    adj = rt.make_topology("random", n, rng, rho=rho)
    D = rng.poisson(20, (T, n)).astype(float)
    if setting == "E":
        tr = rest.estimate_traces(rc.with_capacity(tr, float(D.mean())))
        D = rest.estimate_counts(D)
    return tr, adj, D


def _z0(T, n, seed=0):
    return 0.01 * jax.random.normal(jax.random.PRNGKey(seed), (T, n, n + 1))


def _ref_plan(tr, adj, D, z0, em, iters):
    s, r = rmv._convex_run(*rmv._convex_inputs(tr, adj, D), z0,
                           error_model=em, gamma=1.0, iters=iters, lr=0.05,
                           capacity_penalty=50.0, batched=False)
    return rmv.MovementPlan(s=np.asarray(s, float), r=np.asarray(r, float))


def _obj(plan, tr, D, em):
    return rmv.plan_cost(plan, tr, D, error_model=em)["total"]


def _assert_close(got, want, tr, D, em):
    np.testing.assert_allclose(got.s, want.s, rtol=0, atol=ATOL_PLAN)
    np.testing.assert_allclose(got.r, want.r, rtol=0, atol=ATOL_PLAN)
    np.testing.assert_allclose(_obj(got, tr, D, em), _obj(want, tr, D, em),
                               rtol=RTOL_OBJ)


def _assert_within_own_spread(got, runs, tr, D, em):
    """``runs``: the reference's plans from z0·(1 + k·1e-7), k = −2..2
    (the middle one from z0 itself)."""
    mid = runs[len(runs) // 2]
    s_spread = max(np.abs(p.s - mid.s).max() for p in runs)
    objs = [_obj(p, tr, D, em) for p in runs]
    obj_spread = max(objs) - min(objs)
    assert s_spread > ATOL_PLAN        # the reference alone misses 1e-3
    assert np.abs(got.s - mid.s).max() <= 2 * s_spread
    assert np.abs(got.r - mid.r).max() <= 2 * s_spread
    assert abs(_obj(got, tr, D, em) - objs[len(runs) // 2]) \
        <= 2 * obj_spread


N, T = 12, 10
WELL_POSED = [(em, "B", it) for em in ("discard", "neg_G", "sqrt")
              for it in (50, 800)] + \
    [(em, "E", 50) for em in ("discard", "neg_G", "sqrt")] + \
    [("sqrt", "E", 800)]


@pytest.mark.parametrize("em,setting,iters", WELL_POSED)
def test_solve_convex_matches_reference_at_its_z0(em, setting, iters):
    tr, adj, D = _problem(N, T, setting)
    z0 = _z0(T, N)
    want = _ref_plan(tr, adj, D, z0, em, iters)
    got = pmv.solve_convex(tr, adj, D, error_model=em, iters=iters,
                           z0=np.asarray(z0), device="cpu")
    _assert_close(got, want, tr, D, em)


@pytest.mark.parametrize("em", ["discard", "neg_G"])
def test_capacity_bound_linear_models_within_reference_spread(em):
    tr, adj, D = _problem(N, T, "E")
    z0 = _z0(T, N)
    runs = [_ref_plan(tr, adj, D, z0 * (1 + k * 1e-7), em, 800)
            for k in (-2, -1, 0, 1, 2)]
    got = pmv.solve_convex(tr, adj, D, error_model=em, iters=800,
                           z0=np.asarray(z0), device="cpu")
    _assert_within_own_spread(got, runs, tr, D, em)


@pytest.mark.parametrize("em", ["sqrt", "neg_G"])
def test_solve_convex_on_a_schedule_matches_reference(em):
    """A time-varying schedule: the support mask changes by round."""
    rng = np.random.default_rng(4)
    n, T_ = 8, 6
    tr = rc.testbed_like_costs(n, T_, rng)
    adj3 = rng.random((T_, n, n)) < 0.5
    D = rng.poisson(20, (T_, n)).astype(float)
    z0 = _z0(T_, n, 3)
    want = _ref_plan(tr, rs.NetworkSchedule.full(adj3), D, z0, em, 800)
    got = pmv.solve_convex(tr, ps.NetworkSchedule.full(adj3), D,
                           error_model=em, z0=np.asarray(z0), device="cpu")
    _assert_close(got, want, tr, D, em)
    for t in range(T_ - 1):      # shares only on each round's own links
        off = ~(adj3[t] | np.eye(n, dtype=bool))
        assert np.all(got.s[t][off] == 0.0)


def test_batched_equals_sequential():
    probs = [_problem(9, 7, "B", seed=sd) for sd in (5, 6, 7)]
    seeds = [0, 1, 2]
    trs, adjs, Ds = zip(*probs)
    batched = pmv.solve_convex_batched(list(trs), list(adjs), list(Ds),
                                       iters=300, seeds=seeds, device="cpu")
    for (tr, adj, D), sd, got in zip(probs, seeds, batched):
        want = pmv.solve_convex(tr, adj, D, iters=300, seed=sd,
                                device="cpu")
        np.testing.assert_allclose(got.s, want.s, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.r, want.r, rtol=0, atol=1e-5)


def test_batched_int_seed_gives_every_scenario_the_same_start():
    tr, adj, D = _problem(6, 5, "B")
    a, b = pmv.solve_convex_batched([tr, tr], [adj, adj], [D, D], iters=20,
                                    seeds=3, device="cpu")
    np.testing.assert_array_equal(a.s, b.s)
    one = pmv.solve_convex(tr, adj, D, iters=20, seed=3, device="cpu")
    np.testing.assert_allclose(a.s, one.s, rtol=0, atol=1e-6)


@pytest.mark.parametrize("em", ["sqrt", "neg_G"])
def test_default_z0_reaches_the_reference_objective(em):
    """Each package from its own default start (torch's seeded randn,
    jax's PRNGKey(0)) reaches the same objective."""
    tr, adj, D = _problem(N, T, "B")
    want = rmv.solve_convex(tr, adj, D, error_model=em)
    got = pmv.solve_convex(tr, adj, D, error_model=em, device="cpu")
    np.testing.assert_allclose(_obj(got, tr, D, em), _obj(want, tr, D, em),
                               rtol=RTOL_OBJ)


def test_convex_solver_feasible_and_competitive():
    """The reference's own check (tests/test_movement.py) on the port."""
    rng = np.random.default_rng(1)
    n, T_ = 6, 6
    tr = rc.synthetic_costs(n, T_, rng, f_err=3.0)
    adj = rt.fully_connected(n)
    D = np.full((T_, n), 30.0)
    plan = pmv.solve_convex(tr, adj, D, error_model="sqrt", gamma=5.0,
                            iters=400, device="cpu")
    plan.check(adj)

    def cost(p):
        return pmv.plan_cost(p, tr, D, error_model="sqrt",
                             gamma=5.0)["total"]

    val = cost(plan)
    assert val <= cost(pmv.no_movement_plan(T_, n)) * 1.02
    assert val <= cost(pmv.MovementPlan(s=np.zeros((T_, n, n)),
                                        r=np.ones((T_, n)))) * 1.02


@pytest.mark.parametrize("gamma,c_srv,c_t", [(2.0, 0.1, 0.05),
                                             (0.5, 0.3, 0.2)])
def test_theorem4_closed_form_bitwise(gamma, c_srv, c_t):
    rng = np.random.default_rng(0)
    c = rng.uniform(0.1, 1.0, 5)
    D = rng.uniform(1.0, 2000.0, 5)
    for got, want in zip(pmv.theorem4_closed_form(c, c_srv, c_t, gamma, D),
                         rmv.theorem4_closed_form(c, c_srv, c_t, gamma, D)):
        np.testing.assert_array_equal(got, want)


def _setting_problem():
    rng = np.random.default_rng(8)
    n, T_ = 8, 8
    tr = rc.testbed_like_costs(n, T_, rng)
    adj = rt.make_topology("random", n, rng, rho=0.6,
                           costs=tr.c_node.mean(0))
    D = rng.poisson(20, (T_, n)).astype(float)
    return tr, adj, D


def _ref_setting(setting, tr, adj, D, em, z0):
    """The reference's ``solve_setting`` with the convex start ``z0``
    (its own default start is ``_z0(T, n, 0)``)."""
    if setting in ("D", "E"):
        tr_true = rc.with_capacity(tr, float(D.mean()))
    else:
        tr_true = tr
    tp, Dp = tr_true, D
    if setting in ("C", "E"):
        tp, Dp = rest.estimate_traces(tr_true), rest.estimate_counts(D)
    plan = _ref_plan(tp, adj, Dp, z0, em, 800)
    if setting in ("D", "E"):
        plan = rmv.repair_capacities(plan, tr_true, adj, D)
    return plan


@pytest.mark.parametrize("setting", list("ABCDE"))
def test_solve_setting_discard_plans_equal_reference(setting):
    tr, adj, D = _setting_problem()
    want = rtrain.solve_setting(setting, tr, adj, D)
    got = ptrain.solve_setting(setting, tr, adj, D, device="cpu")
    assert pmv.plans_equal(got, want)


@pytest.mark.parametrize("setting,em", [(s, "sqrt") for s in "ABCDE"]
                         + [(s, "neg_G") for s in "ABC"])
def test_solve_setting_convex_matches_reference(setting, em):
    tr, adj, D = _setting_problem()
    T_, n = D.shape
    want = rtrain.solve_setting(setting, tr, adj, D, error_model=em)
    if setting != "A":         # the helper replays the reference exactly
        assert rmv.plans_equal(
            _ref_setting(setting, tr, adj, D, em, _z0(T_, n)), want)
    got = ptrain.solve_setting(setting, tr, adj, D, error_model=em,
                               z0=np.asarray(_z0(T_, n)), device="cpu")
    _assert_close(got, want, tr, D, em)


@pytest.mark.parametrize("setting", ["D", "E"])
def test_solve_setting_neg_G_with_capacity_within_reference_spread(setting):
    tr, adj, D = _setting_problem()
    T_, n = D.shape
    z0 = _z0(T_, n)
    runs = [_ref_setting(setting, tr, adj, D, "neg_G", z0 * (1 + k * 1e-7))
            for k in (-2, -1, 0, 1, 2)]
    assert rmv.plans_equal(runs[2], rtrain.solve_setting(
        setting, tr, adj, D, error_model="neg_G"))
    got = ptrain.solve_setting(setting, tr, adj, D, error_model="neg_G",
                               z0=np.asarray(z0), device="cpu")
    _assert_within_own_spread(got, runs, tr, D, "neg_G")
