"""The tier restriction (``core/hierarchy``: ``restrict_traces``,
``restrict_schedule``, ``solve_tier_movement``) and the port's fog-scale
benches (``launch/tables.sparse_scale`` and ``hier_scale``, at a small
``max_n``) against the same composition of reference functions that
``benchmarks/run.py`` runs (never its bench functions, which write
``results/``).

Tolerances: the restriction and the planners are numpy copies, so
traces, schedules and plans are equal bit for bit (``plans_equal``);
the traffic row is equal; the L = 1 claim (a one-tier tree is the flat
scan bit for bit) holds in both packages.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import costs as rc
from repro.core import engine as reng
from repro.core import estimator as rest
from repro.core import federated as RF
from repro.core import hierarchy as rh
from repro.core import movement as rmv
from repro.core import topology as rt
from repro.data import pipeline as rpl
from repro_torch.core import costs as tc
from repro_torch.core import hierarchy as th
from repro_torch.core import movement as tmv
from repro_torch.core import topology as tt
from repro_torch.launch import tables as tb


def _same_plan(got, want):
    assert tmv.plans_equal(got, want)
    np.testing.assert_array_equal(got.r, want.r)
    for f in ("t", "src", "dst", "qty"):
        np.testing.assert_array_equal(getattr(got.edges, f),
                                      getattr(want.edges, f))


def _same_edges(got, want, T):
    assert (got.T, got.n, got.storage) == (want.T, want.n, want.storage)
    np.testing.assert_array_equal(got.activity(), want.activity())
    for t in range(T):
        for a, b in zip(got.edges_at(t), want.edges_at(t)):
            np.testing.assert_array_equal(a, b)


def _tier_problem(n, T, spec, kind, seed=0, cap=np.inf):
    src, dst = rt.random_sparse_edges(n, 6, np.random.default_rng(seed))
    out = []
    for hr, costs, topo in ((rh, rc, rt), (th, tc, tt)):
        tree = hr.TierTree.from_spec(spec, n)
        etr = costs.synthetic_edge_costs(n, T, src, dst,
                                         np.random.default_rng(seed + 1),
                                         cap=cap)
        if kind == "churn":
            sched = topo.churn_schedule_edges(
                n, src, dst, T, 0.1, 0.3, np.random.default_rng(seed + 2),
                tau=2, node_offset=1)
        elif kind == "flap":
            sched = topo.link_flap_schedule_edges(
                n, src, dst, T, np.random.default_rng(seed + 2), p_down=0.3)
        else:                                   # a dense static matrix
            A = np.zeros((n, n), bool)
            A[src, dst] = True
            sched = A
        out.append((tree, etr, sched))
    return out


@pytest.mark.parametrize("kind", ["churn", "flap", "static"])
@pytest.mark.parametrize("spec,n", [("4@2,1@4", 40), ("6@2,2@4,1@8", 90)])
def test_restriction_and_tier_movement_bitwise(kind, spec, n):
    T = 8
    (tree_r, etr_r, s_r), (tree_t, etr_t, s_t) = _tier_problem(n, T, spec,
                                                               kind)
    got, want = th.restrict_traces(tree_t, etr_t), \
        rh.restrict_traces(tree_r, etr_r)
    for f in ("c_node", "f_err", "cap_node", "indptr", "indices", "c_link",
              "cap_link"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.E < etr_t.E
    g = tree_t.parents[0]
    assert (g[got.src] == g[got.indices]).all()
    if kind != "static":
        _same_edges(th.restrict_schedule(tree_t, s_t),
                    rh.restrict_schedule(tree_r, s_r), T)
    for realize in (True, False):
        _same_plan(th.solve_tier_movement(tree_t, etr_t, s_t,
                                          realize=realize),
                   rh.solve_tier_movement(tree_r, etr_r, s_r,
                                          realize=realize))


def test_tier_movement_with_repair_bitwise():
    n, T = 40, 8
    (tree_r, etr_r, s_r), (tree_t, etr_t, s_t) = _tier_problem(
        n, T, "4@2,1@4", "churn", cap=2.0)
    D = np.random.default_rng(3).integers(0, 5, (T, n)).astype(float)
    got = th.solve_tier_movement(tree_t, etr_t, s_t, D=D, device="cpu")
    want = rh.solve_tier_movement(tree_r, etr_r, s_r, D=D)
    _same_plan(got, want)
    e = got.edges
    g = tree_t.parents[0]
    assert (g[e.src] == g[e.dst]).all()


# the benches at small n: sizes [1024] for sparse_scale (its dense
# oracle and the 5x floor at n = 1024, the reference CI's smallest
# row), 512 devices for hier_scale
SPARSE_N, HIER_N = 1024, 512


def _scale_data():
    rng = np.random.default_rng(0)
    x_tr = rng.random((4096, 28, 28)).astype(np.float32)
    y_tr = rng.integers(0, 10, 4096)
    x_te = rng.random((512, 28, 28)).astype(np.float32)
    y_te = rng.integers(0, 10, 512)
    return (x_tr, y_tr, x_te, y_te), rng


def test_sparse_scale_matches_reference_composition():
    keep = {}
    out = tb.sparse_scale(dataclasses.replace(tb.QUICK, max_n=SPARSE_N),
                          "cpu", keep=keep)
    hd = out["headline"]
    assert hd["plans_identical"] and hd["predictions_identical"]
    assert hd["kernel_plan_identical"]
    assert hd["plan_speedup_vs_dense"] >= 5.0
    # the plan rows, as benchmarks/run.py composes them
    (row,) = out["rows"]
    src, dst = rt.random_sparse_edges(SPARSE_N, 8, np.random.default_rng(0))
    sched = rt.churn_schedule_edges(SPARSE_N, src, dst, 16, 0.05, 0.2,
                                    np.random.default_rng(7))
    etr = rc.synthetic_edge_costs(SPARSE_N, 16, src, dst,
                                  np.random.default_rng(1))
    plan = rmv.realize_plan(rmv.greedy_linear(etr, sched), sched)
    assert row["edges"] == len(plan.edges)
    pred = rest.predict_schedule(sched)
    assert len(pred.events_in(0, 16)) > 0
    # the trained problem: same schedule, costs, plan and streams
    data, rng = _scale_data()
    src, dst = rt.random_sparse_edges(SPARSE_N, 8, rng)
    sched = rt.churn_schedule_edges(SPARSE_N, src, dst, 50, 0.05, 0.2,
                                    np.random.default_rng(7))
    etr = rc.synthetic_edge_costs(SPARSE_N, 50, src, dst,
                                  np.random.default_rng(1))
    plan = rmv.realize_plan(rmv.greedy_linear(etr, sched), sched)
    flat = rpl.poisson_streams_flat(SPARSE_N, 50, data[1],
                                    rng=np.random.default_rng(3),
                                    mean_per_round=1.0)
    _same_plan(keep["plan"], plan)
    _same_edges(keep["schedule"], sched, 50)
    for f in ("t", "dev", "idx"):
        np.testing.assert_array_equal(getattr(keep["streams"], f),
                                      getattr(flat, f))
    tr = out["train"]
    assert (tr["n"], tr["T"], tr["samples"]) == (SPARSE_N, 50,
                                                 flat.idx.shape[0])
    hist = keep["hist"]
    assert hist["agg_round"] == [9, 19, 29, 39, 49]
    assert np.isfinite(np.stack(hist["device_loss"])).all()


def test_hier_scale_matches_reference_composition():
    keep = {}
    out = tb.hier_scale(dataclasses.replace(tb.QUICK, max_n=HIER_N), "cpu",
                        keep=keep)
    n = HIER_N
    tree = rh.TierTree.balanced(n, (max(2, n // 100), max(1, n // 3200), 1),
                                (5, 10, 20))
    assert out["tiers"]["group_counts"] == list(tree.group_counts)
    assert keep["tree"].fingerprint() == tree.fingerprint()
    data, rng = _scale_data()
    src, dst = rt.random_sparse_edges(n, 8, rng)
    sched = rt.churn_schedule_edges(n, src, dst, 50, 0.05, 0.2,
                                    np.random.default_rng(7), tau=5,
                                    node_offset=1)
    etr = rc.synthetic_edge_costs(n, 50, src, dst, np.random.default_rng(1))
    _same_plan(keep["plan"], rh.solve_tier_movement(tree, etr, sched))
    params, apply_fn = reng.make_model("linear", jax.random.PRNGKey(0))
    n_params = int(sum(p.size for p in jax.tree_util.tree_leaves(params)))
    assert out["traffic"] == rh.tier_traffic(tree, n_params)
    assert out["headline"]["cross_gateway_edges"] == 0
    hist = keep["hist"]
    assert hist["tier_agg_level"] == [1, 2, 1, 3, 1, 2, 1, 3, 1, 2]
    assert hist["agg_round"] == [19, 39]
    # the L = 1 claim, composed from the reference's functions
    n_s = 64
    src, dst = rt.random_sparse_edges(n_s, 4, np.random.default_rng(2))
    sched = rt.churn_schedule_edges(n_s, src, dst, 20, 0.1, 0.3,
                                    np.random.default_rng(7), tau=5)
    flat = rpl.poisson_streams_flat(n_s, 20, data[1],
                                    rng=np.random.default_rng(3),
                                    mean_per_round=2.0)
    etr = rc.synthetic_edge_costs(n_s, 20, src, dst, np.random.default_rng(1))
    plan = rmv.realize_plan(rmv.greedy_linear(etr, sched), sched)
    cfg = RF.FedConfig(n=n_s, T=20, tau=5, eta=0.1, model="linear", seed=0)
    kw = dict(streams=flat, schedule=sched, engine="scan")
    h1 = RF.run_network_aware(cfg, data, etr, None, plan,
                              hierarchy=rh.TierTree.balanced(n_s, (1,), (5,)),
                              **kw)
    h0 = RF.run_network_aware(cfg, data, etr, None, plan, **kw)
    ref_l1 = all(np.array_equal(np.asarray(h1[k]), np.asarray(h0[k]))
                 for k in ("device_loss", "test_loss", "test_acc", "H_agg"))
    assert out["headline"]["l1_collapse_bitwise"] == ref_l1 is True
