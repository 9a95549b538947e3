"""The port's sparse O(E) network plane against the reference, on the
same numpy-seeded inputs: edge cost traces (``core/costs``), the
edge-list topology producers (``core/topology``), ``expected_cost_traces``
on edge traces, the O(E) Theorem-3 rule ``greedy_linear_edges``, the
stable top-k (``kernels/ops``), ``repair_capacities_edges`` and the
edge ``plan_cost``.

Tolerances: everything here is numpy copied with the same arithmetic,
or (the top-k) a selection, so every comparison is exact: arrays equal
bit for bit, plans ``plans_equal``, producers leaving their generators
in the same state, and cost dicts equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.schedule as rsched_mod
import repro_torch.core.schedule as tsched_mod
from repro.core import costs as rc
from repro.core import estimator as rest
from repro.core import movement as rmv
from repro.core import topology as rt
from repro.kernels import ops as rops
from repro_torch.core import costs as tc
from repro_torch.core import estimator as test_
from repro_torch.core import movement as tmv
from repro_torch.core import topology as tt
from repro_torch.kernels import ops as tops

EDGE_FIELDS = ("c_node", "f_err", "cap_node", "indptr", "indices", "c_link",
               "cap_link")


def _edges_equal(got, want):
    for f in EDGE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.src, want.src)


def _same_schedule(got, want):
    """Same storage, activity and edge list at every round (forward,
    then random access that restarts the replay)."""
    assert (got.T, got.n, got.storage) == (want.T, want.n, want.storage)
    np.testing.assert_array_equal(got.activity(), want.activity())
    for t in list(range(want.T)) + [2, 0, want.T - 1]:
        for a, b in zip(got.edges_at(t), want.edges_at(t)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.active_at(t), want.active_at(t))
    for a, b in zip(got.union_csr(), want.union_csr()):
        np.testing.assert_array_equal(a, b)


def _support(n, deg, seed):
    return rt.random_sparse_edges(n, deg, np.random.default_rng(seed))


@pytest.mark.parametrize("n,deg,seed", [(5, 2, 0), (40, 4, 1), (300, 8, 2)])
def test_support_producers_bitwise(n, deg, seed):
    rr, rg = np.random.default_rng(seed), np.random.default_rng(seed)
    for a, b in zip(tt.random_sparse_edges(n, deg, rg),
                    rt.random_sparse_edges(n, deg, rr)):
        np.testing.assert_array_equal(a, b)
    assert rr.random() == rg.random()
    for k in (1, 2, 5, 8):
        for a, b in zip(tt.ring_lattice_edges(n, k),
                        rt.ring_lattice_edges(n, k)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,T,seed", [(12, 5, 0), (200, 9, 3)])
def test_edge_cost_traces_bitwise(n, T, seed):
    src, dst = _support(n, 3, seed)
    rr, rg = np.random.default_rng(seed), np.random.default_rng(seed)
    want = rc.synthetic_edge_costs(n, T, src, dst, rr, f_err=0.6, cap=4.0)
    got = tc.synthetic_edge_costs(n, T, src, dst, rg, f_err=0.6, cap=4.0)
    _edges_equal(got, want)
    assert (got.T, got.n, got.E) == (want.T, want.n, want.E)
    assert rr.random() == rg.random()
    q_src = np.random.default_rng(9).integers(0, n, 50)
    q_dst = np.random.default_rng(10).integers(0, n, 50)
    q_src[:5], q_dst[:5] = src[:5], dst[:5]           # some hits
    np.testing.assert_array_equal(got.edge_ids(q_src, q_dst),
                                  want.edge_ids(q_src, q_dst))
    dense = rc.synthetic_costs(n, T, np.random.default_rng(seed))
    _edges_equal(tc.edge_costs_from_dense(
        tc.CostTraces(*(getattr(dense, f) for f in
                        ("c_node", "c_link", "f_err", "cap_node",
                         "cap_link"))), src, dst),
        rc.edge_costs_from_dense(dense, src, dst))


@pytest.mark.parametrize("tau,offset", [(None, 0), (3, 0), (4, 5)])
def test_churn_schedule_edges_bitwise(tau, offset):
    n, T = 30, 11
    src, dst = _support(n, 3, 1)
    rr, rg = np.random.default_rng(8), np.random.default_rng(8)
    want = rt.churn_schedule_edges(n, src, dst, T, 0.2, 0.3, rr, tau=tau,
                                   node_offset=offset)
    got = tt.churn_schedule_edges(n, src, dst, T, 0.2, 0.3, rg, tau=tau,
                                  node_offset=offset)
    _same_schedule(got, want)
    assert rr.random() == rg.random()


@pytest.mark.parametrize("offset", [0, 3])
def test_link_flap_schedule_edges_bitwise(offset):
    n, T = 30, 12
    src, dst = _support(n, 3, 2)
    src, dst = src[::2], dst[::2]          # some pairs one way only
    rr, rg = np.random.default_rng(4), np.random.default_rng(4)
    want = rt.link_flap_schedule_edges(n, src, dst, T, rr, p_down=0.3,
                                       p_up=0.4, node_offset=offset)
    got = tt.link_flap_schedule_edges(n, src, dst, T, rg, p_down=0.3,
                                      p_up=0.4, node_offset=offset)
    _same_schedule(got, want)
    assert len(got.events_in(0, T)) == len(want.events_in(0, T)) > 0
    assert rr.random() == rg.random()


def _edge_problem(n, T, seed=0, kind="churn", cap=np.inf):
    """(reference, port) edge traces and schedules, same draws."""
    src, dst = _support(n, 4, seed)
    out = []
    for costs, topo in ((rc, rt), (tc, tt)):
        etr = costs.synthetic_edge_costs(n, T, src, dst,
                                         np.random.default_rng(seed + 1),
                                         cap=cap)
        if kind in ("churn", "predicted"):
            sched = topo.churn_schedule_edges(
                n, src, dst, T, 0.1, 0.3, np.random.default_rng(seed + 2),
                tau=3)
        else:
            sched = topo.link_flap_schedule_edges(
                n, src, dst, T, np.random.default_rng(seed + 2), p_down=0.2)
        if kind == "predicted":           # a union smaller than the support
            sched = (rest if costs is rc else test_).predict_schedule(sched)
        out.append((etr, sched))
    return out, (src, dst)


@pytest.mark.parametrize("kind", ["churn", "flap"])
@pytest.mark.parametrize("floor", [0.05, 0.3])
def test_expected_cost_traces_on_edge_traces_bitwise(kind, floor):
    ((etr_r, s_r), (etr_t, s_t)), _ = _edge_problem(40, 15, kind=kind)
    want = rest.expected_cost_traces(etr_r, s_r, 4, floor=floor)
    got = test_.expected_cost_traces(etr_t, s_t, 4, floor=floor)
    assert isinstance(got, tc.EdgeCostTraces)
    _edges_equal(got, want)
    assert not np.array_equal(got.c_link, etr_t.c_link)


def _same_plan(got, want):
    assert tmv.plans_equal(got, want)
    np.testing.assert_array_equal(got.r, want.r)
    for f in ("t", "src", "dst", "qty"):
        np.testing.assert_array_equal(getattr(got.edges, f),
                                      getattr(want.edges, f))


@pytest.mark.parametrize("kind", ["churn", "flap", "predicted"])
@pytest.mark.parametrize("n,T,seed", [(16, 6, 0), (120, 12, 1)])
def test_greedy_linear_edges_bitwise(kind, n, T, seed):
    ((etr_r, s_r), (etr_t, s_t)), _ = _edge_problem(n, T, seed, kind)
    if kind == "predicted":
        assert s_t.union_csr()[1].size < etr_t.E
    want = rmv.realize_plan(rmv.greedy_linear(etr_r, s_r), s_r)
    got = tmv.realize_plan(tmv.greedy_linear(etr_t, s_t), s_t)
    _same_plan(got, want)
    _same_plan(tmv.greedy_linear_edges(etr_t, s_t),
               rmv.greedy_linear_edges(etr_r, s_r))
    # the port's dense numpy rule on the same costs gives the same plan
    dense = tc.synthetic_costs(n, T, np.random.default_rng(seed + 5))
    etr_d = tc.edge_costs_from_dense(dense, *_support(n, 4, seed))
    _same_plan(tmv.greedy_linear(etr_d, s_t),
               tmv.greedy_linear(dense, s_t, backend="numpy"))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_topk_neighbors_with_ties_equal_reference(seed, k):
    rng = np.random.default_rng(seed)
    T, n = 3, 9
    c_link = rng.integers(0, 3, (T, n, n)).astype(np.float32)
    c_next = rng.integers(0, 3, (T, n)).astype(np.float32)
    adj = rng.random((T, n, n)) < 0.4
    adj[:, 0] = False                         # a row with no neighbour
    want = rops.topk_neighbors(jnp.asarray(c_link), jnp.asarray(c_next),
                               jnp.asarray(adj), k=k)
    got = tops.topk_neighbors(torch.from_numpy(c_link),
                              torch.from_numpy(c_next),
                              torch.from_numpy(adj), k=k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    src, dst = np.nonzero(adj.any(0))
    indptr = np.searchsorted(src, np.arange(n + 1))
    live = adj[:, src, dst] & (src != dst)
    ce = c_link[:, src, dst]
    want = rops.topk_neighbors_csr(ce, c_next, indptr, dst, live, k=k)
    got = tops.topk_neighbors_csr(torch.from_numpy(ce),
                                  torch.from_numpy(c_next), indptr, dst,
                                  torch.from_numpy(live), k=k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("edge_costs", [True, False])
@pytest.mark.parametrize("cap", [1.5, 3.0])
def test_repair_capacities_edges_bitwise(edge_costs, cap):
    n, T = 20, 8
    ((etr_r, s_r), (etr_t, s_t)), (src, dst) = _edge_problem(n, T, 3,
                                                             cap=cap)
    D = np.random.default_rng(5).integers(0, 6, (T, n)).astype(float)
    if edge_costs:
        tr_r, tr_t = etr_r, etr_t
    else:
        dense = rc.synthetic_costs(n, T, np.random.default_rng(6), cap=cap)
        tr_r = dense
        tr_t = tc.CostTraces(*(getattr(dense, f) for f in
                               ("c_node", "c_link", "f_err", "cap_node",
                                "cap_link")))
    plan_r = rmv.realize_plan(rmv.greedy_linear(tr_r, s_r, backend="numpy"),
                              s_r)
    plan_t = tmv.realize_plan(tmv.greedy_linear(tr_t, s_t, backend="numpy"),
                              s_t)
    want = rmv.repair_capacities_edges(plan_r, tr_r, s_r, D)
    got = tmv.repair_capacities_edges(plan_t, tr_t, s_t, D, device="cpu")
    _same_plan(got, want)
    assert not tmv.plans_equal(got, plan_t)     # capacities did bind
    for em in ("discard", "neg_G", "sqrt"):
        assert tmv.plan_cost(got, tr_t, D, error_model=em) == \
            rmv.plan_cost(want, tr_r, D, error_model=em)


def test_repair_edges_above_the_dense_guard(monkeypatch):
    """Edge traces on an edge-list schedule repair where dense views
    raise, as the reference's ``test_repair_edges_above_dense_guard``."""
    monkeypatch.setattr(rsched_mod, "DENSE_VIEW_MAX_N", 16)
    monkeypatch.setattr(tsched_mod, "DENSE_VIEW_MAX_N", 16)
    n, T = 24, 6
    ((etr_r, s_r), (etr_t, s_t)), _ = _edge_problem(n, T, 4, cap=2.0)
    with pytest.raises(RuntimeError):
        s_t.adj_at(0)
    D = np.full((T, n), 3.0)
    want = rmv.repair_capacities_edges(
        rmv.realize_plan(rmv.greedy_linear(etr_r, s_r), s_r), etr_r, s_r, D)
    got = tmv.repair_capacities_edges(
        tmv.realize_plan(tmv.greedy_linear(etr_t, s_t), s_t), etr_t, s_t, D,
        device="cpu")
    _same_plan(got, want)
    got.check(s_t)


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_cost_on_edge_traces_equal_reference(seed):
    ((etr_r, s_r), (etr_t, s_t)), _ = _edge_problem(50, 10, seed)
    D = np.random.default_rng(seed).poisson(3.0, (10, 50)).astype(float)
    plan_r = rmv.realize_plan(rmv.greedy_linear(etr_r, s_r), s_r)
    plan_t = tmv.realize_plan(tmv.greedy_linear(etr_t, s_t), s_t)
    for em in ("discard", "neg_G", "sqrt"):
        got = tmv.plan_cost(plan_t, etr_t, D, error_model=em)
        assert got == rmv.plan_cost(plan_r, etr_r, D, error_model=em)
        assert got["transfer"] > 0


@pytest.mark.parametrize("kind", ["churn", "flap"])
def test_live_matrix_and_piecewise_support(kind):
    """The port's kept liveness rows are ``edge_ids_at`` of every round,
    and ``piecewise_support`` (window sets as masks over one support)
    replays as the reference's ``piecewise_edges`` of the same sets."""
    ((_, s_r), (_, s_t)), _ = _edge_problem(40, 12, 2, kind)
    live = s_t.live_matrix()
    assert live.shape == (12, s_t.union_csr()[1].size)
    assert not live.flags.writeable
    for t in range(12):
        np.testing.assert_array_equal(np.nonzero(live[t])[0],
                                      s_r.edge_ids_at(t))
    indptr, dst = s_t.union_csr()
    src = np.repeat(np.arange(40), np.diff(indptr))
    rng = np.random.default_rng(3)
    keeps = [rng.random(src.size) < p for p in (0.9, 0.5, 0.7, 0.2)]
    bounds = [(0, 3), (3, 5), (5, 9), (9, 12)]
    active = rng.random((12, 40)) < 0.8
    got = tsched_mod.NetworkSchedule.piecewise_support(
        40, src, dst, keeps, bounds, active=active)
    sets = [(src[k], dst[k]) for k in keeps]
    want = rsched_mod.NetworkSchedule.piecewise_edges(40, sets, bounds,
                                                      active=active)
    _same_schedule(got, want)
    _same_schedule(tsched_mod.NetworkSchedule.piecewise_edges(
        40, [(s[::-1], d[::-1]) for s, d in sets], bounds, active=active),
        want)
    for t in range(12):
        q = rng.integers(0, 40, (2, 60))
        np.testing.assert_array_equal(got.has_edges(t, *q),
                                      want.has_edges(t, *q))
