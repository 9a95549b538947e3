"""The port's host-side data plane against the reference: cost traces,
topologies, schedules, datasets, Poisson streams, movement routing,
padding and staging must be bitwise equal for the same seeds (they are
numpy copies with identical rng stepping)."""
import numpy as np
import pytest

from repro.core import costs as rc
from repro.core import movement as rmv
from repro.core import schedule as rs
from repro.core import topology as rt
from repro.data import pipeline as rpl
from repro.data import synthetic as rsyn
from repro_torch.core import costs as tc
from repro_torch.core import movement as tmv
from repro_torch.core import schedule as ts
from repro_torch.core import topology as tt
from repro_torch.data import pipeline as tpl
from repro_torch.data import synthetic as tsyn

N, T = 6, 8
SEEDS = [0, 1, 2]
TOPOLOGIES = ["full", "random", "hierarchical", "social", "scale_free"]


def _traces(mod, kind, seed):
    mk = mod.testbed_like_costs if kind == "testbed" else mod.synthetic_costs
    return mk(N, T, np.random.default_rng(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["testbed", "synthetic"])
def test_costs_bitwise(kind, seed):
    ref, got = _traces(rc, kind, seed), _traces(tc, kind, seed)
    for f in ("c_node", "c_link", "f_err", "cap_node", "cap_link"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    capped_r = rc.with_capacity(ref, 5.0)
    capped_t = tc.with_capacity(got, 5.0)
    np.testing.assert_array_equal(capped_t.cap_node, capped_r.cap_node)
    np.testing.assert_array_equal(capped_t.cap_link, capped_r.cap_link)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", TOPOLOGIES)
def test_topology_bitwise(kind, seed):
    costs = np.random.default_rng(seed + 10).random(N)
    rr, rg = np.random.default_rng(seed), np.random.default_rng(seed)
    ref = rt.make_topology(kind, N, rr, rho=0.4, costs=costs)
    got = tt.make_topology(kind, N, rg, rho=0.4, costs=costs)
    np.testing.assert_array_equal(got, ref)
    # the generators are left in the same state
    assert rr.random() == rg.random()


@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_static_and_full_match(seed):
    rng = np.random.default_rng(seed)
    adj = rt.random_graph(N, 0.5, rng)
    active = rng.random((T, N)) < 0.8
    stack = rng.random((T, N, N)) < 0.5
    pairs = [(rt.make_schedule("static", adj, T, rng),
              tt.make_schedule("static", adj, T, rng)),
             (rs.NetworkSchedule.constant(adj, T, active=active),
              ts.NetworkSchedule.constant(adj, T, active=active)),
             (rs.as_schedule(stack, T), ts.as_schedule(stack, T))]
    src, dst = np.nonzero(np.ones((N, N), bool))
    for ref, got in pairs:
        assert (ref.static_adj is None) == (got.static_adj is None)
        np.testing.assert_array_equal(got.activity(), ref.activity())
        np.testing.assert_array_equal(got.adj_view(), ref.adj_view())
        for t in range(T):
            np.testing.assert_array_equal(got.adj_at(t), ref.adj_at(t))
            np.testing.assert_array_equal(got.has_edges(t, src, dst),
                                          ref.has_edges(t, src, dst))
        assert [(e.t, e.kind, e.node, e.peer) for e in got.events_in(0, T)] \
            == [(e.t, e.kind, e.node, e.peer) for e in ref.events_in(0, T)]
    assert ts.as_schedule(adj, T).adj_at(3) is adj       # no copy


def test_image_dataset_bitwise():
    ref = rsyn.make_image_dataset(n_train=300, n_test=50, seed=3)
    got = tsyn.make_image_dataset(n_train=300, n_test=50, seed=3)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _streams(mod, y, seed, iid):
    return mod.poisson_streams(N, T, y, iid=iid,
                               rng=np.random.default_rng(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("iid", [True, False])
def test_streams_and_counts_bitwise(seed, iid):
    y = np.random.default_rng(99).integers(0, 10, 500).astype(np.int32)
    ref, got = _streams(rpl, y, seed, iid), _streams(tpl, y, seed, iid)
    for t in range(T):
        for i in range(N):
            np.testing.assert_array_equal(got.collected[t][i],
                                          ref.collected[t][i])
    np.testing.assert_array_equal(tpl.counts(got), rpl.counts(ref))


@pytest.mark.parametrize("seed", SEEDS)
def test_routing_padding_staging_bitwise(seed):
    x, y, _, _ = rsyn.make_image_dataset(n_train=400, n_test=10, seed=0)
    rng_r, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    tr_r, tr_t = rc.testbed_like_costs(N, T, rng_r), \
        tc.testbed_like_costs(N, T, rng_t)
    adj = rt.make_topology("random", N, np.random.default_rng(seed),
                           rho=0.6)
    plan_r = rmv.greedy_linear(tr_r, adj, backend="numpy")
    plan_t = tmv.greedy_linear(tr_t, adj, backend="numpy")
    st_r, st_t = rpl.poisson_streams(N, T, y, rng=rng_r), \
        tpl.poisson_streams(N, T, y, rng=rng_t)
    proc_r = rpl.apply_movement(st_r, plan_r, np.random.default_rng(7))
    proc_t = tpl.apply_movement(st_t, plan_t, np.random.default_rng(7))
    for t in range(T):
        for i in range(N):
            np.testing.assert_array_equal(proc_t[t][i], proc_r[t][i])
    P = tpl.pad_size(proc_t)
    assert P == rpl.pad_size(proc_r)
    assert tpl.pad_size(proc_t, bucket="pow2") == \
        rpl.pad_size(proc_r, bucket="pow2")
    for a, b in zip(tpl.stage_rounds(proc_t, y, P),
                    rpl.stage_rounds(proc_r, y, P)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpl.pad_batches(proc_t[2], x, y, P),
                    rpl.pad_batches(proc_r[2], x, y, P)):
        np.testing.assert_array_equal(a, b)
    labels = [y[np.concatenate([proc_t[t][i] for t in range(T)])]
              for i in range(N)]
    assert tpl.label_similarity(labels) == rpl.label_similarity(labels)


@pytest.mark.parametrize("value", [1, 3, 4, 5, 100, 129])
def test_bucket_size_matches(value):
    for kw in ({}, {"max_inflation": 4 / 3}):
        assert tpl.bucket_size(value, **kw) == rpl.bucket_size(value, **kw)
    assert tpl.bucket_size(value, "exact") == value
