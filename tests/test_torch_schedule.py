"""The port's network schedules (``repro_torch.core.schedule``) and their
producers (``repro_torch.core.topology``) against the reference: every
storage mode and accessor must replay bitwise-equal rounds, events and
edge lists for the same inputs, and the producers must draw the same
schedules from the same seed and leave the generator in the same
state."""
import numpy as np
import pytest

from repro.core import schedule as rs
from repro.core import topology as rt
from repro_torch.core import schedule as ts
from repro_torch.core import topology as tt

N, T = 7, 9
SEEDS = [0, 1, 2]


def _events(mod, rng, n=N, count=12):
    """Seeded link events over rounds 1..T-1 (same draws for both)."""
    evs = []
    for _ in range(count):
        t, i, j = (int(rng.integers(1, T)), int(rng.integers(n)),
                   int(rng.integers(n)))
        if i != j:
            kind = "link_up" if rng.random() < 0.5 else "link_down"
            evs.append(mod.NetEvent(t, kind, i, j))
    return evs


def _pair(mode, seed):
    """(reference, port) schedules of one storage mode, same inputs."""
    out = []
    for mod in (rs, ts):
        rng = np.random.default_rng(seed)
        adj = rng.random((N, N)) < 0.5
        np.fill_diagonal(adj, False)
        active = rng.random((T, N)) < 0.75
        S = mod.NetworkSchedule
        if mode == "constant":
            out.append(S.constant(adj, T, active=active))
        elif mode == "full":
            out.append(S.full(rng.random((T, N, N)) < 0.4, active=active))
        elif mode == "events":
            out.append(S.from_events(adj, T, _events(mod, rng),
                                     active=active))
        elif mode == "piecewise":
            adjs = [rng.random((N, N)) < 0.5 for _ in range(3)]
            out.append(S.piecewise(adjs, [(0, 3), (3, 6), (6, T)],
                                   active=active))
        elif mode == "masked":
            out.append(S.masked(adj, active,
                                initial_active=np.ones(N, bool)))
        elif mode == "edgelist":
            src, dst = np.nonzero(adj)
            out.append(S.edgelist(N, T, src, dst, events=_events(mod, rng),
                                  active=active, mask_inactive=True,
                                  initial_active=np.ones(N, bool)))
        elif mode == "edgelist_arrays":
            src, dst = np.nonzero(adj)
            k = 10
            ev = (rng.integers(1, T, k), rng.integers(0, N, k),
                  rng.integers(0, N, k), rng.random(k) < 0.5)
            out.append(S.edgelist(N, T, src, dst, events=ev, active=active,
                                  mask_inactive=True))
        elif mode == "piecewise_edges":
            sets = [np.nonzero(rng.random((N, N)) < 0.4) for _ in range(3)]
            out.append(S.piecewise_edges(N, sets, [(0, 4), (4, 7), (7, T)],
                                         active=active))
    return out


MODES = ["constant", "full", "events", "piecewise", "masked", "edgelist",
         "edgelist_arrays", "piecewise_edges"]


def _events_equal(a, b):
    assert [(e.t, e.kind, e.node, e.peer) for e in a] == \
        [(e.t, e.kind, e.node, e.peer) for e in b]


def assert_schedules_equal(got, want):
    assert (got.T, got.n) == (want.T, want.n)
    assert got.storage == want.storage
    assert (got.static_adj is None) == (want.static_adj is None)
    if want.static_adj is not None:
        np.testing.assert_array_equal(got.static_adj, want.static_adj)
    se_g, se_w = got.static_edges(), want.static_edges()
    assert (se_g is None) == (se_w is None)
    if se_w is not None:
        for a, b in zip(se_g, se_w):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.activity(), want.activity())
    _events_equal(got.events_in(0, got.T), want.events_in(0, want.T))
    _events_equal(got.events_in(2, 5), want.events_in(2, 5))
    src, dst = np.nonzero(np.ones((got.n, got.n), bool))
    # a forward sweep, then random access that restarts the replay
    for t in list(range(got.T)) + [3, 0, got.T - 1, 1]:
        np.testing.assert_array_equal(got.adj_at(t), want.adj_at(t))
        np.testing.assert_array_equal(got.active_at(t), want.active_at(t))
        for a, b in zip(got.edges_at(t), want.edges_at(t)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.has_edges(t, src, dst),
                                      want.has_edges(t, src, dst))
        for i in (0, got.n - 1):
            np.testing.assert_array_equal(got.neighbors_at(t, i),
                                          want.neighbors_at(t, i))
    np.testing.assert_array_equal(got.adj_view(), want.adj_view())
    assert repr(got) == repr(want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", MODES)
def test_storage_modes_bitwise(mode, seed):
    want, got = _pair(mode, seed)
    assert_schedules_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", MODES)
def test_to_edgelist_round_trip_bitwise(mode, seed):
    want, got = _pair(mode, seed)
    ge, we = got.to_edgelist(), want.to_edgelist()
    assert_schedules_equal(ge, we)
    for a, b in zip(ge.union_csr(), we.union_csr()):
        np.testing.assert_array_equal(a, b)
    for t in range(T):
        np.testing.assert_array_equal(ge.edge_ids_at(t), we.edge_ids_at(t))
        # the edge-list replay is the dense replay of the source schedule
        np.testing.assert_array_equal(ge.adj_at(t), want.to_edgelist()
                                      .adj_at(t))
    assert ge.to_edgelist() is ge


@pytest.mark.parametrize("mask", [None, True, False])
@pytest.mark.parametrize("mode", ["constant", "events", "masked",
                                  "edgelist"])
def test_with_activity_bitwise(mode, mask):
    want, got = _pair(mode, 5)
    act = np.random.default_rng(9).random((T, N)) < 0.6
    assert_schedules_equal(got.with_activity(act, mask_inactive=mask),
                           want.with_activity(act, mask_inactive=mask))
    with pytest.raises(ValueError):
        got.with_activity(act[:, :-1])


def test_adj_at_reuses_its_buffer():
    """Masked and events rounds come back in one scratch buffer, as in
    the reference: a caller holding round t sees it overwritten."""
    _, got = _pair("masked", 0)
    rows = [t for t in range(T) if not got.active_at(t).all()]
    a = got.adj_at(rows[0])
    held = a.copy()
    b = got.adj_at(rows[1])
    assert a is b
    np.testing.assert_array_equal(held, got.adj_view()[rows[0]])
    _, ev = _pair("events", 0)
    assert ev.adj_at(1) is ev.adj_at(2)


def test_edgelist_dense_guard(monkeypatch):
    for mod in (rs, ts):
        monkeypatch.setattr(mod, "DENSE_VIEW_MAX_N", 4)
    assert ts.DENSE_VIEW_MAX_N == 4
    want, got = _pair("edgelist", 0)
    for s in (want, got):
        with pytest.raises(RuntimeError, match="DENSE_VIEW_MAX_N"):
            s.adj_at(0)
        s.edges_at(0)                   # the sparse accessors still work
    with pytest.raises(TypeError):
        _pair("constant", 0)[1].union_csr()
    with pytest.raises(TypeError):
        _pair("masked", 0)[1].edge_ids_at(0)


def test_events_in_counts_round_zero_exits():
    """With ``initial_active`` every device starts active, so exits in
    round 0 are events (the reference's count)."""
    act = np.ones((T, N), bool)
    act[0, [1, 4]] = False
    act[3, 2] = False
    adj = np.ones((N, N), bool)
    for mod in (rs, ts):
        s = mod.NetworkSchedule.masked(adj, act,
                                       initial_active=np.ones(N, bool))
        evs = s.events_in(0, T)
        assert [(e.t, e.kind, e.node) for e in evs][:2] == \
            [(0, "exit", 1), (0, "exit", 4)]
        assert len(mod.NetworkSchedule.masked(adj, act).events_in(0, T)) \
            == len(evs) - 2


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p_exit,p_entry,tau", [(0.1, 0.1, 3), (0.3, 0.05,
                                                                None)])
def test_churn_process_and_schedule_bitwise(seed, p_exit, p_entry, tau):
    rr, rg = np.random.default_rng(seed), np.random.default_rng(seed)
    pr = rt.ChurnProcess(N, p_exit, p_entry, rr)
    pg = tt.ChurnProcess(N, p_exit, p_entry, rg)
    for t in range(T):
        np.testing.assert_array_equal(pg.step(), pr.step())
        np.testing.assert_array_equal(pg.contributing(), pr.contributing())
        if t % 3 == 2:
            pr.sync(), pg.sync()
            np.testing.assert_array_equal(pg.waiting, pr.waiting)
    adj = rt.random_graph(N, 0.6, np.random.default_rng(seed + 1))
    want = rt.churn_schedule(adj, T, p_exit, p_entry, rr, tau=tau)
    got = tt.churn_schedule(adj, T, p_exit, p_entry, rg, tau=tau)
    assert_schedules_equal(got, want)
    assert rr.random() == rg.random()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p_down,p_up", [(0.05, 0.5), (0.3, 0.2)])
def test_link_flap_schedule_bitwise(seed, p_down, p_up):
    adj = rt.watts_strogatz(N, 4, 0.2, np.random.default_rng(seed))
    rr, rg = np.random.default_rng(seed), np.random.default_rng(seed)
    want = rt.link_flap_schedule(adj, T, rr, p_down=p_down, p_up=p_up)
    got = tt.link_flap_schedule(adj, T, rg, p_down=p_down, p_up=p_up)
    assert_schedules_equal(got, want)
    assert rr.random() == rg.random()


@pytest.mark.parametrize("kind", ["static", "churn", "flap"])
def test_make_schedule_bitwise(kind):
    adj = rt.random_graph(N, 0.5, np.random.default_rng(4))
    kw = dict(p_exit=0.2, p_entry=0.1, p_flap=0.2, p_recover=0.4, tau=3)
    rr, rg = np.random.default_rng(8), np.random.default_rng(8)
    want = rt.make_schedule(kind, adj, T, rr, **kw)
    got = tt.make_schedule(kind, adj, T, rg, **kw)
    assert_schedules_equal(got, want)
    assert rr.random() == rg.random()
    with pytest.raises(ValueError, match="unknown schedule kind"):
        tt.make_schedule("tides", adj, T, rg)


@pytest.mark.parametrize("fn", [tt.churn_schedule_edges,
                                tt.link_flap_schedule_edges])
def test_edge_producers_name_their_roadmap_item(fn):
    """The edge-list producers, once refused (ROADMAP queue 1 item 7),
    now draw the reference's schedules bitwise from the same seed, for
    the flat stream (offset 0) and a tier's own stream, and leave the
    generator where the reference leaves it."""
    ref = getattr(rt, fn.__name__)
    src, dst = rt.random_sparse_edges(N, 3, np.random.default_rng(5))
    kw = ({"p_down": 0.3, "p_up": 0.4} if "flap" in fn.__name__
          else {"tau": 3})
    args = (() if "flap" in fn.__name__ else (0.2, 0.3))
    for offset in (0, 2):
        rr, rg = np.random.default_rng(0), np.random.default_rng(0)
        want = ref(N, src, dst, T, *args, rr, node_offset=offset, **kw)
        got = fn(N, src, dst, T, *args, rg, node_offset=offset, **kw)
        assert got.storage == want.storage == "edgelist"
        assert_schedules_equal(got, want)
        assert rr.random() == rg.random()
