"""The port's bucket dispatch (``core/costmodel.py``) and the dispatched
sweep (``launch.tables.run_scenarios``) against the reference's.

``CostModel.choose`` is held to the reference's ``CostModel(compile_s=0)``
on the same descriptors: decisions, predicted seconds, slots and
predicted programs exactly (the same float arithmetic in Python), and
so are the EMA updates. A small sweep through ``run_scenarios`` (a
3-point bucket and a 1-point bucket, dispatched, and the same points
forced onto the sweep engine), with both models pinned (no compile
listener, no EMA refinement, so the decisions cannot follow the host's
clock) and the port trained from the reference's initial weights:
every row's key, setting, cost, engine and dispatch equal, label
similarities and mean activity equal, accuracy curves within atol 1e-2
(the engines' tolerance).
"""
import jax
import numpy as np
import pytest
import torch

from benchmarks import fog as BF
from repro.core import costmodel as rcm
from repro.core import engine as reng
from repro_torch.core import costmodel as tcm
from repro_torch.core import federated as TF
from repro_torch.launch import tables as TT
from repro_torch.models.convert import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bucket(rng, S):
    T = int(rng.choice([8, 12, 20]))
    pts = [(T, int(rng.integers(3, 30)), int(rng.integers(4, 200)))
           for _ in range(S)]
    return dict(points=pts, T_b=T, n_b=max(n for _, n, _ in pts),
                P_b=max(P for _, _, P in pts),
                R_b=int(rng.integers(8, 400)), chunk=8,
                eval_slots=int(rng.integers(0, 10 ** 5)))


def test_choose_matches_reference_at_zero_compile():
    rng = np.random.default_rng(0)
    ref, port = rcm.CostModel(compile_s=0.0), tcm.CostModel()
    assert port.compile_s == 0.0
    for i in range(40):
        dims = _bucket(rng, int(rng.integers(1, 7)))
        key = ("mlp", 0.1, 5, i % 5)
        kw = {}
        if i % 4 == 1:
            kw["force_path"] = "batched"
        if i % 6 == 2:
            kw["staging"] = ["dense", "ragged"][i % 2]
        if i % 3 == 0:
            dims["idents"] = [(p[0], p[1], j) for j, p in
                              enumerate(dims["points"])]
        want = ref.choose(key=key, **dims, **kw)
        got = port.choose(key=key, **dims, **kw)
        assert got.as_row() == want.as_row()
        assert (got.slots, got.new_programs, got.predicted_s) == \
            (want.slots, want.new_programs, want.predicted_s)
        if i % 2:
            ref.record(want, key=key, **dims)
            port.record(got, key=key, **dims)
        if i % 5 == 0:
            idents = [(1, 2, i)]
            ref.mark_loop_seen(key, idents)
            port.mark_loop_seen(key, idents)
        secs = float(rng.random() * 3)
        for m in (ref, port):
            m.observe_run(got.path, got.staging, got.slots["loop"], secs, 0,
                          n_points=len(dims["points"]),
                          eval_slots=dims["eval_slots"])
        assert (port.slot_s, port.ragged_slot_s) == (ref.slot_s,
                                                     ref.ragged_slot_s)
    tcm.install_listener()                   # nothing to listen to


class _PinnedRef(rcm.CostModel):
    def observe_run(self, *a, **kw):
        pass


class _PinnedPort(tcm.CostModel):
    def observe_run(self, *a, **kw):
        pass


SMALL_REF = BF.BenchScale(n_train=800, n_test=200, T=8, tau=4)
SMALL = TT.BenchScale(n_train=800, n_test=200, T=8, tau=4)


def _jax_params(model, seed):
    jp, _ = reng.make_model(model, jax.random.PRNGKey(seed))
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()})


def _points():
    # three same-shape points (one S = 3 bucket) and one odd size (S = 1)
    return ([dict(key={"i": i}, n=4, seed=i) for i in range(3)]
            + [dict(key={"i": 3}, n=9, seed=0, p_exit=0.2, p_entry=0.2)])


@pytest.fixture(scope="module")
def sweeps():
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(rcm, "install_listener", lambda: None)
        mp.setattr(rcm, "MODEL", _PinnedRef(compile_s=0.0))
        mp.setattr(tcm, "MODEL", _PinnedPort())
        run, run_b = TF.run_network_aware, TF.run_network_aware_batched

        def one(cfg, *a, **kw):
            return run(cfg, *a, params=_jax_params(cfg.model, cfg.seed),
                       **kw)

        def bucket(cfgs, *a, **kw):
            return run_b(cfgs, *a, params=[_jax_params(c.model, c.seed)
                                           for c in cfgs], **kw)

        mp.setattr(TF, "run_network_aware", one)
        mp.setattr(TF, "run_network_aware_batched", bucket)
        out = {}
        for engine in ("auto", "batched"):
            ref_sc = [BF.make_scenario(SMALL_REF, error_model="discard", **p)
                      for p in _points()]
            port_sc = [TT.make_scenario(SMALL, error_model="discard", **p)
                       for p in _points()]
            out[engine] = (
                BF.run_scenarios(ref_sc, SMALL_REF, engine=engine,
                                 mesh=None),
                TT.run_scenarios(port_sc, SMALL, engine=engine,
                                 device="cpu"))
        yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("engine", ["auto", "batched"])
def test_run_scenarios_rows_match_reference(sweeps, engine):
    want, got = sweeps[engine]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("i", "setting", "cost", "engine", "dispatch",
                  "sim_before", "sim_after", "avg_active"):
            assert g.get(k) == w.get(k), (engine, k)
        np.testing.assert_allclose(g["acc_curve"], w["acc_curve"],
                                   atol=1e-2)
    if engine == "auto":
        assert got[3]["dispatch"]["reason"] == "S=1"
        assert got[3]["dispatch"]["path"] == "loop"
        assert got[0]["dispatch"]["reason"] == "cost-model"
    else:
        assert all(r["dispatch"]["reason"] == "forced"
                   and r["dispatch"]["staging"] == "dense"
                   and r["engine"] == "batched" for r in got)


def test_bucket_keys_match_reference():
    pts = _points() + [dict(key={}, n=4, seed=1, faults="drop",
                            fault_rate=0.3, quorum=0.5)]
    for p in pts:
        r = BF.make_scenario(SMALL_REF, error_model="discard", **p)
        t = TT.make_scenario(SMALL, error_model="discard", **p)
        assert TT.scenario_bucket_key(t) == BF.scenario_bucket_key(r)
        assert TT._point_ident(t) == BF._point_ident(r)
        for name in ("setting", "gamma", "activity", "hierarchy"):
            assert getattr(t, name) == getattr(r, name)


def test_scenarios_take_settings_density_and_tiers():
    """The new Scenario fields plan as the reference plans them: setting
    A moves nothing, C and E plan on estimates, D and E are repaired;
    ``mean_per_round`` sets the stream density; ``tiers`` builds the
    tree."""
    from repro.core import movement as rmv
    from repro_torch.core import movement as tmv

    ref = [BF.make_scenario(SMALL_REF, setting=s, error_model="discard",
                            mean_per_round=3.0, seed=2) for s in "ABCDE"]
    port = [TT.make_scenario(SMALL, setting=s, error_model="discard",
                             mean_per_round=3.0, seed=2) for s in "ABCDE"]
    for r, t in zip(ref, port):
        np.testing.assert_array_equal(t.D, r.D)
    for r, t, pr, pt in zip(ref, port, BF.solve_scenario_plans(ref),
                            TT.solve_scenario_plans(port, device="cpu")):
        assert tmv.plan_cost(pt, t.traces, t.D) == \
            rmv.plan_cost(pr, r.traces, r.D), t.setting
    tree = TT.make_scenario(SMALL, tiers="2@4,1@8", seed=0).hierarchy
    assert tree.levels == 2 and list(tree.taus) == [4, 8]


def test_forced_loop_marks_points_seen(monkeypatch):
    monkeypatch.setattr(tcm, "MODEL", _PinnedPort())
    sc = [TT.make_scenario(SMALL, key={"i": i}, n=4, seed=i,
                           error_model="discard") for i in range(2)]
    rows = TT.run_scenarios(sc, SMALL, engine="scan", device="cpu")
    assert all(r["engine"] == "scan" and "dispatch" not in r for r in rows)
    key = TT.scenario_bucket_key(sc[0])
    assert ("loop", key, TT._point_ident(sc[1])) in tcm.MODEL._seen


def test_tables_cli_lists_scenario_batched():
    assert TT.TABLES["scenario_batched"] is TT.scenario_batched


def test_scenario_batched_row_at_tiny_scale(monkeypatch):
    """The ``scenario_batched`` row on two small grids: bucket programs
    no more than buckets, accuracy curves within 1e-2 of the loop, and
    on the fig5-shaped grid every point equal in its bucket and alone,
    dense and ragged, bit for bit."""
    monkeypatch.setattr(tcm, "MODEL", _PinnedPort())
    monkeypatch.setattr(TT, "SCENARIO_GRIDS", {
        "fig5": [dict(n=n, seed=s, iid=False) for n in (4, 5)
                 for s in range(2)],
        "prediction": [dict(p_exit=0.2, p_entry=0.2, replan=m, seed=7)
                       for m in ("oracle", "once")]})
    out = TT.scenario_batched(SMALL, "cpu")
    fig5, pred = out["rows"]
    assert (fig5["grid"], fig5["points"], fig5["buckets"]) == ("fig5", 4, 2)
    assert fig5["staged_histories_bitwise"] and fig5["ragged_alone_bitwise"]
    assert fig5["staged_max_diff"] == fig5["ragged_alone_max_diff"] == 0.0
    assert pred["staged_histories_bitwise"] is None
    assert out["headline"]["train_programs_leq_buckets"]
    assert out["headline"]["max_acc_curve_gap"] <= 1e-2
    for r in out["rows"]:
        assert r["loop_warm_s"] > 0 and r["dispatched_warm_s"] > 0
        assert set(r["warm_phases"]) == {"stage_s", "program_s", "eval_s",
                                         "train_s"}
        assert all(d["reason"] == "cost-model" for d in r["dispatch_warm"])
