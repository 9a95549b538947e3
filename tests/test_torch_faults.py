"""The fault plane through the port against the reference
(``repro.core.faults``, the guarded and quorum-gated aggregation of
``repro.core.engine``, ``run_network_aware(faults=…)``, the training
CLI's ``--faults`` flags and the fault-tolerance study), on the same
numpy-seeded inputs.

Tolerances:

* ``FaultSchedule`` and ``make_faults`` are a numpy copy: events, views,
  summaries and composed schedules bitwise, validation messages equal.
* ``_finite_mask`` and ``_guarded_uploads`` exactly (a multiply by the
  same float32 factor and a select), NaN positions included.
* Engines under faults, the port trained from the reference's initial
  weights: ``agg_round``, ``H_agg``, ``agg_survivors`` and
  ``agg_quorum_ok`` exact; losses within rtol 2e-3, atol 1e-4 and
  accuracy within 1e-2 (the reference's scan-vs-legacy tolerances);
  NaN in the same places in unguarded runs.
* Within the port: an empty schedule under the guard is the clean run
  bit for bit, and the scan engine equals the legacy oracle under the
  same tolerances.
"""
import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fog as BF
from benchmarks import run as BR
from repro.core import engine as reng
from repro.core import faults as rfl
from repro.core import federated as RF
from repro.core import hierarchy as rh
from repro.core import movement as rmv
from repro.core import schedule as rs
from repro.core.costs import synthetic_costs
from repro.core.topology import fully_connected
from repro.data import pipeline as rpl
from repro.data.synthetic import make_image_dataset
from repro.launch import train as rtrain
from repro_torch.core import engine as teng
from repro_torch.core import faults as tfl
from repro_torch.core import federated as TF
from repro_torch.core import hierarchy as th
from repro_torch.core import movement as tmv
from repro_torch.core import schedule as ts
from repro_torch.data import pipeline as tpl
from repro_torch.launch import tables as TT
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax
from test_torch_engine import assert_histories_match

N, T, TAU = 6, 12, 4
DATA = make_image_dataset(n_train=1200, n_test=400, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small training steps run on one thread: under the test
    workers' load, intra-op threads only wait for each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _jax_params(model="mlp", seed=0):
    jp, _ = reng.make_model(model, jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in jp.items()}


def _key(fs):
    """NaN-safe event key (NaN payloads defeat ==)."""
    return [(e.t, e.kind, e.device, repr(e.value)) for e in fs.events]


def _same_schedule(got, want):
    assert _key(got) == _key(want)
    assert (got.T, got.n, got.tau) == (want.T, want.n, want.tau)
    for view in ("activity_mask", "upload_ok", "corrupt"):
        a, b = getattr(got, view)(), getattr(want, view)()
        assert a.dtype == b.dtype, view
        np.testing.assert_array_equal(a, b, err_msg=view)
    for a, b in zip(got.engine_arrays(), want.engine_arrays()):
        np.testing.assert_array_equal(a, b)
    assert got.summary() == want.summary()
    assert got.has_crashes == want.has_crashes
    assert got.has_upload_faults == want.has_upload_faults
    assert repr(got) == repr(want)


# ---------------------------------------------------------------------------
# FaultSchedule and make_faults: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("payload", ["nan", "inf", "scale"])
def test_sample_matches_reference(seed, payload):
    kw = dict(p_straggle=0.2, p_drop=0.15, p_crash=0.25, p_corrupt=0.3,
              corrupt=payload, corrupt_scale=-7.5, crash_len=seed % 3)
    got = tfl.FaultSchedule.sample(20, 9, 5, rng=seed, **kw)
    want = rfl.FaultSchedule.sample(20, 9, 5, rng=seed, **kw)
    _same_schedule(got, want)
    g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
    tfl.FaultSchedule.sample(20, 9, 5, rng=g1, **kw)
    rfl.FaultSchedule.sample(20, 9, 5, rng=g2, **kw)
    assert g1.random() == g2.random()          # generators left in step


@pytest.mark.parametrize("kind", ["straggle", "drop", "crash", "corrupt",
                                  "mixed", "none", None])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_make_faults_matches_reference(kind, rate):
    got = tfl.make_faults(kind, 30, 8, 5, rate=rate, seed=7926,
                          corrupt="inf")
    want = rfl.make_faults(kind, 30, 8, 5, rate=rate, seed=7926,
                           corrupt="inf")
    assert (got is None) == (want is None)
    if want is not None:
        _same_schedule(got, want)


def test_drop_wins_over_corrupt_and_crash_defaults():
    ev = [(3, "corrupt", 1, float("nan")), (3, "drop", 1, 0.0),
          (7, "corrupt", 2, 2.0), (5, "crash", 0, 0.0),
          (2, "crash", 3, 2.0), (9, "crash", 4, 10.0)]
    got = tfl.FaultSchedule(12, 5, 4, [tfl.FaultEvent(*e) for e in ev])
    want = rfl.FaultSchedule(12, 5, 4, [rfl.FaultEvent(*e) for e in ev])
    _same_schedule(got, want)
    assert got.corrupt()[3, 1] == 1.0 and got.upload_ok()[3, 1] == 0.0
    # crash of length 0: the rest of its window (rounds 5..7)
    assert not got.activity_mask()[5:8, 0].any()
    assert got.activity_mask()[8, 0]


@pytest.mark.parametrize("args,match", [
    ((3, "meteor", 0), "unknown fault kind"),
])
def test_event_validation_matches_reference(args, match):
    with pytest.raises(ValueError, match=match) as a:
        rfl.FaultEvent(*args)
    with pytest.raises(ValueError, match=match) as b:
        tfl.FaultEvent(*args)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("T_,n,tau,event,match", [
    (12, 4, 4, (2, "drop", 0), "window-last"),
    (12, 4, 4, (6, "corrupt", 1, 3.0), "window-last"),
    (12, 4, 4, (12, "crash", 0), "outside horizon"),
    (12, 4, 4, (-1, "crash", 0), "outside horizon"),
    (12, 4, 4, (3, "straggle", 4), "outside"),
    (0, 4, 4, None, "T, n, tau > 0"),
])
def test_schedule_validation_matches_reference(T_, n, tau, event, match):
    def build(mod):
        evs = [] if event is None else [mod.FaultEvent(*event)]
        return mod.FaultSchedule(T_, n, tau, evs)

    with pytest.raises(ValueError, match=match) as a:
        build(rfl)
    with pytest.raises(ValueError, match=match) as b:
        build(tfl)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("call,match", [
    (lambda m: m.FaultSchedule.sample(8, 3, 4, rng=0, corrupt="zero"),
     "unknown corrupt payload"),
    (lambda m: m.make_faults("meteor", 8, 3, 4, rate=0.1),
     "unknown fault kind"),
    (lambda m: m.FaultSchedule(8, 3, 4).compose(),
     "needs a schedule or a static adjacency"),
])
def test_producer_errors_match_reference(call, match):
    with pytest.raises(ValueError, match=match) as a:
        call(rfl)
    with pytest.raises(ValueError, match=match) as b:
        call(tfl)
    assert str(a.value) == str(b.value)


def _same_network(got, want):
    assert got.storage == want.storage
    np.testing.assert_array_equal(got.activity(), want.activity())
    for t in range(got.T):
        np.testing.assert_array_equal(got.adj_at(t), want.adj_at(t))


@pytest.mark.parametrize("base", ["static", "schedule", "none"])
def test_compose_matches_reference(base):
    kw = dict(p_crash=0.4, p_drop=0.2)
    got = tfl.FaultSchedule.sample(10, 6, 5, rng=5, **kw)
    want = rfl.FaultSchedule.sample(10, 6, 5, rng=5, **kw)
    adj = np.random.default_rng(1).random((6, 6)) < 0.6
    if base == "schedule":
        act = np.random.default_rng(2).random((10, 6)) < 0.8
        tg = got.compose(ts.NetworkSchedule.constant(adj, 10, active=act))
        rw = want.compose(rs.NetworkSchedule.constant(adj, 10, active=act))
    elif base == "static":
        tg, rw = got.compose(adj=adj), want.compose(adj=adj)
    else:
        clean_t, clean_r = tfl.FaultSchedule(10, 6, 5), \
            rfl.FaultSchedule(10, 6, 5)
        tg, rw = clean_t.compose(adj=adj), clean_r.compose(adj=adj)
        assert tg.storage == "constant"
    _same_network(tg, rw)
    with pytest.raises(ValueError, match="fault schedule is") as a:
        want.compose(adj=np.ones((5, 5), bool))
    with pytest.raises(ValueError, match="fault schedule is") as b:
        got.compose(adj=np.ones((5, 5), bool))
    assert str(a.value) == str(b.value)


# ---------------------------------------------------------------------------
# the guard: exact
# ---------------------------------------------------------------------------


def _stack_with_payloads(seed):
    rng = np.random.default_rng(seed)
    W = {"w1": rng.standard_normal((5, 4, 3)).astype(np.float32),
         "b1": rng.standard_normal((5, 3)).astype(np.float32)}
    W["w1"][1, 2, 0] = np.nan                  # a NaN already in a row
    W["b1"][3, 1] = np.inf
    return W


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("payload", [np.nan, np.inf, -10.0, 1.0])
def test_guarded_uploads_match_reference(guard, payload):
    W = _stack_with_payloads(0)
    contrib = np.array([1, 1, 0, 1, 1], np.float32)
    upl = np.array([1, 0, 1, 1, 1], np.float32)
    cor = np.array([1, 1, 1, 1, payload], np.float32)
    Wr, cr = reng._guarded_uploads(
        {k: jnp.asarray(v) for k, v in W.items()}, jnp.asarray(contrib),
        jnp.asarray(upl), jnp.asarray(cor), guard, 1)
    Wt, ct = teng._guarded_uploads(
        {k: torch.from_numpy(v) for k, v in W.items()},
        torch.from_numpy(contrib), torch.from_numpy(upl),
        torch.from_numpy(cor), guard)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cr))
    for k in W:
        np.testing.assert_array_equal(Wt[k].numpy(), np.asarray(Wr[k]))
    mt = teng._finite_mask(Wt)
    np.testing.assert_array_equal(
        mt.numpy(), np.asarray(reng._finite_mask(Wr, 1)))
    if guard:
        # nothing non-finite reaches the reduction
        assert all(np.isfinite(Wt[k].numpy()).all() for k in W)


def test_guard_is_bitwise_identity_on_clean_uploads():
    rng = np.random.default_rng(4)
    W = {"w": torch.from_numpy(rng.standard_normal((4, 7))
                               .astype(np.float32)),
         "z": torch.tensor([[-0.0], [0.0], [1e-38], [3.0]])}
    ones = torch.ones(4)
    contrib = torch.tensor([1.0, 0.0, 1.0, 1.0])
    Wu, c = teng._guarded_uploads(W, contrib, ones, ones, True)
    assert torch.equal(c, contrib)
    for k in W:
        assert torch.equal(Wu[k], W[k])
        assert (torch.signbit(Wu[k]) == torch.signbit(W[k])).all()


# ---------------------------------------------------------------------------
# the engines under faults, against the reference
# ---------------------------------------------------------------------------


def _problem(mod_pl):
    rng = np.random.default_rng(0)
    traces = synthetic_costs(N, T, rng)
    adj = fully_connected(N)
    streams = mod_pl.poisson_streams(N, T, DATA[1], rng=rng)
    return traces, adj, streams


def _run_ref(engine, faults=None, guard=True, quorum=0.0, tiers=None,
             **kw):
    traces, adj, streams = _problem(rpl)
    plan = rmv.greedy_linear(traces, adj, backend="numpy")
    cfg = RF.FedConfig(n=N, T=T, tau=TAU, eta=0.05, model="mlp", seed=0)
    hier = None if tiers is None else rh.TierTree.from_spec(tiers, N)
    return RF.run_network_aware(cfg, DATA, traces, adj, plan,
                                streams=streams, engine=engine,
                                faults=faults, guard=guard, quorum=quorum,
                                hierarchy=hier, **kw)


def _run_port(engine, faults=None, guard=True, quorum=0.0, tiers=None,
              **kw):
    traces, adj, streams = _problem(tpl)
    plan = tmv.greedy_linear(traces, adj, backend="numpy")
    cfg = TF.FedConfig(n=N, T=T, tau=TAU, eta=0.05, model="mlp", seed=0)
    hier = None if tiers is None else th.TierTree.from_spec(tiers, N)
    return TF.run_network_aware(cfg, DATA, traces, adj, plan,
                                streams=streams, engine=engine,
                                faults=faults, guard=guard, quorum=quorum,
                                hierarchy=hier,
                                params=params_from_jax(_jax_params()),
                                device="cpu", **kw)


def _faults(mod, kind, rate, seed=3, corrupt="nan"):
    return mod.make_faults(kind, T, N, TAU, rate=rate, seed=seed,
                           corrupt=corrupt)


def assert_faulted_match(got, want):
    """Exact fault fields, the engine tolerances elsewhere, and NaN in
    the same places."""
    assert got["agg_survivors"] == want["agg_survivors"]
    assert got["agg_quorum_ok"] == want["agg_quorum_ok"]
    assert got["fault_summary"] == want["fault_summary"]
    for k in ("device_loss", "test_loss"):
        a, b = np.asarray(got[k], float), np.asarray(want[k], float)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
    assert_histories_match(got, want)


CASES = {
    "mixed_q50": ("mixed", 0.4, dict(quorum=0.5)),
    "drop_q60": ("drop", 0.5, dict(quorum=0.6)),
    "corrupt_nan_guarded": ("corrupt", 0.3, {}),
    "corrupt_inf_unguarded": ("corrupt", 0.3, dict(guard=False)),
    "corrupt_nan_unguarded": ("corrupt", 0.3, dict(guard=False)),
    "crash": ("crash", 0.3, {}),
    "scale_guarded": ("corrupt", 0.3, dict(corrupt="scale")),
}


@functools.lru_cache(maxsize=None)
def _ref_case(name, engine):
    kind, rate, kw = CASES[name]
    kw = dict(kw)
    corrupt = kw.pop("corrupt", "inf" if "inf" in name else "nan")
    return _run_ref(engine, _faults(rfl, kind, rate, corrupt=corrupt),
                    **kw)


@pytest.mark.parametrize("engine", ["scan", "legacy"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_engines_under_faults_match_reference_scan(name, engine):
    kind, rate, kw = CASES[name]
    kw = dict(kw)
    corrupt = kw.pop("corrupt", "inf" if "inf" in name else "nan")
    got = _run_port(engine, _faults(tfl, kind, rate, corrupt=corrupt),
                    **kw)
    assert_faulted_match(got, _ref_case(name, "scan"))
    if "unguarded" in name:
        assert np.isnan(got["test_loss"][-1])


def test_reference_legacy_agrees_with_its_scan_on_the_cases():
    """The port is held to the reference's scan; its legacy oracle gives
    the same fault fields on these cases (so the port's legacy engine
    is held to both)."""
    for name in ("mixed_q50", "drop_q60"):
        want, leg = _ref_case(name, "scan"), _ref_case(name, "legacy")
        assert want["agg_survivors"] == leg["agg_survivors"]
        assert want["agg_quorum_ok"] == leg["agg_quorum_ok"]


@pytest.mark.parametrize("name", ["mixed_q50", "corrupt_nan_unguarded",
                                  "drop_q60"])
def test_tiered_engine_under_faults_matches_reference(name):
    kind, rate, kw = CASES[name]
    tiers = "3@4,1@12"
    want = _run_ref("scan", _faults(rfl, kind, rate), tiers=tiers, **kw)
    got = _run_port("scan", _faults(tfl, kind, rate), tiers=tiers, **kw)
    assert_faulted_match(got, want)
    for k in ("tier_agg_round", "tier_agg_level"):
        assert got[k] == want[k]


def test_tiered_l1_tree_delegates_with_faults():
    fs = _faults(tfl, "mixed", 0.4)
    flat = _run_port("scan", fs, quorum=0.5)
    one = _run_port("scan", fs, quorum=0.5, tiers="1@4")
    assert one["agg_quorum_ok"] == flat["agg_quorum_ok"]
    assert one["test_acc"] == flat["test_acc"]


def test_clean_noop_is_bitwise():
    clean = _run_port("scan")
    for engine in ("scan", "legacy"):
        noop = _run_port(engine, tfl.FaultSchedule(T, N, TAU), quorum=0.5)
        base = clean if engine == "scan" else _run_port("legacy")
        assert noop["test_acc"] == base["test_acc"]
        assert noop["test_loss"] == base["test_loss"]
        for a, b in zip(noop["device_loss"], base["device_loss"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.stack(noop["H_agg"]),
                                      np.stack(base["H_agg"]))
        assert all(noop["agg_quorum_ok"])
    tiered = _run_port("scan", tiers="3@4,1@12")
    noop = _run_port("scan", tfl.FaultSchedule(T, N, TAU), quorum=0.5,
                     tiers="3@4,1@12")
    assert noop["test_loss"] == tiered["test_loss"]
    for a, b in zip(noop["device_loss"], tiered["device_loss"]):
        np.testing.assert_array_equal(a, b)


def test_quorum_failure_carries_global_forward():
    """Every upload of the second window dropped, quorum 0.5: that
    aggregation is skipped — the global and its evaluation carry over,
    H keeps accumulating into the next window — on both sides."""
    ev = [(7, "drop", i) for i in range(N)]
    got = _run_port("scan", tfl.FaultSchedule(
        T, N, TAU, [tfl.FaultEvent(*e) for e in ev]), quorum=0.5)
    want = _run_ref("scan", rfl.FaultSchedule(
        T, N, TAU, [rfl.FaultEvent(*e) for e in ev]), quorum=0.5)
    assert got["agg_quorum_ok"] == want["agg_quorum_ok"] == [True, False,
                                                              True]
    assert got["agg_survivors"][1] == 0.0
    assert got["test_acc"][1] == got["test_acc"][0]
    assert got["test_loss"][1] == got["test_loss"][0]
    H = np.stack(got["H_agg"])
    assert (H[2] > H[1]).any() and (H[2] >= H[1]).all()
    assert_faulted_match(got, want)
    leg = _run_port("legacy", tfl.FaultSchedule(
        T, N, TAU, [tfl.FaultEvent(*e) for e in ev]), quorum=0.5)
    assert leg["agg_quorum_ok"] == got["agg_quorum_ok"]
    np.testing.assert_array_equal(np.stack(leg["H_agg"]), H)


def test_crash_only_equals_composed_activity():
    fs = _faults(tfl, "crash", 0.4)
    assert fs.has_crashes and not fs.has_upload_faults
    got = _run_port("scan", fs)
    act = fs.compose(adj=fully_connected(N)).activity()
    want = _run_port("scan", activity=act)
    np.testing.assert_array_equal(np.stack(got["active"]), act)
    assert got["test_acc"] == want["test_acc"]
    for a, b in zip(got["device_loss"], want["device_loss"]):
        np.testing.assert_array_equal(a, b)


def test_fault_schedule_must_fit_the_run():
    with pytest.raises(ValueError, match=r"fault schedule is \(T=8"):
        _run_port("scan", tfl.FaultSchedule(8, N, TAU))
    with pytest.raises(ValueError, match="tau=3"):
        _run_port("scan", tfl.FaultSchedule(T, N, 3))


# ---------------------------------------------------------------------------
# the CLI and the study
# ---------------------------------------------------------------------------

ARGS = ["--mode", "fog", "--model", "mlp", "--n", "6", "--T", "8",
        "--tau", "4", "--n-train", "600", "--n-test", "200"]


def _recording(module, sink, **extra):
    run = module.run_network_aware

    def wrapped(*a, **kw):
        sink.append(run(*a, **kw, **extra))
        return sink[-1]
    return wrapped


@pytest.mark.parametrize("flags", [
    ["--faults", "mixed", "--fault-rate", "0.4", "--quorum", "0.5"],
    ["--faults", "corrupt", "--fault-rate", "0.3", "--unguarded"],
    ["--faults", "corrupt", "--fault-rate", "0.3", "--corrupt-mode",
     "scale"],
    ["--faults", "crash", "--fault-rate", "0.4"],
    ["--faults", "crash", "--fault-rate", "0.4", "--churn", "0.1"],
    ["--faults", "drop", "--fault-rate", "0.6", "--quorum", "0.6"],
    ["--tiers", "3@4,1@8", "--faults", "mixed", "--fault-rate", "0.4"],
])
def test_cli_faults_match_reference_cli(flags, monkeypatch):
    ref_h, port_h = [], []
    monkeypatch.setattr(RF, "run_network_aware", _recording(RF, ref_h))
    monkeypatch.setattr(TF, "run_network_aware", _recording(
        TF, port_h, params=params_from_jax(_jax_params())))
    with contextlib.redirect_stdout(io.StringIO()):
        want = rtrain.main(ARGS + flags)
        got = ttrain.main(ARGS + flags + ["--device", "cpu"])
    for k in ("cost", "fault_summary", "quorum_skips", "engine",
              "schedule", "n_events", "hierarchy"):
        assert got.get(k) == want.get(k), k
    assert_faulted_match(port_h[0], ref_h[0])


def test_cli_checkpoint_then_resume_reproduces_the_run(tmp_path):
    ck = str(tmp_path / "ck.pt")
    with contextlib.redirect_stdout(io.StringIO()):
        whole = ttrain.main(ARGS + ["--device", "cpu"])
        first = ttrain.main(ARGS + ["--device", "cpu", "--checkpoint", ck])
        again = ttrain.main(ARGS + ["--device", "cpu", "--resume", ck])
    assert first["engine"] == again["engine"] == "scan"
    assert first["acc_curve"] == again["acc_curve"] == whole["acc_curve"]
    with pytest.raises(ValueError, match="scan-engine feature"), \
            contextlib.redirect_stdout(io.StringIO()):
        ttrain.main(ARGS + ["--device", "cpu", "--engine", "legacy",
                            "--checkpoint", ck])


def test_breakdown_takes_the_fault_flags():
    from repro_torch.launch import breakdown

    res = breakdown.run(ARGS + ["--device", "cpu", "--reps", "1",
                                "--faults", "mixed", "--fault-rate", "0.4",
                                "--quorum", "0.5"])
    assert res["train_cold_s"] > 0 and len(res["train_warm_s"]) == 1


SMALL_REF = BF.BenchScale(n_train=2000, n_test=500, T=20, tau=5)
SMALL = TT.BenchScale(n_train=2000, n_test=500, T=20, tau=5)


def test_fault_study_matches_reference(monkeypatch):
    """``--only faults`` against the reference's study, both trained
    point by point on the scan engine, the port from the reference's
    initial weights: every cost, fault summary, quorum count and claim
    equal, accuracies within 1e-2."""
    sink = {}
    monkeypatch.setattr(BR, "_emit", lambda name, s, derived:
                        sink.__setitem__(name, derived))
    monkeypatch.setattr(BF, "run_scenarios",
                        functools.partial(BF.run_scenarios, batch=False))
    BR.fault_tolerance(SMALL_REF)
    want = json.loads(json.dumps(sink["faults"], default=float))
    run = TT.F.run_network_aware

    def train(cfg, *a, **kw):
        return run(cfg, *a, params=params_from_jax(
            _jax_params(cfg.model, cfg.seed)), **kw)

    monkeypatch.setattr(TT.F, "run_network_aware", train)
    got = json.loads(json.dumps(TT.fault_tolerance(SMALL, "cpu"),
                                default=float))
    assert [r["arm"] for r in got["rows"]] == [r["arm"]
                                               for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        for k in ("avg_active", "cost_total", "fault_summary",
                  "quorum_skips"):
            assert g[k] == w[k], (g["arm"], k)
        assert abs(g["acc"] - w["acc"]) <= 1e-2, (g["arm"], g["acc"],
                                                  w["acc"])
    h, w = got["headline"], want["headline"]
    for k in ("quorum_skips_q0", "quorum_skips_q60", "clean_noop_bitwise",
              "resume_bitwise", "unguarded_near_random",
              "guard_within_2pp"):
        assert h[k] == w[k], k
    assert h["clean_noop_bitwise"] and h["resume_bitwise"]
    assert h["quorum_skips_q0"] == 0
