"""The port's sweep engine (``run_rounds_batched``) against the
reference's, on the CPU.

The stagers (dense slabs and ragged chunk-row tables, with phantom
rounds, phantom devices and churn) are numpy copies of the reference's
and are held bit for bit. The engine is held, from the reference's
initial weights (``params_from_jax``), to the reference's
``run_rounds_batched(mesh=None)`` for dense, ragged and faulted
buckets: ``agg_round``, ``H_agg``, ``agg_survivors`` and
``agg_quorum_ok`` exactly; ``device_loss`` and ``test_loss`` within
rtol 2e-3, atol 1e-4 and ``test_acc`` within atol 1e-2, the engines'
tolerances (observed here: at most 4.8e-7 on the losses and 1.5e-8 on
the accuracy). Against the port's own ``run_rounds_scan`` at the
bucket's staging the same tolerances hold (eq. (4) is a sequential sum
here, an einsum there).

Bit for bit: a scenario inside a bucket and the same scenario alone at
the same staging (ragged: a bucket of one; dense: alone through
``engine="batched"`` with ``max_points`` the bucket's P_b, since an
exact P pads the loss sums differently), clean and under faults; and a
repeated sweep that hits the staged-operand cache. The stacked
evaluator equals scalar submits bit for bit and reports every failure.
``--engine batched`` through the CLI matches the reference CLI's.
"""
import contextlib
import copy
import io

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.core import faults as rfl
from repro.core import federated as RF
from repro.core import movement as rmv
from repro.core.costs import synthetic_costs
from repro.core.topology import fully_connected
from repro.data import pipeline as rpl
from repro.data.synthetic import make_image_dataset
from repro.launch import train as rtrain
from repro_torch.core import engine as teng
from repro_torch.core import faults as tfl
from repro_torch.core import federated as TF
from repro_torch.data import pipeline as tpl
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax

DATA = make_image_dataset(n_train=1200, n_test=400, seed=0)
RTOL, ATOL, ACC_ATOL = 2e-3, 1e-4, 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(n=6, T=12, tau=4, p_exit=0.0, p_entry=0.0, seed=0,
           max_points=0):
    cfg = RF.FedConfig(n=n, T=T, tau=tau, eta=0.05, model="mlp", seed=seed,
                       p_exit=p_exit, p_entry=p_entry, max_points=max_points)
    rng = np.random.default_rng(seed)
    traces = synthetic_costs(n, T, rng)
    streams = rpl.poisson_streams(n, T, DATA[1], rng=rng)
    plan = rmv.greedy_linear(traces, fully_connected(n))
    activity = RF.churn_activity(cfg, rng) if (p_exit or p_entry) else None
    return cfg, plan, streams, activity


def _tcfg(cfg, **kw):
    return TF.FedConfig(**{**{k: getattr(cfg, k) for k in (
        "n", "T", "tau", "eta", "model", "iid", "seed", "max_points",
        "p_exit", "p_entry")}, **kw})


def _params(seed, model="mlp"):
    jp, _ = reng.make_model(model, jax.random.PRNGKey(seed))
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()})


def _port(setups, faults=None, cfg_kw=None, **kw):
    return TF.run_network_aware_batched(
        [_tcfg(s[0], **(cfg_kw or {})) for s in setups], DATA,
        [s[1] for s in setups],
        streams=[copy.deepcopy(s[2]) for s in setups],
        activities=[s[3] for s in setups],
        params=[_params(s[0].seed) for s in setups], faults=faults,
        device="cpu", **kw)


EVENTS = [(3, "corrupt", 0, float("nan")), (5, "crash", 2), (7, "drop", 3),
          (11, "drop", 1), (11, "drop", 4), (11, "drop", 5)]
SPECS = [dict(n=4, T=12, tau=4, seed=0), dict(n=6, T=12, tau=4, seed=1),
         dict(n=6, T=8, tau=4, seed=3, p_exit=0.2, p_entry=0.15)]


def _faults(mod):
    return mod.FaultSchedule(12, 6, 4, [mod.FaultEvent(*e) for e in EVENTS])


@pytest.fixture(scope="module", params=["dense", "ragged"])
def staging(request):
    return request.param


@pytest.fixture(scope="module", params=[False, True],
                ids=["clean", "faulted"])
def runs(request, staging):
    """(setups, faults, reference histories, port histories) of one
    bucket: a mixed clean bucket (phantom devices, a shorter T, churn),
    or two n = 6 points of which the first is faulted."""
    faulted = request.param
    if faulted:
        setups = [_setup(n=6, T=12, tau=4, seed=s) for s in (0, 1)]
        kw = dict(guard=True, quorum=0.6)
        rf, tf = [_faults(rfl), None], [_faults(tfl), None]
    else:
        setups = [_setup(**s) for s in SPECS]
        kw, rf, tf = {}, None, None
    with torch.no_grad():
        want = RF.run_network_aware_batched(
            [s[0] for s in setups], DATA, [s[1] for s in setups],
            streams=[copy.deepcopy(s[2]) for s in setups],
            activities=[s[3] for s in setups], mesh=None, staging=staging,
            faults=rf, **kw)
    got = _port(setups, faults=tf, staging=staging, **kw)
    return setups, tf, kw, want, got


def assert_close(got, want):
    assert got["agg_round"] == want["agg_round"]
    np.testing.assert_array_equal(np.stack(got["H_agg"]),
                                  np.stack(want["H_agg"]))
    for k in ("agg_survivors", "agg_quorum_ok"):
        assert got.get(k) == want.get(k), k
    np.testing.assert_allclose(np.stack(got["device_loss"]),
                               np.stack(want["device_loss"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                               atol=ACC_ATOL)


def assert_bitwise(a, b):
    assert a["agg_round"] == b["agg_round"]
    assert a["test_acc"] == b["test_acc"]
    assert a["test_loss"] == b["test_loss"]
    np.testing.assert_array_equal(np.stack(a["device_loss"]),
                                  np.stack(b["device_loss"]))
    np.testing.assert_array_equal(np.stack(a["H_agg"]),
                                  np.stack(b["H_agg"]))
    if "agg_survivors" in a:
        assert a["agg_survivors"] == b["agg_survivors"]
        assert a["agg_quorum_ok"] == b["agg_quorum_ok"]


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------

def _streams(seed, T, n, empty_every=0):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(T):
        row = []
        for i in range(n):
            k = int(rng.integers(0, 20))
            if empty_every and (t * n + i) % empty_every == 0:
                k = 0
            row.append(rng.integers(0, 64, k).astype(np.int64))
        out.append(row)
    return out


BUCKETS = [  # (T, n) per scenario: phantom rounds and devices
    [(6, 2), (4, 1)], [(12, 4), (12, 6), (10, 6)], [(8, 5)]]


@pytest.mark.parametrize("shapes", BUCKETS)
@pytest.mark.parametrize("bucket", ["pow2", "exact"])
def test_stagers_bitwise_the_reference(shapes, bucket):
    y = np.arange(64, dtype=np.int32) % 10
    procs = [_streams(i, T, n, empty_every=3) for i, (T, n) in
             enumerate(shapes)]
    acts = [np.random.default_rng(9 + i).random((T, n)) < 0.8
            for i, (T, n) in enumerate(shapes)]
    mp = [0] * (len(shapes) - 1) + [24]
    for stage, fields in (("stage_scenario_batch", (
            "idx", "yb", "w", "counts", "act", "is_agg")),
            ("stage_scenario_ragged", (
                "idx", "yb", "w", "cell", "counts", "act", "is_agg"))):
        want = getattr(rpl, stage)(procs, y, acts, 2, max_points=mp,
                                   bucket=bucket)
        got = getattr(tpl, stage)(procs, y, acts, 2, max_points=mp,
                                  bucket=bucket)
        assert got.dims == want.dims
        assert (got.T, got.n, got.P) == (want.T, want.n, want.P)
        for f in fields:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, (stage, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{stage}.{f}")
    np.testing.assert_array_equal(tpl.ragged_rows(procs, 3),
                                  rpl.ragged_rows(procs, 3))
    assert tpl.bucket_rounds(10, 4) == rpl.bucket_rounds(10, 4) == 16


def test_ragged_stager_takes_flat_streams():
    y = np.arange(64, dtype=np.int32) % 10
    procs = [_streams(5, 6, 3)]
    flat = tpl.flat_from_streams(tpl.FogStreams(procs[0], n=3, T=6))
    act = [np.ones((6, 3), bool)]
    a = tpl.stage_scenario_ragged([flat], y, act, 3)
    b = rpl.stage_scenario_ragged(procs, y, act, 3)
    for f in ("idx", "yb", "w", "cell", "counts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_padding_warnings_fire_once_per_sweep():
    y = np.arange(64, dtype=np.int32)
    small = [[np.arange(2)] for _ in range(4)]
    big = [[np.arange(60)] for _ in range(4)]
    act = [np.ones((4, 1))] * 3
    tpl.reset_padding_warnings()
    with pytest.warns(UserWarning, match="shape bucket pads") as rec:
        tpl.stage_scenario_batch([small, small, big], y, act, tau=2)
        tpl.stage_scenario_batch([small, small, big], y, act, tau=2)
    assert len([w for w in rec if "shape bucket" in str(w.message)]) == 1


# ---------------------------------------------------------------------------
# the engine against the reference, against alone, against the scan
# ---------------------------------------------------------------------------

def test_batched_matches_reference(runs):
    _, _, _, want, got = runs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g, w)
        assert g["active"][0].shape == w["active"][0].shape


def test_in_bucket_equals_alone_bitwise(runs, staging):
    """Ragged: each scenario alone as a bucket of one. Dense: every
    pad size pinned to the bucket's P_b, then each scenario alone
    through ``engine="batched"`` (S = 1, exact staging)."""
    setups, tf, kw, _, got = runs
    if staging == "dense":
        P_b = tpl.bucket_size(max(g["max_points"] for g in got),
                              max_inflation=tpl.BUCKET_MAX_INFLATION)
        got = _port(setups, faults=tf, staging="dense",
                    cfg_kw={"max_points": P_b}, **kw)
    for b, (s, g) in enumerate(zip(setups, got)):
        f = None if tf is None else tf[b]
        if staging == "ragged":
            alone = _port([s], faults=None if f is None else [f],
                          staging="ragged", **kw)[0]
        else:
            alone = TF.run_network_aware(
                _tcfg(s[0], max_points=P_b), DATA, None, None, s[1],
                streams=copy.deepcopy(s[2]), activity=s[3],
                engine="batched", params=_params(s[0].seed), faults=f,
                device="cpu", **(kw if f is not None else {}))
        if f is None and "agg_survivors" in g:
            g = {k: v for k, v in g.items()
                 if k not in ("agg_survivors", "agg_quorum_ok")}
        assert_bitwise(alone, g)


def test_batched_matches_port_scan(runs, staging):
    """The port's scan engine at the bucket's staging: the exact fields
    exactly, the losses within the tolerances."""
    setups, tf, kw, _, got = runs
    for b, (s, g) in enumerate(zip(setups, got)):
        f = None if tf is None else tf[b]
        h = TF.run_network_aware(
            _tcfg(s[0], max_points=g["max_points"]), DATA, None, None,
            s[1], streams=copy.deepcopy(s[2]), activity=s[3],
            engine="scan", params=_params(s[0].seed), faults=f,
            device="cpu", **(kw if f is not None else {}))
        if f is None:
            g = {k: v for k, v in g.items()
                 if k not in ("agg_survivors", "agg_quorum_ok")}
        assert_close(g, h)


def test_single_engine_is_the_bucket_of_one():
    s = _setup(n=5, T=8, tau=4, seed=2)
    one = TF.run_network_aware(_tcfg(s[0]), DATA, None, None, s[1],
                               streams=copy.deepcopy(s[2]),
                               engine="batched", params=_params(2),
                               device="cpu")
    bucket = _port([s], bucket="exact")[0]
    assert_bitwise(one, bucket)
    assert one["round"] == list(range(8)) and len(one["active"]) == 8


def test_staged_cache_hits_on_repeat_sweep():
    setups = [_setup(n=4, T=8, tau=4, seed=0), _setup(n=6, T=8, tau=4,
                                                      seed=1)]
    teng.reset_staged_cache()
    first = _port(setups)
    assert teng.staged_cache_stats() == {"hits": 0, "misses": 1}
    teng.reset_phase_timings()
    second = _port(setups)
    assert teng.staged_cache_stats() == {"hits": 1, "misses": 1}
    ph = teng.phase_timings()
    assert ph["program_s"] > 0 and ph["eval_s"] > 0
    assert ph["train_s"] >= ph["program_s"]
    for a, b in zip(first, second):
        assert_bitwise(a, b)


def test_bucket_programs_count_shapes():
    setups = [_setup(n=4, T=8, tau=4, seed=0), _setup(n=6, T=8, tau=4,
                                                      seed=1)]
    b0 = teng.batched_compile_count()
    _port(setups, staging="ragged")
    b1 = teng.batched_compile_count()
    _port(setups, staging="ragged")
    assert b1 - b0 <= 1 and teng.batched_compile_count() == b1


def test_batched_refusals():
    s1, s2 = _setup(seed=0), _setup(seed=1)
    with pytest.raises(ValueError, match="share"):
        TF.run_network_aware_batched(
            [_tcfg(s1[0]), _tcfg(s2[0], eta=0.9)], DATA, [s1[1], s2[1]],
            streams=[s1[2], s2[2]], device="cpu")
    with pytest.raises(ValueError, match="one entry per scenario"):
        TF.run_network_aware_batched([_tcfg(s1[0])], DATA, [s1[1], s2[1]],
                                     device="cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        _port([s1], mesh=object())
    with pytest.raises(ValueError, match="staging"):
        _port([s1], staging="sparse")
    with pytest.raises(ValueError, match="DeviceMesh"):
        TF.run_network_aware(_tcfg(s1[0]), DATA, None, None, s1[1],
                             engine="sharded", mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# the stacked evaluator
# ---------------------------------------------------------------------------

def test_submit_stack_matches_scalar_submits():
    from repro_torch.models import mnist as mm

    p = _params(0)
    p2 = {k: v * 0.5 for k, v in p.items()}
    stack = {k: torch.stack([torch.stack([p[k], p2[k]]),
                             torch.stack([p2[k], p[k]])]) for k in p}
    apply_fn = mm.MODELS["mlp"][1]
    ev = teng.AsyncEvaluator(apply_fn, DATA[2], DATA[3], device="cpu")
    ev.submit_stack(stack, n_axes=2)
    ev.submit(p)
    (tl, tl_s), (ta, ta_s) = ev.collect()
    assert tl.shape == ta.shape == (2, 2)
    ref = teng.AsyncEvaluator(apply_fn, DATA[2], DATA[3], device="cpu")
    for q in (p, p2, p2, p):
        ref.submit(q)
    losses, accs = ref.result()
    np.testing.assert_array_equal(tl.reshape(-1), np.asarray(losses,
                                                             np.float32))
    np.testing.assert_array_equal(ta.reshape(-1), np.asarray(accs,
                                                             np.float32))
    assert tl_s == losses[0] and ta_s == accs[0]
    ref.shutdown()
    ref.shutdown()


def test_evaluator_reports_every_failure():
    calls = []

    def bad(p, x):
        calls.append(1)
        raise ValueError("boom")

    x = np.zeros((4, 3), np.float32)
    y = np.zeros(4, np.int32)
    ev = teng.AsyncEvaluator(bad, x, y, device="cpu", retries=2,
                             backoff=0.0)
    ev.submit_stack({"w": torch.zeros((2, 3))})
    assert len(calls) == 3                   # first try and two retries
    ev.submit({"w": torch.zeros(3)})         # after a kept failure: no-op
    assert len(calls) == 3
    with pytest.raises(RuntimeError, match="1 submitted") as ei:
        ev.collect()
    assert isinstance(ei.value.__cause__, ValueError)
    assert len(ei.value.failures) == 1
    ev.shutdown()                            # nothing pending any more


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

ARGS = ["--mode", "fog", "--model", "mlp", "--n", "6", "--T", "8",
        "--tau", "4", "--n-train", "600", "--n-test", "200",
        "--engine", "batched"]


def _recording(module, sink, **extra):
    run = module.run_network_aware

    def wrapped(*a, **kw):
        sink.append(run(*a, **kw, **extra))
        return sink[-1]
    return wrapped


@pytest.mark.parametrize("flags", [
    [], ["--faults", "mixed", "--fault-rate", "0.4", "--quorum", "0.5"],
    ["--churn", "0.1", "--replan", "predict"]])
def test_cli_engine_batched_matches_reference_cli(flags, monkeypatch):
    ref_h, port_h = [], []
    monkeypatch.setattr(RF, "run_network_aware", _recording(RF, ref_h))
    monkeypatch.setattr(TF, "run_network_aware", _recording(
        TF, port_h, params=_params(0)))
    with contextlib.redirect_stdout(io.StringIO()):
        want = rtrain.main(ARGS + flags)
        got = ttrain.main(ARGS + flags + ["--device", "cpu"])
    for k in ("engine", "cost", "fault_summary", "quorum_skips",
              "schedule", "replan", "n_events", "sim_before", "sim_after"):
        assert got.get(k) == want.get(k), k
    assert got["engine"] == "batched"
    assert_close(port_h[0], ref_h[0])
    np.testing.assert_allclose(got["acc_curve"], want["acc_curve"],
                               atol=ACC_ATOL)


def test_cli_engine_sharded_still_refuses():
    """--engine sharded runs (tests/test_torch_sharded_engine.py); with
    --sanitize it still stops, naming the tooling item."""
    with pytest.raises(SystemExit, match="queue 1 item 13"):
        ttrain.main(ARGS[:-1] + ["sharded", "--device", "cpu",
                                 "--sanitize"])
