"""The port's runtime sanitizer (``core/sanitize.py``) and compile-event
fan-out (``core/monitoring.py``), beside the reference's.

The reference's tests of both are mirrored (``tests/test_analysis.py``:
one fan-out for every subscriber, a broken subscriber starves nobody,
the warm watchdog, the config's scope, ``debug_nans`` on an eager op,
bitwise histories under the sanitizer). A planted host sync in each of
the guarded round loops raises, and the same run without the sanitizer
does not. The port's ``--sanitize`` CLI is held to the reference CLI's
on the same small case: the ``sanitize`` blocks are equal, and the
histories, from the reference's initial weights, are within the
engines' tolerances (rtol 2e-3, atol 1e-4 on the losses, atol 1e-2 on
the accuracy); with unguarded corrupt uploads both raise.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.core import federated as RF
from repro.launch import train as rtrain
from repro_torch.core import costmodel as tcm
from repro_torch.core import engine as teng
from repro_torch.core import federated as TF
from repro_torch.core import monitoring as mon
from repro_torch.core import movement as tmv
from repro_torch.core import sanitize as sz
from repro_torch.core.costs import synthetic_costs
from repro_torch.core.hierarchy import TierTree
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax

DATA = make_image_dataset(n_train=600, n_test=200, seed=0)
RTOL, ATOL, ACC_ATOL = 2e-3, 1e-4, 1e-2
BLOCK = {"transfer_guard": True, "debug_nans": True, "warm_compiles": 0}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(engine="scan", eta=0.05, sanitize=False, **kw):
    cfg = TF.FedConfig(n=6, T=8, tau=2, eta=eta, model="mlp", seed=3)
    traces = synthetic_costs(cfg.n, cfg.T, np.random.default_rng(1))
    plan = tmv.no_movement_plan(cfg.T, cfg.n)
    return TF.run_network_aware(cfg, DATA, traces, None, plan,
                                engine=engine, sanitize=sanitize,
                                device="cpu", **kw)


def _new_program_key():
    """One sweep-engine run under a program key no other run has (a new
    η): one compile event."""
    _new_program_key.eta *= 0.5
    return _run("batched", eta=_new_program_key.eta)


_new_program_key.eta = 0.37


def _bitwise(a, b):
    assert a["agg_round"] == b["agg_round"]
    assert a["test_acc"] == b["test_acc"]
    assert a["test_loss"] == b["test_loss"]
    np.testing.assert_array_equal(np.stack(a["device_loss"]),
                                  np.stack(b["device_loss"]))
    np.testing.assert_array_equal(np.stack(a["H_agg"]),
                                  np.stack(b["H_agg"]))
    assert a.get("agg_survivors") == b.get("agg_survivors")


# ---------------------------------------------------------------------------
# the compile-event fan-out
# ---------------------------------------------------------------------------


def test_subscribers_share_one_registration():
    assert mon.listener_installed()
    a, b = [], []
    mon.subscribe_compile(a.append)
    mon.subscribe_compile(b.append)
    try:
        before, keys = mon.compile_events(), teng.batched_compile_count()
        _new_program_key()
        delta = mon.compile_events() - before
        assert delta == teng.batched_compile_count() - keys == 1
        assert a == b == [0.0]
    finally:
        mon.unsubscribe_compile(a.append)
        mon.unsubscribe_compile(b.append)


def test_broken_subscriber_does_not_starve_others():
    def boom(_):
        raise RuntimeError("subscriber bug")
    good = []
    mon.subscribe_compile(boom)
    mon.subscribe_compile(good.append)
    try:
        mon.record_compile(1.5)
        assert good == [1.5]
    finally:
        mon.unsubscribe_compile(boom)
        mon.unsubscribe_compile(good.append)


def test_costmodel_listener_subscribes_once_and_keeps_zero_s_emas():
    tcm.install_listener()
    n_subs = len(mon._SUBSCRIBERS)
    tcm.install_listener()                   # idempotent
    assert len(mon._SUBSCRIBERS) == n_subs
    events, compile_s = tcm.MODEL.compile_events, tcm.MODEL.compile_s
    _new_program_key()
    assert tcm.MODEL.compile_events == events + 1
    assert tcm.MODEL.compile_s == compile_s  # a 0 s event moves no EMA


def test_warm_run_adds_no_program_key():
    _run("batched", eta=0.011)
    before = mon.compile_events()
    _run("batched", eta=0.011)
    assert mon.compile_events() == before


# ---------------------------------------------------------------------------
# the sanitizer
# ---------------------------------------------------------------------------


def test_watchdog_raises_on_warm_compile():
    with pytest.raises(sz.RecompileError):
        with sz.sanitized(sz.SanitizeConfig(expect_warm=True,
                                            debug_nans=False)):
            _new_program_key()


def test_config_saved_and_restored():
    with sz.sanitized(True) as cfg:
        assert sz.active() is cfg
        with pytest.raises(FloatingPointError):
            torch.log(torch.zeros(3) - 1.0)
    assert sz.active() is None
    assert torch.isnan(torch.log(torch.zeros(3) - 1.0)).all()
    with sz.hot_loop_guard():                 # inert again
        torch.arange(3.0).sum().item()


def test_false_is_a_noop():
    with sz.sanitized(False) as cfg:
        assert cfg is None and sz.active() is None


def test_hot_loop_guard_inert_outside_sanitized():
    with sz.hot_loop_guard():
        x = torch.arange(3.0)
        x.sum().item(), x.numpy(), float(x[0]), torch.nonzero(x)


def test_debug_nans_catches_engine_nan():
    with sz.sanitized(sz.SanitizeConfig(transfer_guard=False)):
        with pytest.raises(FloatingPointError, match="nan"):
            torch.log(torch.zeros(3) - 1.0)
        # infinities pass, as under jax's debug_nans; data movement of a
        # NaN makes none, so it passes too
        torch.log(torch.zeros(3))
        torch.tensor([1.0, float("nan")]).clone()[:1]


@pytest.mark.parametrize("engine", ["scan", "batched"])
def test_engine_history_bitwise_under_sanitize(engine):
    h0 = _run(engine)
    h1 = _run(engine, sanitize=True)
    _bitwise(h0, h1)
    # the warm sanitized re-run must not compile anything
    warm = sz.SanitizeConfig(expect_warm=True)
    h2 = _run(engine, sanitize=warm)
    _bitwise(h1, h2)
    assert warm.last_compiles == 0


def test_bad_sanitize_value_rejected():
    with pytest.raises(TypeError, match="SanitizeConfig"):
        sz.SanitizeConfig.coerce("yes")


@pytest.mark.parametrize("op", [
    lambda x: x.sum().item(), lambda x: float(x[0]), lambda x: bool(x[0]),
    lambda x: torch.nonzero(x), lambda x: x.to("meta"),
    lambda x: torch.empty(3, device="meta").to("cpu"),
    lambda x: torch.empty(3, device="meta").copy_(x)],
    ids=["item", "float", "bool", "nonzero", "to_device", "to_host",
         "copy_across"])
def test_guard_raises_on_syncs_and_host_copies(op):
    x = torch.arange(1.0, 4.0)
    with sz.sanitized(True):
        with pytest.raises(RuntimeError, match="Disallowed"):
            with sz.hot_loop_guard():
                op(x)


def test_guard_allows_same_side_copies_and_checks_outputs_on_exit():
    x = torch.tensor([1.0, float("nan")])
    with sz.sanitized(True):
        with sz.hot_loop_guard() as outs:    # a NaN selected away passes
            y = torch.where(torch.isnan(x), torch.zeros(()), x)
            y.to("cpu").clone()
            outs.append({"y": y})
        with pytest.raises(FloatingPointError, match="out.*x"):
            with sz.hot_loop_guard() as outs:
                outs.append({"x": x * 2.0})


class _PlantedSync:
    """``engine._bcast`` with a host read planted in it: every round
    loop scales its SGD step through it."""

    def __init__(self):
        self.calls = 0
        self._orig = teng._bcast

    def __call__(self, v, like):
        self.calls += 1
        float(v.sum())
        return self._orig(v, like)


LOOPS = {
    "scan": dict(engine="scan"),
    "checkpointed": dict(engine="scan", checkpoint_path=True),
    "hierarchical": dict(hierarchy=TierTree.from_spec("3@2,1@4", 6)),
    "batched": dict(engine="batched"),
    "sharded": dict(engine="sharded"),
}


@pytest.mark.parametrize("loop", list(LOOPS))
def test_planted_sync_raises_in_each_guarded_loop(loop, monkeypatch,
                                                  tmp_path):
    kw = dict(LOOPS[loop])
    if kw.get("checkpoint_path"):
        kw["checkpoint_path"] = str(tmp_path / "ckpt")
    planted = _PlantedSync()
    monkeypatch.setattr(teng, "_bcast", planted)
    _run(**kw)                               # unsanitized: it runs
    assert planted.calls > 0
    with pytest.raises(RuntimeError, match="Disallowed device-to-host"):
        _run(sanitize=True, **kw)


# ---------------------------------------------------------------------------
# the CLI, beside the reference CLI
# ---------------------------------------------------------------------------

ARGS = ["--mode", "fog", "--model", "mlp", "--n", "6", "--T", "8",
        "--tau", "2", "--n-train", "600", "--n-test", "200", "--sanitize"]


def _params(seed):
    jp, _ = reng.make_model("mlp", jax.random.PRNGKey(seed))
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()})


def _recording(monkeypatch, module, sink, **extra):
    run = module.run_network_aware

    def wrapped(*a, **kw):
        sink.append(run(*a, **kw, **extra))
        return sink[-1]
    monkeypatch.setattr(module, "run_network_aware", wrapped)


def _close(got, want):
    assert got["agg_round"] == want["agg_round"]
    np.testing.assert_array_equal(np.stack(got["H_agg"]),
                                  np.stack(want["H_agg"]))
    assert got.get("agg_survivors") == want.get("agg_survivors")
    np.testing.assert_allclose(np.stack(got["device_loss"]),
                               np.stack(want["device_loss"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                               atol=ACC_ATOL)


@pytest.mark.parametrize("flags", [
    [], ["--tiers", "3@2,1@4"], ["--engine", "batched"],
    ["--faults", "corrupt", "--fault-rate", "0.3"]],
    ids=["plain", "tiers", "batched", "guarded_corrupt"])
def test_cli_sanitize_matches_reference_cli(flags, monkeypatch):
    ref_h, port_h = [], []
    _recording(monkeypatch, RF, ref_h)
    _recording(monkeypatch, TF, port_h, params=_params(0))
    with contextlib.redirect_stdout(io.StringIO()):
        want = rtrain.main(ARGS + flags)
        got = ttrain.main(ARGS + flags + ["--device", "cpu"])
    assert got["sanitize"] == want["sanitize"] == BLOCK
    for k in ("engine", "cost", "fault_summary", "quorum_skips"):
        assert got.get(k) == want.get(k), k
    assert len(port_h) == len(ref_h) == 2    # the cold and the warm pass
    _bitwise(port_h[0], port_h[1])
    _close(port_h[1], ref_h[1])


def test_cli_unguarded_corrupt_raises_in_both():
    flags = ["--faults", "corrupt", "--fault-rate", "0.3", "--unguarded"]
    # the reference's transfer guard fires where a program is traced: a
    # program of the same run compiled earlier in this process (the
    # unguarded corrupt run of tests/test_torch_faults.py) is reused
    # without a transfer, and nothing raises
    jax.clear_caches()
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(Exception, match="Disallowed host-to-device"):
            rtrain.main(ARGS + flags)
        with pytest.raises(FloatingPointError, match="nan"):
            ttrain.main(ARGS + flags + ["--device", "cpu"])
        # without --sanitize both run to the end
        ttrain.main(ARGS[:-1] + flags + ["--device", "cpu"])
