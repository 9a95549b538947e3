"""The port's training engines against the reference's scan engine on
the same plan, streams and initial weights (carried across with
``params_from_jax``), for mlp, cnn and linear at n=4, T=8, τ=4.

Integer and schedule quantities (``agg_round``, ``H_agg``, ``active``,
``processed_counts``) must be exact. ``device_loss`` and ``test_loss``
are held within rtol 2e-3, atol 1e-4 and ``test_acc`` within atol 1e-2:
the tolerances of the reference's own scan-vs-legacy test
(``tests/test_engine.py``), for the same reason — summation order.
"""
import jax
import numpy as np
import pytest

from repro.core import costs as rc
from repro.core import engine as reng
from repro.core import federated as RF
from repro.core import movement as rmv
from repro.core.topology import fully_connected
from repro.data import pipeline as rpl
from repro.data.synthetic import make_image_dataset
from repro_torch.core import engine as teng
from repro_torch.core import federated as TF
from repro_torch.core import movement as tmv
from repro_torch.data import pipeline as tpl
from repro_torch.models.convert import params_from_jax

N, T, TAU = 4, 8, 4
DATA = make_image_dataset(n_train=600, n_test=200, seed=0)


def _cfg(model, mod):
    return mod.FedConfig(n=N, T=T, tau=TAU, eta=0.1, model=model, seed=0)


def _run_ref(model):
    rng = np.random.default_rng(0)
    traces = rc.testbed_like_costs(N, T, rng)
    adj = fully_connected(N)
    streams = rpl.poisson_streams(N, T, DATA[1], rng=rng)
    plan = rmv.greedy_linear(traces, adj, backend="numpy")
    return RF.run_network_aware(_cfg(model, RF), DATA, traces, adj, plan,
                                streams=streams, engine="scan")


def _run_port(model, engine):
    rng = np.random.default_rng(0)
    traces = rc.testbed_like_costs(N, T, rng)
    adj = fully_connected(N)
    streams = tpl.poisson_streams(N, T, DATA[1], rng=rng)
    plan = tmv.greedy_linear(traces, adj, backend="numpy")
    jp, _ = reng.make_model(model, jax.random.PRNGKey(0))
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    return TF.run_network_aware(_cfg(model, TF), DATA, traces, adj, plan,
                                streams=streams, engine=engine,
                                params=params, device="cpu")


def assert_histories_match(got, want):
    assert got["agg_round"] == want["agg_round"]
    assert got["round"] == want["round"]
    np.testing.assert_array_equal(np.stack(got["H_agg"]),
                                  np.stack(want["H_agg"]))
    np.testing.assert_array_equal(np.stack(got["active"]),
                                  np.stack(want["active"]))
    assert got["processed_counts"] == want["processed_counts"]
    assert got["sim_before"] == want["sim_before"]
    assert got["sim_after"] == want["sim_after"]
    np.testing.assert_allclose(np.stack(got["device_loss"]),
                               np.stack(want["device_loss"]),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"], atol=1e-2)


@pytest.fixture(scope="module", params=["mlp", "cnn", "linear"])
def model_runs(request):
    model = request.param
    return model, _run_ref(model)


@pytest.mark.parametrize("engine", ["scan", "legacy"])
def test_engine_matches_reference_scan(model_runs, engine):
    model, want = model_runs
    got = _run_port(model, engine)
    assert len(got["device_loss"]) == T
    assert got["device_loss"][0].shape == (N,)
    assert_histories_match(got, want)


def test_per_round_gather_equals_prestaged(monkeypatch):
    """Gathering pixels per round (above PRESTAGE_LIMIT_BYTES) changes
    no number: the two staging modes give bitwise-equal histories."""
    pre = _run_port("mlp", "scan")
    monkeypatch.setattr(teng, "PRESTAGE_LIMIT_BYTES", 0)
    per_round = _run_port("mlp", "scan")
    for k in ("device_loss", "H_agg"):
        np.testing.assert_array_equal(np.stack(per_round[k]),
                                      np.stack(pre[k]))
    assert per_round["test_loss"] == pre["test_loss"]
    assert per_round["test_acc"] == pre["test_acc"]


def test_unported_engines_raise():
    """Every reference engine is ported; an unknown name raises."""
    with pytest.raises(ValueError, match="unknown engine"):
        _run_port("linear", "nope")
