"""The whole slice, both packages side by side: costs → topology →
streams → ``solve_setting("B")`` → ``run_network_aware`` with the same
initial weights, held to the criteria of ``test_torch_engine.py``; and
the port's CLI, whose plan cost must equal the reference CLI's
(``repro.launch.train.run_fog``) exactly."""
import jax
import numpy as np
import pytest

from repro.core import costs as rc
from repro.core import engine as reng
from repro.core import federated as RF
from repro.core import topology as rt
from repro.data import pipeline as rpl
from repro.data import synthetic as rsyn
from repro.launch import train as rtrain
from repro_torch.core import costs as tc
from repro_torch.core import federated as TF
from repro_torch.core import topology as tt
from repro_torch.data import pipeline as tpl
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax
from test_torch_engine import assert_histories_match

N, T, TAU = 6, 8, 4


def _slice(costs, topo, pl, syn, F, solve, setting, **run_kw):
    rng = np.random.default_rng(3)
    data = syn.make_image_dataset(n_train=500, n_test=120, seed=3)
    traces = costs.testbed_like_costs(N, T, rng)
    adj = topo.make_topology("random", N, rng, rho=0.7,
                             costs=traces.c_node.mean(0))
    streams = pl.poisson_streams(N, T, data[1], rng=rng)
    D = pl.counts(streams)
    plan = solve(setting, traces, adj, D)
    cfg = F.FedConfig(n=N, T=T, tau=TAU, eta=0.1, model="mlp", seed=3)
    return F.run_network_aware(cfg, data, traces, adj, plan,
                               streams=streams, **run_kw)


@pytest.mark.parametrize("setting", ["A", "B"])
def test_slice_matches_reference(setting):
    want = _slice(rc, rt, rpl, rsyn, RF, rtrain.solve_setting, setting,
                  engine="scan")
    jp, _ = reng.make_model("mlp", jax.random.PRNGKey(3))
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    got = _slice(tc, tt, tpl, tsyn, TF,
                 lambda *a: ttrain.solve_setting(*a, device="cpu"), setting,
                 params=params, device="cpu")
    assert_histories_match(got, want)


ARGS = ["--mode", "fog", "--model", "linear", "--n", "6", "--T", "8",
        "--tau", "4", "--n-train", "300", "--n-test", "60",
        "--topology", "random", "--rho", "0.6"]


def test_cli_cost_equals_reference_cli(capsys):
    want = rtrain.main(ARGS)
    got = ttrain.main(ARGS + ["--device", "cpu"])
    capsys.readouterr()
    assert got["cost"] == want["cost"]
    for k in ("mode", "setting", "schedule", "replan", "n_events",
              "sim_before", "sim_after"):
        assert got[k] == want[k], k
    assert got["engine"] == "scan"
    assert len(got["acc_curve"]) == len(want["acc_curve"]) == T // TAU
    assert got["history"]["max_points"] == got["pad_size"]


@pytest.mark.parametrize("flags", [
    ["--setting", "E", "--sanitize"],
    ["--error-model", "sqrt", "--engine", "sharded", "--sanitize"],
    ["--faults", "drop", "--engine", "sharded", "--sanitize"],
    ["--tiers", "2@4,1@8", "--faults", "crash", "--engine", "sharded",
     "--sanitize"],
    ["--checkpoint", "x", "--sanitize"],
    ["--resume", "x", "--engine", "sharded", "--sanitize"], ["--sanitize"],
    ["--engine", "batched", "--sanitize"], ["--engine", "sharded",
                                            "--sanitize"],
    ["--tiers", "2@4,1@8", "--sanitize"],
])
def test_cli_unported_flags_name_their_roadmap_item(flags, tmp_path,
                                                    capsys):
    """Every flag is ported: each combination runs sanitized, its
    history bitwise the same flags' run without --sanitize, or raises
    what the reference CLI raises (a resume from a missing file)."""
    flags = [str(tmp_path / f) if f == "x" else f for f in flags]
    try:
        got = ttrain.main(ARGS + ["--device", "cpu"] + flags)
    except Exception as e:
        with pytest.raises(type(e)) as want:
            rtrain.main(ARGS + flags)
        assert str(want.value) == str(e)
        return
    plain = ttrain.main(ARGS + ["--device", "cpu"]
                        + [f for f in flags if f != "--sanitize"])
    capsys.readouterr()
    assert got["sanitize"] == {"transfer_guard": True, "debug_nans": True,
                               "warm_compiles": 0}
    a, b = got["history"], plain["history"]
    assert a["test_acc"] == b["test_acc"]
    assert a["test_loss"] == b["test_loss"]
    np.testing.assert_array_equal(np.stack(a["device_loss"]),
                                  np.stack(b["device_loss"]))
    np.testing.assert_array_equal(np.stack(a["H_agg"]),
                                  np.stack(b["H_agg"]))


def test_breakdown_reports_cold_warm_and_busy_time():
    from repro_torch.launch import breakdown

    _union = breakdown._union_s
    assert _union([(0, 2e6), (1e6, 3e6), (5e6, 6e6)]) == 4.0
    assert _union([]) == 0.0
    res = breakdown.run(ARGS + ["--device", "cpu", "--reps", "1",
                                "--model", "mlp"])
    assert res["device"] == "cpu" and res["device_idle_share"] is None
    assert len(res["train_warm_s"]) == 1
    assert res["train_cold_s"] > 0 and res["profiled_wall_s"] > 0
