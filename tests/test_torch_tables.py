"""Paper Tables III and IV through the port (``repro_torch.launch.
tables``) against the reference's harness (``benchmarks.fog``) run on
this tree, and the port's training CLI on settings C/D/E.

* Rows planned by the Theorem-3 rule (every Table III row, Table IV's
  ``discard`` rows) are numpy on both sides: held bitwise.
* Convex rows are held within rtol 1e-4 on every cost field, the port
  started from the reference's own ``z0``; Table IV's ``neg_G/D`` row,
  where the descent is chaotic in the reference itself
  (``tests/test_torch_convex.py``), within twice the spread of the
  reference's own runs from ``z0·(1 + k·1e-7)``.
* Trained rows at a reduced size: exact fields equal, histories within
  the engine tolerances of ``tests/test_torch_engine.py`` (the port
  trains from the reference's initial weights).

The reference is held on this tree, not to ``results/
bench_table3_settings.json``: its row E moved (0.55%) after that JSON
was written.
"""
import contextlib
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import fog as RF
from repro.core import costs as rc
from repro.core import engine as reng
from repro.core import movement as rmv
from repro.core import topology as rt
from repro.data import pipeline as rpl
from repro.launch import train as rtrain
from repro_torch.core import movement as pmv
from repro_torch.launch import tables as TT
from repro_torch.launch import train as ptrain
from repro_torch.models.convert import params_from_jax
from test_torch_engine import assert_histories_match


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The solver's many small ops run on one thread: under the test
    workers' load, intra-op threads only wait for each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _z0(T, n):
    return np.array(0.01 * jax.random.normal(jax.random.PRNGKey(0),
                                             (T, n, n + 1)))


@pytest.mark.parametrize("setting", list("ABCDE"))
def test_table3_rows_bitwise(setting):
    want = RF.fog_experiment(scale=RF.QUICK, setting=setting, train=False)
    got = TT.fog_experiment(scale=TT.QUICK, setting=setting, train=False,
                            device="cpu")
    assert got == want


@pytest.mark.parametrize("em,setting", [("neg_G", "B"), ("sqrt", "B"),
                                        ("sqrt", "D")])
def test_table4_convex_rows_match_reference_at_its_z0(em, setting):
    want = RF.fog_experiment(scale=RF.QUICK, setting=setting,
                             error_model=em, train=False)
    got = TT.fog_experiment(scale=TT.QUICK, setting=setting,
                            error_model=em, train=False, device="cpu",
                            z0=_z0(RF.QUICK.T, 10))
    assert {k: v for k, v in got.items() if k != "cost"} == \
        {k: v for k, v in want.items() if k != "cost"}
    for k, v in want["cost"].items():
        np.testing.assert_allclose(got["cost"][k], v, rtol=1e-4,
                                   err_msg=k)


def _ref_table4_D(em, z0):
    """The reference's setting-D Table IV row, replayed step by step
    (``fog_experiment`` → ``make_plan``) from the convex start ``z0``."""
    rng = np.random.default_rng(0)
    data = RF.dataset(RF.QUICK.n_train, RF.QUICK.n_test)
    T, n = RF.QUICK.T, 10
    tr = rc.testbed_like_costs(n, T, rng, f_err=0.7, medium="wifi")
    adj = rt.make_topology("full", n, rng, rho=1.0,
                           costs=tr.c_node.mean(0))
    D = rpl.counts(rpl.poisson_streams(n, T, data[1], iid=True, rng=rng))
    tr = rc.with_capacity(tr, float(D.mean()))
    s, r = rmv._convex_run(*rmv._convex_inputs(tr, adj, D), z0,
                           error_model=em, gamma=1.0, iters=400, lr=0.05,
                           capacity_penalty=50.0, batched=False)
    plan = rmv.repair_capacities(
        rmv.MovementPlan(s=np.asarray(s, float), r=np.asarray(r, float)),
        tr, adj, D)
    return rmv.plan_cost(plan, tr, D, error_model=em)["total"]


def test_table4_neg_G_D_row_within_reference_spread():
    z0 = _z0(RF.QUICK.T, 10)
    totals = [_ref_table4_D("neg_G", z0 * (1 + k * 1e-7))
              for k in (-2, -1, 0, 1, 2)]
    want = RF.fog_experiment(scale=RF.QUICK, setting="D",
                             error_model="neg_G", train=False)
    assert totals[2] == want["cost"]["total"]     # the replay is exact
    spread = max(totals) - min(totals)
    assert spread > 1e-4 * abs(totals[2])       # the reference misses 1e-4
    got = TT.fog_experiment(scale=TT.QUICK, setting="D",
                            error_model="neg_G", train=False, device="cpu",
                            z0=z0)
    assert abs(got["cost"]["total"] - totals[2]) <= 2 * spread


SMALL_REF = RF.BenchScale(n_train=2000, n_test=500, T=8, tau=4)
SMALL = TT.BenchScale(n_train=2000, n_test=500, T=8, tau=4)


def _recording(module, sink, **extra):
    run = module.run_network_aware

    def wrapped(*a, **kw):
        sink.append(run(*a, **kw, **extra))
        return sink[-1]
    return wrapped


@pytest.mark.parametrize("setting", ["A", "B"])
def test_trained_row_matches_reference(setting, monkeypatch):
    ref_h, port_h = [], []
    monkeypatch.setattr(RF.F, "run_network_aware",
                        _recording(RF.F, ref_h))
    jp, _ = reng.make_model("mlp", jax.random.PRNGKey(0))
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    monkeypatch.setattr(TT.F, "run_network_aware",
                        _recording(TT.F, port_h, params=params))
    want = RF.fog_experiment(scale=SMALL_REF, setting=setting)
    got = TT.fog_experiment(scale=SMALL, setting=setting, device="cpu")
    for k in ("setting", "cost", "n", "rho", "tau", "topology", "iid",
              "sim_before", "sim_after", "avg_active"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["acc_curve"], want["acc_curve"],
                               atol=1e-2)
    assert_histories_match(port_h[0], ref_h[0])


def test_tables_cli_quick(tmp_path, capsys, monkeypatch):
    """The CLI's wiring (the rows' values are held above), at the
    reduced scale in place of ``--quick``'s."""
    monkeypatch.setattr(TT, "QUICK", SMALL)
    out = tmp_path / "tables.json"
    res = TT.main(["--quick", "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    assert json.loads(printed) == json.loads(out.read_text())
    t3, t4 = res["table3"], res["table4"]
    assert sorted(t3["rows"]) == list("ABCDE")
    assert sorted(t4["rows"]) == sorted(f"{em}/{s}" for em in (
        "discard", "neg_G", "sqrt") for s in "BD")
    for k, row in t3["rows"].items():
        assert (row["acc"] is not None) == (k in "AB"), k
    for k, row in t4["rows"].items():
        assert (row["acc"] is not None) == k.endswith("/B"), k
    assert t4["rows"]["discard/D"]["cost"] == t3["rows"]["D"]["cost"]
    assert set(t3["headline"]) == {"unit_cost_reduction_A_to_B",
                                   "claim_geq_40pct", "process_reduction"}
    assert set(t4["headline"]) == {"negG_processes_most",
                                   "negG_total_highest"}


RESULTS = Path(__file__).resolve().parents[1] / "results"


@pytest.mark.parametrize("argv", [["--only", "table9"],
                                  ["--out", str(RESULTS / "x.json")]])
def test_tables_cli_refuses(argv):
    with pytest.raises(SystemExit):
        TT.main(argv + ["--device", "cpu"])


ARGS = ["--mode", "fog", "--model", "linear", "--n", "6", "--T", "8",
        "--tau", "4", "--n-train", "300", "--n-test", "60",
        "--topology", "random", "--rho", "0.6"]


@pytest.mark.parametrize("setting", ["C", "D", "E"])
@pytest.mark.parametrize("em", ["discard", "neg_G", "sqrt"])
def test_train_cli_settings_match_reference_cli(setting, em, monkeypatch):
    """The port's CLI, its convex start set to the reference's: discard
    costs equal, convex costs within rtol 1e-4, and under capacities the
    plan feasible. At this size neg_G under capacities is not chaotic
    in the reference: its totals from z0·(1 + k·1e-7) lie within 1e-5
    relative of each other."""
    monkeypatch.setattr(pmv, "convex_z0", lambda T, n, seeds: torch.stack(
        [torch.from_numpy(_z0(T, n)) for _ in seeds]))
    flags = ["--setting", setting, "--error-model", em]
    with contextlib.redirect_stdout(io.StringIO()):
        want = rtrain.main(ARGS + flags)
        got = ptrain.main(ARGS + flags + ["--device", "cpu"])
    for k in ("mode", "setting", "schedule", "replan", "n_events"):
        assert got[k] == want[k], k
    if setting in "DE":
        got["plan"].check(ptrain.build_problem(
            ptrain.parse_args(ARGS))["schedule"])
    if em == "discard":
        assert got["cost"] == want["cost"]
    else:
        np.testing.assert_allclose(got["cost"]["total"],
                                   want["cost"]["total"], rtol=1e-4)
    assert len(got["acc_curve"]) == 2
