"""Network dynamics through the port against the reference: the
prediction plane (``estimator``), plan realization, the Theorem-3 plan
on churn, flap and predicted schedules, and the training CLI under
``--schedule churn|flap`` and ``--replan``.

* The estimator functions and ``realize_plan`` are numpy copies: held
  bitwise.
* ``greedy_linear``'s numpy backend equals the reference's numpy
  backend; the port's device path on the CPU (the kernel's plain
  version) equals the reference's ``jnp`` backend.
* The CLI's ``cost``, ``schedule``, ``replan`` and ``n_events`` equal
  the reference CLI's; the histories are held by
  ``test_torch_engine.assert_histories_match``, the port trained from
  the reference's initial weights.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.core import costs as rc
from repro.core import engine as reng
from repro.core import estimator as rest
from repro.core import federated as RF
from repro.core import movement as rmv
from repro.core import schedule as rs
from repro.core import topology as rt
from repro.launch import train as rtrain
from repro_torch.core import costs as tc
from repro_torch.core import estimator as pest
from repro_torch.core import federated as TF
from repro_torch.core import movement as tmv
from repro_torch.core import schedule as ts
from repro_torch.core import topology as tt
from repro_torch.device import resolve_device
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax
from test_torch_engine import assert_histories_match

N, T = 10, 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small training steps run on one thread: under the test
    workers' load, intra-op threads only wait for each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same_plan(got, want):
    e, f = got.edges, want.edges
    for a in ("t", "src", "dst", "qty"):
        np.testing.assert_array_equal(getattr(e, a), getattr(f, a))
    np.testing.assert_array_equal(got.r, want.r)


def _schedules(kind, seed, n=N):
    """(reference, port) true schedules of one kind, same draws."""
    out = []
    for topo, sched in ((rt, rs), (tt, ts)):
        rng = np.random.default_rng(seed)
        adj = topo.random_graph(n, 0.5, rng)
        if kind == "churn":
            out.append(topo.churn_schedule(adj, T, 0.15, 0.2, rng, tau=5))
        elif kind == "flap":
            out.append(topo.link_flap_schedule(adj, T, rng, p_down=0.2,
                                               p_up=0.4))
        elif kind == "edgelist":
            out.append(topo.churn_schedule(adj, T, 0.15, 0.2, rng)
                       .to_edgelist())
        elif kind == "static":
            out.append(sched.NetworkSchedule.constant(adj, T))
    return out


KINDS = ["churn", "flap", "edgelist", "static"]


@pytest.mark.parametrize("L", [1, 3, 5, 20])
@pytest.mark.parametrize("kind", KINDS)
def test_window_rates_bitwise(kind, L):
    want, got = _schedules(kind, 1)
    np.testing.assert_array_equal(pest.window_activity_rates(got, L),
                                  rest.window_activity_rates(want, L))
    for a, b in zip(pest.window_link_rates_edges(got, L),
                    rest.window_link_rates_edges(want, L)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pest.window_link_rates(got, L),
                                  rest.window_link_rates(want, L))


def test_window_link_rates_dense_guard(monkeypatch):
    _, got = _schedules("churn", 0)
    monkeypatch.setattr(ts, "DENSE_VIEW_MAX_N", 4)
    with pytest.raises(RuntimeError, match="window_link_rates_edges"):
        pest.window_link_rates(got)


@pytest.mark.parametrize("mode", ["threshold", "expected"])
@pytest.mark.parametrize("kind", KINDS)
def test_predict_schedule_bitwise(kind, mode):
    from test_torch_schedule import assert_schedules_equal

    want, got = _schedules(kind, 2)
    pw = rest.predict_schedule(want, mode=mode)
    pg = pest.predict_schedule(got, mode=mode)
    assert_schedules_equal(pg, pw)
    assert pg.storage == ("edgelist" if kind == "edgelist" else
                          pw.storage)
    assert pest.schedule_prediction_accuracy(pg, got) == \
        rest.schedule_prediction_accuracy(pw, want)
    with pytest.raises(ValueError, match="prediction mode"):
        pest.predict_schedule(got, mode="oracle")


@pytest.mark.parametrize("kind", ["churn", "flap"])
def test_expected_cost_traces_bitwise(kind):
    want, got = _schedules(kind, 3)
    tr_r = rc.synthetic_costs(N, T, np.random.default_rng(3))
    tr_t = tc.synthetic_costs(N, T, np.random.default_rng(3))
    a = pest.expected_cost_traces(tr_t, got, floor=0.2)
    b = rest.expected_cost_traces(tr_r, want, floor=0.2)
    for f in ("c_node", "c_link", "f_err", "cap_node", "cap_link"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # edge cost traces (once refused, ROADMAP queue 1 item 7) on the
    # edge-list replay of the same schedule
    indptr, dst = want.to_edgelist().union_csr()
    src = np.repeat(np.arange(N), np.diff(indptr))
    ea, eb = (m.expected_cost_traces(
        m_c.edge_costs_from_dense(tr, src, dst), s.to_edgelist(),
        floor=0.2)
        for m, m_c, tr, s in ((pest, tc, tr_t, got),
                              (rest, rc, tr_r, want)))
    assert isinstance(ea, tc.EdgeCostTraces) and src.size
    for f in ("c_node", "c_link", "f_err", "cap_node", "cap_link",
              "indptr", "indices"):
        np.testing.assert_array_equal(getattr(ea, f), getattr(eb, f))


@pytest.mark.parametrize("kind", ["churn", "flap", "static"])
@pytest.mark.parametrize("seed", [0, 1])
def test_realize_plan_bitwise(kind, seed):
    """Plans made on the base graph (and a fractional one) realized
    against the true schedule: both loss channels charged to r."""
    want, got = _schedules(kind, seed)
    tr = rc.synthetic_costs(N, T, np.random.default_rng(seed))
    adj = np.array(want.adj_view()[0])         # the base graph
    frac = np.random.default_rng(seed).random((T, N, N)) * adj
    frac /= frac.sum(2, keepdims=True) + 1.0
    r = 1.0 - frac.sum(2)
    for pr, pt in ((rmv.greedy_linear(tr, adj, backend="numpy"),
                    tmv.greedy_linear(tr, adj, backend="numpy")),
                   (rmv.MovementPlan(s=frac, r=r),
                    tmv.MovementPlan(s=frac, r=r))):
        _same_plan(pt, pr)
        got_p = tmv.realize_plan(pt, got)
        _same_plan(got_p, rmv.realize_plan(pr, want))
        if kind == "static":
            assert tmv.plans_equal(got_p, pt)
        else:
            assert got_p.r.sum() >= pt.r.sum()
        got_p.check(got)


@pytest.mark.parametrize("kind", ["churn", "flap", "predicted_churn",
                                  "predicted_flap", "edgelist"])
def test_greedy_linear_on_dynamic_schedules(kind):
    base = kind.split("_")[-1]
    want, got = _schedules(base, 4)
    if kind.startswith("predicted"):
        want, got = rest.predict_schedule(want), pest.predict_schedule(got)
    tr = rc.synthetic_costs(N, T, np.random.default_rng(4))
    plan = tmv.greedy_linear(tr, got, backend="numpy")
    _same_plan(plan, rmv.greedy_linear(tr, want, backend="numpy"))
    if kind in ("churn", "flap"):
        # the oracle plan passes its own schedule unchanged
        assert tmv.plans_equal(tmv.realize_plan(plan, got), plan)
    if kind != "edgelist":
        _same_plan(tmv.greedy_linear(tr, got, backend="cuda",
                                     device="cpu"),
                   rmv.greedy_linear(tr, want, backend="jnp"))


def test_device_inputs_copy_each_round():
    """The kernel's adjacency operand holds every round, not the last
    round ``adj_at`` left in its reused buffer."""
    _, got = _schedules("churn", 5)
    tr = tc.synthetic_costs(N, T, np.random.default_rng(5))
    adj = tmv.device_inputs(tr, got, "cpu")[4].numpy()
    act = got.activity()
    for t in range(T - 1):
        np.testing.assert_array_equal(adj[t], got.adj_view()[t]
                                      & act[t + 1][None, :])
    assert not adj[T - 1].any()


ARGS = ["--mode", "fog", "--model", "mlp", "--n", "6", "--T", "10",
        "--tau", "5", "--n-train", "2000", "--n-test", "500"]


def _recording(module, sink, **extra):
    run = module.run_network_aware

    def wrapped(*a, **kw):
        sink.append(run(*a, **kw, **extra))
        return sink[-1]
    return wrapped


@pytest.mark.parametrize("flags", [
    ["--churn", "0.1"], ["--schedule", "churn"], ["--schedule", "flap"],
    ["--setting", "C", "--churn", "0.1"],
    ["--churn", "0.1", "--replan", "predict"],
    ["--churn", "0.1", "--replan", "once"], ["--churn", "0.1",
                                             "--plan-once"],
    ["--schedule", "flap", "--replan", "predict"],
    ["--schedule", "flap", "--p-flap", "0.3", "--plan-once"],
    ["--p-exit", "0.2", "--p-entry", "0.1"],
    ["--schedule", "churn", "--p-exit", "0.3", "--p-entry", "0.2",
     "--replan", "predict", "--setting", "D"],
    ["--tiers", "3@5,1@10", "--churn", "0.1"],
])
def test_cli_dynamics_match_reference_cli(flags, monkeypatch):
    ref_h, port_h = [], []
    monkeypatch.setattr(RF, "run_network_aware", _recording(RF, ref_h))
    jp, _ = reng.make_model("mlp", jax.random.PRNGKey(0))
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    monkeypatch.setattr(TF, "run_network_aware",
                        _recording(TF, port_h, params=params))
    with contextlib.redirect_stdout(io.StringIO()):
        want = rtrain.main(ARGS + flags)
        got = ttrain.main(ARGS + flags + ["--device", "cpu"])
    for k in ("cost", "schedule", "replan", "n_events", "engine",
              "sim_before", "sim_after", "hierarchy"):
        assert got.get(k) == want.get(k), k
    assert_histories_match(port_h[0], ref_h[0])
    assert got["history"] is port_h[0]


@pytest.mark.parametrize("flags,match", [
    (["--schedule", "flap", "--p-exit", "0.1"], "does not model node churn"),
    (["--plan-once", "--replan", "predict"], "--plan-once conflicts"),
])
def test_cli_refusals_match_reference(flags, match):
    with pytest.raises(SystemExit, match=match) as ref, \
            contextlib.redirect_stdout(io.StringIO()):
        rtrain.main(ARGS + flags)
    with pytest.raises(SystemExit, match=match) as port:
        ttrain.main(ARGS + flags + ["--device", "cpu"])
    assert str(port.value) == str(ref.value)


def test_breakdown_runs_a_dynamic_plan():
    from repro_torch.launch import breakdown

    res = breakdown.run(ARGS + ["--device", "cpu", "--reps", "1",
                                "--churn", "0.2", "--replan", "predict"])
    assert res["train_cold_s"] > 0 and len(res["train_warm_s"]) == 1


def test_churn_activity_and_baselines_match_reference():
    cfg_r = RF.FedConfig(n=N, T=T, tau=5, p_exit=0.2, p_entry=0.1)
    cfg_t = TF.FedConfig(n=N, T=T, tau=5, p_exit=0.2, p_entry=0.1)
    rr, rg = np.random.default_rng(6), np.random.default_rng(6)
    np.testing.assert_array_equal(TF.churn_activity(cfg_t, rg),
                                  RF.churn_activity(cfg_r, rr))
    assert rr.random() == rg.random()


def test_resolved_devices_keep_convolutions_off_cudnn():
    """cuDNN picks a convolution's engine by the workspace it can get, so
    the card's CNN arithmetic would follow its free memory, and the flap
    and churn runs carry that difference to 1e-2 in 20 rounds. Every
    resolved device turns cuDNN and TF32 off."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        resolve_device("cpu")
        assert not torch.backends.cudnn.enabled
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
