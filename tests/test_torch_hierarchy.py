"""The tiered path of the port against the reference
(``repro.core.hierarchy``, ``repro.core.engine.aggregate_tier`` /
``aggregate_edges``, ``run_network_aware(hierarchy=...)`` and the
``--tiers`` CLI), on the same numpy-seeded inputs.

Tolerances: the tier tree, its staging helpers and the traffic counts
are numpy copies and must be equal. ``aggregate_tier`` and
``aggregate_edges`` are within 1e-6 of the reference (float32 sums of
a few terms). Within the port, a group's row of ``aggregate_tier`` is
bitwise ``aggregate_edges`` over its ascending member list: both add
each group's members in ascending order. Histories: ``agg_round``,
``tier_agg_*``, ``H_agg``, ``active`` and ``processed_counts`` exact;
losses within rtol 2e-3, atol 1e-4 and accuracy within 1e-2 (the
reference's own scan-vs-legacy tolerances, for summation order).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import costs as rc
from repro.core import engine as reng
from repro.core import federated as RF
from repro.core import hierarchy as rh
from repro.core import movement as rmv
from repro.core.topology import fully_connected
from repro.data import pipeline as rpl
from repro.data.synthetic import make_image_dataset
from repro.launch import train as rtrain
from repro_torch.core import engine as teng
from repro_torch.core import federated as TF
from repro_torch.core import hierarchy as th
from repro_torch.core import movement as tmv
from repro_torch.data import pipeline as tpl
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax

SPECS = [("8@2,2@4,1@8", 64), ("32@5,4@10,1@20", 1000), ("3@4,1@4", 12),
         ("1@3", 5), ("5@1,5@2,1@6", 10)]


def _trees(spec, n):
    return th.TierTree.from_spec(spec, n), rh.TierTree.from_spec(spec, n)


@pytest.mark.parametrize("spec,n", SPECS)
def test_tier_tree_equals_reference(spec, n):
    got, want = _trees(spec, n)
    assert (got.n, got.taus, got.levels) == (want.n, want.taus, want.levels)
    assert got.group_counts == want.group_counts
    assert got.widest_bucket == want.widest_bucket
    for a, b in zip(got.parents, want.parents):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.ancestors(), want.ancestors()):
        np.testing.assert_array_equal(a, b)
    for T in (1, 7, 40):
        np.testing.assert_array_equal(got.level_rounds(T),
                                      want.level_rounds(T))
    assert got.fingerprint() == want.fingerprint()
    bal = th.TierTree.balanced(n, got.group_counts, got.taus)
    assert bal.fingerprint() == got.fingerprint()


def _bad_trees(mod):
    return [
        lambda: mod.TierTree.balanced(16, (4, 1), (2, 3)),
        lambda: mod.TierTree.from_spec("4@2,2@4", 16),
        lambda: mod.TierTree(n=8, taus=(2, 4),
                             parents=(np.zeros(7, np.int64),
                                      np.zeros(1, np.int64))),
        lambda: mod.TierTree(n=8, taus=(2, 4),
                             parents=(np.array([0, 0, 2, 2, 3, 3, 3, 3]),
                                      np.zeros(4, np.int64))),
        lambda: mod.TierTree.from_spec("definitely-not-a-spec", 8),
        lambda: mod.TierTree.from_spec("", 8),
        lambda: mod.TierTree(n=0, taus=(1,), parents=(np.zeros(0),)),
        lambda: mod.TierTree(n=4, taus=(0,), parents=(np.zeros(4),)),
        lambda: mod.TierTree(n=4, taus=(2, 4), parents=(np.zeros(4),)),
        lambda: mod.TierTree(n=4, taus=(2,),
                             parents=(np.array([0, 0, -1, 0]),)),
        lambda: mod.TierTree(n=4, taus=(2,),
                             parents=(np.array([0, 0, 1, 1]),)),
    ]


@pytest.mark.parametrize("i", range(11))
def test_tier_tree_validation_errors_equal_reference(i):
    with pytest.raises(ValueError) as want:
        _bad_trees(rh)[i]()
    with pytest.raises(ValueError) as got:
        _bad_trees(th)[i]()
    assert str(got.value) == str(want.value)


def test_intra_tier_edges_and_traffic_equal_reference():
    rng = np.random.default_rng(0)
    for spec, n in SPECS:
        got, want = _trees(spec, n)
        src, dst = rng.integers(0, n, 200), rng.integers(0, n, 200)
        np.testing.assert_array_equal(th.intra_tier_edges(got, src, dst),
                                      rh.intra_tier_edges(want, src, dst))
        for P, B in ((7850, 4), (159010, 2)):
            assert th.tier_traffic(got, P, bytes_per_param=B) == \
                rh.tier_traffic(want, P, bytes_per_param=B)


def _stack_params(m, rng):
    return {"w": rng.standard_normal((m, 4, 3)).astype(np.float32),
            "b": rng.standard_normal((m, 2)).astype(np.float32)}


def _t(W):
    return {k: torch.from_numpy(v) for k, v in W.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_tier_and_edges_match_reference(seed):
    rng = np.random.default_rng(seed)
    m, G = 11, 4
    W = _stack_params(m, rng)
    H = rng.integers(0, 6, m).astype(np.float32)
    gids = rng.integers(0, G, m)
    gids[:G] = np.arange(G)                  # every group named
    got, got_Hg = teng.aggregate_tier(_t(W), torch.from_numpy(H), gids, G)
    want, want_Hg = reng.aggregate_tier(W, H, gids, G)
    np.testing.assert_array_equal(got_Hg.numpy(), np.asarray(want_Hg))
    for k in W:
        assert got[k].shape == (G,) + W[k].shape[1:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    members = np.array([9, 2, 5, 0])
    prev = {k: v[0] for k, v in W.items()}
    for prev_g in (None, prev):
        got = teng.aggregate_edges(_t(W), torch.from_numpy(H), members,
                                   None if prev_g is None else _t(prev_g))
        want = reng.aggregate_edges(W, H, members, prev_g)
        for k in W:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6)


def test_aggregate_tier_row_is_aggregate_edges_bitwise():
    rng = np.random.default_rng(0)
    m = 9
    W = _t(_stack_params(m, rng))
    H = torch.from_numpy(rng.integers(0, 6, m).astype(np.float32))
    gids = np.array([0, 2, 0, 1, 1, 2, 0, 2, 2])
    Wg, Hg = teng.aggregate_tier(W, H, gids, 3)
    for g in range(3):
        members = np.nonzero(gids == g)[0]
        ref = teng.aggregate_edges(W, H, members, None)
        for k in W:
            assert torch.equal(Wg[k][g], ref[k])
        assert float(Hg[g]) == float(H[members].sum())


def test_aggregate_tier_zero_weight_group_yields_zeros():
    rng = np.random.default_rng(1)
    W = _t(_stack_params(4, rng))
    H = torch.tensor([0.0, 0.0, 3.0, 2.0])
    Wg, Hg = teng.aggregate_tier(W, H, np.array([0, 0, 1, 1]), 2)
    assert float(Hg[0]) == 0.0
    for k in W:
        assert not Wg[k][0].any()
        assert Wg[k][1].any()


def test_two_stage_composition_is_manual_aggregate_edges():
    """A 2-tier top model equals aggregate_edges per gateway, stacked,
    then aggregate_edges over the gateways with their H totals, bit for
    bit; the total weight telescopes to H.sum()."""
    rng = np.random.default_rng(2)
    m = 8
    W = _t(_stack_params(m, rng))
    H = torch.from_numpy(rng.integers(1, 5, m).astype(np.float32))
    g0 = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    W1, H1 = teng.aggregate_tier(W, H, g0, 2)
    Wt, Ht = teng.aggregate_tier(W1, H1, np.zeros(2, np.int64), 1)
    stacked = {k: torch.stack([
        teng.aggregate_edges(W, H, np.nonzero(g0 == g)[0], None)[k]
        for g in range(2)]) for k in W}
    ref = teng.aggregate_edges(stacked, H1, np.array([0, 1]), None)
    for k in W:
        assert torch.equal(Wt[k][0], ref[k])
    assert float(Ht[0]) == float(H.sum())


def test_tier_segments_are_built_once_per_tree():
    """One m-length member→group map per tier, shared by H_g and every
    leaf whatever its width: nothing of length m·P is built."""
    tree = th.TierTree.from_spec("2@2,1@4", 4)
    segs = teng.tier_segments(tree, torch.device("cpu"))
    assert teng.tier_segments(tree, torch.device("cpu")) is segs
    ids, layout = segs[0].groups()
    assert layout is None                     # no kernel layout on the CPU
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), tree.parents[0])
    assert segs[0].groups()[0] is ids
    assert [s.group_ids.shape[0] for s in segs] == [4, 2]
    assert all(t.numel() <= 4 for s in segs for t in vars(s).values()
               if isinstance(t, torch.Tensor))


N, T = 8, 8
DATA = make_image_dataset(n_train=600, n_test=200, seed=0)


def _run(model, spec, tau, port, **kw):
    rng = np.random.default_rng(0)
    traces = rc.testbed_like_costs(N, T, rng)
    adj = fully_connected(N)
    pl_, mv_, F_, hr_ = ((tpl, tmv, TF, th) if port
                         else (rpl, rmv, RF, rh))
    streams = pl_.poisson_streams(N, T, DATA[1], rng=rng)
    plan = mv_.greedy_linear(traces, adj, backend="numpy")
    cfg = F_.FedConfig(n=N, T=T, tau=tau, eta=0.1, model=model, seed=0)
    tree = hr_.TierTree.from_spec(spec, N) if spec else None
    if port:
        jp, _ = reng.make_model(model, jax.random.PRNGKey(0))
        kw["params"] = params_from_jax({k: np.asarray(v)
                                        for k, v in jp.items()})
        kw["device"] = "cpu"
    return F_.run_network_aware(cfg, DATA, traces, adj, plan,
                                streams=streams, hierarchy=tree, **kw)


def _assert_tiered_match(got, want):
    for k in ("agg_round", "tier_agg_round", "tier_agg_level", "round",
              "processed_counts", "hierarchy"):
        assert got[k] == want[k], k
    for k in ("H_agg", "active"):
        np.testing.assert_array_equal(np.stack(got[k]), np.stack(want[k]))
    np.testing.assert_allclose(np.stack(got["device_loss"]),
                               np.stack(want["device_loss"]),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"], atol=1e-2)


@pytest.mark.parametrize("model,spec,tau", [
    ("mlp", "4@2,2@4,1@8", 2), ("cnn", "2@4,1@8", 4),
    ("linear", "3@2,1@4", 2), ("mlp", "2@4,1@4", 4)])
def test_tiered_history_matches_reference(model, spec, tau):
    want = _run(model, spec, tau, port=False)
    got = _run(model, spec, tau, port=True)
    assert len(got["test_acc"]) == len(got["agg_round"]) > 0
    _assert_tiered_match(got, want)


def test_l1_tree_is_the_flat_scan_bitwise():
    flat = _run("mlp", None, 4, port=True)
    l1 = _run("mlp", "1@4", 4, port=True)
    assert l1["hierarchy"]["levels"] == 1
    assert l1["agg_round"] == flat["agg_round"]
    assert l1["test_loss"] == flat["test_loss"]
    assert l1["test_acc"] == flat["test_acc"]
    for k in ("device_loss", "H_agg"):
        np.testing.assert_array_equal(np.stack(l1[k]), np.stack(flat[k]))


def test_hierarchy_wiring_errors():
    tree = th.TierTree.from_spec("2@2,1@4", N)
    with pytest.raises(ValueError, match="engine"):
        _run("linear", "2@2,1@4", 2, port=True, engine="legacy")
    with pytest.raises(ValueError, match="hierarchy"):
        _run("linear", None, 2, port=True, engine="hierarchical")
    with pytest.raises(ValueError, match="tau"):
        _run("linear", "2@4,1@8", 2, port=True)
    with pytest.raises(ValueError, match="n="):
        th_bad = th.TierTree.from_spec("2@2,1@4", N - 2)
        TF.run_network_aware(TF.FedConfig(n=N, T=T, tau=2), DATA, None,
                             None, None, hierarchy=th_bad, device="cpu")
    with pytest.raises(ValueError, match="tau"):
        teng.run_rounds_hierarchical(None, {}, *DATA, [[]], None, 4, 0.1,
                                     1, tree=tree, device="cpu")


ARGS = ["--mode", "fog", "--model", "mlp", "--n", "8", "--T", "8",
        "--tau", "2", "--n-train", "300", "--n-test", "60"]


def test_cli_tiers_matches_reference_cli(capsys):
    flags = ARGS + ["--tiers", "4@2,2@4,1@8"]
    want = rtrain.main(flags)
    got = ttrain.main(flags + ["--device", "cpu"])
    capsys.readouterr()
    assert got["cost"] == want["cost"]
    assert got["hierarchy"] == want["hierarchy"] == {
        "levels": 3, "group_counts": [4, 2, 1], "taus": [2, 4, 8]}
    assert got["engine"] == want["engine"] == "hierarchical"
    assert len(got["acc_curve"]) == len(want["acc_curve"]) == 1
    assert got["history"]["tier_agg_level"] == [1, 2, 1, 3]


@pytest.mark.parametrize("flags,match", [
    (["--tiers", "4@4,1@8"], "must equal --tau"),
    (["--tiers", "4@2,1@4", "--checkpoint", "x"], "scan-engine feature"),
    (["--tiers", "4@2,2@4"], "root"),
])
def test_cli_tiers_errors(flags, match):
    with pytest.raises((SystemExit, ValueError), match=match):
        ttrain.main(ARGS + ["--device", "cpu"] + flags)


def test_breakdown_takes_tiers():
    from repro_torch.launch import breakdown

    res = breakdown.run(ARGS + ["--device", "cpu", "--reps", "1",
                                "--tiers", "4@2,1@4"])
    assert res["tiers"] == "4@2,1@4"
    assert res["train_cold_s"] > 0 and len(res["train_warm_s"]) == 1
