"""The port's flat sample streams (``data/pipeline.FlatStreams``) and the
engines on them, against the reference on the same numpy-seeded
inputs.

Tolerances: the flat pipeline is numpy with the reference's rng use, so
streams, routing and the staged ``idx``, ``yb``, ``w`` and ``counts``
are equal bit for bit; ``counts_flat`` (float32 sums of ones through
the segment sum's plain version) equals the reference's ``jax.ops``
path exactly. Within the port on the CPU, a flat-stream run equals the
run on the same streams as per-cell lists bit for bit (``test_loss``,
``test_acc``), as the reference's own test holds it. Against the
reference, from the reference's initial weights: ``agg_round``,
``H_agg``, ``active``, ``processed_counts`` (and ``tier_agg_*``)
exact; losses within rtol 2e-3, atol 1e-4 and accuracy within 1e-2,
the engine tolerances of ``tests/test_torch_hierarchy.py`` (observed
here on the CPU: ``device_loss`` ≤ 1.9e-6, ``test_loss`` ≤ 4.8e-7,
``test_acc`` ≤ 7.5e-9, absolute).
"""
import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import costs as rc
from repro.core import engine as reng
from repro.core import federated as RF
from repro.core import hierarchy as rh
from repro.core import movement as rmv
from repro.core import topology as rt
from repro.data import pipeline as rpl
from repro_torch.core import costs as tc
from repro_torch.core import engine as teng
from repro_torch.core import federated as TF
from repro_torch.core import hierarchy as th
from repro_torch.core import movement as tmv
from repro_torch.core import topology as tt
from repro_torch.data import pipeline as tpl
from repro_torch.models import mnist as mm
from repro_torch.models.convert import params_from_jax

Y = np.random.default_rng(0).integers(0, 10, 500)


def _flat_pair(n, T, seed, mean=2.0):
    return [m.poisson_streams_flat(n, T, Y, rng=np.random.default_rng(seed),
                                   mean_per_round=mean) for m in (rpl, tpl)]


def _flat_equal(got, want):
    assert (got.n, got.T) == (want.n, want.T)
    for f in ("t", "dev", "idx"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def _lists_equal(got, want):
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw)
        for a, b in zip(rg, rw):
            np.testing.assert_array_equal(a, b)


def _plans(n, T, seed, fractional=False):
    """(reference, port) plans: the edge greedy under churn (bang-bang)
    or a random fractional plan."""
    src, dst = rt.random_sparse_edges(n, 3, np.random.default_rng(seed))
    out = []
    for costs, topo, mv in ((rc, rt, rmv), (tc, tt, tmv)):
        if fractional:
            s = np.random.default_rng(seed).random((T, n, n))
            s *= np.random.default_rng(seed + 1).random((T, n, n)) < 0.2
            s /= s.sum(2, keepdims=True) + 0.5
            out.append(mv.MovementPlan(s=s, r=1.0 - s.sum(2)))
            continue
        etr = costs.synthetic_edge_costs(n, T, src, dst,
                                         np.random.default_rng(seed + 1))
        sched = topo.churn_schedule_edges(n, src, dst, T, 0.1, 0.3,
                                          np.random.default_rng(seed + 2))
        out.append(mv.realize_plan(mv.greedy_linear(etr, sched), sched))
    return out


@pytest.mark.parametrize("n,T,seed,mean", [(6, 4, 0, 1.0), (50, 9, 1, 2.0),
                                           (300, 5, 2, 0.5)])
def test_flat_streams_and_converters_bitwise(n, T, seed, mean):
    want, got = _flat_pair(n, T, seed, mean)
    _flat_equal(got, want)
    np.testing.assert_array_equal(got.cell_key(), want.cell_key())
    lists_w, lists_g = rpl.streams_from_flat(want), tpl.streams_from_flat(got)
    _lists_equal(lists_g.collected, lists_w.collected)
    _flat_equal(tpl.flat_from_streams(lists_g), rpl.flat_from_streams(lists_w))
    # collected per-cell lists, flattened
    fog_w = rpl.poisson_streams(n, T, Y, rng=np.random.default_rng(seed))
    fog_g = tpl.poisson_streams(n, T, Y, rng=np.random.default_rng(seed))
    _flat_equal(tpl.flat_from_streams(fog_g), rpl.flat_from_streams(fog_w))


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_movement_flat_and_dense_bitwise(fractional, seed):
    n, T = 20, 8
    want, got = _flat_pair(n, T, seed)
    plan_r, plan_t = _plans(n, T, seed, fractional)
    routed_w = rpl.apply_movement_flat(want, plan_r,
                                       np.random.default_rng(seed + 9))
    routed_g = tpl.apply_movement_flat(got, plan_t,
                                       np.random.default_rng(seed + 9))
    _flat_equal(routed_g, routed_w)
    lists = tpl.streams_from_flat(got)
    lists_r = rpl.streams_from_flat(want)
    _lists_equal(tpl.apply_movement_dense(lists, plan_t,
                                          np.random.default_rng(3)),
                 rpl.apply_movement_dense(lists_r, plan_r,
                                          np.random.default_rng(3)))
    # the edge routing is the dense oracle's, and the flat routing of a
    # bang-bang plan has its cell membership
    dense = tpl.apply_movement_dense(lists, plan_t, np.random.default_rng(3))
    _lists_equal(tpl.apply_movement(lists, plan_t, np.random.default_rng(3)),
                 dense)
    if not fractional:
        cells = tpl.streams_from_flat(routed_g).collected
        for row_f, row_d in zip(cells, dense):
            for a, b in zip(row_f, row_d):
                np.testing.assert_array_equal(np.sort(a), np.sort(b))


@pytest.mark.parametrize("requested", [0, 2, 40])
def test_pad_size_and_stage_rounds_flat_bitwise(requested):
    n, T = 30, 7
    want, got = _flat_pair(n, T, 4, mean=3.0)
    largest = tpl.pad_size(got)
    with _maybe_warn(requested == 2):      # below the largest cell
        P = tpl.pad_size(got, requested)
    with _maybe_warn(requested == 2):
        assert P == rpl.pad_size(want, requested) == max(largest, requested)
    for P_ in (P, largest - 2):            # fitting and truncating
        with _maybe_warn(P_ < largest):
            staged_g = tpl.stage_rounds(got, Y, P_)
        with _maybe_warn(P_ < largest):
            staged_w = rpl.stage_rounds(want, Y, P_)
        for a, b in zip(staged_g, staged_w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        # the flat staging equals the per-cell loop on the same cells
        with _maybe_warn(P_ < largest):
            loop = tpl.stage_rounds(tpl.streams_from_flat(got).collected, Y,
                                    P_)
        for a, b in zip(staged_g, loop):
            np.testing.assert_array_equal(a, b)


def _maybe_warn(on):
    return pytest.warns(UserWarning) if on else contextlib.nullcontext()


@pytest.mark.parametrize("n,T,mean", [(1, 1, 3.0), (40, 6, 2.0),
                                      (4096, 3, 1.0)])
def test_counts_flat_equals_reference(n, T, mean):
    want, got = _flat_pair(n, T, 5, mean)
    c = tpl.counts_flat(got, "cpu")
    assert c.dtype == np.float64 and c.shape == (T, n)
    np.testing.assert_array_equal(c, rpl.counts_flat(want))
    np.testing.assert_array_equal(tpl.counts(got, "cpu"), rpl.counts(want))
    empty = tpl.FlatStreams(t=np.zeros(0, np.int64), dev=np.zeros(0, np.int64),
                            idx=np.zeros(0, np.int64), n=n, T=T)
    np.testing.assert_array_equal(tpl.counts_flat(empty, "cpu"),
                                  np.zeros((T, n)))


N, T, TAU = 12, 8, 2


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    return (rng.random((300, 28, 28)).astype(np.float32),
            rng.integers(0, 10, 300),
            rng.random((60, 28, 28)).astype(np.float32),
            rng.integers(0, 10, 60))


def _problem(port, data, seed=0):
    costs, topo, mv, pl_ = ((tc, tt, tmv, tpl) if port
                            else (rc, rt, rmv, rpl))
    src, dst = rt.random_sparse_edges(N, 4, np.random.default_rng(seed))
    sched = topo.churn_schedule_edges(N, src, dst, T, 0.1, 0.3,
                                      np.random.default_rng(seed + 2))
    etr = costs.synthetic_edge_costs(N, T, src, dst,
                                     np.random.default_rng(seed + 1))
    plan = mv.realize_plan(mv.greedy_linear(etr, sched), sched)
    flat = pl_.poisson_streams_flat(N, T, data[1],
                                    rng=np.random.default_rng(seed + 3),
                                    mean_per_round=2.0)
    return etr, sched, plan, flat


def _run(port, model, data, spec=None, lists=False, **kw):
    etr, sched, plan, flat = _problem(port, data)
    F_, hr_, pl_ = (TF, th, tpl) if port else (RF, rh, rpl)
    streams = pl_.streams_from_flat(flat) if lists else flat
    cfg = F_.FedConfig(n=N, T=T, tau=TAU, eta=0.1, model=model, seed=0)
    tree = hr_.TierTree.from_spec(spec, N) if spec else None
    if port:
        jp, _ = reng.make_model(model, jax.random.PRNGKey(0))
        kw["params"] = params_from_jax({k: np.asarray(v)
                                        for k, v in jp.items()})
        kw["device"] = "cpu"
    return F_.run_network_aware(cfg, data, etr, None, plan, streams=streams,
                                schedule=sched, hierarchy=tree, **kw)


@pytest.mark.parametrize("spec", [None, "3@2,1@4"])
def test_flat_streams_equal_lists_in_the_port(data, spec):
    """On the same routed cells the engines give the same history from
    a FlatStreams as from its per-cell lists, bit for bit. Through
    ``run_network_aware`` the two routings put a cell's samples in
    different orders (collection order against a permutation), so the
    losses differ in the last bits there, in the reference as in the
    port (2.4e-7 in ``test_loss`` on these inputs, both packages),
    while the counts, H and rounds are equal."""
    etr, sched, plan, flat = _problem(True, data)
    cfg = TF.FedConfig(n=N, T=T, tau=TAU, eta=0.1, model="mlp", seed=0)
    _, routed, act, P = TF._prepare_streams(cfg, data, plan, flat, None,
                                            sched)
    jp, apply_fn = reng.make_model("mlp", jax.random.PRNGKey(0))
    params = {k: torch.from_numpy(np.asarray(v)) for k, v in
              params_from_jax({k: np.asarray(v) for k, v in jp.items()})
              .items()}
    tree = th.TierTree.from_spec(spec, N) if spec else None
    runner = (teng.run_rounds_scan if tree is None else
              functools.partial(teng.run_rounds_hierarchical, tree=tree))
    hists = [runner(mm.mlp_apply, params, *data, processed, act, TAU, 0.1,
                    P, device="cpu")
             for processed in (routed, tpl.streams_from_flat(routed)
                               .collected)]
    for k in hists[1]:
        assert np.array_equal(np.asarray(hists[0][k]),
                              np.asarray(hists[1][k])), k
    via_flat = _run(True, "mlp", data, spec)
    via_lists = _run(True, "mlp", data, spec, lists=True)
    assert via_flat["sim_before"] is None
    assert via_lists["sim_before"] is not None
    for k in ("agg_round", "round"):
        assert via_flat[k] == via_lists[k], k
    for k in ("H_agg", "active", "processed_counts"):
        np.testing.assert_array_equal(np.stack(via_flat[k]),
                                      np.stack(via_lists[k]))
    np.testing.assert_allclose(via_flat["test_loss"], via_lists["test_loss"],
                               rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("model,spec", [("mlp", None), ("linear", None),
                                        ("mlp", "3@2,1@4"),
                                        ("linear", "4@2,2@4,1@8")])
def test_flat_stream_engines_match_reference(data, model, spec):
    want = _run(False, model, data, spec)
    got = _run(True, model, data, spec)
    keys = ["agg_round", "round", "sim_before", "sim_after"]
    if spec:
        keys += ["tier_agg_round", "tier_agg_level", "hierarchy"]
    for k in keys:
        assert got[k] == want[k], k
    for k in ("H_agg", "active", "processed_counts"):
        np.testing.assert_array_equal(np.stack(got[k]), np.stack(want[k]))
    np.testing.assert_allclose(np.stack(got["device_loss"]),
                               np.stack(want["device_loss"]),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"], atol=1e-2)


def test_flat_streams_refused_by_the_legacy_engine(data):
    for F_, pl_, costs in ((RF, rpl, rc), (TF, tpl, tc)):
        flat = pl_.poisson_streams_flat(6, 4, data[1],
                                        rng=np.random.default_rng(0))
        cfg = F_.FedConfig(n=6, T=4, tau=2, eta=0.05, model="mlp", seed=0)
        kw = {"device": "cpu"} if F_ is TF else {}
        with pytest.raises(ValueError, match="scan-engine feature") as e:
            F_.run_network_aware(
                cfg, data, costs.synthetic_costs(6, 4,
                                                 np.random.default_rng(1)),
                rt.fully_connected(6), rmv.no_movement_plan(4, 6)
                if F_ is RF else tmv.no_movement_plan(4, 6),
                streams=flat, engine="legacy", **kw)
        assert "engine='legacy'" in str(e.value)
