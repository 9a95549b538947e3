"""The paper's tables and figures through the port.

    python -m repro_torch.launch.tables --only table3,table4 [--quick] \
        [--device cpu] [--out PATH]

One fog experiment = costs → topology → streams → plan → (training) →
plan cost, as :func:`benchmarks.fog.fog_experiment` runs it for the
reference, on the port and on ``--device`` (``cuda`` by default; the
convex solver and, at n ≥ 256 on a card, the Theorem-3 kernel run
there). ``--only`` takes any of:

* ``table2`` — centralized vs federated vs network-aware accuracy;
* ``table3`` — settings A–E (no movement, perfect information, imperfect
  information, capacities, both);
* ``table4`` — the discard-cost models f·D·r, −f·G and f/√G under
  settings B and D;
* ``table5`` — static vs 1% churn;
* ``fig5`` … ``fig10`` — nodes, connectivity, aggregation period,
  topologies × medium, exit and entry rates;
* ``thm5`` — Theorem 5's closed form against simulated greedy savings;
* ``dynamics`` — churn and flap, replanning on every event against
  planning once, plus the constant-schedule guard;
* ``prediction`` — oracle, predicted and plan-once planners (and
  ``expected`` at the highest rates) on the true schedule, plus the
  static guard;
* ``faults`` — the fault-tolerance study: guarded and unguarded
  aggregation under corrupted uploads, quorum-gated sync under heavy
  upload loss, mixed faults, and the two exactness claims (an empty
  fault schedule under the guard is the clean run bit for bit, and a
  run resumed from a mid-horizon checkpoint is the uninterrupted one);
* ``sparse_scale`` — the O(E) network plane at fog scale: edge-list
  churn planning at n = 1024, 10,240 and 102,400 against the dense
  oracle, then a T = 50 churn run of 102,400 devices on flat streams,
  under a no-(n, n) guard (``--max-n`` caps n);
* ``hier_scale`` — the same 102,400 devices under a 3-tier tree with
  movement kept within gateways, against the flat plane, and the L = 1
  tree bitwise the flat scan;
* ``scenario_batched`` — the sweep engine: the fig5 grid (n ∈ {5, 10,
  20} × 6 seeds) and the dynamics and prediction grids at 4 samples a
  device a round, each bucket dispatched by the cost model
  (:mod:`repro_torch.core.costmodel`) against the forced per-point
  loop, with the in-bucket-equals-alone checks (``--repeat`` warm
  repeats).

The sweeps of figs. 5 and 6, the two dynamics studies and the fault
study build their points as :func:`benchmarks.fog.make_scenario` does
and train them one by one on the scan engine (``run_scenarios(...,
engine="scan")``); ``scenario_batched`` dispatches them. The rows and
headlines are printed as JSON, and written to ``--out`` when given;
nothing is written under ``results/``, which holds the reference's
artifacts.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import tempfile
import time
from pathlib import Path

import numpy as np

import torch

from repro_torch.core import costmodel as cm
from repro_torch.core import engine as eng
from repro_torch.core import estimator as est
from repro_torch.core import faults as fl
from repro_torch.core import federated as F
from repro_torch.core import hierarchy as hr
from repro_torch.core import movement as mv
from repro_torch.core import theory as th
from repro_torch.core import topology as topo
from repro_torch.core.costs import (CostTraces, synthetic_costs,
                                    synthetic_edge_costs, testbed_like_costs,
                                    with_capacity)
from repro_torch.core.schedule import NetworkSchedule
from repro_torch.core.topology import (churn_schedule, fully_connected,
                                       link_flap_schedule, make_topology,
                                       scale_free)
from repro_torch.data import pipeline as pl
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import segment_reduce as sr
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import solve_setting
from repro_torch.models import mnist as mm


@dataclasses.dataclass(frozen=True)
class BenchScale:
    n_train: int = 20_000
    n_test: int = 4_000
    T: int = 40
    tau: int = 5
    eta: float = 0.1
    # cap on the device count of sparse_scale and hier_scale (0 = their
    # full n = 102,400)
    max_n: int = 0
    # warm repeats of scenario_batched's timed sweeps
    repeats: int = 1


QUICK = BenchScale(n_train=8_000, n_test=2_000, T=20, tau=5)
DEFAULT = BenchScale()


@functools.lru_cache(maxsize=2)
def dataset(n_train: int, n_test: int, seed: int = 0):
    return make_image_dataset(n_train=n_train, n_test=n_test, seed=seed)


def _draw(scale: BenchScale, *, n=10, model="mlp", iid=True,
          costs="testbed", topology="full", rho=1.0, medium="wifi",
          p_exit=0.0, p_entry=0.0, f_err=0.7, seed=0, mean_per_round=None):
    """One experiment's problem, drawn in the reference's order: costs,
    topology, then streams (``mean_per_round`` samples a device a
    round; None: |D|/(nT)). Returns the generator there (the churn or
    flap draw comes next), the run's config, the cost traces, the base
    graph, the streams and their counts."""
    rng = np.random.default_rng(seed)
    data = dataset(scale.n_train, scale.n_test)
    cfg = F.FedConfig(n=n, T=scale.T, tau=scale.tau, eta=scale.eta,
                      model=model, iid=iid, seed=seed, p_exit=p_exit,
                      p_entry=p_entry)
    if costs == "testbed":
        traces = testbed_like_costs(n, scale.T, rng, f_err=f_err,
                                    medium=medium)
    else:
        traces = synthetic_costs(n, scale.T, rng, f_err=f_err)
    adj = make_topology(topology, n, rng, rho=rho,
                        costs=traces.c_node.mean(0))
    streams = pl.poisson_streams(n, scale.T, data[1], iid=iid, rng=rng,
                                 mean_per_round=mean_per_round)
    return rng, cfg, traces, adj, streams, pl.counts(streams)


def fog_experiment(*, scale: BenchScale, n=10, model="mlp", iid=True,
                   costs="testbed", topology="full", rho=1.0,
                   setting="B", error_model="discard", medium="wifi",
                   p_exit=0.0, p_entry=0.0, f_err=0.7, seed=0, train=True,
                   device=None, z0=None) -> dict:
    """One experiment; returns the cost decomposition and, with
    ``train``, the accuracy curve. The plan is the training CLI's
    :func:`~repro_torch.launch.train.solve_setting` at 400 convex
    iterations on the static graph, as the reference's benches plan;
    ``z0`` is the solver's initial point (None: its default). With
    ``p_exit``/``p_entry`` the training runs under the churn trace of
    :func:`~repro_torch.core.federated.churn_activity`, drawn after the
    plan."""
    device = resolve_device(device)
    rng, cfg, traces, adj, streams, D = _draw(
        scale, n=n, model=model, iid=iid, costs=costs, topology=topology,
        rho=rho, medium=medium, p_exit=p_exit, p_entry=p_entry,
        f_err=f_err, seed=seed)
    plan = solve_setting(setting, traces, adj, D, error_model=error_model,
                         device=device, z0=z0, iters=400)
    if setting in ("D", "E"):
        traces = with_capacity(traces, float(D.mean()))
    cost = mv.plan_cost(plan, traces, D, error_model=error_model)
    out = {"setting": setting, "cost": cost, "n": n, "rho": rho,
           "tau": scale.tau, "topology": topology, "iid": iid}
    if train:
        activity = (F.churn_activity(cfg, rng)
                    if (p_exit or p_entry) else None)
        hist = F.run_network_aware(cfg, dataset(scale.n_train, scale.n_test),
                                   traces, adj, plan, streams=streams,
                                   activity=activity, device=device)
        out.update(_trained(hist))
    return out


def _trained(hist: dict) -> dict:
    """The history fields a trained row keeps."""
    return {"acc": hist["test_acc"][-1], "acc_curve": hist["test_acc"],
            "sim_before": hist["sim_before"],
            "sim_after": hist["sim_after"],
            "avg_active": float(np.mean([a.sum() for a in hist["active"]]))}


# ---------------------------------------------------------------------------
# Sweep points with a network schedule (benchmarks.fog.make_scenario's
# recipe at setting B), planned and trained one by one
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Scenario:
    """One sweep point: costs, topology, streams, schedule and the plan
    recipe. ``setting``: the Table III setting the point is planned
    under (A: no movement; C, E: on estimates; D, E: repaired against
    capacities). ``error_model``: "discard" plans by the Theorem-3 rule,
    "sqrt" (or "neg_G") by the convex solve at ``gamma``. ``activity``:
    a (T, n) active mask that overrides the schedule's. ``replan``:
    "oracle" plans on the true schedule, "predict" on the schedule
    predicted from the observed history, "expected" on the observed
    support with 1/availability link prices, "once" on the base graph
    (True/False: oracle/once). ``faults`` (unannounced failures) are
    never visible to the planner: crash outages enter at realization,
    upload faults inside the engine's aggregation under ``guard`` and
    ``quorum``. ``hierarchy``: a TierTree; such a point trains alone on
    the scan substrate, never in a batched bucket."""

    key: dict
    cfg: F.FedConfig
    traces: object
    adj: np.ndarray
    D: np.ndarray
    streams: pl.FogStreams
    setting: str = "B"
    error_model: str = "sqrt"
    gamma: float = 1.0
    activity: np.ndarray | None = None
    schedule: NetworkSchedule | None = None
    replan: bool | str = "oracle"
    faults: fl.FaultSchedule | None = None
    guard: bool = True
    quorum: float = 0.0
    hierarchy: object | None = None


def make_scenario(scale: BenchScale, *, key=None, setting="B",
                  error_model="sqrt", gamma=1.0, dynamics=None,
                  p_flap=0.05, replan="oracle", faults=None,
                  fault_rate=0.0, guard=True, quorum=0.0,
                  corrupt_mode="nan", tiers=None, **draw) -> Scenario:
    """Build one sweep point: :func:`_draw`'s problem (``draw`` takes its
    keywords, ``mean_per_round`` among them), then the schedule from the
    same generator. ``setting`` D or E gives the traces capacities at
    the mean count. ``dynamics``: None (churn when
    ``p_exit``/``p_entry`` are set, else static), "churn" or "flap"
    (links fail w.p. ``p_flap`` and recover w.p. 0.5 a round).
    ``faults``/``fault_rate``: a
    :class:`~repro_torch.core.faults.FaultSchedule` or a
    :func:`~repro_torch.core.faults.make_faults` kind drawn at that rate
    from a generator of its own (seed + 7919), so a faulted point
    shares streams, costs and topology with its clean twin;
    ``guard``/``quorum``/``corrupt_mode`` configure the engine side.
    ``tiers``: a TierTree or a ``--tiers`` spec (its first period must
    be ``scale.tau``)."""
    rng, cfg, traces, adj, streams, D = _draw(scale, **draw)
    if setting in ("D", "E"):
        traces = with_capacity(traces, float(D.mean()))
    if dynamics is None:
        dynamics = "churn" if (cfg.p_exit or cfg.p_entry) else "static"
    schedule = None
    if dynamics == "churn" and (cfg.p_exit or cfg.p_entry):
        schedule = churn_schedule(adj, scale.T, cfg.p_exit, cfg.p_entry,
                                  rng, tau=scale.tau)
    elif dynamics == "flap":
        schedule = link_flap_schedule(adj, scale.T, rng, p_down=p_flap,
                                      p_up=0.5)
    if not isinstance(faults, fl.FaultSchedule):
        faults = fl.make_faults(faults, scale.T, cfg.n, scale.tau,
                                rate=fault_rate, seed=cfg.seed + 7919,
                                corrupt=corrupt_mode)
    hierarchy = tiers
    if isinstance(tiers, str):
        hierarchy = hr.TierTree.from_spec(tiers, cfg.n)
    return Scenario(key=dict(key or {}), cfg=cfg, traces=traces, adj=adj,
                    D=D, streams=streams, setting=setting,
                    error_model=error_model, gamma=gamma,
                    schedule=schedule, replan=replan, faults=faults,
                    guard=guard, quorum=quorum, hierarchy=hierarchy)


def replan_mode(replan) -> str:
    """``Scenario.replan`` as "oracle", "predict", "expected" or "once"
    (True is oracle, False once)."""
    if replan is True:
        return "oracle"
    if replan is False:
        return "once"
    if replan in ("oracle", "predict", "expected", "once"):
        return replan
    raise ValueError(f"unknown replan mode {replan!r}; expected "
                     "'oracle', 'predict', 'expected', 'once' or a bool")


def _estimated(sc: Scenario):
    """The traces and counts the planner sees: estimates under settings
    C and E, the true ones otherwise; under "expected" the link costs
    are priced by 1/availability."""
    if sc.setting in ("C", "E"):
        tr, D = est.estimate_traces(sc.traces), est.estimate_counts(sc.D)
    else:
        tr, D = sc.traces, sc.D
    if sc.schedule is not None and replan_mode(sc.replan) == "expected":
        tr = est.expected_cost_traces(tr, sc.schedule)
    return tr, D


def _plan_network(sc: Scenario):
    """The network the planner sees: the true schedule, the predicted
    one ("threshold" for predict, "expected" for expected) or the base
    graph."""
    if sc.schedule is None:
        return sc.adj
    mode = replan_mode(sc.replan)
    if mode == "oracle":
        return sc.schedule
    if mode in ("predict", "expected"):
        return est.predict_schedule(
            sc.schedule, mode="threshold" if mode == "predict"
            else "expected")
    return sc.adj


def solve_scenario_plans(scenarios: list[Scenario], *, iters=400, seed=0,
                         device=None) -> list[mv.MovementPlan]:
    """Plans for a sweep: no movement under setting A, Theorem-3 plans
    point by point, convex plans in one ``solve_convex_batched`` call
    per (T, n, error model, γ) group (every point from the same
    ``seed``'s z0), each on the point's planner view (:func:`_estimated`,
    :func:`_plan_network`). Settings D and E are repaired against the
    true traces and counts. Every plan with a schedule is then realized
    against it, with the point's crash outages composed in where it has
    any."""
    device = resolve_device(device)
    nets = [_plan_network(sc) for sc in scenarios]
    plans: list = [None] * len(scenarios)
    groups: dict[tuple, list[int]] = {}
    for b, sc in enumerate(scenarios):
        T_, n = sc.D.shape
        if sc.setting == "A":
            plans[b] = mv.no_movement_plan(T_, n)
        elif sc.error_model == "discard":
            plans[b] = mv.greedy_linear(_estimated(sc)[0], nets[b],
                                        device=device)
        else:
            groups.setdefault((T_, n, sc.error_model, sc.gamma),
                              []).append(b)
    for (_, _, em, gamma), idxs in groups.items():
        estimated = [_estimated(scenarios[b]) for b in idxs]
        for b, p in zip(idxs, mv.solve_convex_batched(
                [tr for tr, _ in estimated], [nets[b] for b in idxs],
                [D for _, D in estimated], error_model=em, gamma=gamma,
                iters=iters, seeds=seed, device=device)):
            plans[b] = p
    for b, sc in enumerate(scenarios):
        if sc.setting in ("D", "E"):
            plans[b] = mv.repair_capacities(plans[b], sc.traces, nets[b],
                                            sc.D)
        if sc.faults is not None and sc.faults.has_crashes:
            plans[b] = mv.realize_plan(
                plans[b], sc.faults.compose(sc.schedule, adj=sc.adj))
        elif sc.schedule is not None:
            plans[b] = mv.realize_plan(plans[b], sc.schedule)
    return plans


def scenario_bucket_key(sc: Scenario, *, bucket: str = "pow2") -> tuple:
    """The shape bucket a sweep point trains in: points sharing this key
    run through one bucket program of the sweep engine (P is bucketed
    inside the group). The fault config is part of the key: guard and
    quorum are the bucket program's, and fault-free points keep the
    clean program."""
    T_, n = sc.D.shape
    return (sc.cfg.model, sc.cfg.eta, sc.cfg.tau,
            pl.bucket_rounds(T_, sc.cfg.tau, bucket),
            pl.bucket_size(n, bucket,
                           max_inflation=pl.BUCKET_MAX_INFLATION),
            sc.faults is not None,
            bool(sc.guard) if sc.faults is not None else False,
            float(sc.quorum) if sc.faults is not None else 0.0)


def _group_dims(prepared, tau: int, bucket: str) -> dict:
    """The padded bucket dims of one group under dense and ragged
    staging, from the prepared streams: the cost model's shape
    inputs."""
    points = []
    for (_, processed, _, max_pts) in prepared:
        if isinstance(processed, pl.FlatStreams):
            T_, n = processed.T, processed.n
        else:
            T_, n = len(processed), len(processed[0])
        points.append((T_, n, int(max_pts)))
    cap = pl.BUCKET_MAX_INFLATION
    T_b = max(pl.bucket_rounds(T_, tau, bucket) for T_, _, _ in points)
    n_b = max(pl.bucket_size(n, bucket, max_inflation=cap)
              for _, n, _ in points)
    P_b = pl.bucket_size(max(P for _, _, P in points), bucket,
                         max_inflation=cap)
    rows = pl.ragged_rows([p[1] for p in prepared])
    R_b = pl.bucket_size(max(int(rows.max()) if rows.size else 1, 1),
                         bucket, max_inflation=cap)
    return {"points": points, "T_b": T_b, "n_b": n_b, "P_b": P_b,
            "R_b": R_b, "chunk": pl.RAGGED_CHUNK}


def _point_ident(sc: Scenario) -> tuple:
    """Preparation-free identity of one point's loop run: the config
    fields that set its staged shapes."""
    cfg = sc.cfg
    return (cfg.T, cfg.n, cfg.seed, cfg.p_exit, cfg.p_entry)


def run_scenarios(scenarios: list[Scenario], scale: BenchScale, *,
                  train=True, engine="auto", iters=400, seed=0,
                  batch: bool | None = None, bucket: str = "pow2",
                  plans=None, mesh="auto", staging: str | None = None,
                  device=None) -> list[dict]:
    """Solve (unless ``plans`` are given), cost and (with ``train``)
    train a sweep, as :func:`benchmarks.fog.run_scenarios` does.

    ``engine="auto"`` (with more than one point) groups the points into
    shape buckets (:func:`scenario_bucket_key`) and prices each bucket
    through :data:`repro_torch.core.costmodel.MODEL`: the per-point loop
    on the scan engine, or the sweep engine
    (:func:`repro_torch.core.federated.run_network_aware_batched`) with
    dense or ragged staging; a bucket of one point takes the loop. Each
    row records the decision under ``"dispatch"``. ``engine="batched"``
    (or ``batch=True``) sends every bucket through the sweep engine,
    dense unless ``staging`` says otherwise; ``engine="scan"``,
    ``"legacy"`` or ``batch=False`` trains the points one by one
    (``engine="batched"`` with ``batch=False``: one by one through the
    sweep engine). ``staging``: None (dispatch chooses; forced batched
    is dense), "auto", "dense" or "ragged". Hierarchical points always
    train one by one on the scan substrate. ``engine="auto"`` points
    train on ``engine.resolve_engine("auto")``. ``mesh``: "auto" (a data
    mesh when the default process group has more than one rank, else
    one card), None (one card) or a 1-D "data" ``DeviceMesh``.

    Rows: the point's key, setting, cost and engine, the dispatch where
    there was one, and trained, accuracy, curves, label similarity and
    mean active devices, and under faults the fault summary and the
    aggregations the quorum skipped."""
    device = resolve_device(device)
    if plans is None:
        plans = solve_scenario_plans(scenarios, iters=iters, seed=seed,
                                     device=device)
    data = dataset(scale.n_train, scale.n_test)
    if batch is None:
        batch = engine in ("auto", "batched") and len(scenarios) > 1
    force_batched = engine == "batched" or (batch and engine != "auto")
    point_engine = eng.resolve_engine(engine)
    engines = [("batched" if batch else point_engine)] * len(scenarios)
    hists: list = [None] * len(scenarios)
    dispatches: list = [None] * len(scenarios)
    hier_idx = {b for b, sc in enumerate(scenarios)
                if sc.hierarchy is not None}

    def one(b, **kw):
        sc = scenarios[b]
        return F.run_network_aware(
            sc.cfg, data, sc.traces, sc.adj, plans[b], streams=sc.streams,
            activity=sc.activity, schedule=sc.schedule, faults=sc.faults,
            guard=sc.guard, quorum=sc.quorum, device=device, **kw)

    if train:
        for b in sorted(hier_idx):
            hists[b] = one(b, engine="scan",
                           hierarchy=scenarios[b].hierarchy)
            engines[b] = "hierarchical"
    if train and batch:
        groups: dict[tuple, list[int]] = {}
        for b, sc in enumerate(scenarios):
            if b not in hier_idx:
                groups.setdefault(scenario_bucket_key(sc, bucket=bucket),
                                  []).append(b)
        for gkey, idxs in groups.items():
            fault_list = [scenarios[b].faults for b in idxs]
            t_prep0 = time.perf_counter()
            prepared = [F._prepare_streams(
                scenarios[b].cfg, data, plans[b], scenarios[b].streams,
                scenarios[b].activity, scenarios[b].schedule,
                scenarios[b].faults) for b in idxs]
            eng.add_phase_time("stage_s", time.perf_counter() - t_prep0)
            tau = scenarios[idxs[0]].cfg.tau
            dims = _group_dims(prepared, tau, bucket)
            dims["idents"] = [_point_ident(scenarios[b]) for b in idxs]
            dims["eval_slots"] = sum(T_ // tau for T_, _, _
                                     in dims["points"]) * scale.n_test
            pin = staging
            if pin is None:
                pin = "dense" if force_batched else "auto"
            decision = cm.MODEL.choose(
                key=gkey, force_path="batched" if force_batched else None,
                staging=None if pin == "auto" else pin, **dims)
            t0 = time.perf_counter()
            if decision.path == "batched":
                outs = F.run_network_aware_batched(
                    [scenarios[b].cfg for b in idxs], data,
                    [plans[b] for b in idxs], mesh=mesh, bucket=bucket,
                    staging=decision.staging, prepared=prepared,
                    faults=(fault_list if any(f is not None
                                              for f in fault_list)
                            else None),
                    # the bucket key groups by (guard, quorum)
                    guard=scenarios[idxs[0]].guard,
                    quorum=scenarios[idxs[0]].quorum, device=device)
                for b, hist in zip(idxs, outs):
                    hists[b], engines[b] = hist, "batched"
            else:
                loop_engine = eng.resolve_engine("auto")
                for i, b in enumerate(idxs):
                    hists[b] = one(b, engine=loop_engine,
                                   prepared=prepared[i],
                                   mesh=None if mesh == "auto" else mesh)
                    engines[b] = loop_engine
            synchronize(device)
            ran = ("loop" if decision.path == "loop"
                   else f"batched-{decision.staging}")
            cm.MODEL.observe_run(
                decision.path, decision.staging,
                decision.slots.get(ran, 0), time.perf_counter() - t0, 0,
                n_points=len(idxs), eval_slots=dims["eval_slots"])
            cm.MODEL.record(decision, key=gkey, **dims)
            for b in idxs:
                dispatches[b] = decision.as_row()
    elif train:
        for b in range(len(scenarios)):
            if b not in hier_idx:
                hists[b] = one(b, engine=engines[b], mesh=(
                    None if mesh == "auto" else mesh))
        # a forced loop sweep has run its points: later dispatched
        # sweeps price the loop path as warm
        for b, sc in enumerate(scenarios):
            if b not in hier_idx:
                cm.MODEL.mark_loop_seen(
                    scenario_bucket_key(sc, bucket=bucket),
                    [_point_ident(sc)])
    rows = []
    for b, (sc, plan, hist) in enumerate(zip(scenarios, plans, hists)):
        out = {**sc.key, "setting": sc.setting,
               "cost": mv.plan_cost(plan, sc.traces, sc.D,
                                    error_model=sc.error_model,
                                    gamma=sc.gamma),
               "engine": engines[b]}
        if dispatches[b] is not None:
            out["dispatch"] = dispatches[b]
        if hist is not None:
            out.update(_trained(hist))
            if sc.faults is not None:
                out["fault_summary"] = sc.faults.summary()
                out["quorum_skips"] = int(sum(
                    not ok for ok in hist.get("agg_quorum_ok", [])))
        rows.append(out)
    return rows


def table3_settings(scale: BenchScale, device=None) -> dict:
    """Settings A–E: cost decomposition, and accuracy for A and B."""
    rows = {}
    for setting in "ABCDE":
        r = fog_experiment(scale=scale, setting=setting, model="mlp",
                           train=setting in "AB", device=device)
        rows[setting] = {"cost": r["cost"], "acc": r.get("acc")}
    unit_A = rows["A"]["cost"]["unit"]
    unit_B = rows["B"]["cost"]["unit"]
    return {"rows": rows, "headline": {
        "unit_cost_reduction_A_to_B": 1 - unit_B / unit_A,
        "claim_geq_40pct": bool((1 - unit_B / unit_A) >= 0.40),
        "process_reduction": 1 - rows["B"]["cost"]["process"]
        / max(rows["A"]["cost"]["process"], 1e-9)}}


def table4_error_costs(scale: BenchScale, device=None) -> dict:
    """The discard-cost models f·D·r, −f·G and f/√G under settings B
    and D; accuracy for B."""
    rows = {}
    for em in ("discard", "neg_G", "sqrt"):
        for setting in ("B", "D"):
            r = fog_experiment(scale=scale, setting=setting,
                               error_model=em, train=(setting == "B"),
                               device=device)
            rows[f"{em}/{setting}"] = {"cost": r["cost"],
                                       "acc": r.get("acc")}
    return {"rows": rows, "headline": {
        "negG_processes_most": bool(
            rows["neg_G/B"]["cost"]["processed_frac"]
            >= rows["sqrt/B"]["cost"]["processed_frac"] - 0.05),
        "negG_total_highest": bool(
            rows["neg_G/B"]["cost"]["process"]
            + rows["neg_G/B"]["cost"]["transfer"]
            >= rows["discard/B"]["cost"]["process"]
            + rows["discard/B"]["cost"]["transfer"] - 1e-6)}}


TABLE2_MODELS = ("mlp", "cnn")


def table2_accuracy(scale: BenchScale, device=None) -> dict:
    """Centralized vs federated vs network-aware accuracy, iid and
    non-iid, synthetic and testbed costs (paper Table II)."""
    rows = {}
    data = dataset(scale.n_train, scale.n_test)
    for model in TABLE2_MODELS:
        cen = F.run_centralized(
            F.FedConfig(model=model, eta=scale.eta, T=scale.T),
            data, steps=scale.T * 10, batch=512, device=device)
        rows[f"centralized/{model}"] = cen["test_acc"]
        for iid in (True, False):
            tag = "iid" if iid else "noniid"
            fed = fog_experiment(scale=scale, model=model, iid=iid,
                                 setting="A", device=device)
            rows[f"federated/{model}/{tag}"] = fed["acc"]
            for costs in ("synthetic", "testbed"):
                na = fog_experiment(scale=scale, model=model, iid=iid,
                                    costs=costs, setting="B", device=device)
                rows[f"network_aware/{model}/{tag}/{costs}"] = na["acc"]
    # paper claim: network-aware within 4pp of federated
    gaps = [rows[f"federated/{m}/{d}"] - rows[f"network_aware/{m}/{d}/testbed"]
            for m in TABLE2_MODELS for d in ("iid", "noniid")]
    return {"rows": rows,
            "headline": {"max_gap_pp": 100 * max(gaps),
                         "claim_within_4pp": bool(max(gaps) <= 0.04)}}


def table5_dynamics(scale: BenchScale, device=None) -> dict:
    """Static vs dynamic network, 1% churn (paper Table V)."""
    stat = fog_experiment(scale=scale, setting="B", device=device)
    dyn = fog_experiment(scale=scale, setting="B", p_exit=0.01,
                         p_entry=0.01, seed=1, device=device)
    return {"static": {k: stat[k] for k in ("acc", "cost")},
            "dynamic": {k: dyn[k] for k in ("acc", "cost")},
            "headline": {
                "acc_drop_pp": 100 * (stat["acc"] - dyn["acc"]),
                "unit_cost_delta": dyn["cost"]["unit"]
                - stat["cost"]["unit"],
                "avg_active": dyn.get("avg_active")}}


def _sweep(scale, param_values, claim_fn=None, *, device=None, **fixed):
    """One fog experiment a point; a row of its cost fractions and
    accuracy."""
    rows = []
    for pv in param_values:
        r = fog_experiment(scale=scale, device=device, **fixed, **pv)
        rows.append({**pv, "unit": r["cost"]["unit"],
                     "moved_rate": r["cost"]["moved_rate"],
                     "processed_frac": r["cost"]["processed_frac"],
                     "discarded_frac": r["cost"]["discarded_frac"],
                     "acc": r.get("acc"), "sim_after": r.get("sim_after")})
    out = {"rows": rows}
    if claim_fn:
        out["headline"] = claim_fn(rows)
    return out


def _scenario_sweep(scale, points, claim_fn=None, *, iters=300,
                    device=None, **fixed):
    """Figs. 5/6: the points planned by the Theorem-3 rule and trained
    one by one; then the same points solved under the 1/√G model, one
    ``solve_convex_batched`` call per (T, n) group at ``iters`` steps,
    each row gaining its ``unit_sqrt``."""
    scenarios = [make_scenario(scale, key=pv, **pv, **fixed,
                               error_model="discard") for pv in points]
    full = run_scenarios(scenarios, scale, iters=iters, engine="scan",
                         device=device)
    rows = [{**r, **{k: r["cost"][k] for k in
                     ("unit", "moved_rate", "processed_frac",
                      "discarded_frac")}} for r in full]
    for r in rows:
        r.pop("cost"), r.pop("acc_curve", None), r.pop("sim_before", None)
    convex = [dataclasses.replace(sc, error_model="sqrt")
              for sc in scenarios]
    for r, sc, plan in zip(rows, convex, solve_scenario_plans(
            convex, iters=iters, device=device)):
        r["unit_sqrt"] = mv.plan_cost(plan, sc.traces, sc.D,
                                      error_model="sqrt")["unit"]
    out = {"rows": rows}
    if claim_fn:
        out["headline"] = claim_fn(rows)
    return out


FIG5_POINTS = [{"n": n} for n in (5, 10, 20, 30)]
FIG6_POINTS = [{"rho": r} for r in (0.0, 0.25, 0.5, 0.75, 1.0)]


def fig5_nodes(scale: BenchScale, device=None) -> dict:
    """Unit cost falls and non-iid accuracy rises with n (Fig. 5)."""
    return _scenario_sweep(
        scale, FIG5_POINTS, iid=False, device=device,
        claim_fn=lambda rows: {
            "unit_cost_decreasing": bool(
                rows[-1]["unit"] <= rows[0]["unit"] + 1e-9),
            "noniid_acc_improves": bool(
                rows[-1]["acc"] >= rows[0]["acc"] - 0.02),
            "units": [r["unit"] for r in rows],
            "accs": [r["acc"] for r in rows]})


def fig6_connectivity(scale: BenchScale, device=None) -> dict:
    """Connectivity ρ on a random graph (Fig. 6)."""
    return _scenario_sweep(
        scale, FIG6_POINTS, topology="random", iid=False,
        device=device,
        claim_fn=lambda rows: {
            "unit_cost_decreasing_in_rho": bool(
                rows[-1]["unit"] <= rows[0]["unit"] + 1e-9),
            "moved_rate_increasing": bool(
                rows[-1]["moved_rate"] >= rows[0]["moved_rate"] - 1e-9),
            "units": [r["unit"] for r in rows]})


FIG7_TAUS = (2, 5, 10, 20)


def fig7_aggregation(scale: BenchScale, device=None) -> dict:
    """Aggregation period τ (Fig. 7)."""
    rows = []
    for tau in FIG7_TAUS:
        r = fog_experiment(scale=dataclasses.replace(scale, tau=tau),
                           iid=False, device=device)
        rows.append({"tau": tau, "acc": r["acc"], "unit": r["cost"]["unit"]})
    return {"rows": rows, "headline": {
        "acc_small_tau_geq_acc_large_tau": bool(
            rows[0]["acc"] >= rows[-1]["acc"] - 0.02),
        "accs": [r["acc"] for r in rows]}}


def fig8_topologies(scale: BenchScale, device=None) -> dict:
    """Cost components per topology × medium (Fig. 8), at f_err 0.45 so
    that discarding is in play."""
    rows = {}
    for topo in ("social", "hierarchical", "full"):
        for medium in ("lte", "wifi"):
            r = fog_experiment(scale=scale, topology=topo, medium=medium,
                               f_err=0.45, train=False, device=device)
            rows[f"{topo}/{medium}"] = r["cost"]
    return {"rows": rows, "headline": {
        "hierarchical_moves_least": bool(
            rows["hierarchical/wifi"]["moved_rate"]
            <= rows["full/wifi"]["moved_rate"] + 1e-9),
        "wifi_discards_more_than_lte": bool(
            rows["social/wifi"]["discarded_frac"]
            >= rows["social/lte"]["discarded_frac"] - 1e-9)}}


CHURN_RATES = (0.0, 0.01, 0.02, 0.05)


def fig9_exit(scale: BenchScale, device=None) -> dict:
    """p_exit sweep with p_entry = 2% (Fig. 9)."""
    return _sweep(scale, [{"p_exit": p, "p_entry": 0.02, "seed": 5}
                          for p in CHURN_RATES], device=device,
                  claim_fn=lambda rows: {
                      "acc_declines_with_exit": bool(
                          rows[-1]["acc"] <= rows[0]["acc"] + 0.02),
                      "accs": [r["acc"] for r in rows]})


def fig10_entry(scale: BenchScale, device=None) -> dict:
    """p_entry sweep with p_exit = 2% (Fig. 10)."""
    return _sweep(scale, [{"p_exit": 0.02, "p_entry": p, "seed": 6}
                          for p in CHURN_RATES], device=device,
                  claim_fn=lambda rows: {
                      "acc_improves_with_entry": bool(
                          rows[-1]["acc"] >= rows[0]["acc"] - 0.02),
                      "accs": [r["acc"] for r in rows]})


def thm5_value_of_offloading(scale: BenchScale, device=None) -> dict:
    """Theorem 5's closed form (15) against simulated greedy savings on
    scale-free graphs, sweeping the cost range C (claim: about linear
    in C)."""
    rng = np.random.default_rng(0)
    n, T = 60, 8
    rows = []
    for C in (0.5, 1.0, 2.0, 4.0):
        adj = scale_free(n, 2, rng)
        hist: dict = {}
        for k in adj.sum(1):
            hist[int(k)] = hist.get(int(k), 0) + 1.0 / n
        closed = th.theorem5_network_savings(C, hist)
        tr = synthetic_costs(n, T, rng, f_err=1e9)   # no discarding
        tr.c_node[:] *= C
        tr.c_link[:] = 0.0
        D = np.ones((T, n))
        base = mv.plan_cost(mv.no_movement_plan(T, n), tr, D)["total"]
        got = mv.plan_cost(mv.greedy_linear(tr, adj, device=device), tr,
                           D)["total"]
        sim = (base - got) / ((T - 1) * n)   # per point; none move at T-1
        rows.append({"C": C, "closed_form": closed, "simulated": sim})
    ratio = [r["closed_form"] / r["C"] for r in rows]
    return {"rows": rows, "headline": {
        "linear_in_C": bool(max(ratio) - min(ratio) < 0.05 * max(ratio)),
        "sim_vs_closed_relerr": max(
            abs(r["simulated"] - r["closed_form"])
            / max(r["closed_form"], 1e-9) for r in rows)}}


DYNAMICS_RATES = (0.0, 0.02, 0.05, 0.1)
CONST_GUARD = (512, 50)          # (n, T) of the constant-schedule guard


def network_dynamics(scale: BenchScale, device=None) -> dict:
    """Paper §V-E through the schedule plane: accuracy and cost against
    churn rate, replanning on every event (the schedule-aware Theorem-3
    rule) against planning once on the base graph (realized against the
    schedule: data over dead links or toward exited receivers is lost);
    a link-flap pair; and the constant-schedule guard: at
    ``CONST_GUARD`` = (n, T) the plan on a constant schedule must equal
    the plan on the raw static matrix, and its time is reported beside
    it."""
    rates = DYNAMICS_RATES
    scenarios = []
    for rate in rates:
        for replan in ((True,) if rate == 0 else (True, False)):
            scenarios.append(make_scenario(
                scale, key={"kind": "churn", "rate": rate,
                            "replan": replan},
                error_model="discard", p_exit=rate, p_entry=rate,
                replan=replan, seed=7))
    for replan in (True, False):
        scenarios.append(make_scenario(
            scale, key={"kind": "flap", "rate": 0.1, "replan": replan},
            error_model="discard", dynamics="flap", p_flap=0.1,
            replan=replan, seed=7))
    full = run_scenarios(scenarios, scale, engine="scan", device=device)
    rows = []
    for r, sc in zip(full, scenarios):
        rows.append({**r["cost"], **{k: r.get(k) for k in
                                     ("kind", "rate", "replan", "acc",
                                      "avg_active")},
                     "n_events": (len(sc.schedule.events_in(0, scale.T))
                                  if sc.schedule is not None else 0)})

    n2, T2 = CONST_GUARD
    tr2 = synthetic_costs(n2, T2, np.random.default_rng(1))
    adj2 = fully_connected(n2)
    sched2 = NetworkSchedule.constant(adj2, T2)
    mv.greedy_linear(tr2, adj2, device=device)          # warm
    static_s, const_s = [], []
    for _ in range(3):
        t = time.perf_counter()
        p_static = mv.greedy_linear(tr2, adj2, device=device)
        static_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        p_const = mv.greedy_linear(tr2, sched2, device=device)
        const_s.append(time.perf_counter() - t)
    static_s, const_s = sorted(static_s)[1], sorted(const_s)[1]

    by = {(r["kind"], r["rate"], r["replan"]): r for r in rows}
    pairs = [(by[("churn", c, True)], by[("churn", c, False)])
             for c in rates[1:]]
    return {
        "rows": rows,
        "const_schedule": {"n": n2, "T": T2, "static_s": static_s,
                           "const_s": const_s},
        "headline": {
            "acc_static": by[("churn", 0.0, True)]["acc"],
            f"acc_churn{round(100 * rates[-1])}_replan":
                by[("churn", rates[-1], True)]["acc"],
            f"acc_churn{round(100 * rates[-1])}_plan_once":
                by[("churn", rates[-1], False)]["acc"],
            # replan takes the per-point minimum over the true candidate
            # set, so it never costs more than the realized plan-once
            "replan_cost_never_worse": bool(all(
                a["total"] <= b["total"] + 1e-9 for a, b in pairs)),
            "plan_once_discards_more": bool(all(
                a["discarded_frac"] <= b["discarded_frac"] + 1e-9
                for a, b in pairs)),
            "const_schedule_overhead": const_s / static_s,
            "const_identical_plan": bool(mv.plans_equal(p_static,
                                                        p_const))}}


PREDICTION_POINTS = ([("churn", r) for r in (0.02, 0.05, 0.1)]
                     + [("flap", r) for r in (0.05, 0.1, 0.2)])
PREDICTION_EXPECTED_AT = (("churn", 0.1), ("flap", 0.2))


def network_prediction(scale: BenchScale, device=None) -> dict:
    """Predictive replanning: accuracy and cost under three planner
    views of a dynamic network — the true schedule ("oracle"), the
    schedule predicted from the observed history ("predict") and the
    base graph ("once") — over churn and flap rates, with an "expected"
    row (observed support, 1/availability link prices) at
    ``PREDICTION_EXPECTED_AT``. Every plan is realized against the true
    schedule. A static guard solves one point under all three modes:
    the plans must be equal bit for bit."""
    points, expected_at = PREDICTION_POINTS, PREDICTION_EXPECTED_AT
    modes = ("oracle", "predict", "once")
    scenarios = []
    for kind, rate in points:
        dyn = (dict(p_exit=rate, p_entry=rate) if kind == "churn"
               else dict(dynamics="flap", p_flap=rate))
        here = modes + (("expected",) if (kind, rate) in expected_at
                        else ())
        for mode in here:          # one seed: one true schedule per point
            scenarios.append(make_scenario(
                scale, key={"kind": kind, "rate": rate, "replan": mode},
                error_model="discard", replan=mode, seed=7, **dyn))
    full = run_scenarios(scenarios, scale, engine="scan", device=device)
    rows = []
    for r, sc in zip(full, scenarios):
        row = {**{k: r.get(k) for k in ("kind", "rate", "replan", "acc",
                                        "avg_active")}, **r["cost"]}
        if sc.replan == "predict" and sc.schedule is not None:
            row.update(est.schedule_prediction_accuracy(
                est.predict_schedule(sc.schedule), sc.schedule))
        rows.append(row)

    base = make_scenario(scale, key={"kind": "static"},
                         error_model="discard", seed=7)
    sched_c = NetworkSchedule.constant(base.adj, scale.T)
    trio = solve_scenario_plans(
        [dataclasses.replace(base, schedule=sched_c, replan=m)
         for m in modes], device=device)
    static_bitwise = all(mv.plans_equal(trio[0], p) for p in trio[1:])
    rows.append({"kind": "static", "rate": 0.0, "replan": "all",
                 "static_modes_bitwise": static_bitwise,
                 **mv.plan_cost(trio[0], base.traces, base.D)})

    by = {(r["kind"], r["rate"], r["replan"]): r for r in rows}
    top = max(r for k, r in points if k == "churn")
    o, p, q = (by[("churn", top, m)] for m in modes)
    acc_gap = o["acc"] - q["acc"]
    recovery = ((p["acc"] - q["acc"]) / acc_gap
                if abs(acc_gap) > 1e-9 else None)
    tag = f"churn{round(100 * top)}"
    headline = {
        f"acc_{tag}_oracle": o["acc"], f"acc_{tag}_predict": p["acc"],
        f"acc_{tag}_once": q["acc"],
        f"predict_gap_recovery_{tag}": recovery,
        "predict_recovers_gap": bool(recovery is not None
                                     and recovery >= 0.2),
        f"pred_link_accuracy_{tag}": p.get("link_accuracy"),
        # oracle plans on the true candidate set of every round: its
        # realized cost lower-bounds both other modes point by point
        "oracle_cost_never_worse": bool(all(
            by[(k, r, "oracle")]["total"] <= by[(k, r, m)]["total"] + 1e-9
            for k, r in points for m in ("predict", "once"))),
        "static_modes_bitwise": static_bitwise}
    if ("churn", top) in expected_at:
        x = by[("churn", top, "expected")]
        headline[f"acc_{tag}_expected"] = x["acc"]
        headline[f"cost_{tag}_expected_vs_predict"] = x["total"] - p["total"]
    return {"rows": rows, "headline": headline}


def _bitwise(a: dict, b: dict, keys=("test_acc", "test_loss")) -> bool:
    """Two histories equal bit for bit in ``keys`` and ``device_loss``."""
    return bool(all(a[k] == b[k] for k in keys)
                and all(np.array_equal(x, y) for x, y in
                        zip(a["device_loss"], b["device_loss"])))


# the sweep engine's grids (benchmarks.run.scenario_batched): paper-
# density streams, the regime where per-point overheads dominate a sweep
SCENARIO_DENSITY = 4.0
SCENARIO_GRIDS = {
    # 3 network sizes x 6 seeds (the paper's error bars): 3 buckets
    "fig5": [dict(n=n, seed=s, iid=False) for n in (5, 10, 20)
             for s in range(6)],
    # churn rates x replan-on-event against plan-once
    "dynamics": [dict(p_exit=r, p_entry=r, replan=rp, seed=7)
                 for r in (0.02, 0.1) for rp in ("oracle", "once")],
    # three planner views of one churned network
    "prediction": [dict(p_exit=0.05, p_entry=0.05, replan=m, seed=7)
                   for m in ("oracle", "predict", "once")],
}


def scenario_grid(scale: BenchScale, grid: str) -> list[Scenario]:
    """The points of one of ``SCENARIO_GRIDS``, Theorem-3 plans."""
    return [make_scenario(scale, key={"grid": grid, **pv},
                          error_model="discard",
                          mean_per_round=SCENARIO_DENSITY, **pv)
            for pv in SCENARIO_GRIDS[grid]]


def _histories_equal(a: dict, b: dict) -> bool:
    return bool(a["agg_round"] == b["agg_round"]
                and np.array_equal(np.stack(a["H_agg"]),
                                   np.stack(b["H_agg"]))
                and _bitwise(a, b))


def _largest_diff(a: dict, b: dict) -> float:
    """The largest |difference| of two histories' device and test losses
    and test accuracies."""
    return max(float(np.abs(np.subtract(np.asarray(a[k]),
                                        np.asarray(b[k]))).max())
               for k in ("device_loss", "test_loss", "test_acc"))


def _buckets(scenarios) -> list[list[int]]:
    groups: dict = {}
    for b, sc in enumerate(scenarios):
        groups.setdefault(scenario_bucket_key(sc), []).append(b)
    return list(groups.values())


def in_bucket_equals_alone(scenarios, plans, scale, staging: str,
                           device) -> tuple[bool, float]:
    """Each bucket of the sweep trained together through the sweep
    engine, then every point of it alone (S = 1) at the same staging.
    Returns whether every history is equal bit for bit, and the largest
    difference (:func:`_largest_diff`). Dense: every point's pad size
    pinned to its bucket's P_b, both runs, and alone through
    ``engine="batched"``; ragged: alone as a bucket of one."""
    data = dataset(scale.n_train, scale.n_test)
    ok, worst = True, 0.0
    for idxs in _buckets(scenarios):
        cfgs = [scenarios[b].cfg for b in idxs]
        if staging == "dense":
            P_b = pl.bucket_size(max(
                F._prepare_streams(scenarios[b].cfg, data, plans[b],
                                   scenarios[b].streams,
                                   scenarios[b].activity,
                                   scenarios[b].schedule)[3]
                for b in idxs), max_inflation=pl.BUCKET_MAX_INFLATION)
            cfgs = [dataclasses.replace(c, max_points=P_b) for c in cfgs]
        kw = dict(staging=staging, device=device)
        outs = F.run_network_aware_batched(
            cfgs, data, [plans[b] for b in idxs],
            streams=[scenarios[b].streams for b in idxs],
            activities=[scenarios[b].activity for b in idxs],
            schedules=[scenarios[b].schedule for b in idxs], **kw)
        for cfg, b, hb in zip(cfgs, idxs, outs):
            sc = scenarios[b]
            if staging == "dense":
                alone = F.run_network_aware(
                    cfg, data, sc.traces, sc.adj, plans[b],
                    streams=sc.streams, activity=sc.activity,
                    schedule=sc.schedule, engine="batched", device=device)
            else:
                alone = F.run_network_aware_batched(
                    [cfg], data, [plans[b]], streams=[sc.streams],
                    activities=[sc.activity], schedules=[sc.schedule],
                    **kw)[0]
            ok &= _histories_equal(alone, hb)
            worst = max(worst, _largest_diff(alone, hb))
    return bool(ok), worst


def _uniq_dispatches(rows) -> list:
    out = []
    for r in rows:
        d = r.get("dispatch")
        if d is not None and d not in out:
            out.append(d)
    return out


def scenario_batched(scale: BenchScale, device=None) -> dict:
    """The sweep engine against the per-point loop
    (``benchmarks.run.scenario_batched``): for each grid of
    ``SCENARIO_GRIDS``, the cost-model-dispatched sweep
    run first (nothing of it run yet: "cold"), then the forced loop on
    the scan engine, then ``scale.repeats`` warm repeats of each; both
    get the same plans. Rows: wall times and speedups, each bucket's
    dispatch, the bucket programs run (≤ the buckets), the phase times
    of the fastest warm dispatched sweep, the largest accuracy gap to
    the loop (the sweep engine sums eq. (4) in a fixed order, the scan
    an einsum), and on fig5 the in-bucket-equals-alone checks under
    dense and ragged staging."""
    device = resolve_device(device)
    repeats = max(int(scale.repeats), 1)
    rows = []
    for gname in SCENARIO_GRIDS:
        scenarios = scenario_grid(scale, gname)
        t = time.perf_counter()
        plans = solve_scenario_plans(scenarios, device=device)
        solve_s = time.perf_counter() - t
        n_buckets = len(_buckets(scenarios))

        def timed(**kw):
            t = time.perf_counter()
            out = run_scenarios(scenarios, scale, plans=plans,
                                device=device, **kw)
            synchronize(device)
            return time.perf_counter() - t, out

        b0 = eng.batched_compile_count()
        disp_cold_s, disp = timed(engine="auto")
        programs = eng.batched_compile_count() - b0
        loop_cold_s, loop = timed(engine="auto", batch=False)
        loop_warm_s = min(timed(engine="auto", batch=False)[0]
                          for _ in range(repeats))
        disp_warm_s, phases, disp_warm = None, None, disp
        for _ in range(repeats):
            eng.reset_phase_timings()
            dt, out = timed(engine="auto")
            if disp_warm_s is None or dt < disp_warm_s:
                disp_warm_s, phases, disp_warm = (dt, eng.phase_timings(),
                                                  out)
        acc_gap = max(max(abs(a - b) for a, b in zip(lr["acc_curve"],
                                                     br["acc_curve"]))
                      for lr, br in zip(loop, disp_warm))
        alone = {st: (in_bucket_equals_alone(scenarios, plans, scale, st,
                                             device)
                      if gname == "fig5" else (None, None))
                 for st in ("dense", "ragged")}
        rows.append({
            "grid": gname, "points": len(scenarios),
            "buckets": n_buckets,
            "staged_histories_bitwise": alone["dense"][0],
            "staged_max_diff": alone["dense"][1],
            "ragged_alone_bitwise": alone["ragged"][0],
            "ragged_alone_max_diff": alone["ragged"][1],
            "dispatch_cold": _uniq_dispatches(disp),
            "solve_s": solve_s,
            "loop_cold_s": loop_cold_s, "dispatched_cold_s": disp_cold_s,
            "loop_warm_s": loop_warm_s, "dispatched_warm_s": disp_warm_s,
            "speedup_cold": loop_cold_s / disp_cold_s,
            "speedup_warm": loop_warm_s / disp_warm_s,
            "warm_repeats": repeats,
            "warm_phases": phases,
            "dispatch_warm": _uniq_dispatches(disp_warm),
            "dispatched_train_programs": programs,
            "train_programs_leq_buckets": bool(programs <= n_buckets),
            "acc_curves_equal": bool(all(
                lr["acc_curve"] == br["acc_curve"]
                for lr, br in zip(loop, disp_warm))),
            "acc_curve_gap": acc_gap})
    by = {r["grid"]: r for r in rows}
    headline = {
        "min_grid_speedup_warm": min(r["speedup_warm"] for r in rows),
        "train_programs_leq_buckets": bool(all(
            r["train_programs_leq_buckets"] for r in rows)),
        "max_acc_curve_gap": max(r["acc_curve_gap"] for r in rows)}
    if "fig5" in by:
        f = by["fig5"]
        headline.update(
            fig5_speedup_cold=f["speedup_cold"],
            fig5_speedup_warm=f["speedup_warm"],
            fig5_buckets=f["buckets"],
            fig5_staged_histories_bitwise=f["staged_histories_bitwise"],
            fig5_ragged_alone_bitwise=f["ragged_alone_bitwise"])
    return {"rows": rows, "headline": headline}


FAULT_ARMS = (("clean", {}),
              ("corrupt10_guarded", dict(faults="corrupt", fault_rate=0.10)),
              ("corrupt10_unguarded", dict(faults="corrupt", fault_rate=0.10,
                                           guard=False)),
              ("corrupt30_guarded", dict(faults="corrupt", fault_rate=0.30)),
              ("drop50_q0", dict(faults="drop", fault_rate=0.50)),
              ("drop50_q60", dict(faults="drop", fault_rate=0.50,
                                  quorum=0.60)),
              ("mixed10_guarded", dict(faults="mixed", fault_rate=0.10,
                                       quorum=0.25)))


def fault_tolerance(scale: BenchScale, device=None) -> dict:
    """The fault-tolerance study (``benchmarks.run.fault_tolerance``):
    accuracy and cost of guarded against unguarded aggregation under
    corrupted uploads, quorum-gated sync under heavy upload loss and a
    mixed arm, seed 7, Theorem-3 plans; plus its two exactness claims —
    an empty FaultSchedule with the guard on and quorum 0.5 gives the
    clean run bit for bit, and a run checkpointed and stopped at the
    mid-horizon window boundary, then resumed, gives the uninterrupted
    run bit for bit. The horizon is floored at T = 60, as the
    reference's study does: fault statistics need windows."""
    device = resolve_device(device)
    scale = dataclasses.replace(scale, T=max(scale.T, 60))
    scenarios = [make_scenario(scale, key={"arm": arm},
                               error_model="discard", seed=7, **kw)
                 for arm, kw in FAULT_ARMS]
    plans = solve_scenario_plans(scenarios, iters=300, seed=0,
                                 device=device)
    full = run_scenarios(scenarios, scale, plans=plans, engine="scan",
                         device=device)
    rows = [{"arm": r["arm"], "acc": r["acc"],
             "avg_active": r["avg_active"],
             "cost_total": r["cost"]["total"],
             "fault_summary": r.get("fault_summary"),
             "quorum_skips": r.get("quorum_skips")} for r in full]

    data = dataset(scale.n_train, scale.n_test)
    sc0 = scenarios[0]

    def run0(**kw):
        return F.run_network_aware(sc0.cfg, data, sc0.traces, sc0.adj,
                                   plans[0], streams=sc0.streams,
                                   engine="scan", device=device, **kw)

    clean = run0()
    noop = run0(faults=fl.FaultSchedule(scale.T, sc0.cfg.n, scale.tau),
                guard=True, quorum=0.5)
    clean_noop_bitwise = bool(
        _bitwise(clean, noop)
        and np.array_equal(np.asarray(clean["H_agg"]),
                           np.asarray(noop["H_agg"])))
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.pt")
        half = (scale.T // 2 // scale.tau) * scale.tau or scale.tau
        part = run0(checkpoint_path=ck, stop_after=half)
        res = run0(resume=ck)
        resume_bitwise = bool(part.get("stopped_at") == half
                              and _bitwise(res, clean))

    by = {r["arm"]: r for r in rows}
    acc_clean = by["clean"]["acc"]
    return {"rows": rows, "headline": {
        "acc_clean": acc_clean,
        "acc_guarded_c10": by["corrupt10_guarded"]["acc"],
        "acc_unguarded_c10": by["corrupt10_unguarded"]["acc"],
        "acc_guarded_c30": by["corrupt30_guarded"]["acc"],
        "guard_within_2pp": bool(
            by["corrupt10_guarded"]["acc"] >= acc_clean - 0.02),
        "unguarded_near_random": bool(
            by["corrupt10_unguarded"]["acc"] <= 0.2),
        "quorum_skips_q0": by["drop50_q0"]["quorum_skips"],
        "quorum_skips_q60": by["drop50_q60"]["quorum_skips"],
        "clean_noop_bitwise": clean_noop_bitwise,
        "resume_bitwise": resume_bitwise}}


# ---------------------------------------------------------------------------
# The sparse O(E) plane at fog scale (benchmarks.run's sparse_scale and
# hier_scale, composed from the port's functions)
# ---------------------------------------------------------------------------

SCALE_SIZES = (1024, 10_240, 102_400)
SCALE_T_PLAN, SCALE_DEG, SCALE_T_TRAIN = 16, 8, 50


def _scale_sizes(scale: BenchScale) -> list[int]:
    if not scale.max_n:
        return list(SCALE_SIZES)
    return [n for n in SCALE_SIZES if n <= scale.max_n] or [scale.max_n]


def _scale_data():
    """The scale benches' random 4096/512-image dataset and the
    generator after it (the support is drawn from it next)."""
    rng = np.random.default_rng(0)
    x_tr = rng.random((4096, 28, 28)).astype(np.float32)
    y_tr = rng.integers(0, 10, 4096)
    x_te = rng.random((512, 28, 28)).astype(np.float32)
    y_te = rng.integers(0, 10, 512)
    return (x_tr, y_tr, x_te, y_te), rng


def _dense_floor(n: int) -> int:
    """The smallest dense (n, n) numpy array: bool at fog scale,
    float64 below 32,768 devices."""
    return n * n * (1 if n >= 32_768 else 8)


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _device_peak(device):
    """``torch.cuda.max_memory_allocated`` since the last
    :func:`_reset_peak` on a card, None on the CPU."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def _check_device_peak(tag: str, peak, n: int) -> None:
    """The card never holds a float32 (n, n) array's worth of memory."""
    if peak is not None and n >= 8_192:
        assert peak < 4 * n * n, (
            f"{tag}: the card's peak {peak} bytes >= {4 * n * n}, the "
            f"size of a float32 (n={n})² array")


def sparse_scale(scale: BenchScale, device=None, *,
                 keep: dict | None = None) -> dict:
    """The sparse O(E) network plane at fog scale: (a) edge-list churn
    schedule, per-edge costs, the O(E) Theorem-3 rule, realization and
    the window-rate prediction at n ∈ {1024, 10,240, 102,400} (capped
    by ``scale.max_n``), with the dense numpy oracle at the smallest n:
    the plans equal (and the plan of the kernel-1 backend on a card),
    the predictions equal, the sparse path at least 5× faster; (b) a
    T = 50 churn run at the largest n on flat streams through the scan
    engine, under the tracemalloc guard that no numpy (n, n) array was
    made (asserted from 8192 devices), and on a card under the guard
    that its peak stays below a float32 (n, n) array. ``keep``, when
    given, receives the run's schedule, costs, plan, streams and
    history, for a caller that checks them further."""
    import tracemalloc

    device = resolve_device(device)
    sizes = _scale_sizes(scale)
    T_PLAN, DEG = SCALE_T_PLAN, SCALE_DEG

    def sparse_plan(n, with_mem=False):
        rng = np.random.default_rng(0)
        src, dst = topo.random_sparse_edges(n, DEG, rng)
        sched = topo.churn_schedule_edges(
            n, src, dst, T_PLAN, 0.05, 0.2, np.random.default_rng(7))
        etr = synthetic_edge_costs(n, T_PLAN, src, dst,
                                   np.random.default_rng(1))
        if with_mem:
            tracemalloc.start()
        t = time.perf_counter()
        plan = mv.realize_plan(mv.greedy_linear(etr, sched), sched)
        pred = est.predict_schedule(sched)
        wall = time.perf_counter() - t
        peak = None
        if with_mem:
            _, peak = tracemalloc.get_traced_memory()
            tracemalloc.stop()
        return plan, pred, wall, peak, (src, dst, etr)

    rows = []
    for n in sizes:
        plan, pred, wall, peak, _ = sparse_plan(n, with_mem=True)
        rows.append({"n": n, "T": T_PLAN, "edges": len(plan.edges),
                     "sparse_s": wall, "sparse_peak_bytes": peak,
                     "dense_tensor_bytes": T_PLAN * n * n * 8,
                     "peak_over_nn": peak / (n * n)})

    # the dense oracle at the smallest n: the same support, costs
    # (per-edge streams scattered onto (T, n, n)) and churn seed
    n0 = sizes[0]
    plan_s, pred_s, sparse_s, _, (src, dst, etr) = sparse_plan(n0)
    # foglint: disable=dense-materialization -- sparse_scale's dense numpy oracle, built at the smallest n only
    A = np.zeros((n0, n0), bool)
    A[src, dst] = True
    c_link = np.zeros((T_PLAN, n0, n0))
    c_link[:, etr.src, etr.indices] = etr.c_link
    tr = CostTraces(c_node=etr.c_node, c_link=c_link, f_err=etr.f_err,
                    cap_node=etr.cap_node,
                    cap_link=np.full((T_PLAN, n0, n0), np.inf))
    sched_d = churn_schedule(A, T_PLAN, 0.05, 0.2, np.random.default_rng(7))
    t = time.perf_counter()
    plan_d = mv.realize_plan(mv.greedy_linear(tr, sched_d, backend="numpy"),
                             sched_d)
    pred_d = est.predict_schedule(sched_d)
    dense_s = time.perf_counter() - t
    # the device backend (kernel 1 on a card from n = 256, numpy on the
    # CPU) plans the same network: equal plans, not timed
    plan_k = mv.realize_plan(mv.greedy_linear(tr, sched_d, device=device),
                             sched_d)
    identical = bool(mv.plans_equal(plan_s, plan_d))
    kernel_identical = bool(mv.plans_equal(plan_k, plan_d))
    pred_match = all(
        np.array_equal(a, b) for t_ in range(T_PLAN)
        for a, b in zip(pred_s.edges_at(t_), pred_d.edges_at(t_)))
    speedup = dense_s / max(sparse_s, 1e-12)
    assert identical, "sparse plan diverged from the dense oracle"
    assert kernel_identical, "the device backend's plan diverged from numpy"
    assert pred_match, "sparse prediction diverged from the dense oracle"
    assert speedup >= 5.0, (
        f"sparse planning only {speedup:.1f}x faster than the dense "
        f"oracle at n={n0} (acceptance floor is 5x)")

    # end to end at the largest n: T = 50 churn on flat streams; the
    # traced numpy peak would hold any (n, n) array made on the way
    n_big, T_tr, tau = sizes[-1], SCALE_T_TRAIN, 10
    data, rng = _scale_data()
    src, dst = topo.random_sparse_edges(n_big, DEG, rng)
    _reset_peak(device)
    parts = {}
    tracemalloc.start()
    t = t_all = time.perf_counter()
    sched = topo.churn_schedule_edges(
        n_big, src, dst, T_tr, 0.05, 0.2, np.random.default_rng(7))
    parts["schedule_s"], t = time.perf_counter() - t, time.perf_counter()
    etr = synthetic_edge_costs(n_big, T_tr, src, dst,
                               np.random.default_rng(1))
    parts["costs_s"], t = time.perf_counter() - t, time.perf_counter()
    plan = mv.realize_plan(mv.greedy_linear(etr, sched), sched)
    parts["plan_s"], t = time.perf_counter() - t, time.perf_counter()
    flat = pl.poisson_streams_flat(n_big, T_tr, data[1],
                                   rng=np.random.default_rng(3),
                                   mean_per_round=1.0)
    parts["streams_s"], t = time.perf_counter() - t, time.perf_counter()
    cfg = F.FedConfig(n=n_big, T=T_tr, tau=tau, eta=0.1, model="linear",
                      seed=0)
    hist = F.run_network_aware(cfg, data, etr, None, plan, streams=flat,
                               schedule=sched, engine="scan", device=device)
    synchronize(device)
    parts["run_s"] = time.perf_counter() - t
    train_s = time.perf_counter() - t_all
    _, train_peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    dev_peak = _device_peak(device)
    dense_floor = _dense_floor(n_big)
    no_dense = bool(train_peak < dense_floor)
    if n_big >= 8_192:
        assert no_dense, (
            f"end-to-end peak {train_peak} bytes >= {dense_floor} — a "
            f"dense (n={n_big})² array fits under the traced peak")
    _check_device_peak("sparse_scale train", dev_peak, n_big)
    if keep is not None:
        keep.update(schedule=sched, costs=etr, plan=plan, streams=flat,
                    hist=hist, data=data)
    return {
        "rows": rows,
        "dense_oracle": {"n": n0, "dense_s": dense_s, "sparse_s": sparse_s},
        "train": {"n": n_big, "T": T_tr, "tau": tau,
                  "samples": int(flat.idx.shape[0]),
                  "max_points": hist["max_points"],
                  "train_s": train_s, "parts": parts,
                  "train_peak_bytes": train_peak,
                  "device_peak_bytes": dev_peak,
                  "nn_bytes": n_big * n_big,
                  "test_acc": hist["test_acc"],
                  "final_acc": hist["test_acc"][-1]},
        "headline": {
            "n_max": sizes[-1],
            "plan_speedup_vs_dense": speedup,
            "plans_identical": identical,
            "kernel_plan_identical": kernel_identical,
            "predictions_identical": bool(pred_match),
            "train_n": n_big,
            "train_s": train_s,
            "train_peak_over_nn": train_peak / (n_big * n_big),
            "no_dense_nn_materialized": no_dense,
            "final_acc": hist["test_acc"][-1]}}


def hier_scale(scale: BenchScale, device=None, *,
                keep: dict | None = None) -> dict:
    """Tiered aggregation at fog scale: a 3-tier tree (n/100 gateways,
    n/3200 regions, one cloud; τ = 5, 10, 20) over n = 102,400 devices
    (capped by ``scale.max_n``) trains a T = 50 churn run on flat
    streams, with movement solved within tier-1 gateways and eq. (4)
    composed up the tree through the segment-reduce kernel on a card,
    against the flat plane at the same τ_0. The tracemalloc no-(n, n)
    guard holds at every build phase and both trainings (from 8192
    devices), no movement edge crosses a gateway, the cross-tier bytes
    lie below the flat plane's (from 10,240 devices), and an L = 1
    tree is the flat scan bit for bit. The tiers' segment layouts are
    built before the timed run (``tier_segments_s``). ``keep`` as in
    :func:`sparse_scale`, with both histories and the tree."""
    import tracemalloc

    device = resolve_device(device)
    n_big = min(SCALE_SIZES[-1], scale.max_n or SCALE_SIZES[-1])
    T_tr, DEG = SCALE_T_TRAIN, SCALE_DEG
    taus = (5, 10, 20)
    g1, g2 = max(2, n_big // 100), max(1, n_big // 3200)
    tree = hr.TierTree.balanced(n_big, (g1, g2, 1), taus)
    dense_floor = _dense_floor(n_big)
    peaks = {}

    def guarded(tag, fn):
        tracemalloc.start()
        out = fn()
        _, pk = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        peaks[tag] = pk
        if n_big >= 8_192:
            assert pk < dense_floor, (
                f"{tag}: peak {pk} bytes >= {dense_floor} — a dense "
                f"(n={n_big})² array fits under the traced peak")
        return out

    data, rng = _scale_data()
    src, dst = topo.random_sparse_edges(n_big, DEG, rng)
    sched = guarded("tier1_schedule", lambda: topo.churn_schedule_edges(
        n_big, src, dst, T_tr, 0.05, 0.2, np.random.default_rng(7),
        tau=taus[0], node_offset=1))
    etr = guarded("tier1_costs", lambda: synthetic_edge_costs(
        n_big, T_tr, src, dst, np.random.default_rng(1)))
    plan_h = guarded("tier1_movement", lambda: hr.solve_tier_movement(
        tree, etr, sched, device=device))
    e = plan_h.edges
    off = e.src != e.dst
    cross = int((tree.parents[0][e.src[off]]
                 != tree.parents[0][e.dst[off]]).sum())
    assert cross == 0, f"{cross} movement edges cross a gateway boundary"
    anc = tree.ancestors()
    for lv in range(2, tree.levels + 1):
        guarded(f"tier{lv}_staging",
                lambda lv=lv: np.bincount(
                    anc[lv - 1], minlength=tree.group_counts[lv - 1]))
    widths = [math.prod(shape)
              for shape in mm.MODELS["linear"][0]().values()]
    traffic = guarded("tier_traffic",
                      lambda: hr.tier_traffic(tree, sum(widths)))
    if n_big >= 10_240:
        assert (traffic["cross_tier_bytes_per_window"]
                < traffic["flat_bytes_per_window"]), traffic

    flat = pl.poisson_streams_flat(n_big, T_tr, data[1],
                                   rng=np.random.default_rng(3),
                                   mean_per_round=1.0)
    cfg = F.FedConfig(n=n_big, T=T_tr, tau=taus[0], eta=0.1,
                      model="linear", seed=0)
    t = time.perf_counter()
    eng.tier_segments(tree, device)
    synchronize(device)
    seg_s = time.perf_counter() - t

    _reset_peak(device)
    launches0 = sr.launches
    t = time.perf_counter()
    hist_h = guarded("train_hier", lambda: F.run_network_aware(
        cfg, data, etr, None, plan_h, streams=flat, schedule=sched,
        engine="scan", hierarchy=tree, device=device))
    synchronize(device)
    hier_s = time.perf_counter() - t
    seg_launches = sr.launches - launches0
    peak_h = _device_peak(device)
    _check_device_peak("hier_scale train_hier", peak_h, n_big)

    # the flat plane at the same τ_0: movement over the full support,
    # every upload to one server each window
    t = time.perf_counter()
    plan_f = guarded("flat_movement", lambda: mv.realize_plan(
        mv.greedy_linear(etr, sched), sched))
    flat_plan_s = time.perf_counter() - t
    _reset_peak(device)
    t = time.perf_counter()
    hist_f = guarded("train_flat", lambda: F.run_network_aware(
        cfg, data, etr, None, plan_f, streams=flat, schedule=sched,
        engine="scan", device=device))
    synchronize(device)
    flat_s = time.perf_counter() - t
    peak_f = _device_peak(device)
    _check_device_peak("hier_scale train_flat", peak_f, n_big)

    l1_bitwise = l1_collapse_bitwise(data, taus[0], device)
    assert l1_bitwise, "L=1 TierTree diverged from the flat scan"

    if keep is not None:
        keep.update(schedule=sched, costs=etr, plan=plan_h, streams=flat,
                    hist=hist_h, hist_flat=hist_f, tree=tree, data=data)
    peak_all = max(peaks.values())
    return {
        "tiers": {"group_counts": list(tree.group_counts),
                  "taus": list(tree.taus),
                  "widest_bucket": tree.widest_bucket,
                  "mesh_axes": mesh_lib.tier_mesh_axes(
                      tree, mesh_lib.world_size())},
        "traffic": traffic,
        "peaks_bytes": peaks,
        "device_peak_bytes": {"train_hier": peak_h, "train_flat": peak_f},
        "train": {"n": n_big, "T": T_tr,
                  "samples": int(flat.idx.shape[0]),
                  "max_points": hist_h["max_points"],
                  "tier_segments_s": seg_s, "hier_s": hier_s,
                  "flat_plan_s": flat_plan_s, "flat_s": flat_s,
                  "segment_launches": seg_launches,
                  "tier_agg_level": hist_h["tier_agg_level"],
                  "acc_hier": hist_h["test_acc"],
                  "acc_flat": hist_f["test_acc"]},
        "headline": {
            "n": n_big,
            "levels": tree.levels,
            "rounds_per_s_hier": T_tr / hier_s,
            "rounds_per_s_flat": T_tr / flat_s,
            "cross_tier_bytes_per_window":
                traffic["cross_tier_bytes_per_window"],
            "flat_window_bytes": traffic["flat_bytes_per_window"],
            "cross_over_flat": traffic["cross_over_flat"],
            "cross_gateway_edges": cross,
            "train_peak_over_nn": peak_all / (n_big * n_big),
            "no_dense_nn_materialized": bool(peak_all < dense_floor),
            "l1_collapse_bitwise": bool(l1_bitwise),
            "final_acc_hier": hist_h["test_acc"][-1],
            "final_acc_flat": hist_f["test_acc"][-1]}}


def l1_collapse_bitwise(data, tau: int, device) -> bool:
    """The L = 1 claim at n = 64 under churn on flat streams: a one-tier
    tree's history is the flat scan's bit for bit."""
    n_s = 64
    src, dst = topo.random_sparse_edges(n_s, 4, np.random.default_rng(2))
    sched = topo.churn_schedule_edges(n_s, src, dst, 20, 0.1, 0.3,
                                      np.random.default_rng(7), tau=tau)
    flat = pl.poisson_streams_flat(n_s, 20, data[1],
                                   rng=np.random.default_rng(3),
                                   mean_per_round=2.0)
    etr = synthetic_edge_costs(n_s, 20, src, dst, np.random.default_rng(1))
    plan = mv.realize_plan(mv.greedy_linear(etr, sched), sched)
    cfg = F.FedConfig(n=n_s, T=20, tau=tau, eta=0.1, model="linear",
                      seed=0)
    kw = dict(streams=flat, schedule=sched, engine="scan", device=device)
    h1 = F.run_network_aware(cfg, data, etr, None, plan,
                             hierarchy=hr.TierTree.balanced(n_s, (1,),
                                                            (tau,)), **kw)
    h0 = F.run_network_aware(cfg, data, etr, None, plan, **kw)
    return all(np.array_equal(np.asarray(h1[k]), np.asarray(h0[k]))
               for k in ("device_loss", "test_loss", "test_acc", "H_agg"))


TABLES = {"table2": table2_accuracy, "table3": table3_settings,
          "table4": table4_error_costs, "table5": table5_dynamics,
          "fig5": fig5_nodes, "fig6": fig6_connectivity,
          "fig7": fig7_aggregation, "fig8": fig8_topologies,
          "fig9": fig9_exit, "fig10": fig10_entry,
          "thm5": thm5_value_of_offloading, "dynamics": network_dynamics,
          "prediction": network_prediction, "faults": fault_tolerance,
          "sparse_scale": sparse_scale, "hier_scale": hier_scale,
          "scenario_batched": scenario_batched}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="table3,table4",
                    help=f"comma-separated subset of {list(TABLES)}")
    ap.add_argument("--quick", action="store_true",
                    help="the reference's CI scale (8,000 samples, T=20)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-n", type=int, default=0,
                    help="cap on sparse_scale's and hier_scale's n "
                         "(0: their full 102,400)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="warm repeats of scenario_batched's sweeps")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the JSON here (never under results/)")
    args = ap.parse_args(argv)
    names = [s for s in args.only.split(",") if s]
    unknown = sorted(set(names) - set(TABLES))
    if unknown:
        raise SystemExit(f"unknown table(s) {unknown}; choose from "
                         f"{sorted(TABLES)}")
    results = Path(__file__).resolve().parents[3] / "results"
    if args.out and results in Path(args.out).resolve().parents:
        raise SystemExit(f"--out {args.out}: results/ holds the "
                         "reference's artifacts; write elsewhere")
    scale = dataclasses.replace(QUICK if args.quick else DEFAULT,
                                max_n=args.max_n, repeats=args.repeat)
    device = resolve_device(args.device)
    out = {"device": str(device), "scale": dataclasses.asdict(scale)}
    for name in names:
        t0 = time.perf_counter()
        out[name] = TABLES[name](scale, device)
        out[name]["seconds"] = time.perf_counter() - t0
    text = json.dumps(out, default=float, indent=2)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return out


if __name__ == "__main__":
    main()
