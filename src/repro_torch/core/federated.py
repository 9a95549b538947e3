"""Network-aware federated learning (paper §III-B + §V).

``run_network_aware`` prepares the sample streams on the host (movement
routing, pad sizing) and hands the staged rounds to the training engine
in :mod:`repro_torch.core.engine`: ``"scan"`` (the whole horizon on the
device, default), ``"legacy"`` (the per-round oracle), ``"batched"``
(the sweep engine with one scenario), ``"sharded"`` (that slice with
the fog devices split across the ranks of a data mesh, eq. (4) an
all-reduce) or ``"auto"`` (``engine.resolve_engine``: sharded when the
default process group has more than one rank, scan otherwise). With
``hierarchy=`` a
:class:`repro_torch.core.hierarchy.TierTree` composes eq. (4) up its
tiers (``"hierarchical"``, on the scan substrate).
``run_network_aware_batched`` trains a whole bucket of sweep points at
once through the sweep engine.

Baselines: ``run_centralized`` (all data at one node) and
``run_federated`` (no movement, G_i = D_i), the Table II rows.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import movement as mv
from repro_torch.core import sanitize as sz
from repro_torch.core.costs import CostTraces
from repro_torch.core.hierarchy import TierTree
from repro_torch.core.schedule import NetworkSchedule
from repro_torch.core.topology import churn_schedule
from repro_torch.data import pipeline as pl
from repro_torch.device import resolve_device
from repro_torch.models import mnist as mm


@dataclasses.dataclass
class FedConfig:
    n: int = 10
    T: int = 100
    tau: int = 10
    eta: float = 0.01
    model: str = "cnn"
    iid: bool = True
    seed: int = 0
    max_points: int = 0          # pad size; 0 -> auto from streams
    p_exit: float = 0.0
    p_entry: float = 0.0


def run_network_aware(cfg: FedConfig, data, traces: CostTraces,
                      adj: np.ndarray | None, plan: mv.MovementPlan,
                      streams: pl.FogStreams | pl.FlatStreams | None
                      = None,
                      activity: np.ndarray | None = None,
                      engine: str = "scan",
                      schedule: NetworkSchedule | None = None,
                      params: dict | None = None,
                      hierarchy: TierTree | None = None,
                      faults=None, guard: bool = True,
                      quorum: float = 0.0,
                      checkpoint_path: str | None = None,
                      checkpoint_every: int = 1,
                      resume: str | None = None,
                      stop_after: int | None = None,
                      mesh=None, prepared=None, sanitize=False,
                      device=None) -> dict:
    """Train with a given movement plan. Returns the history dict.

    ``adj`` is accepted for signature symmetry with the planning layer;
    training never reads it. ``schedule`` supplies the (T, n) active
    mask; ``activity`` overrides it. ``params`` — optional initial
    global parameters (port layout, e.g. from
    ``models.convert.params_from_jax``); by default they are drawn from
    a ``torch.Generator`` seeded with ``cfg.seed``. ``hierarchy`` — a
    tier tree over the ``cfg.n`` devices whose first period is
    ``cfg.tau``; engines ``"auto"``, ``"scan"`` and ``"hierarchical"``
    then run it (an L=1 tree is the flat scan), and the history gains
    ``"hierarchy"``. ``device`` defaults to ``cuda``.

    ``faults`` — optional :class:`repro_torch.core.faults.
    FaultSchedule` (unannounced failures): crash outages stop data
    collection and training like unplanned churn, and straggled,
    dropped and corrupted uploads are injected inside the engine's
    aggregation, guarded by ``guard`` (non-finite uploads dropped, H
    renormalized over the survivors) and gated by ``quorum`` (windows
    whose surviving-upload fraction falls below it carry the previous
    global forward). The history gains ``fault_summary``,
    ``agg_survivors`` and ``agg_quorum_ok``.

    ``checkpoint_path``, ``checkpoint_every``, ``resume`` and
    ``stop_after`` — window-boundary checkpointing of the scan engine
    (see :func:`repro_torch.core.engine.run_rounds_scan`); other
    engines refuse them.

    ``streams`` may be a :class:`repro_torch.data.pipeline.FlatStreams`
    (the sparse staging path for 10⁵ devices: masking, routing and
    staging as array operations over the sample table); the scan and
    hierarchical engines take it, the legacy engine refuses it.

    ``engine="batched"`` runs the sweep engine with S = 1
    (:func:`repro_torch.core.engine.run_rounds_batched_single`: exact
    pad sizes, eq. (4) as a sequential sum) and ``engine="sharded"``
    its slice over a data mesh; ``mesh`` is passed to either (None or
    "auto": one card for "batched", ``launch/mesh.make_data_mesh`` for
    "sharded"). ``prepared`` — the
    ``(streams, processed, act_all, max_pts)`` of an earlier
    :func:`_prepare_streams` call, so a sweep that prepared the
    streams to price a bucket does not prepare them twice.

    ``sanitize`` — ``True`` or a :class:`repro_torch.core.sanitize.
    SanitizeConfig`: runs the engine under the runtime checkers (NaN
    checks, a transfer guard around the round loops, and a
    warm-recompile watchdog when ``expect_warm`` is set). A smoke
    harness: every eager op is checked on the host, so don't time
    under it.
    """
    device = resolve_device(device)
    if hierarchy is not None:
        if engine not in ("auto", "scan", "hierarchical"):
            raise ValueError("hierarchy= runs on the scan substrate; "
                             f"got engine={engine!r}")
        if hierarchy.n != cfg.n:
            raise ValueError(f"tier tree has n={hierarchy.n} devices "
                             f"but cfg.n={cfg.n}")
        if hierarchy.taus[0] != cfg.tau:
            raise ValueError(f"tier tree aggregates its first tier "
                             f"every {hierarchy.taus[0]} rounds but "
                             f"cfg.tau={cfg.tau}")
        engine = "hierarchical"
    elif engine == "hierarchical":
        raise ValueError("engine='hierarchical' needs a hierarchy= "
                         "TierTree")
    engine = eng.resolve_engine(engine)
    runners = {"scan": eng.run_rounds_scan, "legacy": eng.run_rounds_legacy,
               "hierarchical": functools.partial(
                   eng.run_rounds_hierarchical, tree=hierarchy),
               "batched": functools.partial(
                   eng.run_rounds_batched_single, mesh=mesh),
               "sharded": functools.partial(
                   eng.run_rounds_sharded,
                   mesh=None if mesh == "auto" else mesh)}
    if engine not in runners:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{sorted(runners)} or 'auto'")
    if (isinstance(streams, pl.FlatStreams)
            and engine not in ("scan", "hierarchical")):
        raise ValueError("FlatStreams sparse staging is a scan-engine "
                         f"feature; got engine={engine!r}")
    engine_kw = {}
    if faults is not None:
        engine_kw = dict(faults=faults, guard=guard, quorum=quorum)
    if (checkpoint_path is not None or resume is not None
            or stop_after is not None):
        if engine != "scan":
            raise ValueError("checkpoint/resume is a scan-engine feature; "
                             f"got engine={engine!r}")
        engine_kw.update(checkpoint_path=checkpoint_path,
                        checkpoint_every=checkpoint_every, resume=resume,
                        stop_after=stop_after)
    x_tr, y_tr, x_te, y_te = data
    if prepared is not None:
        streams, processed, act_all, max_pts = prepared
    else:
        streams, processed, act_all, max_pts = _prepare_streams(
            cfg, data, plan, streams, activity, schedule, faults)
    apply_fn = mm.MODELS[cfg.model][1]
    params = _initial_params(cfg, params, device)

    hist = _history_base(cfg, y_tr, streams, processed, act_all)
    hist["max_points"] = max_pts
    if hierarchy is not None:
        hist["hierarchy"] = {"levels": hierarchy.levels,
                             "group_counts": list(hierarchy.group_counts),
                             "taus": list(hierarchy.taus)}
    if faults is not None:
        hist["fault_summary"] = faults.summary()
    with sz.sanitized(sanitize):
        hist.update(runners[engine](apply_fn, params, x_tr, y_tr, x_te,
                                    y_te, processed, act_all, cfg.tau,
                                    cfg.eta, max_pts, device=device,
                                    **engine_kw))
    return hist


def _initial_params(cfg: FedConfig, params, device) -> dict:
    """``params`` on ``device``, or the model's parameters drawn from a
    ``torch.Generator`` seeded with ``cfg.seed``."""
    if params is None:
        specs_fn = mm.MODELS[cfg.model][0]
        return mm.init_params(
            specs_fn(), torch.Generator().manual_seed(cfg.seed),
            device=device)
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device)
            for k, v in params.items()}


def run_network_aware_batched(cfgs: list[FedConfig], data,
                              plans: list[mv.MovementPlan], *,
                              streams: list | None = None,
                              activities: list | None = None,
                              schedules: list | None = None,
                              mesh="auto", bucket: str = "pow2",
                              staging: str = "dense",
                              prepared: list | None = None,
                              faults: list | None = None,
                              guard: bool = True, quorum: float = 0.0,
                              params: list | None = None,
                              device=None) -> list[dict]:
    """Train a whole bucket of sweep points at once: each point's host
    preparation (:func:`_prepare_streams`, the same code as
    :func:`run_network_aware`, so the streams are those of a loop over
    the points), then :func:`repro_torch.core.engine.
    run_rounds_batched`, which pads every point to the bucket's shape
    and trains them together. The points must share the dataset,
    model, η and τ (group a sweep first: :func:`repro_torch.launch.
    tables.scenario_bucket_key`).

    ``staging``: "dense" pads every point to the bucket's (n_b, P_b)
    slab; "ragged" stages chunk-row tables. ``prepared`` — one
    ``_prepare_streams`` result per point, as a cost-model dispatch
    that priced the bucket hands them down. ``faults`` — per-point
    FaultSchedules or None, under the shared ``guard`` and ``quorum``.
    ``params`` — optional per-point initial parameters (as in
    :func:`run_network_aware`). ``mesh``: None (one card), a 1-D
    "data" ``DeviceMesh`` (the device axis sharded across its ranks), or
    "auto": a data mesh when the default process group has more than
    one rank, else one card.
    ``device`` defaults to ``cuda``. Returns one history per point, the
    contract of :func:`run_network_aware`."""
    device = resolve_device(device)
    S = len(cfgs)
    if not (S == len(plans)
            and all(lst is None or len(lst) == S
                    for lst in (streams, activities, schedules, faults,
                                params, prepared))):
        raise ValueError("cfgs/plans/streams/activities/schedules/"
                         "faults/params/prepared must have one entry per "
                         "scenario")
    head = (cfgs[0].model, cfgs[0].eta, cfgs[0].tau)
    for cfg in cfgs[1:]:
        if (cfg.model, cfg.eta, cfg.tau) != head:
            raise ValueError(
                "a batched bucket must share (model, eta, tau); got "
                f"{(cfg.model, cfg.eta, cfg.tau)} vs {head}")
    x_tr, y_tr, x_te, y_te = data
    pl.reset_padding_warnings()          # inflation warnings: once a sweep
    processed_list, act_list, max_list, hists = [], [], [], []
    for b, cfg in enumerate(cfgs):
        f = faults[b] if faults is not None else None
        if prepared is not None:
            st, processed, act_all, max_pts = prepared[b]
        else:
            st, processed, act_all, max_pts = _prepare_streams(
                cfg, data, plans[b],
                streams[b] if streams is not None else None,
                activities[b] if activities is not None else None,
                schedules[b] if schedules is not None else None, f)
        processed_list.append(processed)
        act_list.append(act_all)
        max_list.append(max_pts)
        h = _history_base(cfg, y_tr, st, processed, act_all)
        h["max_points"] = max_pts
        if f is not None:
            h["fault_summary"] = f.summary()
        hists.append(h)
    params_list = [_initial_params(cfg, None if params is None
                                   else params[b], device)
                   for b, cfg in enumerate(cfgs)]
    outs = eng.run_rounds_batched(
        mm.MODELS[cfgs[0].model][1], params_list, x_tr, y_tr, x_te, y_te,
        processed_list, act_list, cfgs[0].tau, cfgs[0].eta, max_list,
        bucket=bucket, mesh=mesh, staging=staging, faults=faults,
        guard=guard, quorum=quorum, device=device)
    for hist, out in zip(hists, outs):
        hist.update(out)
    return hists


def _prepare_streams(cfg: FedConfig, data, plan, streams, activity,
                     schedule, faults=None):
    """Host-side data-plane prep: default streams, schedule→activity,
    fault-outage masking, inactive-collection zeroing, movement
    routing, pad sizing. A :class:`FlatStreams` is masked by one gather
    and routed by :func:`pipeline.apply_movement_flat`: nothing O(n²)
    on the way to the engine."""
    _, y_tr, _, _ = data
    rng = np.random.default_rng(cfg.seed)
    if streams is None:
        streams = pl.poisson_streams(cfg.n, cfg.T, y_tr, iid=cfg.iid,
                                     rng=rng)
    if schedule is not None:
        if (schedule.T, schedule.n) != (cfg.T, cfg.n):
            raise ValueError(
                f"schedule is (T={schedule.T}, n={schedule.n}) but the "
                f"run is (T={cfg.T}, n={cfg.n})")
        if activity is None:
            activity = schedule.activity()
    if faults is not None and faults.has_crashes:
        # a crashed device stops collecting and training like a churned
        # one, except that nobody announced it (no plan saw it coming)
        if (faults.T, faults.n) != (cfg.T, cfg.n):
            raise ValueError(
                f"fault schedule is (T={faults.T}, n={faults.n}) but "
                f"the run is (T={cfg.T}, n={cfg.n})")
        base = (np.asarray(activity, bool) if activity is not None
                else np.ones((cfg.T, cfg.n), bool))
        activity = base & faults.activity_mask()
    if isinstance(streams, pl.FlatStreams):
        if activity is not None:
            act = np.asarray(activity, bool)
            keep = act[streams.t, streams.dev]
            streams = pl.FlatStreams(t=streams.t[keep],
                                     dev=streams.dev[keep],
                                     idx=streams.idx[keep],
                                     n=streams.n, T=streams.T)
        processed = pl.apply_movement_flat(streams, plan, rng)
    else:
        if activity is not None:
            # inactive devices collect nothing (no-op for all-active
            # masks)
            for t, i in zip(*np.nonzero(~np.asarray(activity, bool))):
                streams.collected[t][i] = np.empty(0, np.int64)
        processed = pl.apply_movement(streams, plan, rng)
    max_pts = pl.pad_size(processed, cfg.max_points)
    act_all = (np.asarray(activity, bool) if activity is not None
               else np.ones((cfg.T, cfg.n), bool))
    return streams, processed, act_all, max_pts


def _history_base(cfg: FedConfig, y_tr, streams, processed,
                  act_all) -> dict:
    """History skeleton: rounds, Fig. 4b label-similarity diagnostics,
    activity masks and processed counts (the engine fills the rest).
    On flat streams the O(n²) label similarities are ``None``: a
    small-n figure, skipped at fog scale."""
    hist = {"round": list(range(cfg.T)), "sim_before": None,
            "sim_after": None}
    hist["active"] = [act_all[t].copy() for t in range(cfg.T)]
    if isinstance(processed, pl.FlatStreams):
        cnt = np.bincount(processed.cell_key(),
                          minlength=cfg.T * cfg.n).reshape(cfg.T, cfg.n)
        hist["processed_counts"] = [row for row in cnt]
        return hist
    col_labels = [np.concatenate([y_tr[ix] for row in streams.collected
                                  for ix in [row[i]]] or [np.empty(0, int)])
                  for i in range(cfg.n)]
    proc_labels = [np.concatenate([y_tr[processed[t][i]]
                                   for t in range(cfg.T)] or [np.empty(0, int)])
                   for i in range(cfg.n)]
    hist["sim_before"] = pl.label_similarity(col_labels)
    hist["sim_after"] = pl.label_similarity(proc_labels)
    hist["processed_counts"] = [[len(ix) for ix in processed[t]]
                                for t in range(cfg.T)]
    return hist


def run_centralized(cfg: FedConfig, data, steps: int | None = None,
                    batch: int = 600, params: dict | None = None,
                    device=None) -> dict:
    """All data processed at one node (Table II "Centralized"): plain
    SGD at ``cfg.eta`` on batches drawn without replacement from
    ``np.random.default_rng(cfg.seed)``, ``steps`` (default ``cfg.T``)
    of them. ``params`` as in :func:`run_network_aware`."""
    device = resolve_device(device)
    x_tr, y_tr, x_te, y_te = data
    specs_fn, apply_fn = mm.MODELS[cfg.model]
    if params is None:
        params = mm.init_params(
            specs_fn(), torch.Generator().manual_seed(cfg.seed),
            device=device)
    else:
        params = {k: torch.as_tensor(v, dtype=torch.float32).to(device)
                  .clone() for k, v in params.items()}
    steps = steps or cfg.T

    def tensors(x, y):
        return (torch.from_numpy(np.asarray(x, np.float32)).to(device),
                torch.from_numpy(np.asarray(y, np.int64)).to(device))

    rng = np.random.default_rng(cfg.seed)
    losses = []
    for _ in range(steps):
        idx = rng.choice(len(x_tr), batch, replace=False)
        x, y = tensors(x_tr[idx], y_tr[idx])
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = mm.ce_loss(apply_fn(p, x), y)
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            params = {k: v - cfg.eta * g
                      for (k, v), g in zip(p.items(), grads)}
        losses.append(loss.item())
    x, y = tensors(x_te, y_te)
    with torch.no_grad():
        logits = apply_fn(params, x)
        return {"test_acc": float(mm.accuracy(logits, y)),
                "test_loss": float(mm.ce_loss(logits, y)),
                "train_loss": losses}


def run_federated(cfg: FedConfig, data, **kw) -> dict:
    """No-movement baseline: G_i(t) = D_i(t)."""
    plan = mv.no_movement_plan(cfg.T, cfg.n)
    traces = kw.pop("traces", None)
    adj = kw.pop("adj", None)            # training never reads it
    if traces is None:
        from repro_torch.core.costs import synthetic_costs
        traces = synthetic_costs(cfg.n, cfg.T,
                                 np.random.default_rng(cfg.seed))
    return run_network_aware(cfg, data, traces, adj, plan, **kw)


def churn_activity(cfg: FedConfig, rng: np.random.Generator) -> np.ndarray:
    """(T, n) churn trace: the active mask of :func:`churn_schedule` at
    ``cfg.p_exit``/``cfg.p_entry`` with a sync every ``cfg.tau``."""
    # foglint: disable=dense-materialization -- legacy compat shim: churn_schedule takes a dense base adjacency by contract and every caller is small-n
    sched = churn_schedule(np.ones((cfg.n, cfg.n), bool), cfg.T,
                           cfg.p_exit, cfg.p_entry, rng, tau=cfg.tau)
    return sched.activity()
