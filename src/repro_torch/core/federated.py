"""Network-aware federated learning (paper §III-B + §V).

``run_network_aware`` prepares the sample streams on the host (movement
routing, pad sizing) and hands the staged rounds to the training engine
in :mod:`repro_torch.core.engine`: ``"scan"`` (the whole horizon on the
device, default), ``"legacy"`` (the per-round oracle) or ``"auto"``
(scan: the port runs on one card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import movement as mv
from repro_torch.core.costs import CostTraces
from repro_torch.core.schedule import NetworkSchedule
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


# engines of the reference not ported yet, with their ROADMAP.md item
_UNPORTED_ENGINES = {"batched": "queue 1 item 11 (sweep engine)",
                     "sharded": "queue 1 item 12 (multi-GPU)"}


def run_network_aware(cfg: FedConfig, data, traces: CostTraces,
                      adj: np.ndarray | None, plan: mv.MovementPlan,
                      streams: pl.FogStreams | None = None,
                      activity: np.ndarray | None = None,
                      engine: str = "scan",
                      schedule: NetworkSchedule | None = None,
                      params: dict | None = None,
                      device=None) -> dict:
    """Train with a given movement plan. Returns the history dict.

    ``adj`` is accepted for signature symmetry with the planning layer;
    training never reads it. ``schedule`` supplies the (T, n) active
    mask; ``activity`` overrides it. ``params`` — optional initial
    global parameters (port layout, e.g. from
    ``models.convert.params_from_jax``); by default they are drawn from
    a ``torch.Generator`` seeded with ``cfg.seed``. ``device`` defaults
    to ``cuda``.
    """
    device = resolve_device(device)
    if engine == "auto":
        engine = "scan"
    if engine in _UNPORTED_ENGINES:
        raise ValueError(f"engine={engine!r} is not ported yet (ROADMAP.md,"
                         f" {_UNPORTED_ENGINES[engine]})")
    runners = {"scan": eng.run_rounds_scan, "legacy": eng.run_rounds_legacy}
    if engine not in runners:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{sorted(runners)} or 'auto'")
    x_tr, y_tr, x_te, y_te = data
    streams, processed, act_all, max_pts = _prepare_streams(
        cfg, data, plan, streams, activity, schedule)

    specs_fn, apply_fn = mm.MODELS[cfg.model]
    if params is None:
        params = mm.init_params(
            specs_fn(), torch.Generator().manual_seed(cfg.seed),
            device=device)
    else:
        params = {k: torch.as_tensor(v, dtype=torch.float32).to(device)
                  for k, v in params.items()}

    hist = _history_base(cfg, y_tr, streams, processed, act_all)
    hist["max_points"] = max_pts
    hist.update(runners[engine](apply_fn, params, x_tr, y_tr, x_te, y_te,
                                processed, act_all, cfg.tau, cfg.eta,
                                max_pts, device=device))
    return hist


def _prepare_streams(cfg: FedConfig, data, plan, streams, activity,
                     schedule):
    """Host-side data-plane prep: default streams, schedule→activity,
    inactive-collection zeroing, movement routing, pad sizing."""
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
    if activity is not None:
        # inactive devices collect nothing (no-op for all-active masks)
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
    activity masks and processed counts (the engine fills the rest)."""
    hist = {"round": list(range(cfg.T))}
    hist["active"] = [act_all[t].copy() for t in range(cfg.T)]
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
