"""Imperfect-information estimation (paper §IV-A / §V-A) — numpy, host side.

Divide the horizon T into L windows T_1..T_L; within window l, the
optimizer sees the time-AVERAGED observations of D_i(t), c_i(t), c_ij(t),
C_i(t) from window l−1 (window 0 uses uninformative priors). The plan
solved on estimated traces is then executed — and costed — on the true
traces (settings C and E in Table III).

The same window averaging applies to the network itself (the
prediction plane): :func:`predict_schedule` learns per-window link and
device-activity rates from the observed history of a
:class:`~repro_torch.core.schedule.NetworkSchedule` and emits a
predicted schedule to plan against, while execution, costing and
``movement.realize_plan`` confront the plan with the true schedule.

A copy of :mod:`repro.core.estimator` with the same arithmetic, so the
same inputs give bitwise-equal estimates.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import schedule as _schedule_mod
from repro_torch.core.costs import CostTraces, EdgeCostTraces
from repro_torch.core.schedule import NetworkSchedule


# window count shared by every setting-C/E call site (traces and counts)
DEFAULT_WINDOWS = 5


def window_bounds(T: int, L: int) -> list[tuple[int, int]]:
    """Edges of the estimation windows: ``min(L, T)`` half-open
    ``(start, stop)`` ranges covering ``[0, T)``.

    The effective window count is clamped so every window holds at
    least one round — ``linspace`` with L > T produces duplicate
    integer edges, i.e. empty windows whose means are NaN."""
    if T <= 0:
        return []
    L = max(1, min(int(L), int(T)))
    edges = np.linspace(0, T, L + 1).astype(int)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(L)]


def _window_avg(arr: np.ndarray, T: int, L: int, prior: float) -> np.ndarray:
    """Window-l rows hold the mean of window l−1 (window 0: the prior).

    Empty-predecessor windows (impossible after the ``window_bounds``
    clamp, kept as a guard) backfill from the last non-empty window
    instead of emitting NaN rows."""
    out = np.empty_like(arr, dtype=float)
    bounds = window_bounds(T, L)
    last: np.ndarray | None = None
    for l, (a, b) in enumerate(bounds):
        if l == 0:
            out[a:b] = prior
        else:
            pa, pb = bounds[l - 1]
            if pb > pa:
                last = arr[pa:pb].mean(axis=0, keepdims=True)
            out[a:b] = last if last is not None else prior
    return out


def estimate_traces(traces: CostTraces, L: int = DEFAULT_WINDOWS,
                    prior: float = 0.5) -> CostTraces:
    """Window-averaged cost traces; infinite node capacities stay
    infinite, link capacities are observed passively (copied)."""
    T = traces.T
    finite = np.isfinite(traces.cap_node)
    cap_prior = (float(np.mean(traces.cap_node[finite])) if finite.any()
                 else 1e12)
    return CostTraces(
        c_node=_window_avg(traces.c_node, T, L, prior),
        c_link=_window_avg(traces.c_link, T, L, prior),
        f_err=_window_avg(traces.f_err, T, L, prior),
        cap_node=np.where(finite,
                          _window_avg(np.where(finite, traces.cap_node,
                                               cap_prior),
                                      T, L, cap_prior),
                          np.inf),
        cap_link=traces.cap_link.copy(),
    )


def estimate_counts(D: np.ndarray, L: int = DEFAULT_WINDOWS) -> np.ndarray:
    """Window-averaged data-arrival estimates D̂_i(t)."""
    T = D.shape[0]
    prior = float(D.mean()) if D.size else 1.0
    return _window_avg(D, T, L, prior)


# ---------------------------------------------------------------------------
# Prediction plane: window-averaged network estimation
# ---------------------------------------------------------------------------


def window_activity_rates(schedule: NetworkSchedule,
                          L: int = DEFAULT_WINDOWS) -> np.ndarray:
    """(W, n) observed per-window device-activity rates (W = min(L, T)):
    the fraction of the window's rounds each device was active."""
    act = schedule.activity().astype(float)
    return np.stack([act[a:b].mean(axis=0)
                     for a, b in window_bounds(schedule.T, L)])


def window_link_rates_edges(schedule: NetworkSchedule,
                            L: int = DEFAULT_WINDOWS
                            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-edge window availability rates over the schedule's union
    support: ``(src, dst, rates)``, ``rates`` (W, E) the fraction of
    each window's rounds the edge was up (churn-masked schedules fold
    endpoint exits in). Dense schedules go through ``to_edgelist``."""
    sched = (schedule if schedule.storage == "edgelist"
             else schedule.to_edgelist())
    indptr, indices = sched.union_csr()
    esrc = np.repeat(np.arange(sched.n, dtype=np.int64), np.diff(indptr))
    bounds = window_bounds(sched.T, L)
    live = sched.live_matrix()
    rates = np.zeros((len(bounds), indices.size))
    for w, (a, b) in enumerate(bounds):
        # the count of live rounds: integers, exact in float64
        rates[w] = live[a:b].sum(0)
        rates[w] /= max(b - a, 1)
    return esrc, indices, rates


def window_link_rates(schedule: NetworkSchedule,
                      L: int = DEFAULT_WINDOWS) -> np.ndarray:
    """(W, n, n) observed per-window link-availability rates, scattered
    from :func:`window_link_rates_edges`; raises above the dense-view
    size guard."""
    if schedule.n > _schedule_mod.DENSE_VIEW_MAX_N:
        raise RuntimeError(
            f"window_link_rates would materialize (W, {schedule.n}, "
            f"{schedule.n}); use window_link_rates_edges at this scale")
    esrc, edst, rates = window_link_rates_edges(schedule, L)
    out = np.zeros((rates.shape[0], schedule.n, schedule.n))
    out[:, esrc, edst] = rates
    return out


def predict_schedule(observed: NetworkSchedule, L: int = DEFAULT_WINDOWS,
                     *, mode: str = "threshold",
                     threshold: float = 0.5) -> NetworkSchedule:
    """Predicted :class:`NetworkSchedule` from the observed history.

    Window l's prediction is window l−1's observed availability rates;
    window 0 uses the round-0 truth. ``mode="threshold"`` keeps a link
    or device iff its previous-window rate ≥ ``threshold``;
    ``mode="expected"`` keeps anything observed at all (pair it with
    :func:`expected_cost_traces`). Dense observed schedules give
    event-list storage, edge-list ones edge-list piecewise storage, with
    the predicted active trace attached."""
    if mode not in ("threshold", "expected"):
        raise ValueError(f"unknown prediction mode {mode!r}; "
                         "expected 'threshold' or 'expected'")
    cut = threshold if mode == "threshold" else 1e-12
    bounds = window_bounds(observed.T, L)
    act_rates = window_activity_rates(observed, L)
    active = np.empty((observed.T, observed.n), bool)
    a0, b0 = bounds[0]
    active[a0:b0] = np.asarray(observed.active_at(0), bool)
    for w in range(1, len(bounds)):
        a, b = bounds[w]
        active[a:b] = act_rates[w - 1] >= cut
    if observed.storage == "edgelist":
        # window edge sets as masks over the union support (window 0:
        # the round-0 truth, edges_at(0))
        esrc, edst, link_rates = window_link_rates_edges(observed, L)
        keeps = [observed.live_matrix()[0]]
        for w in range(1, len(bounds)):
            keeps.append(link_rates[w - 1] >= cut)
        return NetworkSchedule.piecewise_support(observed.n, esrc, edst,
                                                 keeps, bounds,
                                                 active=active)
    link_rates = window_link_rates(observed, L)
    # foglint: disable=dense-materialization -- dense-storage branch: observed already holds (n, n) rounds (guarded by DENSE_VIEW_MAX_N); the edgelist branch above is the scale path
    adjs = [np.array(observed.adj_at(0), dtype=bool, copy=True)]
    for w in range(1, len(bounds)):
        adjs.append(link_rates[w - 1] >= cut)
    return NetworkSchedule.piecewise(adjs, bounds, active=active)


def expected_cost_traces(traces: CostTraces | EdgeCostTraces,
                         observed: NetworkSchedule,
                         L: int = DEFAULT_WINDOWS, *,
                         floor: float = 0.05
                         ) -> CostTraces | EdgeCostTraces:
    """Availability-weighted link costs for ``mode="expected"``
    planning: within window l ≥ 1 every link's ``c_link`` is scaled by
    1 / max(previous-window availability, ``floor``), the expected cost
    per delivered datapoint under a per-window Bernoulli link model;
    links never observed keep their cost. Dense :class:`CostTraces`
    scale (T, n, n); :class:`EdgeCostTraces` scale (T, E), the rates
    mapped onto the trace support through ``edge_ids``."""
    bounds = window_bounds(observed.T, L)
    if isinstance(traces, EdgeCostTraces):
        esrc, edst, rates = window_link_rates_edges(observed, L)
        eids = traces.edge_ids(esrc, edst)
        hit = eids >= 0
        c_link = np.array(traces.c_link, copy=True)
        for w in range(1, len(bounds)):
            scale = np.ones(traces.E)
            r = rates[w - 1][hit]
            scale[eids[hit]] = np.where(
                r > 0.0, 1.0 / np.maximum(r, floor), 1.0)
            a, b = bounds[w]
            c_link[a:b] *= scale[None, :]
        return dataclasses.replace(traces, c_link=c_link)
    rates = window_link_rates(observed, L)
    c_link = np.array(traces.c_link, copy=True)
    for w in range(1, len(bounds)):
        r = rates[w - 1]
        scale = np.where(r > 0.0, 1.0 / np.maximum(r, floor), 1.0)
        a, b = bounds[w]
        c_link[a:b] *= scale[None]
    return dataclasses.replace(traces, c_link=c_link)


def schedule_prediction_accuracy(predicted: NetworkSchedule,
                                 truth: NetworkSchedule) -> dict:
    """Per-round agreement between a predicted and the true schedule:
    link accuracy over the union of the two supports (links the
    prediction invents count as errors) and activity accuracy. Counted
    on edge keys: within the union support U, round t agrees on
    |U| − |P_t Δ Q_t| links."""
    assert (predicted.T, predicted.n) == (truth.T, truth.n)
    n = truth.n

    def keys(s: NetworkSchedule, t: int) -> np.ndarray:
        src, dst = s.edges_at(t)
        return np.unique(np.asarray(src, np.int64) * n
                         + np.asarray(dst, np.int64))

    rounds = [(keys(predicted, t), keys(truth, t))
              for t in range(truth.T)]
    support = np.unique(np.concatenate(
        [k for pq in rounds for k in pq] or [np.empty(0, np.int64)]))
    u = int(support.size)
    agree = total = 0.0
    for kp, kq in rounds:
        sym_diff = (kp.size + kq.size
                    - 2 * np.intersect1d(kp, kq,
                                         assume_unique=True).size)
        agree += float(u - sym_diff)
        total += float(u)
    act_acc = float((predicted.activity() == truth.activity()).mean())
    return {"link_accuracy": agree / total if total else 1.0,
            "activity_accuracy": act_acc}
