"""Imperfect-information estimation (paper §IV-A / §V-A) — numpy, host side.

Divide the horizon T into L windows T_1..T_L; within window l, the
optimizer sees the time-AVERAGED observations of D_i(t), c_i(t), c_ij(t),
C_i(t) from window l−1 (window 0 uses uninformative priors). The plan
solved on estimated traces is then executed — and costed — on the true
traces (settings C and E in Table III).

A copy of the trace and count estimators of
:mod:`repro.core.estimator`, with the same arithmetic, so the same
inputs give bitwise-equal estimates. The prediction plane (schedule
estimation) is not ported yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.costs import CostTraces


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
