"""Fog data pipeline (paper §V-A) — numpy, host side.

* per-device Poisson arrivals, mean |D_V|/(nT) per round;
* i.i.d. (uniform w/o replacement from the global pool) or non-i.i.d.
  (each device restricted to a random 5 of 10 labels) collection;
* application of a MovementPlan to the physical sample streams:
  offloaded samples travel one round (arrive at t+1), discarded samples
  vanish;
* padding and staging of the (T, n, P) rounds the engine trains on.

A copy of the per-cell-list subset of :mod:`repro.data.pipeline` with
identical rng use, so the same seed gives bitwise-equal streams,
routing and staged arrays.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from repro_torch.core.movement import MovementPlan


@dataclasses.dataclass
class FogStreams:
    """collected[t][i] -> (idx array of global sample ids)."""

    collected: list[list[np.ndarray]]
    n: int
    T: int


def poisson_streams(n: int, T: int, y: np.ndarray, *, iid: bool = True,
                    labels_per_device: int = 5, n_classes: int = 10,
                    rng: np.random.Generator | None = None,
                    mean_per_round: float | None = None) -> FogStreams:
    rng = rng or np.random.default_rng(0)
    N = len(y)
    mean = mean_per_round or N / (n * T)
    device_labels = [rng.choice(n_classes, labels_per_device, replace=False)
                     for _ in range(n)]
    by_label = {c: np.nonzero(y == c)[0] for c in range(n_classes)}
    collected: list[list[np.ndarray]] = []
    for t in range(T):
        row = []
        for i in range(n):
            k = rng.poisson(mean)
            if iid:
                idx = rng.choice(N, size=min(k, N), replace=False)
            else:
                pool = np.concatenate([by_label[c] for c in device_labels[i]])
                idx = rng.choice(pool, size=min(k, len(pool)), replace=False)
            row.append(idx.astype(np.int64))
        collected.append(row)
    return FogStreams(collected=collected, n=n, T=T)


def counts(streams: FogStreams) -> np.ndarray:
    """D[t,i] = |D_i(t)|."""
    return np.array([[len(ix) for ix in row] for row in streams.collected],
                    dtype=float)


def apply_movement(streams: FogStreams, plan: MovementPlan,
                   rng: np.random.Generator | None = None
                   ) -> list[list[np.ndarray]]:
    """Route physical samples per the plan.

    Returns processed[t][i] — global sample ids device i processes at
    round t (= retained local share + arrivals offloaded at t−1).
    Fractions are realized by randomized rounding of contiguous splits;
    each device's (n+1,) share row is rebuilt from its outgoing edges
    into one reused buffer.
    """
    rng = rng or np.random.default_rng(1)
    n, T = streams.n, streams.T
    buckets: list[list[list[np.ndarray]]] = \
        [[[] for _ in range(n)] for _ in range(T)]
    row_buf = np.zeros(n + 1)
    for t in range(T):
        src, dst, qty = plan.round_edges(t)
        starts_e = np.searchsorted(src, np.arange(n + 1))
        r_t = plan.r[t]
        for i in range(n):
            idx = streams.collected[t][i]
            if len(idx) == 0:
                continue
            idx = rng.permutation(idx)
            row_buf[:] = 0.0
            sl = slice(starts_e[i], starts_e[i + 1])
            row_buf[dst[sl]] = qty[sl]
            row_buf[n] = r_t[i]
            fracs = np.clip(row_buf, 0, None)
            fracs = fracs / max(fracs.sum(), 1e-12)
            cuts = np.floor(np.cumsum(fracs) * len(idx) + 1e-9).astype(int)
            ends = cuts[:-1]                     # last bucket = discard
            starts = np.empty_like(ends)
            starts[0] = 0
            starts[1:] = ends[:-1]
            for j in np.nonzero(ends > starts)[0]:
                part = idx[starts[j]:ends[j]]
                if j == i:
                    buckets[t][i].append(part)
                elif t + 1 < T:
                    buckets[t + 1][j].append(part)
    return [[np.concatenate(cell) if cell else np.empty(0, np.int64)
             for cell in row] for row in buckets]


def label_similarity(label_multisets: list[np.ndarray],
                     n_classes: int = 10) -> float:
    """Average pairwise multiset label overlap (paper Fig. 4b):
    s_ij = |Y_i ∩ Y_j| / min(|Y_i|, |Y_j|). One vectorized pass per row
    i over all j > i, in the reference's (i, j) order, so the mean is
    bitwise the reference's pairwise loop."""
    hists = np.stack([np.bincount(lab, minlength=n_classes)
                      for lab in label_multisets]) \
        if label_multisets else np.zeros((0, n_classes), np.int64)
    tot = hists.sum(1)
    sims = []
    for i in range(len(hists) - 1):
        lo = np.minimum(hists[i], hists[i + 1:]).sum(1)
        denom = np.minimum(tot[i], tot[i + 1:])
        ok = denom > 0
        sims.append(lo[ok] / denom[ok])
    sims = np.concatenate(sims) if sims else np.empty(0)
    return float(np.mean(sims)) if sims.size else 0.0


def bucket_size(value: int, bucket: str = "pow2", *,
                max_inflation: float | None = None) -> int:
    """Round a dimension up to its shape bucket: ``"pow2"`` rounds up to
    the next power of two, ``"exact"`` is the identity. ``max_inflation``
    keeps the exact size when the pow2 bucket would grow it more."""
    value = int(value)
    if bucket == "exact":
        return value
    if bucket != "pow2":
        raise ValueError(f"unknown bucket policy {bucket!r}; "
                         "expected 'pow2' or 'exact'")
    b = 1 << max(0, value - 1).bit_length()
    if max_inflation is not None and b > value * max_inflation:
        return value
    return b


def pad_size(processed, requested: int = 0, *,
             bucket: str = "exact") -> int:
    """P for padded batches: the post-movement per-device maximum.
    A ``requested`` pad size only ever grows P."""
    post_max = max((len(ix) for row in processed for ix in row),
                   default=1) or 1
    if requested and requested < post_max:
        warnings.warn(
            f"max_points={requested} is below the post-movement maximum "
            f"of {post_max} samples/device/round; padding to {post_max} "
            "to avoid dropping samples", stacklevel=2)
    return bucket_size(max(requested, post_max), bucket)


def pad_batches(processed_t: list[np.ndarray], x: np.ndarray,
                y: np.ndarray, max_points: int, *,
                bucket: str = "exact"):
    """Stack per-device variable-size batches into padded arrays.

    Returns (xb (n, P, ...), yb (n, P), w (n, P) weight mask)."""
    n = len(processed_t)
    P = bucket_size(max_points, bucket)
    xb = np.zeros((n, P, *x.shape[1:]), x.dtype)
    yb = np.zeros((n, P), np.int32)
    w = np.zeros((n, P), np.float32)
    for i, idx in enumerate(processed_t):
        if len(idx) > P:
            warnings.warn(
                f"pad_batches: device {i} holds {len(idx)} samples but "
                f"P={P}; truncating (size P via pipeline.pad_size to "
                "avoid this)", stacklevel=2)
        k = min(len(idx), P)
        if k:
            xb[i, :k] = x[idx[:k]]
            yb[i, :k] = y[idx[:k]]
            w[i, :k] = 1.0
    return xb, yb, w


def stage_rounds(processed, y: np.ndarray, max_points: int):
    """Stage the whole horizon for the scan engine.

    Returns (idx (T, n, P) int32 — global sample ids, 0-padded;
    yb (T, n, P) int32; w (T, n, P) float32 weight mask;
    counts (T, n) float32). Pixels are gathered on the device."""
    T, n, P = len(processed), len(processed[0]), max_points
    idx = np.zeros((T, n, P), np.int32)
    yb = np.zeros((T, n, P), np.int32)
    w = np.zeros((T, n, P), np.float32)
    counts = np.zeros((T, n), np.float32)
    for t, row in enumerate(processed):
        for i, ix in enumerate(row):
            k = len(ix)
            if k > P:
                warnings.warn(
                    f"stage_rounds: device {i} round {t} holds {k} "
                    f"samples but P={P}; truncating", stacklevel=2)
                k = P
            if k:
                idx[t, i, :k] = ix[:k]
                yb[t, i, :k] = y[ix[:k]]
                w[t, i, :k] = 1.0
            counts[t, i] = k
    return idx, yb, w, counts
