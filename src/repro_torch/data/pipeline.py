"""Fog data pipeline (paper §V-A) — numpy, host side.

* per-device Poisson arrivals, mean |D_V|/(nT) per round;
* i.i.d. (uniform w/o replacement from the global pool) or non-i.i.d.
  (each device restricted to a random 5 of 10 labels) collection;
* application of a MovementPlan to the physical sample streams:
  offloaded samples travel one round (arrive at t+1), discarded samples
  vanish;
* padding and staging of the (T, n, P) rounds the engine trains on.

Streams come as per-cell lists (:class:`FogStreams`) or as one flat
sample table (:class:`FlatStreams`, the O(samples) form for 10⁵
devices). A copy of :mod:`repro.data.pipeline` with identical rng use,
so the same seed gives bitwise-equal streams, routing and staged
arrays. :func:`counts_flat` reduces on the device through the
segment-reduce kernel.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core.movement import MovementPlan
from repro_torch.device import resolve_device


@dataclasses.dataclass
class FogStreams:
    """collected[t][i] -> (idx array of global sample ids)."""

    collected: list[list[np.ndarray]]
    n: int
    T: int


@dataclasses.dataclass
class FlatStreams:
    """Array-backed sample streams — the O(samples) representation the
    sparse network plane stages at device counts where ``FogStreams``'
    T×n Python lists of tiny arrays are unaffordable. Sample ``s`` is
    held by device ``dev[s]`` at round ``t[s]`` with global dataset id
    ``idx[s]``; rows are lex-sorted by (t, dev). Convert with
    :func:`flat_from_streams` / :func:`streams_from_flat` (small n)."""

    t: np.ndarray       # (N,) int64 round of each sample
    dev: np.ndarray     # (N,) int64 holding device
    idx: np.ndarray     # (N,) int64 global dataset id
    n: int
    T: int

    def cell_key(self) -> np.ndarray:
        return self.t * np.int64(self.n) + self.dev


def _flat_sorted(t, dev, idx, n: int, T: int) -> FlatStreams:
    t = np.asarray(t, np.int64)
    dev = np.asarray(dev, np.int64)
    idx = np.asarray(idx, np.int64)
    order = np.argsort(t * np.int64(n) + dev, kind="stable")
    return FlatStreams(t=t[order], dev=dev[order], idx=idx[order],
                       n=n, T=T)


def flat_from_streams(streams: FogStreams) -> FlatStreams:
    """Flatten a ``FogStreams`` (preserves per-cell sample order)."""
    n, T = streams.n, streams.T
    cells = [ix for row in streams.collected for ix in row]
    lens = np.fromiter((len(ix) for ix in cells), np.int64, len(cells))
    cell = np.repeat(np.arange(T * n, dtype=np.int64), lens)
    idx = (np.concatenate(cells) if cells and lens.sum()
           else np.empty(0, np.int64))
    return FlatStreams(t=cell // n, dev=cell % n,
                       idx=np.asarray(idx, np.int64), n=n, T=T)


def streams_from_flat(flat: FlatStreams) -> FogStreams:
    """Expand back to per-cell lists (small-n bridge for the oracles)."""
    n, T = flat.n, flat.T
    key = flat.cell_key()
    starts = np.searchsorted(key, np.arange(T * n + 1, dtype=np.int64))
    collected = [[flat.idx[starts[t * n + i]:starts[t * n + i + 1]].copy()
                  for i in range(n)] for t in range(T)]
    return FogStreams(collected=collected, n=n, T=T)


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


def poisson_streams_flat(n: int, T: int, y: np.ndarray, *,
                         rng: np.random.Generator | None = None,
                         mean_per_round: float | None = None
                         ) -> FlatStreams:
    """Vectorized i.i.d. Poisson arrivals as a :class:`FlatStreams` —
    the O(samples) producer for large n (one ``rng.poisson`` draw for
    the whole (T, n) grid, one ``rng.integers`` draw for the sample
    ids; with-replacement i.i.d. sampling, unlike the per-cell
    without-replacement draw of :func:`poisson_streams`, so the two
    producers are distribution-equal, not bitwise twins)."""
    rng = rng or np.random.default_rng(0)
    N = len(y)
    mean = mean_per_round or N / (n * T)
    k = rng.poisson(mean, (T, n)).astype(np.int64)
    total = int(k.sum())
    cell = np.repeat(np.arange(T * n, dtype=np.int64), k.reshape(-1))
    idx = rng.integers(0, N, total, dtype=np.int64)
    return FlatStreams(t=cell // n, dev=cell % n, idx=idx, n=n, T=T)


def counts(streams, device=None) -> np.ndarray:
    """D[t,i] = |D_i(t)| (FogStreams, or FlatStreams through
    :func:`counts_flat` on ``device``)."""
    if isinstance(streams, FlatStreams):
        return counts_flat(streams, device)
    return np.array([[len(ix) for ix in row] for row in streams.collected],
                    dtype=float)


def counts_flat(flat: FlatStreams, device=None) -> np.ndarray:
    """(T, n) float64 per-cell sample counts of a flat stream: ones
    summed over the int32 cell keys by ``kernels.ops.segment_sum`` on
    ``device`` (``cuda`` by default: the segment-reduce kernel; the
    plain version on ``device="cpu"``). Counts are small integers, so
    the float32 sums are exact."""
    from repro_torch.kernels import ops
    N = flat.idx.shape[0]
    if N == 0:
        return np.zeros((flat.T, flat.n))
    dev = resolve_device(device)
    keys = torch.from_numpy(flat.cell_key().astype(np.int32)).to(dev)
    c = ops.segment_sum(torch.ones(N, dtype=torch.float32, device=dev),
                        keys, num_segments=flat.T * flat.n)
    return c.cpu().numpy().astype(np.float64).reshape(flat.T, flat.n)


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


def apply_movement_flat(flat: FlatStreams, plan: MovementPlan,
                        rng: np.random.Generator | None = None
                        ) -> FlatStreams:
    """Route a flat stream per a BANG-BANG plan — O(samples + plan
    edges), never touching per-cell Python lists.

    Bang-bang means every (t, i) share row moves, keeps or discards its
    WHOLE collection: each share row holds at most one qty-1 edge
    (keep-all is the self-edge, move-all an off-diagonal one) and the
    discard vector ``r`` is 0 on rows with an edge and {0, 1} elsewhere
    — exactly what ``greedy_linear`` emits. Routing is then a gather
    ``dev' = route[t, dev]``: offloaded samples arrive at t+1,
    ``route = −1`` discards, moves past the horizon vanish. Membership
    per cell is identical to :func:`apply_movement` (whole cells move,
    so the per-cell permutation is irrelevant); within-cell sample
    order follows collection order, not the dense path's permuted
    order. Fractional plans fall back to the dense-oracle path through
    the stream converters (small n only)."""
    n, T = flat.n, flat.T
    r = np.asarray(plan.r)
    route = np.full((T, n), -1, np.int64)   # no edge, no retain: discard
    bang = bool(np.isin(r, (0.0, 1.0)).all())
    for t in range(T):
        if not bang:
            break
        src, dst, qty = plan.round_edges(t)
        on = qty >= 0.5
        if (qty.size and (np.unique(src[on]).size < on.sum()
                          or not np.isin(qty, (0.0, 1.0)).all()
                          or r[t, src[on]].any())):
            bang = False
            break
        route[t, src[on]] = dst[on]
    if not bang:
        processed = apply_movement(streams_from_flat(flat), plan, rng)
        return flat_from_streams(
            FogStreams(collected=processed, n=n, T=T))
    dev2 = route[flat.t, flat.dev]
    t2 = flat.t + (dev2 != flat.dev)
    keep = (dev2 >= 0) & (t2 < T)
    return _flat_sorted(t2[keep], dev2[keep], flat.idx[keep], n, T)


def apply_movement_dense(streams: FogStreams, plan: MovementPlan,
                         rng: np.random.Generator | None = None
                         ) -> list[list[np.ndarray]]:
    """Dense-row routing (the pre-sparse path) — preserved as the
    bitwise oracle for the edge-based ``apply_movement``."""
    rng = rng or np.random.default_rng(1)
    n, T = streams.n, streams.T
    buckets: list[list[list[np.ndarray]]] = \
        [[[] for _ in range(n)] for _ in range(T)]
    for t in range(T):
        s_t, r_t = plan.s[t], plan.r[t]
        for i in range(n):
            idx = streams.collected[t][i]
            if len(idx) == 0:
                continue
            idx = rng.permutation(idx)
            fracs = np.concatenate([s_t[i], [r_t[i]]])
            fracs = np.clip(fracs, 0, None)
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
    """P for padded batches: the post-movement per-device maximum, of
    per-cell lists or a :class:`FlatStreams`. A ``requested`` pad size
    only ever grows P."""
    if isinstance(processed, FlatStreams):
        key = processed.cell_key()
        post_max = (int(np.bincount(key).max()) if key.size else 1) or 1
    else:
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
    counts (T, n) float32). Pixels are gathered on the device. A
    :class:`FlatStreams` takes :func:`stage_rounds_flat`: the same
    staged arrays for the same cell contents."""
    if isinstance(processed, FlatStreams):
        return stage_rounds_flat(processed, y, max_points)
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


def stage_rounds_flat(flat: FlatStreams, y: np.ndarray, max_points: int):
    """Vectorized :func:`stage_rounds` over a flat stream: one stable
    sort by cell, within-cell slot positions by run-length arithmetic,
    one scatter per staged array — no per-(t, i) Python work."""
    T, n, P = flat.T, flat.n, max_points
    idx = np.zeros((T, n, P), np.int32)
    yb = np.zeros((T, n, P), np.int32)
    w = np.zeros((T, n, P), np.float32)
    key = flat.cell_key()
    order = np.argsort(key, kind="stable")
    sk, si = key[order], flat.idx[order]
    cell_counts = np.bincount(sk, minlength=T * n).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(cell_counts)])
    pos = np.arange(sk.size, dtype=np.int64) \
        - starts[:-1][np.repeat(np.arange(T * n), cell_counts)]
    over = int(cell_counts.max()) if cell_counts.size else 0
    if over > P:
        warnings.warn(
            f"stage_rounds_flat: a device holds {over} samples but "
            f"P={P}; truncating", stacklevel=2)
    fit = pos < P
    flat_slot = sk[fit] * np.int64(P) + pos[fit]
    idx.reshape(-1)[flat_slot] = si[fit]
    yb.reshape(-1)[flat_slot] = y[si[fit]]
    w.reshape(-1)[flat_slot] = 1.0
    counts = np.minimum(cell_counts, P).astype(np.float32) \
        .reshape(T, n)
    return idx, yb, w, counts
