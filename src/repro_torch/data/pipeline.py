"""Fog data pipeline (paper §V-A) — numpy, host side.

* per-device Poisson arrivals, mean |D_V|/(nT) per round;
* i.i.d. (uniform w/o replacement from the global pool) or non-i.i.d.
  (each device restricted to a random 5 of 10 labels) collection;
* application of a MovementPlan to the physical sample streams:
  offloaded samples travel one round (arrive at t+1), discarded samples
  vanish;
* padding and staging of the (T, n, P) rounds the engine trains on;
* the sweep engine's staging of S scenarios into one shape bucket:
  dense (S, T_b, n_b, P_b) slabs (:func:`stage_scenario_batch`) or
  ragged chunk-row tables (:func:`stage_scenario_ragged`).

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
    # foglint: disable=rng-stream-discipline -- documented default: rng=None selects the fixed legacy stream 0 (bitwise the reference's staging); scenario producers pass a derived Generator
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
    # foglint: disable=rng-stream-discipline -- documented default: rng=None selects the fixed legacy stream 0 (bitwise the reference's staging); scenario producers pass a derived Generator
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
    # foglint: disable=rng-stream-discipline -- documented default: rng=None selects fixed stream 1 (kept distinct from the collection stream), as the reference; callers on the scenario path pass a derived Generator
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
    # foglint: disable=rng-stream-discipline -- documented default: rng=None selects fixed stream 1 (kept distinct from the collection stream), as the reference; callers on the scenario path pass a derived Generator
    rng = rng or np.random.default_rng(1)
    n, T = streams.n, streams.T
    buckets: list[list[list[np.ndarray]]] = \
        [[[] for _ in range(n)] for _ in range(T)]
    for t in range(T):
        # foglint: disable=dense-materialization -- dense-row oracle path (see docstring); the sparse twin is apply_movement_flat
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


# padding-inflation warnings are deduplicated per sweep, not emitted per
# point: a 50-point sweep with one undersized bucket should warn once
_PAD_WARNED: set = set()


def reset_padding_warnings() -> None:
    """Start a new sweep: padding-inflation warnings may fire again."""
    _PAD_WARNED.clear()


def _warn_once(key, msg: str) -> None:
    if key not in _PAD_WARNED:
        _PAD_WARNED.add(key)
        warnings.warn(msg, stacklevel=3)


# padded rounds/devices still execute their (zero-weight) compute, so
# bucketing a dimension that would inflate it beyond this factor falls
# back to the exact size: nearby shapes share a program, distant ones
# pay a recompile instead of phantom FLOPs every round
BUCKET_MAX_INFLATION = 4 / 3


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


def bucket_rounds(T: int, tau: int, bucket: str = "pow2") -> int:
    """Bucket for the round axis: the WINDOW count (T/tau) is bucketed,
    then scaled back by tau — so tau-aligned horizons (the common
    same-T sweep) pad zero rounds while cross-T sweeps still share a
    program per bucket. Padded windows train nothing but still execute,
    so inflation beyond ``BUCKET_MAX_INFLATION`` keeps the exact window
    count. Always a multiple of tau (the engines scan (T/tau, tau)
    aggregation windows)."""
    n_win = -(-int(T) // int(tau))
    return bucket_size(n_win, bucket,
                       max_inflation=BUCKET_MAX_INFLATION) * int(tau)


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


@dataclasses.dataclass
class ScenarioBatch:
    """S scenarios staged into ONE stacked, bucket-padded stream.

    All arrays carry a leading scenario axis: ``idx``/``yb``/``w`` are
    (S, T_b, n_b, P_b), ``counts``/``act`` are (S, T_b, n_b), ``is_agg``
    is (S, T_b). ``T``/``n``/``P`` record each scenario's TRUE dims so
    histories can be sliced back out of the padding; phantom rounds and
    devices are inactive (act 0, counts 0, is_agg False) and train
    nothing."""

    idx: np.ndarray
    yb: np.ndarray
    w: np.ndarray
    counts: np.ndarray
    act: np.ndarray
    is_agg: np.ndarray
    T: list[int]
    n: list[int]
    P: list[int]
    tau: int

    @property
    def dims(self) -> tuple[int, int, int, int]:
        """(S, T_b, n_b, P_b) — the bucket the program compiles for."""
        return self.idx.shape


# chunk size of the ragged row tables: each (round, device) cell is cut
# into ceil(count/RAGGED_CHUNK) virtual rows of RAGGED_CHUNK sample
# slots, so the compiled per-round work is proportional to the actual
# sample total (plus at most one partially-filled chunk per nonempty
# cell) instead of S·P_max. Larger chunks mean fewer rows (less
# parameter gather/scatter traffic) but more slot padding per cell.
RAGGED_CHUNK = 8


@dataclasses.dataclass
class RaggedScenarioBatch:
    """S scenarios staged as per-round RAGGED chunk-row tables.

    Instead of the dense (S, T_b, n_b, P_b) slab of
    :class:`ScenarioBatch` — whose phantom P-slots still execute — each
    round carries a flat table of ``R_b`` chunk rows of ``chunk``
    sample slots: row r of round t holds up to ``chunk`` samples of ONE
    (scenario, device) cell, identified by ``cell[t, r]`` on the flat
    scenario-major device axis (``s * n_b + dev``). Phantom rows point
    at the trash segment ``S * n_b`` so their (zero-weight) garbage
    never reaches a real device. A scenario's rows are contiguous and
    ordered by (device, chunk) within each round, so its per-device
    reduction order — and therefore its bits — is the same whether it
    trains alone or inside the bucket.

    ``counts``/``act``/``is_agg`` and the true-dims lists are exactly
    the dense batch's: the device axis stays (S, n_b), only the sample
    axis goes ragged."""

    idx: np.ndarray      # (T_b, R_b, C) int32 global sample ids
    yb: np.ndarray       # (T_b, R_b, C) int32 labels
    w: np.ndarray        # (T_b, R_b, C) float32 slot mask
    cell: np.ndarray     # (T_b, R_b) int32 flat device id; S*n_b=trash
    counts: np.ndarray   # (S, T_b, n_b) float32
    act: np.ndarray      # (S, T_b, n_b) float32
    is_agg: np.ndarray   # (S, T_b) bool
    T: list[int]
    n: list[int]
    P: list[int]
    tau: int
    chunk: int
    total_samples: int   # true sample total across the bucket
    total_rows: int      # true (unpadded) chunk-row total

    @property
    def dims(self) -> tuple[int, int, int, int, int]:
        """(S, T_b, n_b, R_b, C) — the bucket the program compiles
        for."""
        S, T_b, n_b = self.counts.shape
        R_b, C = self.idx.shape[1:]
        return S, T_b, n_b, R_b, C


def _cell_table(processed, y=None):
    """Normalize per-cell lists or a :class:`FlatStreams` into
    ((T, n) sample counts, concatenated ids in (t, dev, within-cell)
    order) — the inputs the ragged stager scatters from."""
    if isinstance(processed, FlatStreams):
        T, n = processed.T, processed.n
        lens = np.bincount(processed.cell_key(),
                           minlength=T * n).astype(np.int64).reshape(T, n)
        return lens, np.asarray(processed.idx, np.int64)
    lens = np.array([[len(ix) for ix in row] for row in processed],
                    np.int64).reshape(len(processed), -1)
    cells = [np.asarray(ix, np.int64) for row in processed for ix in row]
    ids = (np.concatenate(cells) if cells and lens.sum()
           else np.empty(0, np.int64))
    return lens, ids


def stage_scenario_ragged(processed_list, y: np.ndarray,
                          act_list: list[np.ndarray], tau: int, *,
                          max_points: list[int] | None = None,
                          bucket: str = "pow2",
                          chunk: int | None = None
                          ) -> RaggedScenarioBatch:
    """Ragged counterpart of :func:`stage_scenario_batch`.

    Per-round chunk-row tables are built with one scatter per staged
    array (the :func:`stage_rounds_flat` idiom): every (scenario,
    round, device) cell becomes ceil(count/chunk) rows, rows of one
    round packed scenario-major (scenario rows contiguous, devices in
    index order — the order the in-bucket-equals-alone bitwise
    guarantee rests on), the row axis bucketed like the other compute
    axes (pow2, ``BUCKET_MAX_INFLATION`` cap). The inflation warning
    fires on the RAGGED totals — padded row-slots vs the samples
    actually staged — not on the dense pow2 P prediction, since the
    phantom P-slots the dense warning prices never execute here."""
    C = int(chunk or RAGGED_CHUNK)
    if C < 1:
        raise ValueError(f"chunk must be >= 1; got {C}")
    S = len(processed_list)
    tables = [_cell_table(p) for p in processed_list]
    T_s = [lens.shape[0] for lens, _ in tables]
    n_s = [lens.shape[1] for lens, _ in tables]
    P_s = [pad_size(p, (max_points or [0] * S)[b])
           for b, p in enumerate(processed_list)]
    T_b = max(bucket_rounds(T, tau, bucket) for T in T_s)
    n_b = max(bucket_size(n, bucket,
                          max_inflation=BUCKET_MAX_INFLATION)
              for n in n_s)
    nrows = [-(-lens // C) for lens, _ in tables]        # (T_s, n_s)
    rows_round = np.zeros(T_b, np.int64)
    for b, nr in enumerate(nrows):
        rows_round[:T_s[b]] += nr.sum(1)
    R_max = int(rows_round.max()) if T_b else 0
    R_b = bucket_size(max(R_max, 1), bucket,
                      max_inflation=BUCKET_MAX_INFLATION)
    total_rows = int(rows_round.sum())
    total_samples = int(sum(int(lens.sum()) for lens, _ in tables))
    # satellite of the dense P-inflation warning, computed on what
    # ragged staging actually executes: padded row-slots per horizon
    if total_rows and T_b * R_b > 2 * total_rows:
        _warn_once(
            ("ragged_inflation", T_b, R_b),
            f"ragged bucket pads {total_rows} chunk rows up to "
            f"{T_b}x{R_b} row slots (> 2x) for this sweep; split the "
            "sweep into finer buckets if the padded compute shows up")

    trash = S * n_b
    idx = np.zeros((T_b, R_b, C), np.int32)
    yb = np.zeros((T_b, R_b, C), np.int32)
    w = np.zeros((T_b, R_b, C), np.float32)
    cell = np.full((T_b, R_b), trash, np.int32)
    counts = np.zeros((S, T_b, n_b), np.float32)
    act = np.zeros((S, T_b, n_b), np.float32)
    is_agg = np.zeros((S, T_b), bool)
    off = np.zeros(T_b, np.int64)        # next free row per round
    for b, (lens, ids) in enumerate(tables):
        T, n = T_s[b], n_s[b]
        counts[b, :T, :n] = lens
        act[b, :T, :n] = np.asarray(act_list[b], np.float32)
        is_agg[b, :T] = (np.arange(T) + 1) % tau == 0
        if ids.size:
            nr_flat = nrows[b].reshape(-1)
            lens_flat = lens.reshape(-1)
            cell_of = np.repeat(np.arange(T * n, dtype=np.int64),
                                lens_flat)
            starts = np.concatenate([[0], np.cumsum(lens_flat)])[:-1]
            pos = np.arange(ids.size, dtype=np.int64) - starts[cell_of]
            # scenario-local row index of each cell within its round
            rowbase = np.cumsum(nr_flat) - nr_flat
            round_start = np.concatenate(
                [[0], np.cumsum(nrows[b].sum(1))])[:-1]
            rowbase -= np.repeat(round_start, n)
            t_of = cell_of // n
            row = off[t_of] + rowbase[cell_of] + pos // C
            slot = pos % C
            flat = (t_of * np.int64(R_b) + row) * C + slot
            idx.reshape(-1)[flat] = ids
            yb.reshape(-1)[flat] = y[ids]
            w.reshape(-1)[flat] = 1.0
            cell.reshape(-1)[t_of * np.int64(R_b) + row] = \
                b * n_b + (cell_of % n)
        off[:T] += nrows[b].sum(1)
    return RaggedScenarioBatch(
        idx=idx, yb=yb, w=w, cell=cell, counts=counts, act=act,
        is_agg=is_agg, T=T_s, n=n_s, P=P_s, tau=tau, chunk=C,
        total_samples=total_samples, total_rows=total_rows)


def ragged_rows(processed_list, chunk: int | None = None) -> np.ndarray:
    """Per-round chunk-row totals a ragged bucket of these scenarios
    would stage — the cost model's work estimate, computed without
    building the tables (rows = Σ over cells of ceil(count/chunk))."""
    C = int(chunk or RAGGED_CHUNK)
    T_max = max(
        (p.T if isinstance(p, FlatStreams) else len(p))
        for p in processed_list)
    rows = np.zeros(T_max, np.int64)
    for p in processed_list:
        lens, _ = _cell_table(p)
        rows[:lens.shape[0]] += (-(-lens // C)).sum(1)
    return rows


def stage_scenario_batch(processed_list: list[list[list[np.ndarray]]],
                         y: np.ndarray,
                         act_list: list[np.ndarray], tau: int, *,
                         max_points: list[int] | None = None,
                         bucket: str = "pow2") -> ScenarioBatch:
    """Stage a whole sweep bucket for the batched engine.

    Each scenario's (T_s, n_s, P_s) stream is padded up to the shared
    shape bucket — the round axis via :func:`bucket_rounds` (window
    count bucketed, always a tau multiple), the device and sample axes
    via :func:`bucket_size` — and stacked on a leading scenario axis.
    Warns ONCE per sweep (see :func:`reset_padding_warnings`) when the
    bucket inflates a scenario's own sample budget P by more than 2x:
    that is the signal to split the sweep into finer buckets."""
    S = len(processed_list)
    T_s = [len(p) for p in processed_list]
    n_s = [len(p[0]) for p in processed_list]
    P_s = [pad_size(p, (max_points or [0] * S)[b])
           for b, p in enumerate(processed_list)]
    T_b = max(bucket_rounds(T, tau, bucket) for T in T_s)
    n_b = max(bucket_size(n, bucket,
                          max_inflation=BUCKET_MAX_INFLATION)
              for n in n_s)
    # P buckets off the GROUP max (one program per bucket either way);
    # the pow2 rounding buys cross-sweep cache hits, the cap keeps the
    # padded per-round compute bounded like the n/T axes
    P_b = bucket_size(max(P_s), bucket,
                      max_inflation=BUCKET_MAX_INFLATION)
    for b, P in enumerate(P_s):
        if P_b > 2 * P:
            _warn_once(
                ("P_inflation", P_b),
                f"shape bucket pads P={P} up to {P_b} (> 2x) for at "
                "least one scenario of this sweep; split the sweep "
                "into finer buckets if the padded compute shows up")
    idx = np.zeros((S, T_b, n_b, P_b), np.int32)
    yb = np.zeros((S, T_b, n_b, P_b), np.int32)
    w = np.zeros((S, T_b, n_b, P_b), np.float32)
    counts = np.zeros((S, T_b, n_b), np.float32)
    act = np.zeros((S, T_b, n_b), np.float32)
    is_agg = np.zeros((S, T_b), bool)
    for b, processed in enumerate(processed_list):
        T, n = T_s[b], n_s[b]
        i_b, y_b, w_b, c_b = stage_rounds(processed, y, P_b)
        idx[b, :T, :n], yb[b, :T, :n] = i_b, y_b
        w[b, :T, :n], counts[b, :T, :n] = w_b, c_b
        act[b, :T, :n] = np.asarray(act_list[b], np.float32)
        is_agg[b, :T] = (np.arange(T) + 1) % tau == 0
    return ScenarioBatch(idx=idx, yb=yb, w=w, counts=counts, act=act,
                         is_agg=is_agg, T=T_s, n=n_s, P=P_s, tau=tau)
