"""Federated training engine over n fog devices (paper eqs. 3–4).

Every device i holds its own parameters w_i(t), kept as one parameter
dict whose tensors carry a leading device axis. Each round runs one
local SGD step per device (eq. 3) through ``torch.func.vmap`` of
``torch.func.grad`` — the port of the reference's vmapped step — and
every τ rounds the H-weighted aggregation (eq. 4), a sync of the active
devices and an evaluation of the global model.

``run_rounds_scan`` runs the whole horizon on the device without a host
synchronisation inside the round loop: the staged (T, n, P) indices,
labels and weights are copied up once, the aggregation rounds are known
on the host from τ, and the history is read back once at the end.
Pixels are gathered on the device, all up front when the (T, n, P, ...)
tensor fits ``PRESTAGE_LIMIT_BYTES`` and per round otherwise (the same
numbers either way: a gather is exact).

``run_rounds_hierarchical`` runs the same loop over a tier tree,
composing eq. (4) up the tiers with ``aggregate_tier`` (one segment sum
per parameter leaf, through the segment-reduce kernel on the card).

``run_rounds_legacy`` is the per-round oracle: fresh host-padded
batches every round and the history read back as it goes.

``run_rounds_batched`` is the sweep engine: S scenarios of one shape
bucket (phantom rounds and devices pad them to it) train in one round
loop over the flat (S·n_b) device stack, with dense or ragged staging,
eq. (4) as one row-segment sum a leaf (kernel 2's row form on the
card) and the whole (windows, S) grid of snapshots evaluated at once
(:class:`AsyncEvaluator`); ``run_rounds_batched_single`` is its S = 1
slice (``engine="batched"``). On a 1-D "data" ``DeviceMesh`` the sweep
engine shards the fog-device axis across the ranks and eq. (4) becomes
an all-reduce over the mesh's group; ``run_rounds_sharded`` is that
S = 1 slice (``engine="sharded"``), and ``resolve_engine`` picks it for
``"auto"`` when the default process group has more than one rank.

All three take a :class:`repro_torch.core.faults.FaultSchedule`: crash
outages join the activity, and every aggregation receives guarded
uploads (``_guarded_uploads``: corrupt rows selected away with
``torch.where``, never multiplied by a mask) and is quorum-gated. The
scan engine can also checkpoint at window boundaries and resume bit for
bit (``checkpoint_path``, ``resume``).

The scan and hierarchical engines take the processed streams as
per-cell lists or as a :class:`repro_torch.data.pipeline.FlatStreams`
(T and n from the stream, staged by the flat ``stage_rounds``).
"""
from __future__ import annotations

import collections
import hashlib
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import monitoring, sanitize
from repro_torch.data import pipeline as pl
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.collectives import (all_reduce_flat,
                                                 all_reduce_sum)
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as sr
from repro_torch.models import mnist as mm

PRESTAGE_LIMIT_BYTES = 256 * 1024 ** 2


def resolve_engine(engine: str) -> str:
    """The one "auto" rule of every caller (CLI, sweeps): sharded when an
    initialized default process group has more than one rank, scan
    otherwise."""
    if engine == "auto":
        return ("sharded" if dist.is_initialized()
                and dist.get_world_size() > 1 else "scan")
    return engine


def _stack(params: dict, n: int) -> dict:
    return {k: v.expand(n, *v.shape).clone() for k, v in params.items()}


def _bcast(v, like):
    """(n,) -> (n, 1, ..., 1) to scale a (n, ...) parameter stack."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def make_device_step(apply_fn, eta: float):
    """The vmapped per-device SGD step (eq. 3). ``W`` stacked params,
    ``xb`` (n, P, ...), ``yb`` (n, P) int64, ``w`` (n, P) 0/1 weights,
    ``active`` (n,) float. A device with no data or inactive takes no
    step: ``scale = active * min(Σw, 1)``."""

    def loss(params, xb, yb, w):
        return mm.ce_loss(apply_fn(params, xb), yb, w)

    vgrad = torch.func.vmap(torch.func.grad_and_value(loss))

    def step(W, xb, yb, w, active):
        g, losses = vgrad(W, xb, yb, w)
        lr = eta * (active * torch.clamp(w.sum(1), max=1.0))
        return {k: p - _bcast(lr, p) * g[k] for k, p in W.items()}, losses

    return step


def aggregate(W: dict, H, contributing, prev_global: dict | None):
    """Eq. (4): w(k) = Σ H_i w_i / Σ H_i over contributing devices; the
    previous global model carries over when no device contributes."""
    Hc = H * contributing
    tot = Hc.sum()
    ok = tot > 0
    out = {}
    for k, a in W.items():
        new = torch.where(ok, torch.einsum("n...,n->...", a, Hc)
                          / torch.clamp(tot, min=1e-9),
                          torch.zeros((), dtype=a.dtype, device=a.device))
        if prev_global is not None:
            new = torch.where(ok, new, prev_global[k])
        out[k] = new
    return out


def aggregate_edges(W: dict, H, device_ids, prev_global: dict | None):
    """Eq. (4) over an explicit contributor LIST: w(k) = Σ H_i w_i /
    Σ H_i over ``device_ids``, each weighted sum one segment reduction
    (one segment per parameter, the listed devices its elements, in
    list order). The oracle of :func:`aggregate_tier`."""
    ids = torch.as_tensor(device_ids, device=H.device).long()
    k = ids.shape[0]
    Hc = H[ids]
    tot = Hc.sum()
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    out = {}
    for key, a in W.items():
        P = math.prod(a.shape[1:])
        flat = (a[ids].reshape(k, P) * Hc[:, None]).reshape(-1)
        seg = torch.arange(P, dtype=torch.int32, device=H.device).repeat(k)
        s = ops.segment_sum(flat, seg, num_segments=P)
        new = torch.where(tot > 0, s / torch.clamp(tot, min=1e-9), zero)
        new = new.reshape(a.shape[1:]).to(a.dtype)
        if prev_global is not None:
            new = torch.where(tot > 0, new, prev_global[key])
        out[key] = new
    return out


class TierSegments:
    """One tier's member→group map: the (m,) int32 group ids and, on the
    card, the kernels' layout of them (:func:`segment_reduce.
    segment_layout`: G + 1 offsets and the m members, ascending within
    each group). The H_g sum and every leaf's row-segment sum reduce
    over it, whatever the leaf's width, so a run builds it once per
    tier; nothing of length m·P is kept."""

    def __init__(self, group_ids, num_groups: int, device):
        self.device = torch.device(device)
        self.num_groups = int(num_groups)
        self.group_ids = torch.as_tensor(
            np.asarray(group_ids)).to(self.device, torch.int32)
        self._layout = None

    def groups(self):
        """(ids, layout) of the tier's reductions; no layout on the
        CPU, where the plain versions need none."""
        if self._layout is None and self.device.type == "cuda":
            self._layout = sr.segment_layout(self.group_ids,
                                             self.num_groups)
        return self.group_ids, self._layout


def aggregate_tier(W: dict, H, group_ids, num_groups: int, *,
                   segments: TierSegments | None = None):
    """Eq. (4) per group of one tier: ``W`` a (m, ...) stack (devices at
    tier 1, child groups above), ``H`` the (m,) cumulative weights,
    ``group_ids`` the (m,) member→group map. Returns the (num_groups,
    ...) stack of group models and the group totals H_g, so tiers
    compose: feeding the outputs back in telescopes to the flat eq. (4)
    over the union. One segment sum for H_g, then one row-segment sum
    per leaf (rows weighted by H, members added in ascending order),
    with the divide and ``where`` of :func:`aggregate_edges`: a group's
    row is bitwise what ``aggregate_edges`` over its ascending member
    list gives. An empty group (H_g == 0) comes back as zeros.
    ``segments``, built from the same ``group_ids``, carries the tier's
    ids and layout from one call to the next."""
    if segments is None:
        segments = TierSegments(group_ids, num_groups, H.device)
    G = segments.num_groups
    m = H.shape[0]
    gids, lay = segments.groups()
    Hg = ops.segment_sum(H, gids, num_segments=G, layout=lay)
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    den = torch.clamp(Hg, min=1e-9)[:, None]
    ok = Hg[:, None] > 0
    out = {}
    for key, a in W.items():
        P = math.prod(a.shape[1:])
        s = ops.segment_sum_rows(a.reshape(m, P).contiguous(), gids,
                                 num_segments=G, scale=H, layout=lay)
        o = torch.where(ok, s / den, zero)
        out[key] = o.reshape((G,) + a.shape[1:]).to(a.dtype)
    return out, Hg


def _sync(W: dict, w_global: dict, active) -> dict:
    """Devices with ``active`` set take the global model."""
    return {k: torch.where(_bcast(active, p), w_global[k][None], p)
            for k, p in W.items()}


def _finite_mask(W: dict):
    """1.0 where every parameter leaf of a device is finite — the
    guarded-aggregation mask over the (n, ...) stack. All-finite inputs
    give an all-ones mask."""
    ok = None
    for p in W.values():
        fin = torch.isfinite(p.reshape(p.shape[0], -1)).all(dim=-1)
        ok = fin if ok is None else ok & fin
    return ok.to(torch.float32)


def _guarded_uploads(W: dict, contributing, upl, cor, guard: bool):
    """What the aggregator receives: device params times the per-link
    corruption multiplier ``cor`` (the injection: a multiply, as a
    lossy link applies it), missing uploads (``upl`` 0) out of the
    contributing set, and with ``guard`` the non-finite updates out of
    it too, their rows zeroed by ``torch.where`` before any reduction
    (NaN·0 is NaN, so a mask multiply would not remove them). The H
    total renormalizes over the survivors because the dropped devices
    contribute no H. With identity views (upl == cor == 1) every step
    multiplies by 1.0 or selects through an all-true mask, so the
    result is bitwise the inputs."""
    contributing = contributing * upl
    Wu = {k: p * _bcast(cor, p) for k, p in W.items()}
    if guard:
        ok = _finite_mask(Wu)
        contributing = contributing * ok
        zero = torch.zeros((), dtype=torch.float32, device=ok.device)
        Wu = {k: torch.where(_bcast(ok > 0, p), p, zero)
              for k, p in Wu.items()}
    return Wu, contributing


def _evaluate(apply_fn, params, x, y):
    logits = apply_fn(params, x)
    return mm.ce_loss(logits, y), mm.accuracy(logits, y)


def _check_fault_dims(faults, T: int, n: int, tau: int) -> None:
    """Raise unless a FaultSchedule matches the run's (T, n, τ)."""
    if (faults.T, faults.n) != (T, n):
        raise ValueError(f"fault schedule is (T={faults.T}, n={faults.n})"
                         f" but the run is (T={T}, n={n})")
    if faults.tau != tau:
        raise ValueError(f"fault schedule has tau={faults.tau} but the "
                         f"run aggregates every tau={tau}")


def _stage_fault_ops(faults, T: int, n: int, tau: int, device):
    """Validate a FaultSchedule against the run's (T, n, τ) and return
    its (upload_ok, corrupt) views as (T, n) float32 on ``device``."""
    _check_fault_dims(faults, T, n, tau)
    upl, cor = faults.engine_arrays()
    return (torch.from_numpy(upl).to(device),
            torch.from_numpy(cor).to(device))


def _dims(processed) -> tuple[int, int]:
    """(T, n) of per-cell lists or a :class:`pipeline.FlatStreams`."""
    if isinstance(processed, pl.FlatStreams):
        return processed.T, processed.n
    return len(processed), len(processed[0])


def _fault_activity(act_all, faults):
    """The staged activity: crash outages ANDed into ``act_all``."""
    if faults is None:
        return act_all
    return np.asarray(act_all, bool) & faults.activity_mask()


class _Staged:
    """The staged rounds on the device: the (T, n, P) indices, labels
    and weights, the (T, n) counts and activity, the dataset and the
    test set, copied up once. ``batch(t)`` is round t's pixels,
    gathered all up front when the (T, n, P, ...) tensor fits
    ``PRESTAGE_LIMIT_BYTES`` and per round otherwise (the same numbers
    either way: a gather is exact)."""

    def __init__(self, processed, act_all, x_tr, y_tr, x_te, y_te,
                 max_pts: int, device):
        self.T, self.n = _dims(processed)
        idx, yb, wts, counts = pl.stage_rounds(processed, y_tr, max_pts)

        def up(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                                dtype)

        self.x = up(x_tr)
        self.idx = up(idx, torch.int64)
        item_bytes = math.prod(x_tr.shape[1:]) * 4
        prestage = (self.T * self.n * max_pts * item_bytes
                    <= PRESTAGE_LIMIT_BYTES)
        self.xb_all = self.x[self.idx] if prestage else None
        self.yb, self.w = up(yb, torch.int64), up(wts)
        self.cnt = up(counts)
        self.act = up(np.asarray(act_all, np.float32))
        self.x_te, self.y_te = up(x_te), up(y_te, torch.int64)

    def batch(self, t: int):
        if self.xb_all is not None:
            return self.xb_all[t]
        return self.x[self.idx[t]]


def _history(T: int, n: int, device, faults: bool) -> dict:
    """The per-round history buffers on the device, (T, ...) float32 as
    the reference's checkpointed scan keeps them: device losses, test
    loss and accuracy and H at the aggregation rounds (0 elsewhere),
    and under faults the surviving uploads and the quorum flag."""
    h = {"losses": torch.zeros((T, n), device=device),
         "tl": torch.zeros(T, device=device),
         "ta": torch.zeros(T, device=device),
         "H_at": torch.zeros((T, n), device=device)}
    if faults:
        h["surv"] = torch.zeros(T, device=device)
        h["qok"] = torch.ones(T, device=device)
    return h


class _ScanRound:
    """One round of the scan engine (eq. 3 for every device; at an
    aggregation round eq. (4), the sync and the evaluation), shared by
    the whole-horizon run and the checkpointed one, so a run cut into
    chunks performs the very same operations.

    The carry is (W, wg, H, waiting); the history buffers are filled in
    place. Under faults the aggregation is guarded and quorum-gated on
    the device: ``qok`` stays a 0-d tensor, selected on with
    ``torch.where``, never read by the host."""

    def __init__(self, apply_fn, eta, st: _Staged, is_agg, hist, fo,
                 guard: bool, quorum: float):
        self.apply_fn, self.st, self.is_agg, self.hist = (apply_fn, st,
                                                          is_agg, hist)
        self.step = make_device_step(apply_fn, float(eta))
        self.fo, self.guard, self.quorum = fo, guard, quorum

    def __call__(self, t: int, carry):
        W, wg, H, waiting = carry
        st, hist = self.st, self.hist
        a = st.act[t]
        active = a * (1.0 - waiting)
        W, hist["losses"][t] = self.step(W, st.batch(t), st.yb[t],
                                         st.w[t], active)
        H = H + st.cnt[t] * active
        if not self.is_agg[t]:
            return W, wg, H, waiting
        if self.fo is None:
            wg = aggregate(W, H, active, wg)
            W = _sync(W, wg, a > 0.5)
            hist["H_at"][t] = H
            H = torch.zeros_like(H)
            waiting = 1.0 - a
        else:
            Wu, contrib = _guarded_uploads(W, active, self.fo[0][t],
                                           self.fo[1][t], self.guard)
            surv = contrib.sum()
            qok = surv >= self.quorum * active.sum()
            new = aggregate(Wu, H, contrib, wg)
            # quorum failed: the whole aggregation event is skipped —
            # the previous global carries forward, no sync, and H keeps
            # accumulating into the next window
            wg = {k: torch.where(qok, new[k], old) for k, old in wg.items()}
            W = _sync(W, wg, (a > 0.5) & qok)
            hist["H_at"][t] = H
            H = torch.where(qok, torch.zeros_like(H), H)
            waiting = torch.where(qok, 1.0 - a, waiting)
            hist["surv"][t] = surv
            hist["qok"][t] = qok
        hist["tl"][t], hist["ta"][t] = _evaluate(self.apply_fn, wg,
                                                 st.x_te, st.y_te)
        return W, wg, H, waiting


def run_rounds_scan(apply_fn, params: dict, x_tr, y_tr, x_te, y_te,
                    processed, act_all, tau: int, eta: float,
                    max_pts: int, *, device, faults=None,
                    guard: bool = True, quorum: float = 0.0,
                    checkpoint_path: str | None = None,
                    checkpoint_every: int = 1, resume: str | None = None,
                    stop_after: int | None = None) -> dict:
    """Train all T rounds on ``device``; returns history pieces
    (``device_loss``, ``test_loss``, ``test_acc``, ``agg_round``,
    ``H_agg``) shaped as the reference's.

    ``faults`` — optional :class:`repro_torch.core.faults.
    FaultSchedule`: crash outages are ANDed into the staged activity,
    its (upload_ok, corrupt) views are staged on the device once, and
    every aggregation is guarded (``guard``: non-finite uploads
    dropped, H renormalized over the survivors) and quorum-gated
    (``quorum``: a window whose surviving uploads fall below that
    fraction of the active devices carries the previous global
    forward); the history gains ``agg_survivors`` and
    ``agg_quorum_ok``. ``faults=None`` runs the clean path.

    ``checkpoint_path`` — snapshot the carry (params stack, global, H,
    waiting), the (T, ...) history and the round index every
    ``checkpoint_every`` aggregation windows (:mod:`repro_torch.
    checkpoint.checkpoint`); ``resume`` continues such a snapshot, bit
    for bit what an uninterrupted run gives on the same device.
    ``stop_after`` (rounds; checkpointed runs only) ends the run at the
    next window boundary at or after it and reports ``stopped_at``."""
    fo = None
    if faults is not None:
        fo = _stage_fault_ops(faults, *_dims(processed), tau, device)
    st = _Staged(processed, _fault_activity(act_all, faults), x_tr, y_tr,
                 x_te, y_te, max_pts, device)
    T, n = st.T, st.n
    guard_f = bool(guard) if fo is not None else False
    quorum_f = float(quorum) if fo is not None else 0.0
    is_agg = (np.arange(T) + 1) % tau == 0
    hist = _history(T, n, device, fo is not None)
    rnd = _ScanRound(apply_fn, eta, st, is_agg, hist, fo, guard_f,
                     quorum_f)
    carry = (_stack(params, n), params, torch.zeros(n, device=device),
             torch.zeros(n, device=device))
    if checkpoint_path is not None or resume is not None:
        return _run_scan_checkpointed(
            rnd, carry, T, n, tau, eta, guard_f, quorum_f,
            checkpoint_path, checkpoint_every, resume, stop_after)
    # under run_network_aware(sanitize=...) no host sync or transfer may
    # happen in the round loop (staging above and the read-back below
    # are the design)
    with sanitize.hot_loop_guard() as outs:
        for t in range(T):
            carry = rnd(t, carry)
        outs.append({"carry": carry, "hist": hist})
    return _read_back(hist, np.nonzero(is_agg)[0], T)


def _run_scan_checkpointed(rnd: _ScanRound, carry, T, n, tau, eta, guard,
                           quorum, checkpoint_path, checkpoint_every,
                           resume, stop_after) -> dict:
    """The scan in chunks of ``checkpoint_every`` windows, the state
    snapshotted at each chunk's end (see :func:`run_rounds_scan`). The
    history is carried at its full (T, ...) shape in the snapshot so
    that the restore template is fixed; ``round`` says how much of it
    is real. The snapshot's copy to the host is the one
    synchronisation checkpointing adds."""
    from repro_torch.checkpoint import checkpoint as ckpt

    step = max(1, int(checkpoint_every)) * tau
    hist = rnd.hist

    def as_state(carry, rnd_idx):
        W, wg, H, waiting = carry
        return {"carry": {"W": W, "wg": wg, "H": H, "waiting": waiting},
                "hist": hist,
                "round": torch.tensor(rnd_idx, dtype=torch.int64)}

    run_meta = {"kind": "fog-scan", "T": int(T), "n": int(n),
                "tau": int(tau), "eta": float(eta),
                "faults": rnd.fo is not None, "guard": bool(guard),
                "quorum": float(quorum)}
    start = 0
    if resume is not None:
        state, meta = ckpt.restore(resume, as_state(carry, 0))
        for k, v in run_meta.items():
            if meta.get(k) != v:
                raise ValueError(
                    f"checkpoint {resume!r} was written by a run with "
                    f"{k}={meta.get(k)!r}; this run has {k}={v!r}")
        start = int(state["round"])
        c = state["carry"]
        carry = (c["W"], c["wg"], c["H"], c["waiting"])
        for k, v in state["hist"].items():
            hist[k].copy_(v)
    t0 = start
    while t0 < T:
        if stop_after is not None and t0 >= stop_after:
            break
        t1 = min(t0 + step, T)
        with sanitize.hot_loop_guard() as outs:
            for t in range(t0, t1):
                carry = rnd(t, carry)
            outs.append({"carry": carry, "hist": hist})
        t0 = t1
        if checkpoint_path is not None:
            ckpt.save(checkpoint_path, as_state(carry, t0),
                      metadata=run_meta)
    agg = np.nonzero(rnd.is_agg[:t0])[0]
    out = _read_back(hist, agg, t0)
    if t0 < T:
        out["stopped_at"] = int(t0)
    return out


# the tier segments of the last tree run, per device: one tree's are
# kept at a time
_TIER_SEGMENTS: dict = {}


def tier_segments(tree, device) -> list:
    """The :class:`TierSegments` of each tier of ``tree`` on ``device``,
    kept across runs of the same tree (keyed on its fingerprint), their
    layouts built up front."""
    key = (tree.fingerprint(), str(device))
    if key not in _TIER_SEGMENTS:
        _TIER_SEGMENTS.clear()
        _TIER_SEGMENTS[key] = [
            TierSegments(gids, ng, device)
            for gids, ng in zip(tree.parents, tree.group_counts)]
    segs = _TIER_SEGMENTS[key]
    for seg in segs:
        seg.groups()
    return segs


def run_rounds_hierarchical(apply_fn, params: dict, x_tr, y_tr, x_te,
                            y_te, processed, act_all, tau: int,
                            eta: float, max_pts: int, *, tree,
                            device, faults=None, guard: bool = True,
                            quorum: float = 0.0) -> dict:
    """Tier-aware training over a :class:`repro_torch.core.hierarchy.
    TierTree`: local SGD every round, and at each round whose index
    hits a tier period eq. (4) composes up the tree under cumulative H
    — devices to gateways, gateways to regional groups, … — through
    :func:`aggregate_tier`, for tiers 1 up to the round's highest
    aggregating tier (the tiers above it would be computed and thrown
    away). The global model changes only at top-tier rounds with
    H_top > 0. Each active device syncs from its ancestor at the
    round's highest tier where that group's H_g > 0. H resets only at
    top-tier rounds, so the top model telescopes to the flat eq. (4)
    over all contributing devices. The history (``test_loss``,
    ``test_acc``, ``H_agg``, ``agg_round``) is reported at top-tier
    rounds; ``tier_agg_round`` / ``tier_agg_level`` record every
    aggregation. As in :func:`run_rounds_scan`, the round loop does not
    synchronise with the host, and the history is read back once.

    ``faults`` ride as on the flat path: crash outages ANDed into the
    activity, uploads guarded at the device tier (the tiers compose
    from ``H * contrib``), and the quorum gating the whole event on
    the device — a failed quorum leaves the global, every device and H
    as they were, while the tier sums still run (their result is
    selected away), so the kernel launches are the clean path's.

    An L=1 tree runs :func:`run_rounds_scan` itself."""
    if tau != tree.taus[0]:
        raise ValueError(f"run tau={tau} but the tier tree aggregates "
                         f"its first tier every {tree.taus[0]}")
    if tree.levels == 1:
        return run_rounds_scan(apply_fn, params, x_tr, y_tr, x_te, y_te,
                               processed, act_all, tau, eta, max_pts,
                               device=device, faults=faults, guard=guard,
                               quorum=quorum)
    T, n = _dims(processed)
    if n != tree.n:
        raise ValueError(f"run has n={n} devices but the tree has "
                         f"n={tree.n}")
    fo = None if faults is None else _stage_fault_ops(faults, T, n, tau,
                                                      device)
    st = _Staged(processed, _fault_activity(act_all, faults), x_tr, y_tr,
                 x_te, y_te, max_pts, device)
    L = tree.levels
    lvl = tree.level_rounds(T)
    top = np.nonzero(lvl == L)[0]
    segs = tier_segments(tree, device)
    anc = [torch.from_numpy(a).to(device) for a in tree.ancestors()]

    step = make_device_step(apply_fn, float(eta))
    W = _stack(params, n)
    wg = params
    H = torch.zeros(n, device=device)
    waiting = torch.zeros(n, device=device)
    hist = _history(T, n, device, fo is not None)
    levels = lvl.tolist()
    with sanitize.hot_loop_guard() as outs:
        for t in range(T):
            a = st.act[t]
            active = a * (1.0 - waiting)
            W, hist["losses"][t] = step(W, st.batch(t), st.yb[t], st.w[t],
                                        active)
            H = H + st.cnt[t] * active
            lv = levels[t]
            if lv == 0:
                continue
            qok = None
            if fo is None:
                Wl, contrib = W, active
            else:
                Wl, contrib = _guarded_uploads(W, active, fo[0][t], fo[1][t],
                                               guard)
                surv = contrib.sum()
                qok = surv >= quorum * active.sum()
            Hl = H * contrib
            for seg in segs[:lv]:
                Wl, Hl = aggregate_tier(Wl, Hl, seg.group_ids, seg.num_groups,
                                        segments=seg)
            if lv == L:
                ok = Hl[0] > 0
                if qok is not None:
                    ok = ok & qok
                wg = {key: torch.where(ok, Wl[key][0], old)
                      for key, old in wg.items()}
            src = anc[lv - 1]
            sync = (a > 0.5) & (Hl[src] > 0)
            if qok is not None:
                sync = sync & qok
            W = {key: torch.where(_bcast(sync, p), Wl[key][src], p)
                 for key, p in W.items()}
            waiting = (1.0 - a if qok is None
                       else torch.where(qok, 1.0 - a, waiting))
            if lv == L:
                hist["H_at"][t] = H
                if qok is None:
                    H = torch.zeros_like(H)
                else:
                    H = torch.where(qok, torch.zeros_like(H), H)
                    hist["surv"][t] = surv
                    hist["qok"][t] = qok
                hist["tl"][t], hist["ta"][t] = _evaluate(apply_fn, wg,
                                                         st.x_te, st.y_te)
        outs.append({"W": W, "wg": wg, "H": H, "hist": hist})
    out = _read_back(hist, top, T)
    is_agg = lvl > 0
    out["tier_agg_round"] = [int(t) for t in np.nonzero(is_agg)[0]]
    out["tier_agg_level"] = [int(v) for v in lvl[is_agg]]
    return out


def _read_back(hist: dict, agg_rounds, t_end: int) -> dict:
    """The one read-back of a run: every (T, ...) history buffer in one
    copy, as the reference's history pieces up to round ``t_end`` at
    the recorded aggregation rounds ``agg_rounds``."""
    keys = list(hist)
    rec = torch.cat([hist[k].reshape(-1) for k in keys]).cpu().numpy()
    h, off = {}, 0
    for k in keys:
        size = hist[k].numel()
        h[k] = rec[off:off + size].reshape(hist[k].shape)
        off += size
    out = {"device_loss": list(h["losses"][:t_end]),
           "test_loss": [float(v) for v in h["tl"][agg_rounds]],
           "test_acc": [float(v) for v in h["ta"][agg_rounds]],
           "agg_round": [int(t) for t in agg_rounds],
           "H_agg": list(h["H_at"][agg_rounds])}
    if "surv" in h:
        out["agg_survivors"] = [float(v) for v in h["surv"][agg_rounds]]
        out["agg_quorum_ok"] = [bool(v > 0) for v in h["qok"][agg_rounds]]
    return out


def run_rounds_legacy(apply_fn, params: dict, x_tr, y_tr, x_te, y_te,
                      processed, act_all, tau: int, eta: float,
                      max_pts: int, *, device, faults=None,
                      guard: bool = True, quorum: float = 0.0) -> dict:
    """The per-round loop (fresh host→device copies of the padded batch
    every round, H accumulated on the host in float64) — the numerical
    oracle for ``run_rounds_scan``, under faults too: its quorum test
    is the reference's host float64 ``surv >= quorum * expected``, and
    a failed quorum records H without resetting it and leaves
    ``waiting`` as it was."""
    T, n = len(processed), len(processed[0])
    W = _stack(params, n)
    w_global = params
    step = make_device_step(apply_fn, float(eta))
    x_te_dev = torch.from_numpy(x_te).to(device)
    y_te_dev = torch.from_numpy(y_te).to(device, torch.int64)
    act_arr = np.asarray(_fault_activity(act_all, faults), bool)
    if faults is not None:
        upl, cor = _stage_fault_ops(faults, T, n, tau, device)
    H = np.zeros(n)
    waiting = np.zeros(n, bool)
    out = {"device_loss": [], "test_loss": [], "test_acc": [],
           "agg_round": [], "H_agg": []}
    if faults is not None:
        out["agg_survivors"] = []
        out["agg_quorum_ok"] = []
    for t in range(T):
        act = act_arr[t]
        xb, yb, wts = pl.pad_batches(processed[t], x_tr, y_tr, max_pts)
        contributing = torch.as_tensor(act & ~waiting, dtype=torch.float32,
                                       device=device)
        W, losses = step(W, torch.from_numpy(xb).to(device),
                         torch.from_numpy(yb).to(device, torch.int64),
                         torch.from_numpy(wts).to(device), contributing)
        H += np.array([len(ix) for ix in processed[t]]) * (act & ~waiting)
        out["device_loss"].append(losses.cpu().numpy())
        if (t + 1) % tau == 0:
            if faults is not None:
                Wu, contrib = _guarded_uploads(W, contributing, upl[t],
                                               cor[t], guard)
                surv = float(contrib.sum())
                expd = float(contributing.sum())
                qok = surv >= quorum * expd
                out["agg_survivors"].append(surv)
                out["agg_quorum_ok"].append(bool(qok))
                out["H_agg"].append(H.copy())
                if qok:
                    w_global = aggregate(
                        Wu, torch.as_tensor(H, dtype=torch.float32,
                                            device=device),
                        contrib, w_global)
                    W = _sync(W, w_global, torch.as_tensor(act,
                                                           device=device))
                    waiting = ~act
                    H[:] = 0.0
            else:
                w_global = aggregate(
                    W, torch.as_tensor(H, dtype=torch.float32,
                                       device=device),
                    contributing, w_global)
                W = _sync(W, w_global, torch.as_tensor(act, device=device))
                waiting = ~act  # whoever is out now waits for next sync
                out["H_agg"].append(H.copy())
                H[:] = 0.0
            tl, ta = _evaluate(apply_fn, w_global, x_te_dev, y_te_dev)
            out["agg_round"].append(t)
            out["test_loss"].append(float(tl))
            out["test_acc"].append(float(ta))
    return out


# ---------------------------------------------------------------------------
# the sweep engine: S scenarios of one shape bucket in one round loop
# ---------------------------------------------------------------------------

# host arrays pinned on the device across engine calls (a sweep calls
# the engine many times with the same dataset): keyed by the array's
# identity, shape, type and a sampled checksum (so treat arrays passed
# to the engine as immutable); the value keeps the host array alive so
# its id is not recycled. LRU: only the oldest entry is evicted.
_DEVICE_CACHE_CAP = 16
_DEVICE_CACHE: collections.OrderedDict = collections.OrderedDict()


def _to_device_cached(arr, device, dtype=None):
    arr = np.asarray(arr)
    key = (id(arr),) + _array_identity(arr) + (str(device), str(dtype))
    hit = _DEVICE_CACHE.get(key)
    if hit is None:
        while len(_DEVICE_CACHE) >= _DEVICE_CACHE_CAP:
            _DEVICE_CACHE.popitem(last=False)
        dev = torch.from_numpy(np.ascontiguousarray(arr)).to(device, dtype)
        hit = _DEVICE_CACHE[key] = (arr, dev)
    else:
        _DEVICE_CACHE.move_to_end(key)
    return hit[1]


def _array_identity(arr) -> tuple:
    """Cheap dataset fingerprint: shape, type and a sampled checksum
    (sparse in-place edits can slip through: engine inputs are treated
    as immutable)."""
    a = np.asarray(arr)
    flat = a.reshape(-1)
    sample = flat[::max(1, flat.size // 4096)]
    return (a.shape, str(a.dtype),
            float(np.asarray(sample, np.float64).sum()))


# per-phase host-clock accumulators of the sweep engine: "stage" is the
# host staging, fingerprint and upload, "program" the round loop (to the
# device's last operation), "eval" the stacked evaluation, "train" the
# program, the evaluation and the history assembly together. Reset and
# read around a timed region.
_PHASE = {"stage_s": 0.0, "program_s": 0.0, "eval_s": 0.0,
          "train_s": 0.0}


def phase_timings() -> dict:
    return dict(_PHASE)


def reset_phase_timings() -> None:
    _PHASE.update(stage_s=0.0, program_s=0.0, eval_s=0.0, train_s=0.0)


def add_phase_time(phase: str, seconds: float) -> None:
    """Fold externally timed work (e.g. a sweep's host data
    preparation) into a phase accumulator."""
    _PHASE[phase] = _PHASE.get(phase, 0.0) + float(seconds)


class AsyncEvaluator:
    """Test evaluation off the round loop.

    ``submit`` enqueues one evaluation of a parameter dict and returns
    (on the card the work runs in CUDA's own asynchrony, and nothing
    waits until ``collect``). ``submit_stack`` evaluates a whole stack
    of snapshots, e.g. a bucket's (windows, S) grid, in one
    ``torch.func.vmap`` of the evaluation, a snapshot at a time
    (``chunk_size=1``): a snapshot's numbers are then those of a scalar
    ``submit``, whatever the stack's size (a product over the whole
    stack would let the matrix library block it by that size). The test
    set is pinned on the device.

    Errors: a failure while enqueueing or while the result is read is
    never swallowed. It is kept and raised, the first failure chained,
    at the next ``collect()``/``result()``/``shutdown()``; a failed
    enqueue is first retried ``retries`` times with capped exponential
    backoff. The raised error lists every failure (``.failures``).
    ``submit`` after a kept failure does nothing, so a sweep fails once,
    where it collects; ``shutdown`` is idempotent."""

    def __init__(self, apply_fn, x_te, y_te, *, device=None,
                 retries: int = 3, backoff: float = 0.05,
                 backoff_cap: float = 1.0):
        self._device = resolve_device(device)
        self._apply = apply_fn
        self._x = _to_device_cached(x_te, self._device)
        self._y = _to_device_cached(y_te, self._device, torch.int64)
        self._pending: list = []
        self._errors: list[BaseException] = []
        self._retries = max(0, int(retries))
        self._backoff = float(backoff)
        self._backoff_cap = float(backoff_cap)
        self._closed = False

    def _params(self, params) -> dict:
        return {k: torch.as_tensor(v, dtype=torch.float32).to(self._device)
                for k, v in params.items()}

    def _dispatch(self, fn, *args) -> None:
        delay = self._backoff
        for attempt in range(self._retries + 1):
            try:
                with torch.no_grad():
                    self._pending.append(fn(*args))
                return
            except Exception as e:
                if attempt == self._retries:
                    self._errors.append(e)
                    return
                time.sleep(min(delay, self._backoff_cap))
                delay *= 2.0

    def submit(self, params) -> None:
        if self._errors:
            return                      # raised at the next collect()
        self._closed = False
        self._dispatch(lambda p: _evaluate(self._apply, self._params(p),
                                           self._x, self._y), params)

    def submit_stack(self, params_stack, n_axes: int = 1) -> None:
        """Evaluate a stack of snapshots at once: the leading ``n_axes``
        axes of every leaf are batch axes. The results arrive at
        ``collect()`` as arrays of that batch shape, in submission
        order."""
        if self._errors:
            return
        self._closed = False

        def ev(p, x, y):
            return _evaluate(self._apply, p, x, y)

        fn = ev
        for _ in range(int(n_axes)):
            fn = torch.func.vmap(fn, in_dims=(0, None, None), chunk_size=1)
        self._dispatch(lambda p: fn(self._params(p), self._x, self._y),
                       params_stack)

    def collect(self) -> tuple[list, list]:
        """Wait once for everything submitted; returns (losses, accs):
        floats for ``submit`` entries, arrays for ``submit_stack``
        ones. Raises, listing every failure, instead of returning part
        of the results."""
        errs = list(self._errors)
        losses, accs = [], []
        for item in self._pending:
            try:                        # the card's errors surface here
                tl, ta = (np.asarray(v.cpu()) for v in item)
                losses.append(float(tl) if tl.ndim == 0 else tl)
                accs.append(float(ta) if ta.ndim == 0 else ta)
            except Exception as e:
                errs.append(e)
        self._pending = []
        self._errors = []
        if errs:
            lines = "\n".join(f"  [{i}] {type(e).__name__}: {e}"
                              for i, e in enumerate(errs))
            exc = RuntimeError(f"AsyncEvaluator: {len(errs)} submitted "
                               f"evaluation(s) failed:\n{lines}")
            exc.failures = tuple(errs)
            raise exc from errs[0]
        return losses, accs

    def result(self) -> tuple[list, list]:
        """Alias of :meth:`collect`."""
        return self.collect()

    def shutdown(self) -> None:
        """Collect what is pending and raise a kept failure; a second
        call does nothing."""
        if self._closed:
            return
        self._closed = True
        self.collect()


# staged operands kept across calls: repeated sweeps (replan studies,
# fault grids, timing repeats) enter run_rounds_batched with the same
# streams; staging them again costs host work and an upload per operand.
# Keyed by a fingerprint of everything staging reads, bytes-capped LRU.
# The parameter stack is built fresh every call and never kept.
_STAGED_CACHE_LIMIT_BYTES = 512 * 1024 ** 2
_STAGED_CACHE: collections.OrderedDict = collections.OrderedDict()
_STAGED_CACHE_STATS = {"hits": 0, "misses": 0}


def staged_cache_stats() -> dict:
    """{'hits', 'misses'} of the staged-operand cache (process-wide)."""
    return dict(_STAGED_CACHE_STATS)


def reset_staged_cache() -> None:
    _STAGED_CACHE.clear()
    _STAGED_CACHE_STATS.update(hits=0, misses=0)


def _staged_nbytes(args: dict) -> int:
    return sum(v.numel() * v.element_size() for v in args.values()
               if isinstance(v, torch.Tensor))


def _staged_cache_put(key, args, meta) -> None:
    nbytes = _staged_nbytes(args)
    if nbytes > _STAGED_CACHE_LIMIT_BYTES:
        return                          # larger than the whole cache
    used = sum(e[2] for e in _STAGED_CACHE.values())
    while _STAGED_CACHE and used + nbytes > _STAGED_CACHE_LIMIT_BYTES:
        _, evicted = _STAGED_CACHE.popitem(last=False)
        used -= evicted[2]
    _STAGED_CACHE[key] = (args, meta, nbytes)


def _staged_fingerprint(processed_list, act_list, tau, bucket, staging,
                        max_points, device, faults, x_tr, y_tr, shard=None):
    """blake2b over everything the staged operands are a function of."""
    h = hashlib.blake2b(digest_size=16)
    mp = None if max_points is None else tuple(int(v) for v in max_points)
    h.update(repr((int(tau), bucket, staging, mp, str(device),
                   _array_identity(x_tr), _array_identity(y_tr))
                  + (() if shard is None else (shard,))).encode())
    for b, p in enumerate(processed_list):
        lens, ids = pl._cell_table(p)
        h.update(lens.tobytes())
        h.update(np.ascontiguousarray(ids).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(act_list[b], np.float32)).tobytes())
        f = None if faults is None else faults[b]
        if f is None:
            h.update(b"\x00nofault")
        else:
            for v in f.engine_arrays():
                h.update(np.ascontiguousarray(
                    np.asarray(v, np.float32)).tobytes())
    return h.digest()


def _rank_block(a, block, axis: int = 2):
    """The rank's contiguous block ``[lo, hi)`` of the fog-device axis,
    after padding that axis with zeros (phantom devices: no samples, no
    activity) to ``n_pad``; ``a`` itself when ``block`` is None."""
    if block is None:
        return a
    n_pad, lo, hi = block
    a = _pad_axis(np.asarray(a), n_pad, axis)
    return a[(slice(None),) * axis + (slice(lo, hi),)]


def _pad_axis(a, size: int, axis: int):
    if a.shape[axis] == size:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, size - a.shape[axis])
    return np.pad(a, pad)


def _stage_bucket_operands(processed_list, act_list, y_tr, tau, bucket,
                           staging, max_points, faults, x_dev, x_tr,
                           device, shard=None):
    """The staged device operands of one bucket run, and the host
    metadata that slices the histories back out: round-major (T_b, ...)
    tensors with the scenarios inside (dense idx/yb/w (T_b, S, n_b,
    P_b); ragged idx/yb/w (T_b, R_b, C) and cell (T_b, R_b)), counts and
    activity (T_b, S, n_b), the aggregation flags (windows, S) and, with
    faults, the window-last (upload_ok, corrupt) views (windows, S,
    n_b), identity for phantom windows and devices. Pixels are gathered
    up front when that fits ``PRESTAGE_LIMIT_BYTES``, per round
    otherwise. ``shard`` = (ranks, rank) stages (dense only) the rank's
    contiguous block of the device axis, padded with phantoms to a
    multiple of ``ranks``."""
    S = len(processed_list)
    mp = list(max_points) if max_points is not None else None
    item_bytes = int(np.prod(x_tr.shape[1:], dtype=np.int64)) * 4

    def up(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    block = None
    if staging == "ragged":
        batch = pl.stage_scenario_ragged(processed_list, y_tr, act_list,
                                         tau, max_points=mp, bucket=bucket)
        _, T_b, n_b, R_b, C = batch.dims
        prestage = T_b * R_b * C * item_bytes <= PRESTAGE_LIMIT_BYTES
        idx, yb, wts = batch.idx, batch.yb, batch.w
        M = S * n_b
        cell = up(batch.cell)
        extra = {"cell": cell,
                 "cell_safe": torch.clamp(cell, max=M - 1).long()}
        dims = (T_b, n_b, R_b, C)
    else:
        batch = pl.stage_scenario_batch(processed_list, y_tr, act_list,
                                        tau, max_points=mp, bucket=bucket)
        _, T_b, n_b, P_b = batch.dims
        n_loc = n_b
        if shard is not None:
            ranks, rank = shard
            n_loc = -(-n_b // ranks)
            block = (n_loc * ranks, rank * n_loc, (rank + 1) * n_loc)
        prestage = S * T_b * n_loc * P_b * item_bytes \
            <= PRESTAGE_LIMIT_BYTES

        def rounds_major(a):        # (T_b, S, n_b, ...), the rank's block
            return _rank_block(np.moveaxis(np.asarray(a), 0, 1), block)

        idx, yb, wts = (rounds_major(a) for a in
                        (batch.idx, batch.yb, batch.w))
        extra = {}
        dims = (T_b, n_b, P_b)
    n_win = T_b // tau
    st = {"yb": up(yb, torch.int64), "w": up(wts),
          "counts": up(_rank_block(np.moveaxis(batch.counts, 0, 1), block)),
          "act": up(_rank_block(np.moveaxis(batch.act, 0, 1), block)),
          # aggregations land on window-last rounds by construction
          "agg": up(np.asarray(batch.is_agg, np.float32)
                    .reshape(S, n_win, tau)[..., -1].T),
          **extra}
    idx_dev = up(idx, torch.int64)
    if prestage:
        st["xb_all"] = x_dev[idx_dev]
    else:
        st["idx"] = idx_dev
    if faults is not None:
        n_all = n_b if block is None else block[0]
        upl_w = np.ones((S, n_win, n_all), np.float32)
        cor_w = np.ones((S, n_win, n_all), np.float32)
        for b, f in enumerate(faults):
            if f is None:
                continue
            upl_v, cor_v = f.engine_arrays()        # (T_s, n_s)
            sl = slice(tau - 1, f.T, tau)
            upl_w[b, :f.T // tau, :f.n] = upl_v[sl]
            cor_w[b, :f.T // tau, :f.n] = cor_v[sl]
        st["upl"] = up(_rank_block(np.moveaxis(upl_w, 0, 1), block))
        st["cor"] = up(_rank_block(np.moveaxis(cor_w, 0, 1), block))
    meta = {"T": list(batch.T), "n": list(batch.n),
            "is_agg": np.asarray(batch.is_agg), "T_b": T_b, "n_b": n_b,
            "n_loc": n_b if block is None else block[2] - block[1],
            "n_win": n_win, "prestage": prestage, "dims": dims}
    return st, meta


def _row_loss_fn(apply_fn):
    """The UNNORMALIZED weighted cross-entropy of one ragged chunk row,
    the summand of ``mnist.ce_loss``'s numerator. The ragged round sums
    these per device and divides by the staged count afterwards (equal
    to the dense path's ``w.sum()``: 0/1 weights sum exactly)."""

    def lf(p, xb, yb, w):
        logp = torch.log_softmax(apply_fn(p, xb).float(), dim=-1)
        ll = logp.gather(1, yb[:, None])[:, 0]
        return -(ll * w).sum()

    return lf


class _RowGather(torch.autograd.Function):
    """Each ragged row's owner parameters gathered off the flat (M, ...)
    device stack. Phantom rows carry the trash id M: the gather reads
    row M − 1 for them (``cell_safe``, clamped), where the reference's
    ``mode="clip"`` reads it too. The backward is the transpose, each
    device's row gradients summed in ascending row order by
    ``ops.segment_sum_rows`` (the row kernel on the card), where the
    trash id adds nothing; torch's own backward of ``index_select``
    adds by atomics on the card, in no fixed order."""

    @staticmethod
    def forward(Wf, cell, cell_safe, layout):
        return Wf.index_select(0, cell_safe)

    @staticmethod
    def setup_context(ctx, inputs, output):
        Wf, cell, _, layout = inputs
        ctx.save_for_backward(cell)
        ctx.shape, ctx.layout = Wf.shape, layout

    @staticmethod
    def backward(ctx, grad_rows):
        cell, = ctx.saved_tensors
        M = ctx.shape[0]
        g = ops.segment_sum_rows(
            grad_rows.reshape(grad_rows.shape[0], -1).contiguous(), cell,
            num_segments=M, layout=ctx.layout)
        return g.reshape(ctx.shape), None, None, None


def _layout(ids, num_segments: int):
    """The segment layout of ``ids`` on the card (built once for all the
    leaves that reduce over them); None on the CPU, where the plain
    versions need none."""
    if ids.device.type != "cuda":
        return None
    return sr.segment_layout(ids, num_segments)


# bucket programs by (model, η, prestage, faults, guard, quorum, staging);
# each records the bucket shapes it ran, the port's analogue of the
# reference's per-shape jit cache entries. A program holds closures
# only, so none is evicted.
_BUCKET_PROGRAMS: dict = {}


def batched_compile_count() -> int:
    """The number of distinct (bucket program, bucket shape) keys the
    sweep engine has run. The port builds nothing at run time (no
    ``torch.compile``): this is the analogue of the reference's count of
    jit cache entries, one per program and shape bucket. Each new key is
    also one compile event of :mod:`repro_torch.core.monitoring`."""
    return sum(len(p.shapes) for p in _BUCKET_PROGRAMS.values())


def _bucket_program(apply_fn, eta: float, prestage: bool, faults: bool,
                    guard: bool, quorum: float, staging: str):
    key = (apply_fn, eta, prestage, faults, guard, quorum, staging)
    if key not in _BUCKET_PROGRAMS:
        _BUCKET_PROGRAMS[key] = _BucketProgram(
            apply_fn, eta, prestage, faults, guard, quorum, staging)
    return _BUCKET_PROGRAMS[key]


class _BucketProgram:
    """One bucket of S scenarios trained together: the port of the
    reference's ``_bucket_program``, as a Python loop over (T_b/τ)
    aggregation windows of τ rounds, with the reference's order of
    operations kept literally so that the histories come out the same.

    The device axis is the flat (M = S·n_b) stack. A dense round runs
    :func:`make_device_step` over the M rows; a ragged round gathers the
    chunk rows' owner parameters (:class:`_RowGather`), sums the rows'
    losses and takes the gradient of that sum with respect to the
    stack, whose backward sums each device's row gradients by
    ``ops.segment_sum_rows``; the per-device losses are the same row sum
    over M + 1 segments (the last the trash), divided by the staged
    count.

    Aggregation is deferred by one window, as the reference's double
    buffer: window w's epilogue issues eq. (4)'s H-weighted sums
    (:meth:`agg_sums`, a fixed-order sum over the devices of each
    scenario: one row-kernel launch per leaf into S segments, and the
    1-D kernel for the H totals), and window w + 1's prologue divides,
    syncs and updates ``waiting``. Under faults the uploads are guarded
    and the quorum decision and the H reset move to the prologue too,
    so a window that fails its quorum keeps H accumulating. One card
    gains no overlap from this: the order is kept for the bits.

    With a process ``group`` (the sharded engine), the stack holds this
    rank's contiguous block of each scenario's devices, and eq. (4)'s
    sums are completed across the ranks: one all-reduce of every leaf's
    numerator (one flat buffer) and one of the H totals a window, plus
    one of the survivor and expected counts under faults."""

    def __init__(self, apply_fn, eta, prestage, faults, guard, quorum,
                 staging):
        self.apply_fn, self.eta = apply_fn, float(eta)
        self.prestage, self.faults = prestage, faults
        self.guard, self.quorum = guard, quorum
        self.ragged = staging == "ragged"
        self.step = make_device_step(apply_fn, self.eta)
        self.vrow = torch.func.vmap(_row_loss_fn(apply_fn))
        self.shapes: set = set()

    def agg_sums(self, W, H, contributing, scen, group=None):
        """Eq. (4)'s numerator and denominator per scenario: Σ H_i·c_i·
        w_i and Σ H_i·c_i over each scenario's n_b devices, in ascending
        device order from zero, one product and one add an entry, so a
        scenario's bits are the same alone and in a bucket (phantom
        devices add +0). ``scen`` is (ids, layout) of the rows'
        scenarios. With a ``group``, each rank sums its own devices and
        the partial sums are all-reduced (a copy on one rank)."""
        ids, lay = scen
        S = H.shape[0]
        hc = (H * contributing).reshape(-1)
        num = {k: ops.segment_sum_rows(
                   p.reshape(p.shape[0], -1), ids, num_segments=S,
                   scale=hc, layout=lay)
               for k, p in W.items()}
        tot = ops.segment_sum(hc, ids, num_segments=S, layout=lay)
        if group is not None:
            num = dict(zip(num, all_reduce_flat(list(num.values()), group)))
            tot = all_reduce_sum(tot, group)
        return {k: v.reshape((S,) + W[k].shape[1:])
                for k, v in num.items()}, tot

    @staticmethod
    def finalize(p_num, p_tot, p_flag, wg):
        """The deferred divide: the new global of each scenario whose
        window aggregated with a positive H total; the old one
        elsewhere."""
        live = (p_flag > 0) & (p_tot > 0)
        den = torch.clamp(p_tot, min=1e-9)
        return {k: torch.where(_bcast(live, old), p_num[k] / _bcast(den, old),
                               old) for k, old in wg.items()}

    def ragged_round(self, W, xb, yb, w, cell, cell_safe, cnt, active):
        M = cnt.numel()
        denom = torch.clamp(cnt.reshape(M), min=1.0)
        scale = (active * torch.clamp(cnt, max=1.0)).reshape(M)
        lay = _layout(cell, M)
        leaves = {k: p.detach().requires_grad_(True) for k, p in W.items()}
        with torch.enable_grad():
            Wr = {k: _RowGather.apply(p, cell, cell_safe, lay)
                  for k, p in leaves.items()}
            rloss = self.vrow(Wr, xb, yb, w)
            grads = torch.autograd.grad(rloss.sum(), list(leaves.values()))
        lsum = ops.segment_sum_rows(rloss.detach(), cell,
                                    num_segments=M + 1,
                                    layout=_layout(cell, M + 1))[:M]
        new = {}
        for (k, p), g in zip(W.items(), grads):
            g = g / _bcast(denom, g)
            new[k] = p - _bcast(self.eta * scale, p) * g
        return new, lsum / denom

    def __call__(self, W, wg, x_dev, st, tau: int, group=None):
        T_b, S, n = st["counts"].shape
        M, n_win = S * n, T_b // tau
        dev = x_dev.device
        scen_ids = torch.arange(S, dtype=torch.int32,
                                device=dev).repeat_interleave(n)
        scen = (scen_ids, _layout(scen_ids, S))
        zeros = torch.zeros((S, n), device=dev)
        zs = torch.zeros(S, device=dev)
        H, waiting = zeros, zeros
        p_num = {k: torch.zeros_like(v) for k, v in wg.items()}
        p_tot, p_act, p_flag = zs, zeros, zs
        p_surv = p_expd = zs
        losses = torch.empty((T_b, S, n), device=dev)
        H_w = torch.empty((n_win, S, n), device=dev)
        wg_ys = {k: torch.empty((n_win,) + v.shape, device=dev)
                 for k, v in wg.items()}
        fo = None
        if self.faults:
            fo = {k: torch.empty((n_win, S), device=dev)
                  for k in ("surv", "expd", "qok")}
        for win in range(n_win):
            if self.faults:
                # the previous window's quorum decision lands here, with
                # its deferred sums
                qok_f = (p_surv >= self.quorum * p_expd).float()
                p_flag = p_flag * qok_f
            # prologue: realize the aggregation the previous window
            # issued (divide, sync, waiting)
            wg = self.finalize(p_num, p_tot, p_flag, wg)
            flag = (p_flag > 0)[:, None]
            sync = flag & (p_act > 0.5)                       # (S, n)
            W = {k: torch.where(
                     sync.reshape((S, n) + (1,) * (p.dim() - 1)),
                     wg[k][:, None], p.reshape((S, n) + p.shape[1:]))
                 .reshape(p.shape) for k, p in W.items()}
            waiting = torch.where(flag, 1.0 - p_act, waiting)
            if self.faults:
                H = torch.where(flag, torch.zeros_like(H), H)
            t0 = win * tau
            a = st["act"][t0:t0 + tau]
            act_eff = a * (1.0 - waiting)                     # (τ, S, n)
            for r in range(tau):
                t = t0 + r
                if "xb_all" in st:
                    xb = st["xb_all"][t]
                else:
                    xb = x_dev[st["idx"][t]]
                cnt_r, a_r = st["counts"][t], act_eff[r]
                if self.ragged:
                    W, lt = self.ragged_round(
                        W, xb, st["yb"][t], st["w"][t], st["cell"][t],
                        st["cell_safe"][t], cnt_r, a_r)
                else:
                    P = xb.shape[2]
                    W, lt = self.step(
                        W, xb.reshape((M, P) + xb.shape[3:]),
                        st["yb"][t].reshape(M, P), st["w"][t].reshape(M, P),
                        a_r.reshape(M))
                losses[t] = lt.reshape(S, n)
                H = H + cnt_r * a_r
            # epilogue: issue this window's H-weighted sums; the next
            # prologue consumes them
            H_w[win] = H
            for k, v in wg.items():
                wg_ys[k][win] = v
            agg = st["agg"][win]
            if self.faults:
                Wu, contrib = _guarded_uploads(
                    W, act_eff[-1].reshape(M), st["upl"][win].reshape(M),
                    st["cor"][win].reshape(M), self.guard)
                contrib = contrib.reshape(S, n)
                num, tot = self.agg_sums(Wu, H, contrib, scen, group)
                fo["surv"][win], fo["expd"][win] = p_surv, p_expd
                fo["qok"][win] = qok_f
                counts = torch.stack([contrib.sum(1), act_eff[-1].sum(1)])
                if group is not None:
                    all_reduce_sum(counts, group)
                p_surv, p_expd = counts
            else:
                num, tot = self.agg_sums(W, H, act_eff[-1], scen, group)
                H = torch.where(agg[:, None] > 0, torch.zeros_like(H), H)
            p_num, p_tot, p_act, p_flag = num, tot, a[-1], agg
        # window w's snapshot is the global BEFORE its aggregation
        # realizes: shift by one and realize the last pending window
        if self.faults:
            qok_last = (p_surv >= self.quorum * p_expd).float()
            wg_last = self.finalize(p_num, p_tot, p_flag * qok_last, wg)
            last = {"surv": p_surv, "expd": p_expd, "qok": qok_last}
            fo = {k: torch.cat([v[1:], last[k][None]]) for k, v in fo.items()}
        else:
            wg_last = self.finalize(p_num, p_tot, p_flag, wg)
        wg_win = {k: torch.cat([v[1:], wg_last[k][None]])
                  for k, v in wg_ys.items()}
        return losses, H_w, wg_win, fo


def _check_mesh(mesh) -> None:
    """"auto", None, or a 1-D "data" ``DeviceMesh``."""
    if mesh in ("auto", None):
        return
    if tuple(getattr(mesh, "mesh_dim_names", None) or ()) != ("data",):
        raise ValueError(f"mesh must be 'auto', None or a 1-D 'data' "
                         f"DeviceMesh (launch/mesh.make_data_mesh); got "
                         f"{mesh!r}")


def _resolve_mesh(mesh, processed_list, bucket, device):
    """``mesh="auto"``: a data mesh (``launch/mesh.data_mesh_for`` the
    bucket's device count) when the default group has more than one
    rank, else None (one card)."""
    if mesh != "auto":
        return mesh
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return None
    from repro_torch.launch.mesh import data_mesh_for

    n_max = max(p.n if isinstance(p, pl.FlatStreams) else len(p[0])
                for p in processed_list)
    return data_mesh_for(pl.bucket_size(
        n_max, bucket, max_inflation=pl.BUCKET_MAX_INFLATION), device)


def _gather_devices(t, mesh):
    """The ranks' (..., n_loc) blocks of ``t`` joined along the last
    axis, in rank order, on every rank of ``mesh``."""
    parts = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group("data"))
    return torch.cat(parts, dim=-1)


def run_rounds_batched(apply_fn, params_list, x_tr, y_tr, x_te, y_te,
                       processed_list, act_list, tau: int, eta: float,
                       max_points=None, *, bucket: str = "pow2",
                       mesh="auto", staging: str = "dense", faults=None,
                       guard: bool = True, quorum: float = 0.0,
                       device=None) -> list[dict]:
    """Train a whole bucket of S scenarios in one round loop on
    ``device`` (``cuda`` by default).

    ``processed_list``/``act_list``/``params_list`` carry the S
    scenarios, possibly of different true (T, n, P): they are padded to
    the shared shape bucket with phantom inactive rounds and devices
    (:func:`pipeline.stage_scenario_batch`), and must share the dataset,
    model, η and τ. Returns one history per scenario, sliced back to its
    true (T, n), the keys of :func:`run_rounds_scan`. Evaluation of the
    whole (windows, S) snapshot grid is one stacked
    :class:`AsyncEvaluator` call.

    ``staging``: "dense" stages padded (S, T_b, n_b, P_b) slabs;
    "ragged" stages chunk-row tables (:func:`pipeline.
    stage_scenario_ragged`), so each round's work follows the bucket's
    real sample total. Either way a scenario's history is bitwise the
    same as that scenario run alone at the same staging (dense: alone
    with ``max_points`` the bucket's P_b), on the CPU; it matches
    :func:`run_rounds_scan` within the engines' tolerances (eq. (4) is
    a sequential sum here, an einsum there). Staged device operands are
    kept across calls (:func:`staged_cache_stats`).

    ``faults`` — optional list of per-scenario FaultSchedules (entries
    may be None): crash outages join each scenario's activity and the
    window-last (upload_ok, corrupt) views ride the windows, under the
    shared ``guard`` and ``quorum`` (see :func:`run_rounds_scan`).

    ``mesh``: None is one card; a 1-D "data" ``DeviceMesh`` (dense
    staging only) shards the device axis: the bucket's n_b devices are
    padded with phantoms (no data, never active, H = 0) to a multiple of
    the mesh's extent, each rank trains its contiguous block, eq. (4)'s
    sums are all-reduced over the mesh's group, and the losses and H
    are gathered back, so every rank returns the whole histories. On
    one rank the run is bitwise the run with ``mesh=None``; on several
    the cross-rank sums reassociate eq. (4). Ranks of the default group
    outside a narrower mesh receive the histories from rank 0.
    ``"auto"`` is a mesh when the default group has more than one rank
    (:func:`_resolve_mesh`), else None."""
    t_stage0 = time.perf_counter()
    device = resolve_device(device)
    if staging not in ("dense", "ragged"):
        raise ValueError(f"staging must be 'dense' or 'ragged'; "
                         f"got {staging!r}")
    _check_mesh(mesh)
    mesh = _resolve_mesh(mesh, processed_list, bucket, device)
    shard = group = None
    if mesh is not None:
        if staging == "ragged":
            raise ValueError("ragged staging runs on one card only; pass "
                             "mesh=None (or staging='dense')")
        if mesh.get_coordinate() is None:
            return _share_hists(None, mesh)
        shard = (mesh.size(), mesh.get_local_rank())
        group = mesh.get_group("data")
    S = len(processed_list)
    use_faults = faults is not None and any(f is not None for f in faults)
    if use_faults:
        if len(faults) != S:
            raise ValueError(f"faults list has {len(faults)} entries "
                             f"for {S} scenarios")
        act_list = list(act_list)
        for b, f in enumerate(faults):
            if f is None:
                continue
            _check_fault_dims(f, *_dims(processed_list[b]), tau)
            act_list[b] = np.asarray(act_list[b], bool) \
                & f.activity_mask()
    guard_f = bool(guard) if use_faults else False
    quorum_f = float(quorum) if use_faults else 0.0
    x_dev = _to_device_cached(x_tr, device)
    cache_key = _staged_fingerprint(
        processed_list, act_list, tau, bucket, staging, max_points,
        device, faults if use_faults else None, x_tr, y_tr, shard)
    hit = _STAGED_CACHE.get(cache_key)
    if hit is not None:
        _STAGED_CACHE.move_to_end(cache_key)
        _STAGED_CACHE_STATS["hits"] += 1
        st, meta, _ = hit
    else:
        _STAGED_CACHE_STATS["misses"] += 1
        st, meta = _stage_bucket_operands(
            processed_list, act_list, y_tr, tau, bucket, staging,
            max_points, faults if use_faults else None, x_dev, x_tr,
            device, shard)
        _staged_cache_put(cache_key, st, meta)
    n_b = meta["n_loc"]
    keys = list(params_list[0])

    def leaf(p, k):
        return torch.as_tensor(p[k], dtype=torch.float32).to(device)

    wg0 = {k: torch.stack([leaf(p, k) for p in params_list]) for k in keys}
    W0 = {k: v[:, None].expand(S, n_b, *v.shape[1:])
          .reshape(S * n_b, *v.shape[1:]) for k, v in wg0.items()}
    t_train0 = time.perf_counter()
    _PHASE["stage_s"] += t_train0 - t_stage0
    prog = _bucket_program(apply_fn, eta, meta["prestage"], use_faults,
                           guard_f, quorum_f, staging)
    shape = (S,) + meta["dims"]
    if shape not in prog.shapes:        # a new (program, shape) key
        prog.shapes.add(shape)
        monitoring.record_compile(0.0)
    with torch.no_grad(), sanitize.hot_loop_guard() as outs:
        losses, H_w, wg_win, fo = prog(W0, wg0, x_dev, st, tau, group)
        if mesh is not None:
            losses = _gather_devices(losses, mesh)
            H_w = _gather_devices(H_w, mesh)
        outs.append({"losses": losses, "H": H_w, "wg": wg_win,
                     "faults": fo})
    synchronize(device)
    t_eval0 = time.perf_counter()
    _PHASE["program_s"] += t_eval0 - t_train0
    ev = AsyncEvaluator(apply_fn, x_te, y_te, device=device)
    ev.submit_stack(wg_win, n_axes=2)
    (tl,), (ta,) = ev.collect()
    _PHASE["eval_s"] += time.perf_counter() - t_eval0

    losses = losses.cpu().numpy()
    H_w = H_w.cpu().numpy()
    if fo is not None:
        fo = {k: v.cpu().numpy() for k, v in fo.items()}
    hists = []
    for b in range(S):
        T, n = meta["T"][b], meta["n"][b]
        agg_rounds = np.nonzero(meta["is_agg"][b, :T])[0]
        wins = agg_rounds // tau
        h = {"device_loss": list(losses[:T, b, :n]),
             "test_loss": [float(v) for v in tl[wins, b]],
             "test_acc": [float(v) for v in ta[wins, b]],
             "agg_round": [int(t) for t in agg_rounds],
             "H_agg": list(H_w[wins, b][:, :n])}
        if fo is not None:
            h["agg_survivors"] = [float(v) for v in fo["surv"][wins, b]]
            h["agg_quorum_ok"] = [bool(v > 0) for v in fo["qok"][wins, b]]
        hists.append(h)
    _PHASE["train_s"] += time.perf_counter() - t_train0
    return hists if mesh is None else _share_hists(hists, mesh)


def _share_hists(hists, mesh):
    """The histories on every rank of the default group: a mesh as wide
    as the world has them everywhere; otherwise rank 0 (a member)
    broadcasts them to the ranks outside the mesh."""
    if mesh.size() == dist.get_world_size():
        return hists
    box = [hists]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def run_rounds_batched_single(apply_fn, params, x_tr, y_tr, x_te, y_te,
                              processed, act_all, tau: int, eta: float,
                              max_pts: int, *, mesh="auto",
                              staging: str = "dense", faults=None,
                              guard: bool = True, quorum: float = 0.0,
                              device=None) -> dict:
    """One scenario through the sweep engine (``engine="batched"``,
    S = 1): the same round loop, exact pad sizes."""
    return run_rounds_batched(
        apply_fn, [params], x_tr, y_tr, x_te, y_te, [processed],
        [act_all], tau, eta, [max_pts], bucket="exact", mesh=mesh,
        staging=staging, faults=None if faults is None else [faults],
        guard=guard, quorum=quorum, device=device)[0]


def run_rounds_sharded(apply_fn, params, x_tr, y_tr, x_te, y_te,
                       processed, act_all, tau: int, eta: float,
                       max_pts: int, *, mesh=None, faults=None,
                       guard: bool = True, quorum: float = 0.0,
                       device=None) -> dict:
    """Device-sharded training (``engine="sharded"``): the S = 1 slice of
    :func:`run_rounds_batched` over a 1-D "data" ``DeviceMesh`` (default:
    ``launch/mesh.make_data_mesh`` over the default group's world, made
    by ``launch/mesh.init_process_group`` when there is none). The n fog
    devices are padded with phantoms to a multiple of the mesh's extent
    and split into contiguous blocks, one a rank; eq. (4) is kernel 2's
    row sum over the rank's devices followed by an all-reduce of the
    numerator and of the H total. At world size 1 the history is
    bitwise :func:`run_rounds_batched_single`'s; on more ranks it
    matches :func:`run_rounds_scan` up to the reassociated sums."""
    if mesh is None:
        from repro_torch.launch.mesh import make_data_mesh

        mesh = make_data_mesh(device=device)
    return run_rounds_batched(
        apply_fn, [params], x_tr, y_tr, x_te, y_te, [processed],
        [act_all], tau, eta, [max_pts], bucket="exact", mesh=mesh,
        faults=None if faults is None else [faults], guard=guard,
        quorum=quorum, device=device)[0]
