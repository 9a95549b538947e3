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

import math

import numpy as np
import torch

from repro_torch.data import pipeline as pl
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as sr
from repro_torch.models import mnist as mm

PRESTAGE_LIMIT_BYTES = 256 * 1024 ** 2


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


def _stage_fault_ops(faults, T: int, n: int, tau: int, device):
    """Validate a FaultSchedule against the run's (T, n, τ) and return
    its (upload_ok, corrupt) views as (T, n) float32 on ``device``."""
    if (faults.T, faults.n) != (T, n):
        raise ValueError(f"fault schedule is (T={faults.T}, n={faults.n})"
                         f" but the run is (T={T}, n={n})")
    if faults.tau != tau:
        raise ValueError(f"fault schedule has tau={faults.tau} but the "
                         f"run aggregates every tau={tau}")
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
    for t in range(T):
        carry = rnd(t, carry)
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
        for t in range(t0, t1):
            carry = rnd(t, carry)
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
    for t in range(T):
        a = st.act[t]
        active = a * (1.0 - waiting)
        W, hist["losses"][t] = step(W, st.batch(t), st.yb[t], st.w[t],
                                    active)
        H = H + st.cnt[t] * active
        lv = int(lvl[t])
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
