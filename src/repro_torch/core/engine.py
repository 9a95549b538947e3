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
    """The segment ids of one tier's reductions: the (m,) member→group
    ids for the group weights H_g, and ``g·P + p`` over the (m, P)
    stack for a leaf of P parameters. On the card each comes with the
    kernel's layout. Built at first use and kept, so a run builds each
    (tier, leaf width) once."""

    def __init__(self, group_ids, num_groups: int, device):
        self.device = torch.device(device)
        self.num_groups = int(num_groups)
        self.group_ids = torch.as_tensor(
            np.asarray(group_ids)).to(self.device, torch.int32)
        self._groups = None
        self._params: dict = {}

    def _entry(self, ids, num_segments):
        layout = (sr.segment_layout(ids, num_segments)
                  if self.device.type == "cuda" else None)
        return ids, layout

    def groups(self):
        """(ids, layout) of the H_g reduction."""
        if self._groups is None:
            self._groups = self._entry(self.group_ids, self.num_groups)
        return self._groups

    def params(self, P: int):
        """(ids, layout) of the (group, parameter) reduction of a leaf
        with P parameters per member."""
        if P not in self._params:
            p = torch.arange(P, dtype=torch.int32, device=self.device)
            ids = (self.group_ids[:, None] * P + p[None]).reshape(-1)
            self._params[P] = self._entry(ids, self.num_groups * P)
        return self._params[P]


def aggregate_tier(W: dict, H, group_ids, num_groups: int, *,
                   segments: TierSegments | None = None):
    """Eq. (4) per group of one tier: ``W`` a (m, ...) stack (devices at
    tier 1, child groups above), ``H`` the (m,) cumulative weights,
    ``group_ids`` the (m,) member→group map. Returns the (num_groups,
    ...) stack of group models and the group totals H_g, so tiers
    compose: feeding the outputs back in telescopes to the flat eq. (4)
    over the union. One segment sum per leaf, segments being (group,
    parameter) pairs, with the divide and ``where`` of
    :func:`aggregate_edges`: a group's row is bitwise what
    ``aggregate_edges`` over its ascending member list gives. An empty
    group (H_g == 0) comes back as zeros. ``segments``, built from the
    same ``group_ids``, carries the tier's ids and layouts from one call
    to the next."""
    if segments is None:
        segments = TierSegments(group_ids, num_groups, H.device)
    G = segments.num_groups
    m = H.shape[0]
    gids, glay = segments.groups()
    Hg = ops.segment_sum(H, gids, num_segments=G, layout=glay)
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    den = torch.clamp(Hg, min=1e-9)[:, None]
    ok = Hg[:, None] > 0
    out = {}
    for key, a in W.items():
        P = math.prod(a.shape[1:])
        flat = (a.reshape(m, P) * H[:, None]).reshape(-1)
        ids, lay = segments.params(P)
        s = ops.segment_sum(flat, ids, num_segments=G * P, layout=lay)
        o = torch.where(ok, s.reshape(G, P) / den, zero)
        out[key] = o.reshape((G,) + a.shape[1:]).to(a.dtype)
    return out, Hg


def _sync(W: dict, w_global: dict, active) -> dict:
    """Devices with ``active`` set take the global model."""
    return {k: torch.where(_bcast(active, p), w_global[k][None], p)
            for k, p in W.items()}


def _evaluate(apply_fn, params, x, y):
    logits = apply_fn(params, x)
    return mm.ce_loss(logits, y), mm.accuracy(logits, y)


class _Staged:
    """The staged rounds on the device: the (T, n, P) indices, labels
    and weights, the (T, n) counts and activity, the dataset and the
    test set, copied up once. ``batch(t)`` is round t's pixels,
    gathered all up front when the (T, n, P, ...) tensor fits
    ``PRESTAGE_LIMIT_BYTES`` and per round otherwise (the same numbers
    either way: a gather is exact)."""

    def __init__(self, processed, act_all, x_tr, y_tr, x_te, y_te,
                 max_pts: int, device):
        self.T, self.n = len(processed), len(processed[0])
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


def run_rounds_scan(apply_fn, params: dict, x_tr, y_tr, x_te, y_te,
                    processed, act_all, tau: int, eta: float,
                    max_pts: int, *, device) -> dict:
    """Train all T rounds on ``device``; returns history pieces
    (``device_loss``, ``test_loss``, ``test_acc``, ``agg_round``,
    ``H_agg``) shaped as the reference's."""
    st = _Staged(processed, act_all, x_tr, y_tr, x_te, y_te, max_pts,
                 device)
    T, n = st.T, st.n
    is_agg = (np.arange(T) + 1) % tau == 0
    agg_rounds = np.nonzero(is_agg)[0]
    K = len(agg_rounds)

    step = make_device_step(apply_fn, float(eta))
    W = _stack(params, n)
    wg = params
    H = torch.zeros(n, device=device)
    waiting = torch.zeros(n, device=device)
    losses = torch.empty((T, n), device=device)
    H_at = torch.empty((K, n), device=device)
    evals = torch.empty((K, 2), device=device)
    k = 0
    for t in range(T):
        active = st.act[t] * (1.0 - waiting)
        W, losses[t] = step(W, st.batch(t), st.yb[t], st.w[t], active)
        H = H + st.cnt[t] * active
        if is_agg[t]:
            wg = aggregate(W, H, active, wg)
            W = _sync(W, wg, st.act[t] > 0.5)
            H_at[k] = H
            H = torch.zeros_like(H)
            waiting = 1.0 - st.act[t]
            evals[k, 0], evals[k, 1] = _evaluate(apply_fn, wg, st.x_te,
                                                 st.y_te)
            k += 1
    return _read_back(losses, H_at, evals, agg_rounds)


# the tier segments of the last tree run, per device: the layouts of a
# fog-scale tree fill about a gigabyte of device memory, so one tree's
# are kept at a time
_TIER_SEGMENTS: dict = {}


def tier_segments(tree, device, widths=()) -> list:
    """The :class:`TierSegments` of each tier of ``tree`` on ``device``,
    kept across runs of the same tree (keyed on its fingerprint), with
    the H_g reduction and the reductions of leaves of the given
    ``widths`` built up front."""
    key = (tree.fingerprint(), str(device))
    if key not in _TIER_SEGMENTS:
        _TIER_SEGMENTS.clear()
        _TIER_SEGMENTS[key] = [
            TierSegments(gids, ng, device)
            for gids, ng in zip(tree.parents, tree.group_counts)]
    segs = _TIER_SEGMENTS[key]
    for seg in segs:
        seg.groups()
        for P in widths:
            seg.params(P)
    return segs


def run_rounds_hierarchical(apply_fn, params: dict, x_tr, y_tr, x_te,
                            y_te, processed, act_all, tau: int,
                            eta: float, max_pts: int, *, tree,
                            device) -> dict:
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

    An L=1 tree runs :func:`run_rounds_scan` itself."""
    if tau != tree.taus[0]:
        raise ValueError(f"run tau={tau} but the tier tree aggregates "
                         f"its first tier every {tree.taus[0]}")
    if tree.levels == 1:
        return run_rounds_scan(apply_fn, params, x_tr, y_tr, x_te, y_te,
                               processed, act_all, tau, eta, max_pts,
                               device=device)
    T, n = len(processed), len(processed[0])
    if n != tree.n:
        raise ValueError(f"run has n={n} devices but the tree has "
                         f"n={tree.n}")
    st = _Staged(processed, act_all, x_tr, y_tr, x_te, y_te, max_pts,
                 device)
    L = tree.levels
    lvl = tree.level_rounds(T)
    top = np.nonzero(lvl == L)[0]
    segs = tier_segments(tree, device,
                         [math.prod(p.shape) for p in params.values()])
    anc = [torch.from_numpy(a).to(device) for a in tree.ancestors()]

    step = make_device_step(apply_fn, float(eta))
    W = _stack(params, n)
    wg = params
    H = torch.zeros(n, device=device)
    waiting = torch.zeros(n, device=device)
    losses = torch.empty((T, n), device=device)
    H_at = torch.empty((len(top), n), device=device)
    evals = torch.empty((len(top), 2), device=device)
    k = 0
    for t in range(T):
        a = st.act[t]
        active = a * (1.0 - waiting)
        W, losses[t] = step(W, st.batch(t), st.yb[t], st.w[t], active)
        H = H + st.cnt[t] * active
        lv = int(lvl[t])
        if lv == 0:
            continue
        Wl, Hl = W, H * active
        for seg in segs[:lv]:
            Wl, Hl = aggregate_tier(Wl, Hl, seg.group_ids, seg.num_groups,
                                    segments=seg)
        if lv == L:
            ok = Hl[0] > 0
            wg = {key: torch.where(ok, Wl[key][0], old)
                  for key, old in wg.items()}
        src = anc[lv - 1]
        sync = (a > 0.5) & (Hl[src] > 0)
        W = {key: torch.where(_bcast(sync, p), Wl[key][src], p)
             for key, p in W.items()}
        waiting = 1.0 - a
        if lv == L:
            H_at[k] = H
            H = torch.zeros_like(H)
            evals[k, 0], evals[k, 1] = _evaluate(apply_fn, wg, st.x_te,
                                                 st.y_te)
            k += 1
    hist = _read_back(losses, H_at, evals, top)
    is_agg = lvl > 0
    hist["tier_agg_round"] = [int(t) for t in np.nonzero(is_agg)[0]]
    hist["tier_agg_level"] = [int(v) for v in lvl[is_agg]]
    return hist


def _read_back(losses, H_at, evals, agg_rounds) -> dict:
    """The one read-back of a run — (T, n) losses, (K, n) H and (K, 2)
    test loss and accuracy at the K recorded aggregation rounds — as
    the reference's history pieces."""
    rec = torch.cat([losses.reshape(-1), H_at.reshape(-1),
                     evals.reshape(-1)]).cpu().numpy()
    a, b = losses.numel(), losses.numel() + H_at.numel()
    ev = rec[b:].reshape(evals.shape)
    return {"device_loss": list(rec[:a].reshape(losses.shape)),
            "test_loss": [float(v) for v in ev[:, 0]],
            "test_acc": [float(v) for v in ev[:, 1]],
            "agg_round": [int(t) for t in agg_rounds],
            "H_agg": list(rec[a:b].reshape(H_at.shape))}


def run_rounds_legacy(apply_fn, params: dict, x_tr, y_tr, x_te, y_te,
                      processed, act_all, tau: int, eta: float,
                      max_pts: int, *, device) -> dict:
    """The per-round loop (fresh host→device copies of the padded batch
    every round, H accumulated on the host in float64) — the numerical
    oracle for ``run_rounds_scan``."""
    T, n = len(processed), len(processed[0])
    W = _stack(params, n)
    w_global = params
    step = make_device_step(apply_fn, float(eta))
    x_te_dev = torch.from_numpy(x_te).to(device)
    y_te_dev = torch.from_numpy(y_te).to(device, torch.int64)
    act_arr = np.asarray(act_all, bool)
    H = np.zeros(n)
    waiting = np.zeros(n, bool)
    out = {"device_loss": [], "test_loss": [], "test_acc": [],
           "agg_round": [], "H_agg": []}
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
            w_global = aggregate(W, torch.as_tensor(H, dtype=torch.float32,
                                                    device=device),
                                 contributing, w_global)
            W = _sync(W, w_global, torch.as_tensor(act, device=device))
            waiting = ~act      # whoever is out now waits for next sync
            out["H_agg"].append(H.copy())
            H[:] = 0.0
            tl, ta = _evaluate(apply_fn, w_global, x_te_dev, y_te_dev)
            out["agg_round"].append(t)
            out["test_loss"].append(float(tl))
            out["test_acc"].append(float(ta))
    return out
