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

``run_rounds_legacy`` is the per-round oracle: fresh host-padded
batches every round and the history read back as it goes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.data import pipeline as pl
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


def _sync(W: dict, w_global: dict, active) -> dict:
    """Devices with ``active`` set take the global model."""
    return {k: torch.where(_bcast(active, p), w_global[k][None], p)
            for k, p in W.items()}


def _evaluate(apply_fn, params, x, y):
    logits = apply_fn(params, x)
    return mm.ce_loss(logits, y), mm.accuracy(logits, y)


def run_rounds_scan(apply_fn, params: dict, x_tr, y_tr, x_te, y_te,
                    processed, act_all, tau: int, eta: float,
                    max_pts: int, *, device) -> dict:
    """Train all T rounds on ``device``; returns history pieces
    (``device_loss``, ``test_loss``, ``test_acc``, ``agg_round``,
    ``H_agg``) shaped as the reference's."""
    T, n = len(processed), len(processed[0])
    idx, yb, wts, counts = pl.stage_rounds(processed, y_tr, max_pts)
    is_agg = (np.arange(T) + 1) % tau == 0
    agg_rounds = np.nonzero(is_agg)[0]
    K = len(agg_rounds)

    def up(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    x_dev = up(x_tr)
    idx_dev = up(idx, torch.int64)
    item_bytes = math.prod(x_tr.shape[1:]) * 4
    prestage = T * n * max_pts * item_bytes <= PRESTAGE_LIMIT_BYTES
    xb_all = x_dev[idx_dev] if prestage else None
    yb_dev, w_dev = up(yb, torch.int64), up(wts)
    cnt_dev = up(counts)
    act_dev = up(np.asarray(act_all, np.float32))
    x_te_dev, y_te_dev = up(x_te), up(y_te, torch.int64)

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
        xb = xb_all[t] if prestage else x_dev[idx_dev[t]]
        active = act_dev[t] * (1.0 - waiting)
        W, losses[t] = step(W, xb, yb_dev[t], w_dev[t], active)
        H = H + cnt_dev[t] * active
        if is_agg[t]:
            wg = aggregate(W, H, active, wg)
            W = _sync(W, wg, act_dev[t] > 0.5)
            H_at[k] = H
            H = torch.zeros_like(H)
            waiting = 1.0 - act_dev[t]
            evals[k, 0], evals[k, 1] = _evaluate(apply_fn, wg, x_te_dev,
                                                 y_te_dev)
            k += 1
    # the one read-back of the run
    rec = torch.cat([losses.reshape(-1), H_at.reshape(-1),
                     evals.reshape(-1)]).cpu().numpy()
    losses_h = rec[:T * n].reshape(T, n)
    H_h = rec[T * n:T * n + K * n].reshape(K, n)
    ev = rec[T * n + K * n:].reshape(K, 2)
    return {"device_loss": list(losses_h),
            "test_loss": [float(v) for v in ev[:, 0]],
            "test_acc": [float(v) for v in ev[:, 1]],
            "agg_round": [int(t) for t in agg_rounds],
            "H_agg": list(H_h)}


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
