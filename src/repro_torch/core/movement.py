"""The paper's data-movement optimization (5)–(9), main-path subset.

Decision variables per round t: ``s[t,i,j]`` — fraction of data collected
at device i offloaded to device j (``s[t,i,i]`` = processed locally);
``r[t,i]`` — fraction discarded. Conservation: r + Σ_j s = 1 (eq. 8);
graph support (eq. 7).

``greedy_linear`` is the Theorem-3 closed form for the linear discard
cost f_i(t)·D_i(t)·r_i(t): each datapoint takes the least-marginal-cost
option among {process: c_i(t), offload→k: c_ik(t)+c_k(t+1), discard:
f_i(t)} with k = argmin_j c_ij(t)+c_j(t+1) over out-neighbours. Two
backends: vectorized numpy (a bitwise copy of the reference's) and the
device path through ``kernels.ops.greedy_edges_batched`` (the CUDA
kernel on the card). ``plan_cost`` evaluates the paper's objective
decomposition. Plans are sparse: a COO edge list plus the discard
vector, as in :mod:`repro.core.movement`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.costs import CostTraces
from repro_torch.core.schedule import as_schedule
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PlanEdges:
    """COO movement edges, lexicographically sorted by (t, src, dst).

    ``qty`` is the fraction of D_src(t) routed src→dst (src == dst means
    processed locally). At most one edge per (t, src, dst)."""

    t: np.ndarray    # (E,) int64
    src: np.ndarray  # (E,) int64
    dst: np.ndarray  # (E,) int64
    qty: np.ndarray  # (E,) float64

    def __len__(self) -> int:
        return len(self.t)


class MovementPlan:
    """Movement decisions for all rounds: COO ``edges`` plus the dense
    discard vector ``r`` (T, n). The dense (T, n, n) share tensor ``.s``
    is built lazily, for small-n tests only."""

    def __init__(self, r: np.ndarray, edges: PlanEdges, n: int):
        self.r = np.asarray(r)
        self.edges = edges
        self.n = int(n)
        self._dense: np.ndarray | None = None
        self._splits: np.ndarray | None = None

    @property
    def T(self) -> int:
        return self.r.shape[0]

    @property
    def s(self) -> np.ndarray:
        """Dense (T, n, n) view — O(T·n²) memory, built once."""
        if self._dense is None:
            e = self.edges
            s = np.zeros((self.T, self.n, self.n))
            np.add.at(s, (e.t, e.src, e.dst), e.qty)
            self._dense = s
        return self._dense

    def round_edges(self, t: int):
        """(src, dst, qty) views of round t's edges (sorted by src, dst)."""
        if self._splits is None:
            self._splits = np.searchsorted(self.edges.t,
                                           np.arange(self.T + 1))
        e, sp = self.edges, self._splits
        sl = slice(sp[t], sp[t + 1])
        return e.src[sl], e.dst[sl], e.qty[sl]

    def diag(self) -> np.ndarray:
        """s_ii(t) for all rounds as a dense (T, n) array."""
        e = self.edges
        loc = e.src == e.dst
        d = np.zeros((self.T, self.n))
        d[e.t[loc], e.src[loc]] = e.qty[loc]
        return d

    def offload_fraction(self) -> np.ndarray:
        """Σ_{j≠i} s_ij(t) as a dense (T, n) array (edge reduction)."""
        e = self.edges
        off = e.src != e.dst
        out = np.zeros((self.T, self.n))
        np.add.at(out, (e.t[off], e.src[off]), e.qty[off])
        return out

    def processed(self, D: np.ndarray) -> np.ndarray:
        """G[t,i] = s_ii(t)·D_i(t) + Σ_{j≠i} s_ji(t-1)·D_j(t-1)  (eq. 6)."""
        T = self.T
        e = self.edges
        G = self.diag() * D
        off = e.src != e.dst
        te, se, de, qe = e.t[off], e.src[off], e.dst[off], e.qty[off]
        arrive = te + 1 < T                   # arrives at t+1, in-horizon
        np.add.at(G, (te[arrive] + 1, de[arrive]),
                  qe[arrive] * D[te[arrive], se[arrive]])
        return G


def plans_equal(p: MovementPlan, q: MovementPlan) -> bool:
    """Bitwise plan equality: COO edges and the discard vector."""
    e, f = p.edges, q.edges
    return (np.array_equal(e.t, f.t) and np.array_equal(e.src, f.src)
            and np.array_equal(e.dst, f.dst)
            and np.array_equal(e.qty, f.qty)
            and np.array_equal(p.r, q.r))


def no_movement_plan(T: int, n: int) -> MovementPlan:
    """Setting A: offloading and discarding disabled (G_i = D_i)."""
    tt = np.repeat(np.arange(T, dtype=np.int64), n)
    ii = np.tile(np.arange(n, dtype=np.int64), T)
    edges = PlanEdges(t=tt, src=ii, dst=ii, qty=np.ones(T * n))
    return MovementPlan(r=np.zeros((T, n)), edges=edges, n=n)


# the kernel takes over from numpy at this n when the device is CUDA
# (the reference's PALLAS_MIN_N; the kernel masks the ragged edge, so
# no divisibility condition)
KERNEL_MIN_N = 256


def _plan_from_choice(choice: np.ndarray, k: np.ndarray) -> MovementPlan:
    """(T, n) 3-way decisions + best-neighbour indices -> bang-bang plan,
    emitted as COO edges (one per non-discarding (t, i))."""
    T, n = choice.shape
    tt, ii = np.nonzero(choice != 2)         # lex-sorted by (t, src)
    dst = np.where(choice[tt, ii] == 1, k[tt, ii], ii)
    r = np.zeros((T, n))
    r[choice == 2] = 1.0
    edges = PlanEdges(t=tt.astype(np.int64), src=ii.astype(np.int64),
                      dst=dst.astype(np.int64), qty=np.ones(len(tt)))
    return MovementPlan(r=r, edges=edges, n=n)


def greedy_linear(traces: CostTraces, adj, *, backend: str = "auto",
                  device=None) -> MovementPlan:
    """Theorem 3 rule as one batched min-plus over all T rounds.

    ``adj``: static (n, n) matrix, (T, n, n) stack or NetworkSchedule.
    ``backend``: "numpy" (vectorized on the host, float64 adds),
    "cuda" (the device path in float32 on ``device``: the CUDA kernel on
    a card, its plain PyTorch version with ``device="cpu"``), or "auto"
    (the device path when ``device`` is CUDA and n ≥ KERNEL_MIN_N, numpy
    otherwise). ``device`` defaults to ``cuda``.
    """
    T, n = traces.c_node.shape
    sched = as_schedule(adj, T)
    if backend == "auto":
        use_dev = n >= KERNEL_MIN_N and resolve_device(device).type == "cuda"
        backend = "cuda" if use_dev else "numpy"
    if backend == "cuda":
        return _greedy_linear_device(traces, sched, resolve_device(device))
    if backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}; expected 'numpy', "
                         "'cuda' or 'auto'")
    # row-vectorized min-plus with a single reused (n, n) buffer
    static = sched.static_adj
    act = sched.activity()
    inact = ~act if not act.all() else None
    per_round = static is None or inact is not None
    c_next = np.concatenate([traces.c_node[1:], traces.c_node[-1:]])
    dg = np.arange(n)
    eye = np.eye(n, dtype=bool)
    invalid = None if per_round else ~static | eye
    inv_buf = np.empty((n, n), bool) if per_round else None
    k = np.zeros((T, n), np.int64)
    off_cost = np.full((T, n), np.inf)   # T-1: no off-horizon offloading
    buf = np.empty((n, n))
    for t in range(T - 1):
        np.add(traces.c_link[t], c_next[t][None, :], out=buf)
        if invalid is None:              # time-varying graph, reuse bufs
            np.logical_not(static if static is not None
                           else sched.adj_at(t), out=inv_buf)
            np.logical_or(inv_buf, eye, out=inv_buf)
            if inact is not None:        # receiver gone at arrival t+1
                np.logical_or(inv_buf, inact[t + 1][None, :], out=inv_buf)
            buf[inv_buf] = np.inf
        else:
            buf[invalid] = np.inf
        k[t] = buf.argmin(axis=1)                          # best neighbour
        off_cost[t] = buf[dg, k[t]]
    choice = np.argmin(
        np.stack([traces.c_node, off_cost, traces.f_err]), axis=0)
    return _plan_from_choice(choice, k)


def device_inputs(traces: CostTraces, adj, device) -> tuple:
    """The kernel's float32 operands on ``device``: c_link, c_next,
    c_node, f_err and the (T, n, n) adjacency with the final round
    emptied (no off-horizon offloading) and receivers inactive at the
    arrival round t+1 removed."""
    T, n = traces.c_node.shape
    sched = as_schedule(adj, T)
    adj3 = np.array(sched.adj_view(), dtype=bool, order="C")   # own copy
    adj3[T - 1] = False
    act = sched.activity()
    if not act.all():
        adj3[:T - 1] &= act[1:, None, :]
    c_next = np.concatenate([traces.c_node[1:], traces.c_node[-1:]])

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
            .to(device)

    return (f32(traces.c_link), f32(c_next), f32(traces.c_node),
            f32(traces.f_err), torch.from_numpy(adj3).to(device))


def _greedy_linear_device(traces: CostTraces, adj,
                          device: torch.device) -> MovementPlan:
    from repro_torch.kernels import ops

    T, n = traces.c_node.shape
    return _plan_from_edges(T, n, ops.greedy_edges_batched(
        *device_inputs(traces, adj, device)))


def _plan_from_edges(T: int, n: int, edges) -> MovementPlan:
    """The plan from ``ops.greedy_edges_batched``'s device tensors:
    read back and packed on the host."""
    t_idx, src, dst, keep = (a.cpu().numpy() for a in edges[:4])
    r = np.zeros((T, n))
    r.reshape(-1)[~keep] = 1.0
    kept = PlanEdges(t=t_idx[keep].astype(np.int64),
                     src=src[keep].astype(np.int64),
                     dst=dst[keep].astype(np.int64),
                     qty=np.ones(int(keep.sum())))
    return MovementPlan(r=r, edges=kept, n=n)


def plan_cost(plan: MovementPlan, traces: CostTraces, D: np.ndarray, *,
              error_model: str = "discard", gamma: float = 1.0) -> dict:
    """Objective decomposition on the sparse plan: the transfer term and
    moved-rate reduce over realized edges only."""
    G = plan.processed(D)
    e = plan.edges
    off = e.src != e.dst
    te, se, de, qe = e.t[off], e.src[off], e.dst[off], e.qty[off]
    proc = float(np.sum(G * traces.c_node))
    trans = float(np.sum(qe * D[te, se] * traces.c_link[te, se, de]))
    if error_model == "sqrt":
        disc = float(np.sum(traces.f_err * gamma / np.sqrt(G + 1e-3)))
    elif error_model == "neg_G":
        disc = float(-np.sum(traces.f_err * G))
    else:
        disc = float(np.sum(traces.f_err * D * plan.r))
    total_data = float(D.sum())
    total = proc + trans + disc
    off_frac = plan.offload_fraction()          # Σ_{j≠i} s_ij as (T, n)
    return {"process": proc, "transfer": trans, "discard": disc,
            "total": total,
            "unit": total / max(total_data, 1e-9),
            "data_total": total_data,
            "moved_rate": float((off_frac * D).sum() / max(D.sum(), 1e-9)
                                + (plan.r * D).sum() / max(D.sum(), 1e-9)),
            "processed_frac": float(G.sum() / max(D.sum(), 1e-9)),
            "discarded_frac": float((plan.r * D).sum() / max(D.sum(), 1e-9))}
