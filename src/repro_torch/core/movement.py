"""The paper's data-movement optimization (5)–(9).

Decision variables per round t: ``s[t,i,j]`` — fraction of data collected
at device i offloaded to device j (``s[t,i,i]`` = processed locally);
``r[t,i]`` — fraction discarded. Conservation: r + Σ_j s = 1 (eq. 8);
graph support (eq. 7); node/link capacities (eq. 9).

* ``greedy_linear`` — the Theorem-3 closed form for the linear discard
  cost f_i(t)·D_i(t)·r_i(t): each datapoint takes the least-marginal-cost
  option among {process: c_i(t), offload→k: c_ik(t)+c_k(t+1), discard:
  f_i(t)} with k = argmin_j c_ij(t)+c_j(t+1) over out-neighbours. Two
  backends: vectorized numpy (a bitwise copy of the reference's) and the
  device path through ``kernels.ops.greedy_edges_batched`` (the CUDA
  kernel on the card). On :class:`EdgeCostTraces` the rule runs as
  ``greedy_linear_edges``, an O(T·E) segment min over the link support
  in numpy, bitwise the dense rule on the same costs.
  ``greedy_linear_scalar`` (a pure-Python (t, i, j) loop) and
  ``greedy_linear_loop`` (a per-round numpy loop) are its baselines and
  oracles, dense and float64.
* ``realize_plan`` — a plan confronted with the network that happened:
  shares over links that are down, or toward receivers gone at the
  arrival round, are lost to the discard vector.
* ``repair_capacities`` — Theorem 6's local repair of capacity
  violations, host numpy with the reference's arithmetic order;
  ``repair_capacities_edges`` streams edge dicts and tries each
  spill's next-best neighbours (``kernels.ops.topk_neighbors``) first.
* ``solve_convex`` / ``solve_convex_batched`` — the general convex
  program (Lemma 1) by a masked softmax over [s | r] and Adam, in plain
  PyTorch on the device; capacities enter as quadratic hinge penalties.
* ``theorem4_closed_form`` — the hierarchical closed form (Theorem 4).

``plan_cost`` evaluates the paper's objective decomposition. Plans are
sparse: a COO edge list plus the discard vector, as in
:mod:`repro.core.movement`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.costs import CostTraces, EdgeCostTraces
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


def _edges_from_dense(s: np.ndarray) -> PlanEdges:
    tt, ii, jj = np.nonzero(s)           # np.nonzero is lex-sorted
    return PlanEdges(t=tt.astype(np.int64), src=ii.astype(np.int64),
                     dst=jj.astype(np.int64), qty=np.asarray(s[tt, ii, jj],
                                                             np.float64))


class MovementPlan:
    """Movement decisions for all rounds: COO ``edges`` plus the dense
    discard vector ``r`` (T, n).

    Construct either from a dense tensor (``MovementPlan(s=s, r=r)``,
    edges extracted lazily) or directly from edges
    (``MovementPlan(r=r, edges=edges, n=n)``). The dense (T, n, n) share
    tensor ``.s`` of an edge-built plan is built lazily, for small-n
    oracles and tests only."""

    def __init__(self, s: np.ndarray | None = None,
                 r: np.ndarray | None = None, *,
                 edges: PlanEdges | None = None, n: int | None = None):
        if r is None:
            raise TypeError("MovementPlan requires r")
        self.r = np.asarray(r)
        if s is not None:
            s = np.asarray(s)
            self._dense: np.ndarray | None = s
            self._edges: PlanEdges | None = edges
            self.n = s.shape[2]
        elif edges is not None:
            if n is None:
                raise TypeError("edge-constructed MovementPlan requires n")
            self._dense = None
            self._edges = edges
            self.n = int(n)
        else:
            raise TypeError("MovementPlan requires s or edges")
        self._splits: np.ndarray | None = None

    @property
    def edges(self) -> PlanEdges:
        if self._edges is None:
            self._edges = _edges_from_dense(self._dense)
        return self._edges

    @property
    def T(self) -> int:
        return self.r.shape[0]

    @property
    def s(self) -> np.ndarray:
        """Dense (T, n, n) view — O(T·n²) memory, built once."""
        if self._dense is None:
            e = self._edges
            s = np.zeros((self.T, self.n, self.n))
            np.add.at(s, (e.t, e.src, e.dst), e.qty)
            self._dense = s
        return self._dense

    def _round_splits(self) -> np.ndarray:
        """Edge offsets of the rounds: round t is ``[sp[t], sp[t+1])``."""
        if self._splits is None:
            self._splits = np.searchsorted(self.edges.t,
                                           np.arange(self.T + 1))
        return self._splits

    def round_edges(self, t: int):
        """(src, dst, qty) views of round t's edges (sorted by src, dst)."""
        sp = self._round_splits()
        e = self.edges
        sl = slice(sp[t], sp[t + 1])
        return e.src[sl], e.dst[sl], e.qty[sl]

    def round_dense(self, t: int, out: np.ndarray | None = None
                    ) -> np.ndarray:
        """Round t as a dense (n, n) matrix, written into ``out`` when
        given (zeroed first) so per-round consumers can reuse a single
        buffer instead of materializing (T, n, n)."""
        if out is None:
            out = np.zeros((self.n, self.n))
        else:
            out[:] = 0.0
        src, dst, qty = self.round_edges(t)
        out[src, dst] = qty
        return out

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

    def check(self, adj, atol: float = 1e-5):
        """Validate nonnegativity, conservation (eq. 8) and graph
        support (eq. 7). ``adj`` may be a static (n, n) matrix, a
        (T, n, n) stack or a NetworkSchedule: every offload edge is
        validated against the adjacency of its round."""
        T, n = self.r.shape
        sched = as_schedule(adj, T)
        e = self.edges
        assert np.all(e.qty >= -atol) and np.all(self.r >= -atol)
        total = self.r.copy()
        np.add.at(total, (e.t, e.src), e.qty)
        assert np.allclose(total, 1.0, atol=1e-4), total
        for t in range(T):
            src, dst, qty = self.round_edges(t)
            off = src != dst
            if not off.any():
                continue
            present = sched.has_edges(t, src[off], dst[off])
            lost = qty[off] * ~present
            assert np.all(lost <= atol), \
                f"offload over missing link at round {t}"


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

    ``adj``: static (n, n) matrix, (T, n, n) stack or NetworkSchedule;
    each round's decision uses that round's adjacency, and under an
    active trace the devices inactive at t+1 leave round t's candidate
    set (their arrivals would be lost, see :func:`realize_plan`).
    ``backend``: "numpy" (vectorized on the host, float64 adds),
    "cuda" (the device path in float32 on ``device``: the CUDA kernel on
    a card, its plain PyTorch version with ``device="cpu"``), or "auto"
    (the device path when ``device`` is CUDA and n ≥ KERNEL_MIN_N, numpy
    otherwise). ``device`` defaults to ``cuda``. :class:`EdgeCostTraces`
    go to :func:`greedy_linear_edges` (numpy, whatever the backend).
    """
    if isinstance(traces, EdgeCostTraces):
        return greedy_linear_edges(traces, adj)
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


def _support_live(etraces: EdgeCostTraces, sched) -> np.ndarray:
    """(T, E) liveness of the cost-support edges under the schedule —
    the sparse replacement for per-round dense adjacency rows. O(T·E)
    bool; edge-list schedules never touch a dense view, dense-mode
    schedules fall back to ``adj_at`` gathers (small-n equivalence)."""
    T, n = etraces.c_node.shape
    live = np.zeros((T, etraces.E), bool)
    if getattr(sched, "storage", None) == "edgelist":
        iu, idx = sched.union_csr()
        if np.array_equal(iu, etraces.indptr) and \
                np.array_equal(idx, etraces.indices):
            return sched.live_matrix().copy()  # the same support
        usrc = np.repeat(np.arange(n, dtype=np.int64), np.diff(iu))
        umap = etraces.edge_ids(usrc, idx)   # union eid -> support eid
        on = umap >= 0
        live[:, umap[on]] = sched.live_matrix()[:, on]
    else:
        esrc = etraces.src
        for t in range(T):
            a = np.asarray(sched.adj_at(t), bool)
            live[t] = a[esrc, etraces.indices]
    return live


def _segment_min_csr(eff: np.ndarray, indptr: np.ndarray,
                     esrc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """First-occurrence segment min over CSR rows: per-row minimum of
    ``eff`` and the edge id achieving it (−1 for rows with no finite
    entry). First-min tie-breaking in lex (dst) order — exactly
    ``argmin`` over a dense row restricted to the support."""
    n = indptr.shape[0] - 1
    E = eff.shape[0]
    rowmin = np.full(n, np.inf)
    rowarg = np.full(n, -1, np.int64)
    if E == 0:
        return rowmin, rowarg
    starts = np.minimum(indptr[:-1], E - 1)
    mins = np.minimum.reduceat(eff, starts)
    nonempty = indptr[:-1] < indptr[1:]
    rowmin[nonempty] = mins[nonempty]
    finite = np.isfinite(rowmin)
    # first edge per row attaining the min: candidates ascend, and a
    # finite row holds one, so it is the first candidate at or after
    # the row's start (the reference's np.unique over their rows)
    cand = np.nonzero(np.isfinite(eff) & (eff == rowmin[esrc]))[0]
    at = np.searchsorted(cand, indptr[:-1][finite])
    rowarg[finite] = cand[at]
    rowmin[~finite] = np.inf
    return rowmin, rowarg


def greedy_linear_edges(etraces: EdgeCostTraces, adj) -> MovementPlan:
    """Theorem 3 greedy on the sparse edge support — O(T·E) end to end.

    The per-round candidate reduction is a first-occurrence segment min
    over the support CSR instead of a dense (n, n) argmin, so the plan
    is bitwise-equal to ``greedy_linear`` on the gathered dense costs
    (same float arithmetic, same lex tie-breaking) while never touching
    an (n, n) array. Receiver-aware exactly like the dense path:
    devices inactive at the arrival round t+1 leave round t's candidate
    set."""
    T, n = etraces.c_node.shape
    sched = as_schedule(adj, T)
    indices, indptr, esrc = etraces.indices, etraces.indptr, etraces.src
    act = sched.activity()
    recv = act[1:] if not act.all() else None
    notself = esrc != indices
    live_all = _support_live(etraces, sched)
    c_next = np.concatenate([etraces.c_node[1:], etraces.c_node[-1:]])
    k = np.zeros((T, n), np.int64)
    off_cost = np.full((T, n), np.inf)   # T-1: no off-horizon offloading
    eff = np.empty(etraces.E)
    dead = ~(live_all[:T - 1] & notself)
    if recv is not None:                 # receiver gone at arrival t+1
        dead |= ~recv[:, indices]
    for t in range(T - 1):
        np.add(etraces.c_link[t], c_next[t][indices], out=eff)
        np.putmask(eff, dead[t], np.inf)
        rowmin, rowarg = _segment_min_csr(eff, indptr, esrc)
        off_cost[t] = rowmin
        k[t] = np.where(rowarg >= 0, indices[np.maximum(rowarg, 0)], 0)
    choice = np.argmin(
        np.stack([etraces.c_node, off_cost, etraces.f_err]), axis=0)
    return _plan_from_choice(choice, k)


def device_inputs(traces: CostTraces, adj, device) -> tuple:
    """The kernel's float32 operands on ``device``: c_link, c_next,
    c_node, f_err and the (T, n, n) adjacency with the final round
    emptied (no off-horizon offloading) and receivers inactive at the
    arrival round t+1 removed."""
    T, n = traces.c_node.shape
    sched = as_schedule(adj, T)
    adj3 = np.empty((T, n, n), bool)
    static = sched.static_adj
    if static is not None:
        adj3[:] = static
    else:
        for t in range(T - 1):      # adj_at reuses its buffer: copy out
            adj3[t] = sched.adj_at(t)
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


def _adj_t(adj, T: int) -> np.ndarray:
    """(T, n, n) adjacency view for the dense oracles: a broadcast view
    (no copy) for static matrices, the stored stack otherwise."""
    return as_schedule(adj, T).adj_view()


def greedy_linear_scalar(traces: CostTraces, adj) -> MovementPlan:
    """The Theorem-3 rule as a pure-Python nested loop, one interpreter
    iteration per (t, i, j): the baseline ``engine_throughput`` times
    the batched rule against. Ties go to the lowest j (strict ``<`` over
    ascending j), then to processing, then to offloading; the last round
    offloads nothing."""
    T, n = traces.c_node.shape
    adj3 = _adj_t(adj, T)
    s = np.zeros((T, n, n))
    r = np.zeros((T, n))
    for t in range(T):
        for i in range(n):
            best_j, best_off = -1, np.inf
            if t < T - 1:
                for j in range(n):
                    if j == i or not adj3[t, i, j]:
                        continue
                    c = traces.c_link[t, i, j] + traces.c_node[t + 1, j]
                    if c < best_off:
                        best_j, best_off = j, c
            proc = traces.c_node[t, i]
            disc = traces.f_err[t, i]
            if proc <= best_off and proc <= disc:
                s[t, i, i] = 1.0
            elif best_off <= disc:
                s[t, i, best_j] = 1.0
            else:
                r[t, i] = 1.0
    return MovementPlan(s=s, r=r)


def greedy_linear_loop(traces: CostTraces, adj) -> MovementPlan:
    """The Theorem-3 rule as a per-round numpy loop, the oracle of the
    vectorized :func:`greedy_linear`: each round takes the first minimum
    of ``np.argmin`` over [process, offload, discard]; the last round
    offloads nothing."""
    T, n = traces.c_node.shape
    adj3 = _adj_t(adj, T)
    s = np.zeros((T, n, n))
    r = np.zeros((T, n))
    for t in range(T):
        c_next = traces.c_node[min(t + 1, T - 1)]
        eff = traces.c_link[t] + c_next[None, :]
        eff = np.where(adj3[t], eff, np.inf)
        if t == T - 1:
            eff[:] = np.inf
        np.fill_diagonal(eff, np.inf)
        k = np.argmin(eff, axis=1)
        off_cost = eff[np.arange(n), k]
        choice = np.argmin(np.stack([traces.c_node[t], off_cost,
                                     traces.f_err[t]]), axis=0)
        for i in range(n):
            if choice[i] == 0:
                s[t, i, i] = 1.0
            elif choice[i] == 1:
                s[t, i, k[i]] = 1.0
            else:
                r[t, i] = 1.0
    return MovementPlan(s=s, r=r)


def realize_plan(plan: MovementPlan, schedule) -> MovementPlan:
    """Confront a plan with the network that actually materialized.

    Two loss channels, both charged to the discard vector ``r``:
    send-side (the link is absent at the edge's round: flapped down, or
    an endpoint churned out) and receiver-side (the receiver is inactive
    at t+1, the round its arrivals would be processed). A greedy plan
    solved on the schedule itself passes unchanged; a static schedule
    passes any plan unchanged."""
    T, n = plan.r.shape
    sched = as_schedule(schedule, T)
    e = plan.edges
    keep = np.ones(len(e), bool)
    r = plan.r.copy()
    sp = plan._round_splits()
    for t in range(T):
        sl = slice(sp[t], sp[t + 1])
        src, dst, qty = e.src[sl], e.dst[sl], e.qty[sl]
        off = src != dst
        if not off.any():
            continue
        present = np.zeros(len(src), bool)
        present[off] = sched.has_edges(t, src[off], dst[off])
        lost = off & ~present
        if t + 1 < T:                    # arrival round: receiver gone
            act_next = np.asarray(sched.active_at(t + 1), bool)
            lost |= off & ~act_next[dst]
        if lost.any():
            np.add.at(r[t], src[lost], qty[lost])
            keep[np.arange(sp[t], sp[t + 1])[lost]] = False
    edges = PlanEdges(t=e.t[keep], src=e.src[keep], dst=e.dst[keep],
                      qty=e.qty[keep])
    return MovementPlan(r=r, edges=edges, n=n)


# ---------------------------------------------------------------------------
# Capacity repair (Theorem 6 guidance) — host code, the reference's
# arithmetic in the reference's order: the knife-edge capacity
# comparisons in _revert depend on it
# ---------------------------------------------------------------------------


def _repair_round(s_t, r_t, prev, t, T, adj_t, traces, D, diag_next,
                  dg, eye):
    """Repair one round in place on the dense (n, n) buffer ``s_t``:
    vectorized violation detection, scalar replay of spill events in the
    loop oracle's order. ``adj_t`` is round t's (n, n) adjacency;
    ``prev`` is round t−1 post-repair (None at t=0); ``diag_next`` is
    the pre-repair s_ii of round t+1 (rounds ahead are untouched when
    round t is repaired)."""
    n = s_t.shape[0]
    Dt = D[t]
    Dt_safe = np.maximum(Dt, 1e-12)
    # local processing this round from s_ii(t) plus arrivals from t-1
    if t > 0:
        vol_prev = prev * D[t - 1][:, None]
        arrivals = vol_prev.sum(0) - vol_prev[dg, dg]
    else:
        arrivals = np.zeros(n)
    # (1) link capacity
    viol = (adj_t & ~eye) & (s_t * Dt[:, None] > traces.cap_link[t])
    if viol.any():
        spill_ij = np.where(
            viol, s_t - traces.cap_link[t] / Dt_safe[:, None], 0.0)
        s_t -= spill_ij
        for i, j in zip(*np.nonzero(spill_ij > 0)):   # source-major
            _revert(s_t, r_t, t, i, spill_ij[i, j], traces, Dt, arrivals)
    # (2) node capacity of receivers at t+1 (arrivals processed then),
    # cut sender by sender in the loop oracle's order
    if t + 1 < T:
        vol = s_t * Dt[:, None]
        inc = vol.sum(0) - vol[dg, dg]
        over = inc + diag_next * D[t + 1] - traces.cap_node[t + 1]
        for j in np.nonzero(over > 1e-9)[0]:
            excess = over[j]
            for i in np.nonzero(vol[:, j] > 0)[0]:
                if i == j:
                    continue
                if excess <= 1e-12:
                    break
                cut = min(vol[i, j], excess)
                spill = cut / max(Dt[i], 1e-12)
                s_t[i, j] -= spill
                excess -= cut
                _revert(s_t, r_t, t, i, spill, traces, Dt, arrivals)
    # (3) own node capacity at t for s_ii
    over = s_t[dg, dg] * Dt + arrivals - traces.cap_node[t]
    mask = over > 1e-9
    if mask.any():
        cut = np.minimum(s_t[dg, dg] * Dt, np.maximum(over, 0.0))
        spill = np.where(mask, cut / Dt_safe, 0.0)
        s_t[dg, dg] -= spill
        r_t += spill


def _revert(s_t, r_t, t, i, spill, traces, Dt, arrivals):
    """Send a spilled fraction back to i's next-best option (on round
    t's dense (n, n) view ``s_t`` and discard row ``r_t``)."""
    cap_left = traces.cap_node[t, i] - (s_t[i, i] * Dt[i] + arrivals[i])
    if (traces.c_node[t, i] <= traces.f_err[t, i]
            and cap_left >= spill * Dt[i]):
        s_t[i, i] += spill
    else:
        r_t[i] += spill


def repair_capacities(plan: MovementPlan, traces: CostTraces,
                      adj, D: np.ndarray) -> MovementPlan:
    """Local repair of capacity violations (Theorem 6 guidance).

    A forward pass over t (arrivals chain the rounds), streamed over the
    sparse plan: each round is expanded into one of two reused dense
    (n, n) buffers (this round and the previous one, for arrivals),
    repaired by :func:`_repair_round` and compressed back to edges.
    ``adj`` may be a static matrix, a (T, n, n) stack or a
    NetworkSchedule. Bitwise equal to ``repair_capacities_dense`` and
    ``repair_capacities_loop``, fractional plans included."""
    T, n = plan.r.shape
    sched = as_schedule(adj, T)
    r = plan.r.copy()
    dg = np.arange(n)
    eye = np.eye(n, dtype=bool)
    diag0 = plan.diag()                  # pre-repair s_ii, read one round ahead
    cur = np.zeros((n, n))
    prev = np.zeros((n, n))
    ts, srcs, dsts, qtys = [], [], [], []
    for t in range(T):
        plan.round_dense(t, out=cur)
        _repair_round(cur, r[t], prev if t > 0 else None, t, T,
                      sched.adj_at(t), traces, D,
                      diag0[t + 1] if t + 1 < T else None, dg, eye)
        ii, jj = np.nonzero(cur)
        ts.append(np.full(len(ii), t, np.int64))
        srcs.append(ii.astype(np.int64))
        dsts.append(jj.astype(np.int64))
        qtys.append(cur[ii, jj].copy())
        prev, cur = cur, prev            # repaired round feeds t+1 arrivals
    edges = PlanEdges(t=np.concatenate(ts), src=np.concatenate(srcs),
                      dst=np.concatenate(dsts), qty=np.concatenate(qtys))
    return MovementPlan(r=r, edges=edges, n=n)


def repair_capacities_dense(plan: MovementPlan, traces: CostTraces,
                            adj, D: np.ndarray) -> MovementPlan:
    """Dense-tensor repair, the oracle of the streamed
    :func:`repair_capacities`."""
    T, n = plan.r.shape
    adj3 = _adj_t(adj, T)
    s = plan.s.copy()
    r = plan.r.copy()
    dg = np.arange(n)
    eye = np.eye(n, dtype=bool)
    for t in range(T):
        _repair_round(s[t], r[t], s[t - 1] if t > 0 else None, t, T,
                      adj3[t], traces, D,
                      s[t + 1][dg, dg] if t + 1 < T else None, dg, eye)
    return MovementPlan(s=s, r=r)


def repair_capacities_loop(plan: MovementPlan, traces: CostTraces,
                           adj, D: np.ndarray) -> MovementPlan:
    """Per-(i, j) Python-loop repair, the oracle of the vectorized
    paths."""
    T, n = plan.r.shape
    adj3 = _adj_t(adj, T)
    s = plan.s.copy()
    r = plan.r.copy()
    for t in range(T):
        Dt = D[t]
        arrivals = (s[t - 1] * D[t - 1][:, None]).sum(0) - \
            np.diag(s[t - 1]) * D[t - 1] if t > 0 else np.zeros(n)
        for i in range(n):
            for j in np.nonzero(adj3[t][i])[0]:
                if i == j or s[t, i, j] == 0:
                    continue
                cap = traces.cap_link[t, i, j]
                if s[t, i, j] * Dt[i] > cap:
                    spill = s[t, i, j] - cap / max(Dt[i], 1e-12)
                    s[t, i, j] -= spill
                    _revert(s[t], r[t], t, i, spill, traces, Dt, arrivals)
        if t + 1 < T:
            inc = (s[t] * Dt[:, None]).sum(0) - np.diag(s[t]) * Dt
            local_next = np.diag(s[t + 1]) * D[t + 1]
            over = inc + local_next - traces.cap_node[t + 1]
            for j in np.nonzero(over > 1e-9)[0]:
                senders = [i for i in range(n)
                           if i != j and s[t, i, j] * Dt[i] > 0]
                excess = over[j]
                for i in senders:
                    if excess <= 1e-12:
                        break
                    vol = s[t, i, j] * Dt[i]
                    cut = min(vol, excess)
                    spill = cut / max(Dt[i], 1e-12)
                    s[t, i, j] -= spill
                    excess -= cut
                    _revert(s[t], r[t], t, i, spill, traces, Dt, arrivals)
        G_now = np.diag(s[t]) * Dt + arrivals
        over = G_now - traces.cap_node[t]
        for i in np.nonzero(over > 1e-9)[0]:
            cut = min(np.diag(s[t])[i] * Dt[i], over[i])
            spill = cut / max(Dt[i], 1e-12)
            s[t, i, i] -= spill
            r[t, i] += spill
    return MovementPlan(s=s, r=r)


def repair_capacities_edges(plan: MovementPlan,
                            traces: CostTraces | EdgeCostTraces,
                            adj, D: np.ndarray, *, k: int = 4,
                            device=None) -> MovementPlan:
    """Edge-native capacity repair with next-best offload fallbacks.

    Streams the sparse plan round by round as (src, dst, qty) edge
    dicts plus O(n) aggregates — no dense per-round (n, n) scratch is
    ever rebuilt. Violation handling differs from the Theorem-6 oracle
    rule (:func:`repair_capacities` / ``repair_capacities_dense``) in
    one way: when a transfer overruns a link or receiver capacity, the
    spilled share first tries the source's next-cheapest feasible
    neighbors — the k-best min-plus candidates from
    ``kernels.ops.topk_neighbors`` — respecting both link and receiver
    headroom, before falling back to the oracle's local-process /
    discard rule. Saturated-but-connected networks therefore keep more
    data in play instead of discarding it. Feasible plans pass through
    bitwise unchanged. The top-k runs on ``device`` (``cuda`` by
    default), and only at the first spill; the rest is host numpy.
    """
    T, n = plan.r.shape
    sched = as_schedule(adj, T)
    kk = max(1, min(k, n - 1))
    sparse_costs = isinstance(traces, EdgeCostTraces)
    topk: tuple | None = None

    def _topk():
        """k-best min-plus candidates, solved lazily on the first spill:
        feasible plans pass through without paying the device transfer
        or the top-k. Dense CostTraces run the batched (T,n,n)
        solve (no asymptotic memory added); EdgeCostTraces run the CSR
        variant on (T, E) costs + schedule liveness — no dense
        adjacency view is ever requested, so edge-list schedules repair
        above the dense size guard."""
        nonlocal topk
        if topk is None:
            from repro_torch.kernels import ops

            dev = resolve_device(device)
            c_next = np.concatenate([traces.c_node[1:],
                                     traces.c_node[-1:]])

            def f32(a):
                return torch.from_numpy(
                    np.ascontiguousarray(a, np.float32)).to(dev)

            if sparse_costs:
                live = _support_live(traces, sched)
                live &= traces.src != traces.indices
                cc, cd = ops.topk_neighbors_csr(
                    f32(traces.c_link), f32(c_next), traces.indptr,
                    traces.indices, torch.from_numpy(live).to(dev), k=kk)
            else:
                cc, cd = ops.topk_neighbors(
                    f32(traces.c_link), f32(c_next),
                    torch.from_numpy(np.ascontiguousarray(
                        sched.adj_view())).to(dev), k=kk)
            topk = (cc.cpu().numpy(), cd.cpu().numpy())
        return topk

    diag0 = plan.diag()                  # pre-repair s_ii one round ahead
    r = plan.r.copy()
    arrivals = np.zeros(n)
    ts, srcs, dsts, qtys = [], [], [], []
    for t in range(T):
        src, dst, qty = plan.round_edges(t)
        share: dict[tuple[int, int], float] = {}
        for i, j, q in zip(src, dst, qty):
            share[(int(i), int(j))] = share.get((int(i), int(j)), 0.0) \
                + float(q)
        Dt = D[t]
        cap_link_t = traces.cap_link[t]
        if sparse_costs:
            def _cl(i, j):
                """Per-edge link capacity (0 for off-support pairs)."""
                eid = traces.edge_ids([i], [j])[0]
                return float(cap_link_t[eid]) if eid >= 0 else 0.0
        else:
            def _cl(i, j):
                return cap_link_t[i, j]
        local_next = diag0[t + 1] * D[t + 1] if t + 1 < T else None
        inc = np.zeros(n)
        for (i, j), q in share.items():
            if i != j:
                inc[j] += q * Dt[i]

        def _place(i, frac):
            """Route a spilled fraction of D_i(t): next-best neighbors
            (link + receiver headroom), then local, then discard."""
            if t + 1 < T:
                cand_cost, cand = _topk()
                for c in range(kk):
                    if frac <= 1e-12:
                        return
                    cost = cand_cost[t, i, c]
                    j2 = int(cand[t, i, c])
                    if not np.isfinite(cost) or j2 < 0:
                        break            # ascending order: rest invalid
                    cur_q = share.get((i, j2), 0.0)
                    head = min(
                        _cl(i, j2) - cur_q * Dt[i],
                        traces.cap_node[t + 1, j2] - local_next[j2]
                        - inc[j2])
                    put = min(frac, head / max(Dt[i], 1e-12))
                    if put <= 1e-12:
                        continue
                    share[(i, j2)] = cur_q + put
                    inc[j2] += put * Dt[i]
                    frac -= put
            if frac > 1e-12:             # oracle fallback (_revert rule)
                cap_left = traces.cap_node[t, i] - (
                    share.get((i, i), 0.0) * Dt[i] + arrivals[i])
                if (traces.c_node[t, i] <= traces.f_err[t, i]
                        and cap_left >= frac * Dt[i]):
                    share[(i, i)] = share.get((i, i), 0.0) + frac
                else:
                    r[t, i] += frac

        # (1) link capacities (snapshot the keys; re-read quantities —
        # _place may have grown an edge processed later in the sweep)
        for i, j in sorted(k_ for k_ in share if k_[0] != k_[1]):
            q = share[(i, j)]
            if q > 0.0 and q * Dt[i] > _cl(i, j):
                spill = q - _cl(i, j) / max(Dt[i], 1e-12)
                share[(i, j)] = q - spill
                inc[j] -= spill * Dt[i]
                _place(i, spill)
        # (2) receiver node capacities at t+1 (arrivals processed then)
        if t + 1 < T:
            for j in range(n):
                excess = inc[j] + local_next[j] - traces.cap_node[t + 1, j]
                if excess <= 1e-9:
                    continue
                for i, j_ in sorted(k_ for k_ in share
                                    if k_[1] == j and k_[0] != j):
                    if excess <= 1e-12:
                        break
                    q = share[(i, j)]
                    if q <= 0.0:
                        continue
                    cut = min(q * Dt[i], excess)
                    spill = cut / max(Dt[i], 1e-12)
                    share[(i, j)] = q - spill
                    inc[j] -= cut
                    excess -= cut
                    _place(i, spill)
        # (3) own node capacity at t for s_ii
        for i in range(n):
            loc = share.get((i, i), 0.0)
            over = loc * Dt[i] + arrivals[i] - traces.cap_node[t, i]
            if over > 1e-9:
                cut = min(loc * Dt[i], max(over, 0.0))
                spill = cut / max(Dt[i], 1e-12)
                share[(i, i)] = loc - spill
                r[t, i] += spill

        arrivals[:] = 0.0                # repaired round feeds t+1
        for (i, j), q in share.items():
            if i != j and q > 0.0:
                arrivals[j] += q * Dt[i]
        items = sorted((ij, q) for ij, q in share.items() if q > 0.0)
        ts.append(np.full(len(items), t, np.int64))
        srcs.append(np.array([ij[0] for ij, _ in items], np.int64))
        dsts.append(np.array([ij[1] for ij, _ in items], np.int64))
        qtys.append(np.array([q for _, q in items], np.float64))
    edges = PlanEdges(t=np.concatenate(ts), src=np.concatenate(srcs),
                      dst=np.concatenate(dsts), qty=np.concatenate(qtys))
    return MovementPlan(r=r, edges=edges, n=n)


# ---------------------------------------------------------------------------
# General convex solver (1/sqrt error cost, Lemma 1) on the device
# ---------------------------------------------------------------------------


def _convex_mask(traces: CostTraces, adj) -> np.ndarray:
    """Support mask over the [s_ij | r_i] softmax parametrization."""
    T, n = traces.c_node.shape
    adj3 = _adj_t(adj, T)
    mask = np.concatenate(
        [adj3 | np.eye(n, dtype=bool)[None], np.ones((T, n, 1), bool)],
        axis=2).copy()                                     # [s_ij | r_i]
    # no off-horizon offloading in the final round
    mask[T - 1, :, :n] &= np.eye(n, dtype=bool)
    return mask


def _convex_inputs(traces: CostTraces, adj, D: np.ndarray) -> tuple:
    """One scenario's solver operands on the host, as the reference
    builds them: every trace in float32, capacities clipped at 1e12, the
    boolean support mask and the counts in float32."""
    f32 = np.float32
    return (np.asarray(traces.c_node, f32), np.asarray(traces.c_link, f32),
            np.asarray(traces.f_err, f32),
            np.asarray(np.minimum(traces.cap_node, 1e12), f32),
            np.asarray(np.minimum(traces.cap_link, 1e12), f32),
            _convex_mask(traces, adj), np.asarray(D, f32))


def convex_device_inputs(traces_seq, adj_seq, D_seq, device) -> tuple:
    """The solver's operands for B scenarios, stacked on a leading
    scenario axis and sent to ``device`` once: c_node, c_link, f_err,
    cap_node, cap_link, mask, D, each (B, T, ...)."""
    stacked = [np.stack(a) for a in zip(*(
        _convex_inputs(tr, adj, D)
        for tr, adj, D in zip(traces_seq, adj_seq, D_seq)))]
    return tuple(torch.from_numpy(a).to(device) for a in stacked)


def convex_z0(T: int, n: int, seeds) -> torch.Tensor:
    """The default initial point, (B, T, n, n+1): ``0.01·randn`` from a
    CPU ``torch.Generator`` per seed, so every device starts from the
    same point."""
    return torch.stack([
        0.01 * torch.randn((T, n, n + 1),
                           generator=torch.Generator().manual_seed(sd))
        for sd in seeds])


def _as_z0(z0) -> torch.Tensor:
    """A caller's initial point as a float32 tensor (arrays copied)."""
    if isinstance(z0, torch.Tensor):
        return z0.float()
    return torch.from_numpy(np.array(z0, np.float32))


def convex_run(c_node, c_link, f_err, cap_node, cap_link, mask, D, z0, *,
               error_model: str, gamma: float, iters: int, lr: float,
               capacity_penalty: float):
    """Adam descent on the masked-softmax objective for B scenarios at
    once (every operand carries a leading scenario axis; the objectives
    are summed, so each scenario's gradient is its own). Returns the
    device tensors (s (B, T, n, n), r (B, T, n)). No host sync inside
    the loop."""
    n = c_node.shape[-1]
    off_mask = 1.0 - torch.eye(n, dtype=z0.dtype, device=z0.device)
    neg_inf = torch.tensor(float("-inf"), dtype=z0.dtype, device=z0.device)

    def unpack(z):
        p = torch.softmax(torch.where(mask, z, neg_inf), dim=-1)
        return p[..., :n], p[..., n]                       # rows sum to 1

    def objective(z):
        s, r = unpack(z)
        off = s * off_mask
        G = torch.diagonal(s, dim1=-2, dim2=-1) * D
        inc = torch.einsum("btji,btj->bti", off, D)
        G = G + torch.nn.functional.pad(inc[:, :-1], (0, 0, 1, 0))
        vol = off * D[..., None]
        proc = torch.sum(G * c_node)
        trans = torch.sum(vol * c_link)
        if error_model == "sqrt":
            err = torch.sum(f_err * gamma / torch.sqrt(G + 1e-3))
        elif error_model == "neg_G":
            err = -torch.sum(f_err * G)
        else:  # "discard"
            err = torch.sum(f_err * D * r)
        pen = (torch.sum(torch.relu(G - cap_node) ** 2)
               + torch.sum(torch.relu(vol - cap_link) ** 2))
        return proc + trans + err + capacity_penalty * pen

    z = z0.clone().requires_grad_(True)
    m = torch.zeros_like(z0)
    v = torch.zeros_like(z0)
    f32 = np.float32
    for i in range(iters):
        g, = torch.autograd.grad(objective(z), z)
        # the bias corrections in float32, as the reference's traced step
        bc1 = float(f32(1) - f32(0.9) ** f32(i + 1))
        bc2 = float(f32(1) - f32(0.999) ** f32(i + 1))
        with torch.no_grad():
            g = torch.where(mask, g, 0.0)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / bc1
            vh = v / bc2
            z = z - lr * mh / (torch.sqrt(vh) + 1e-8)
        z.requires_grad_(True)
    with torch.no_grad():
        return unpack(z)


def plans_from_dense(s: torch.Tensor, r: torch.Tensor) -> list:
    """Read the solver's (B, T, n, n) shares and (B, T, n) discards back
    as float64 and wrap each scenario as a plan (edges extracted
    lazily)."""
    s = s.cpu().double().numpy()
    r = r.cpu().double().numpy()
    return [MovementPlan(s=s[b], r=r[b]) for b in range(len(s))]


def solve_convex_batched(traces_seq, adj_seq, D_seq, *,
                         error_model: str = "sqrt", gamma: float = 1.0,
                         iters: int = 800, lr: float = 0.05,
                         capacity_penalty: float = 50.0, seeds=0,
                         z0=None, device=None) -> list[MovementPlan]:
    """Solve B (traces, adj, D) scenarios in one descent on ``device``
    (``cuda`` by default).

    Masked-softmax parametrization of [s | r] + Adam, with the error
    model "sqrt" (f·γ/√G), "neg_G" (−f·G) or "discard" (f·D·r); each
    ``adj`` may be a static matrix, a (T, n, n) stack or a
    NetworkSchedule (the support mask then varies per round). All
    scenarios share (T, n). ``z0`` — the initial point (B, T, n, n+1);
    by default drawn by :func:`convex_z0` from ``seeds``: an int gives
    every scenario the same point, a sequence one each."""
    device = resolve_device(device)
    B = len(traces_seq)
    T, n = traces_seq[0].c_node.shape
    if z0 is None:
        if np.ndim(seeds) == 0:
            seeds = [int(seeds)] * B
        z0 = convex_z0(T, n, seeds)
    z0 = _as_z0(z0)
    s, r = convex_run(*convex_device_inputs(traces_seq, adj_seq, D_seq,
                                            device), z0.to(device),
                      error_model=error_model, gamma=gamma, iters=iters,
                      lr=lr, capacity_penalty=capacity_penalty)
    return plans_from_dense(s, r)


def solve_convex(traces: CostTraces, adj, D: np.ndarray, *,
                 error_model: str = "sqrt", gamma: float = 1.0,
                 iters: int = 800, lr: float = 0.05,
                 capacity_penalty: float = 50.0, seed: int = 0,
                 z0=None, device=None) -> MovementPlan:
    """One scenario of :func:`solve_convex_batched` (``z0`` (T, n, n+1)
    or None for the ``seed``'s default point)."""
    return solve_convex_batched(
        [traces], [adj], [D], error_model=error_model, gamma=gamma,
        iters=iters, lr=lr, capacity_penalty=capacity_penalty, seeds=seed,
        z0=None if z0 is None else _as_z0(z0)[None],
        device=device)[0]


def theorem4_closed_form(c: np.ndarray, c_server: float, c_t: float,
                         gamma: float, D: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """n devices offloading to an edge server (node n+1).

    Returns (r*, s*) per eqs. (13)-(14):
      r_i* = 1 − (γ/2c_i)^{2/3}/D_i − s_i,
      s_i* = (γ/(2(c_{n+1}+c_t)))^{2/3} / Σ_j D_j.
    """
    s_star = (gamma / (2 * (c_server + c_t))) ** (2.0 / 3.0) / D.sum()
    s = np.full_like(c, s_star)
    r = 1.0 - (gamma / (2 * c)) ** (2.0 / 3.0) / D - s
    return np.clip(r, 0.0, 1.0), np.clip(s, 0.0, 1.0)


def plan_cost(plan: MovementPlan, traces: CostTraces | EdgeCostTraces,
              D: np.ndarray, *,
              error_model: str = "discard", gamma: float = 1.0) -> dict:
    """Objective decomposition on the sparse plan: the transfer term and
    moved-rate reduce over realized edges only."""
    G = plan.processed(D)
    e = plan.edges
    off = e.src != e.dst
    te, se, de, qe = e.t[off], e.src[off], e.dst[off], e.qty[off]
    proc = float(np.sum(G * traces.c_node))
    if isinstance(traces, EdgeCostTraces):
        eids = traces.edge_ids(se, de)       # plan edges live on support
        c_edge = np.where(eids >= 0,
                          traces.c_link[te, np.maximum(eids, 0)], 0.0)
        trans = float(np.sum(qe * D[te, se] * c_edge))
    else:
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
