"""Time-varying network plane (paper §V-E): a numpy copy of
:mod:`repro.core.schedule`, with the same storage modes and accessors,
so the same inputs replay bitwise-equal rounds.

A :class:`NetworkSchedule` is the per-round view of the fog network that
every layer consumes: adjacency, active-device mask and entry/exit /
link events. Five storage modes keep a constant network O(n²) — a
constant schedule NEVER materializes the (T, n, n) tensor, and the
edge-list mode never materializes (n, n) at all:

* **constant** — one (n, n) base adjacency shared by every round
  (``adj_at(t)`` returns the base array itself, so static-``adj`` call
  sites that are adapted through :func:`as_schedule` stay bitwise
  identical to passing the raw matrix);
* **full** — an explicit (T, n, n) stack (``adj_at(t)`` is ``arr[t]``,
  matching the pre-schedule time-varying ndarray path bit for bit);
* **events** — piecewise-constant: base adjacency + a sorted link-event
  list, replayed through a cursor into one reused (n, n) buffer
  (sequential sweeps over t cost O(E + T), random access restarts from
  the base);
* **masked** — base adjacency + a (T, n) active trace with
  ``mask_inactive=True``: ``adj_at(t)`` is ``base & active⊗active``
  computed into one reused buffer, which is how node entry/exit
  (``topology.churn_schedule``) makes the movement plane see churn —
  plans stop routing data over links whose endpoint has left;
* **edgelist** — fully sparse O(E): the union link support as a CSR
  (``indptr``, ``indices``) lex-sorted by (src, dst), an initial
  per-edge ``up`` mask, link events resolved to edge ids and replayed
  through the same cursor discipline as events mode, and optional
  activity masking applied per edge. ``edges_at(t)`` /
  ``neighbors_at(t, i)`` are the native accessors; ``adj_at(t)`` stays
  available as a small-n compatibility view but raises once
  ``n > DENSE_VIEW_MAX_N`` so no O(n²) array can sneak into a scaled
  run. This is the storage that carries n=10⁵⁺ scenarios.

The active mask is always dense (T, n) — O(T·n), never a problem.
Entry/exit and link events are derived lazily for ``events_in``.

``edges_at``/``neighbors_at``/``has_edges`` also work on the four dense
modes (derived from ``adj_at``), so movement/estimator call sites are
storage-agnostic; :meth:`NetworkSchedule.to_edgelist` converts any
schedule into edge-list storage with bitwise-identical replay.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_KINDS = ("entry", "exit", "link_up", "link_down")

# Largest n for which edge-list schedules will materialize a dense
# (n, n) compatibility view (``adj_at`` / ``adj_view``). Above this,
# dense views raise — the sparse accessors are the only way in. Module
# attribute so tests/benches can widen it deliberately.
DENSE_VIEW_MAX_N = 4096


def _edge_keys(src, dst, n: int) -> np.ndarray:
    """Lex-sortable int64 key ``src * n + dst`` for directed edges."""
    return (np.asarray(src, np.int64) * np.int64(n)
            + np.asarray(dst, np.int64))


def _unique_keys(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)``, without the sort when the keys are already
    strictly increasing (edge lists cut from a lex-sorted support)."""
    if keys.size < 2 or bool((keys[1:] > keys[:-1]).all()):
        return keys
    return np.unique(keys)


@dataclasses.dataclass(frozen=True, order=True)
class NetEvent:
    """One network change, effective from round ``t`` onward.

    ``node`` is the (source) device; ``peer`` is the link destination
    for link events and -1 for node entry/exit."""

    t: int
    kind: str
    node: int
    peer: int = -1

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}")
        if self.kind.startswith("link") and self.peer < 0:
            raise ValueError("link events require a peer")


class NetworkSchedule:
    """Per-round adjacency + active mask + events (see module doc)."""

    def __init__(self, T: int, n: int, *, base_adj=None, adj_full=None,
                 edge_csr=None, link_events=(), edge_events=None,
                 active=None, mask_inactive=False, initial_active=None):
        self.T, self.n = int(T), int(n)
        if self.T <= 0 or self.n <= 0:
            raise ValueError("NetworkSchedule requires T > 0 and n > 0")
        self._base = base_adj
        self._full = adj_full
        self._active = active
        self._mask = bool(mask_inactive)
        self._initial_active = initial_active
        if edge_csr is not None and (self._base is not None
                                     or self._full is not None):
            raise TypeError("edge_csr is exclusive with base_adj/adj_full")
        if edge_csr is None and self._full is None and self._base is None:
            raise TypeError("NetworkSchedule requires base_adj, adj_full "
                            "or edge_csr")
        if edge_events is not None and edge_csr is None:
            raise TypeError("edge_events (array link events) require "
                            "edge_csr storage")
        if edge_events is not None and link_events:
            raise TypeError("pass link_events or edge_events, not both")
        if self._full is not None and self._full.shape != (self.T, n, n):
            raise ValueError(f"adj_full shape {self._full.shape} != "
                             f"{(self.T, n, n)}")
        if self._base is not None and self._base.shape != (n, n):
            raise ValueError(f"base_adj shape {self._base.shape} != {(n, n)}")
        if self._active is not None and self._active.shape != (self.T, n):
            raise ValueError(f"active shape {self._active.shape} != "
                             f"{(self.T, n)}")
        # _link_events is None while the events live only as arrays
        # (bulk edge-list path) — materialized lazily for events_in.
        self._link_events: list[NetEvent] | None = \
            sorted(link_events) if edge_events is None else None
        if self._link_events is not None:
            for e in self._link_events:
                if not 0 <= e.t < self.T:
                    raise ValueError(f"event round {e.t} outside horizon")
        # edge-list storage: union-support CSR + initial up mask, with
        # link events held as parallel (t, edge-id, up) arrays — no
        # per-event Python objects on the bulk path.
        self._eindptr = self._esrc = self._edst = self._up0 = None
        self._ev_t: np.ndarray | None = None
        self._ev_eids: np.ndarray | None = None
        self._ev_up: np.ndarray | None = None
        if edge_csr is not None:
            indptr, indices, up0 = edge_csr
            self._eindptr = np.asarray(indptr, np.int64)
            self._edst = np.asarray(indices, np.int64)
            self._up0 = np.asarray(up0, bool)
            if self._eindptr.shape != (self.n + 1,):
                raise ValueError(f"indptr shape {self._eindptr.shape} != "
                                 f"{(self.n + 1,)}")
            if self._up0.shape != self._edst.shape:
                raise ValueError("up0 and indices length mismatch")
            self._esrc = np.repeat(np.arange(self.n, dtype=np.int64),
                                   np.diff(self._eindptr))
            keys = _edge_keys(self._esrc, self._edst, self.n)
            if edge_events is not None:
                ev_t = np.asarray(edge_events[0], np.int64).ravel()
                ev_s = np.asarray(edge_events[1], np.int64).ravel()
                ev_d = np.asarray(edge_events[2], np.int64).ravel()
                ev_up = np.asarray(edge_events[3], bool).ravel()
                if not ev_t.shape == ev_s.shape == ev_d.shape \
                        == ev_up.shape:
                    raise ValueError("edge_events arrays length mismatch")
                order = np.argsort(ev_t, kind="stable")
                ev_t, ev_s = ev_t[order], ev_s[order]
                ev_d, ev_up = ev_d[order], ev_up[order]
            else:
                lev = self._link_events
                for e in lev:
                    if not e.kind.startswith("link"):
                        raise ValueError("edge-list schedules take link "
                                         "events only (entry/exit live in "
                                         "the active trace)")
                ev_t = np.asarray([e.t for e in lev], np.int64)
                ev_s = np.asarray([e.node for e in lev], np.int64)
                ev_d = np.asarray([e.peer for e in lev], np.int64)
                ev_up = np.asarray([e.kind == "link_up" for e in lev],
                                   bool)
            if ev_t.size and (ev_t.min() < 0 or ev_t.max() >= self.T):
                raise ValueError("event round outside horizon")
            k = _edge_keys(ev_s, ev_d, self.n)
            pos = (np.searchsorted(keys, k) if keys.size
                   else np.zeros(k.shape, np.int64))
            inb = pos < keys.size
            hit = np.zeros(k.shape, bool)
            hit[inb] = keys[pos[inb]] == k[inb]
            if not hit.all():
                i = int(np.nonzero(~hit)[0][0])
                raise ValueError(f"event edge ({ev_s[i]}, {ev_d[i]}) not "
                                 "in the union support")
            self._ev_t = ev_t
            self._ev_eids = pos.astype(np.int64)
            self._ev_up = ev_up
        # event-replay cursor (events mode) / mask scratch (masked mode)
        self._cur: np.ndarray | None = None
        self._cur_ptr = 0
        self._mask_buf: np.ndarray | None = None
        self._ones_row: np.ndarray | None = None
        self._events_cache: list[NetEvent] | None = None
        # edge-replay cursor (edgelist mode); every round's liveness and
        # the union's edge keys, kept once computed
        self._eup: np.ndarray | None = None
        self._eptr = 0
        self._live_all: np.ndarray | None = None
        self._ukeys: np.ndarray | None = None

    # -- constructors ---------------------------------------------------

    @classmethod
    def constant(cls, adj, T: int, *, active=None) -> "NetworkSchedule":
        """Static network: the adjacency object is kept as-is (no copy),
        so consumers adapted through ``as_schedule`` read the very same
        array a raw static-``adj`` call site would."""
        adj = np.asarray(adj)
        return cls(T, adj.shape[0], base_adj=adj, active=active)

    @classmethod
    def full(cls, adj_full, *, active=None) -> "NetworkSchedule":
        """Explicit (T, n, n) stack (the pre-schedule time-varying
        representation; O(T·n²) — caller's choice)."""
        adj_full = np.asarray(adj_full)
        return cls(adj_full.shape[0], adj_full.shape[1], adj_full=adj_full,
                   active=active)

    @classmethod
    def from_events(cls, base_adj, T: int, events, *,
                    active=None) -> "NetworkSchedule":
        """Piecewise-constant from a link-event list (each event flips
        one directed link from its round onward)."""
        base_adj = np.asarray(base_adj, bool)
        return cls(T, base_adj.shape[0], base_adj=base_adj,
                   link_events=tuple(events), active=active)

    @classmethod
    def piecewise(cls, adjs, bounds, *, active=None) -> "NetworkSchedule":
        """Piecewise-constant from per-window (n, n) adjacencies.

        ``bounds`` are half-open ``(start, stop)`` round ranges (e.g.
        :func:`repro_torch.core.estimator.window_bounds`); window w uses
        ``adjs[w]``. Stored as ``adjs[0]`` plus link events at each
        window boundary — O(n² + E) memory, never O(T·n²). This is the
        storage of predicted schedules (``estimator.predict_schedule``);
        a prediction that never changes collapses to a constant
        schedule (zero-copy fast path through the movement solvers)."""
        if len(adjs) != len(bounds) or not bounds:
            raise ValueError(f"{len(adjs)} window adjacencies for "
                             f"{len(bounds)} bounds")
        base = np.asarray(adjs[0], bool)
        T = int(bounds[-1][1])
        events = []
        prev = base
        for (a, _), adj in zip(bounds[1:], adjs[1:]):
            cur = np.asarray(adj, bool)
            for i, j in zip(*np.nonzero(cur & ~prev)):
                events.append(NetEvent(int(a), "link_up", int(i), int(j)))
            for i, j in zip(*np.nonzero(prev & ~cur)):
                events.append(NetEvent(int(a), "link_down", int(i),
                                       int(j)))
            prev = cur
        if not events and (active is None
                           or np.asarray(active, bool).all()):
            return cls.constant(base, T)
        return cls(T, base.shape[0], base_adj=base,
                   link_events=tuple(events), active=active)

    @classmethod
    def masked(cls, base_adj, active, *,
               initial_active=None) -> "NetworkSchedule":
        """Node entry/exit: per-round adjacency is the base with every
        link touching an inactive endpoint removed. ``initial_active``
        (default: ``active[0]``) anchors the t=0 entry/exit events."""
        base_adj = np.asarray(base_adj, bool)
        active = np.asarray(active, bool)
        return cls(active.shape[0], base_adj.shape[0], base_adj=base_adj,
                   active=active, mask_inactive=True,
                   initial_active=initial_active)

    @classmethod
    def edgelist(cls, n: int, T: int, src, dst, *, events=(), active=None,
                 mask_inactive: bool = False,
                 initial_active=None) -> "NetworkSchedule":
        """Fully sparse O(E) storage. ``(src, dst)`` are the directed
        links up at round 0; ``events`` flip links over time; an active
        trace with ``mask_inactive=True`` removes links touching
        inactive endpoints (the sparse analogue of masked mode). The
        stored support is the union of the initial edges and every
        event edge, so predicted/flapping links that start down are
        representable without densifying.

        ``events`` is either a sequence of link :class:`NetEvent` or —
        the vectorized bulk form, no per-event Python objects — a
        4-tuple of equal-length arrays ``(t, src, dst, up)`` flipping
        link (src[k], dst[k]) to up-state ``up[k]`` at round t[k]."""
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        if src.shape != dst.shape:
            raise ValueError("src/dst length mismatch")
        if src.size and (src.min() < 0 or src.max() >= n
                         or dst.min() < 0 or dst.max() >= n):
            raise ValueError("edge endpoint outside [0, n)")
        base_keys = _unique_keys(_edge_keys(src, dst, n))
        arr_events = (isinstance(events, tuple) and len(events) == 4
                      and not isinstance(events[0], NetEvent))
        if arr_events:
            ev_s = np.asarray(events[1], np.int64).ravel()
            ev_d = np.asarray(events[2], np.int64).ravel()
            if ev_s.size and (min(ev_s.min(), ev_d.min()) < 0
                              or max(ev_s.max(), ev_d.max()) >= n):
                raise ValueError("event edge endpoint outside [0, n)")
            ek = (np.unique(_edge_keys(ev_s, ev_d, n)) if ev_s.size
                  else None)
        else:
            ev_pairs = [(int(e.node), int(e.peer)) for e in events]
            ek = (np.unique(_edge_keys(
                np.asarray([p[0] for p in ev_pairs], np.int64),
                np.asarray([p[1] for p in ev_pairs], np.int64), n))
                if ev_pairs else None)
        keys = np.union1d(base_keys, ek) if ek is not None else base_keys
        esrc = keys // n
        edst = keys % n
        indptr = np.searchsorted(esrc, np.arange(n + 1, dtype=np.int64))
        pos = np.searchsorted(keys, base_keys)
        up0 = np.zeros(keys.size, bool)
        up0[pos] = True
        if arr_events:
            return cls(T, n, edge_csr=(indptr, edst, up0),
                       edge_events=events, active=active,
                       mask_inactive=mask_inactive,
                       initial_active=initial_active)
        return cls(T, n, edge_csr=(indptr, edst, up0),
                   link_events=tuple(events), active=active,
                   mask_inactive=mask_inactive,
                   initial_active=initial_active)

    @classmethod
    def piecewise_edges(cls, n: int, edge_sets, bounds, *,
                        active=None) -> "NetworkSchedule":
        """Sparse analogue of :meth:`piecewise`: per-window ``(src,
        dst)`` edge lists, stored as window-0 edges plus boundary link
        events derived from edge-set diffs — O(E) memory, never (n, n).
        This is the storage of predicted schedules at scale. The sets
        become keep masks over their sorted union (see
        :meth:`piecewise_support`)."""
        if len(edge_sets) != len(bounds) or not bounds:
            raise ValueError(f"{len(edge_sets)} window edge sets for "
                             f"{len(bounds)} bounds")
        keys = [_edge_keys(np.asarray(s, np.int64).ravel(),
                           np.asarray(d, np.int64).ravel(), n)
                for s, d in edge_sets]
        support = np.unique(np.concatenate(keys))
        keeps = [np.isin(support, k) for k in keys]
        return cls.piecewise_support(n, support // n, support % n, keeps,
                                     bounds, active=active)

    @classmethod
    def piecewise_support(cls, n: int, src, dst, keeps, bounds, *,
                          active=None) -> "NetworkSchedule":
        """:meth:`piecewise_edges` of the edge sets ``(src[k], dst[k])``
        for each window's keep mask ``k`` over one lex-sorted support
        ``(src, dst)`` without duplicates: window l's events are the
        links its mask turns on (``link_up``) and off (``link_down``)
        against window l−1's, in support order."""
        if len(keeps) != len(bounds) or not bounds:
            raise ValueError(f"{len(keeps)} window edge sets for "
                             f"{len(bounds)} bounds")
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.size and (min(src.min(), dst.min()) < 0
                         or max(src.max(), dst.max()) >= n):
            raise ValueError("edge endpoint outside [0, n)")
        keeps = [np.asarray(k, bool) for k in keeps]
        prev = keeps[0]
        ev_t, ev_i, ev_up = [], [], []
        for (a, _), keep in zip(bounds[1:], keeps[1:]):
            up = np.nonzero(keep & ~prev)[0]
            down = np.nonzero(prev & ~keep)[0]
            ev_t += [np.full(up.size, a, np.int64),
                     np.full(down.size, a, np.int64)]
            ev_i += [up, down]
            ev_up += [np.ones(up.size, bool), np.zeros(down.size, bool)]
            prev = keep
        idx = np.concatenate(ev_i) if ev_i else np.empty(0, np.int64)
        # the stored support: every link some window keeps, in support
        # order (what edgelist() derives from the keys)
        union = np.logical_or.reduce(keeps)
        usrc = src[union]
        return cls(int(bounds[-1][1]), n,
                   edge_csr=(np.searchsorted(usrc, np.arange(n + 1)),
                             dst[union], keeps[0][union]),
                   edge_events=(np.concatenate(ev_t) if ev_t
                                else np.empty(0, np.int64),
                                src[idx], dst[idx],
                                np.concatenate(ev_up) if ev_up
                                else np.empty(0, bool)),
                   active=active)

    def to_edgelist(self) -> "NetworkSchedule":
        """Convert any storage mode to edge-list storage with bitwise-
        identical per-round replay (``edges_at``/``adj_at``/``events_in``
        all agree). Small-n only for dense inputs — this walks the dense
        representation once."""
        if self._eindptr is not None:
            return self
        if self._full is not None:
            base = np.asarray(self._full[0], bool)
            events = [e for e in self._build_events()
                      if e.kind.startswith("link")]
            mask = False          # full mode never masks by activity
        elif self._link_events:
            base = np.asarray(self._base, bool)
            events = list(self._link_events)
            mask = False          # dense events mode ignores the mask
        else:
            base = np.asarray(self._base, bool)
            events = []
            mask = self._mask
        src, dst = np.nonzero(base)
        return NetworkSchedule.edgelist(
            self.n, self.T, src, dst, events=events, active=self._active,
            mask_inactive=mask, initial_active=self._initial_active)

    def with_activity(self, active, *,
                      mask_inactive: bool | None = None
                      ) -> "NetworkSchedule":
        """Same network, different active trace — how the fault plane
        composes crash outages into the announced schedule
        (``faults.FaultSchedule.compose``). Adjacency storage (base /
        full / events) is preserved; ``mask_inactive`` defaults to the
        schedule's current setting (note adjacency masking only applies
        in base/masked storage — events/full modes keep their stored
        links and expose the new trace through ``active_at`` only)."""
        active = np.asarray(active, bool)
        if active.shape != (self.T, self.n):
            raise ValueError(f"active shape {active.shape} != "
                             f"{(self.T, self.n)}")
        csr = (None if self._eindptr is None
               else (self._eindptr, self._edst, self._up0))
        lev, eev = (), None
        if csr is not None and self._ev_t is not None:
            eev = (self._ev_t, self._esrc[self._ev_eids],
                   self._edst[self._ev_eids], self._ev_up)
        elif self._link_events:
            lev = tuple(self._link_events)
        return NetworkSchedule(
            self.T, self.n, base_adj=self._base, adj_full=self._full,
            edge_csr=csr, link_events=lev, edge_events=eev,
            active=active,
            mask_inactive=self._mask if mask_inactive is None
            else bool(mask_inactive),
            initial_active=self._initial_active)

    # -- accessors ------------------------------------------------------

    @property
    def storage(self) -> str:
        """Storage-mode discriminator: ``constant`` / ``full`` /
        ``events`` / ``masked`` / ``edgelist``."""
        if self._eindptr is not None:
            return "edgelist"
        if self._full is not None:
            return "full"
        if self._link_events:
            return "events"
        if self._mask:
            return "masked"
        return "constant"

    @property
    def static_adj(self) -> np.ndarray | None:
        """The single (n, n) adjacency if it never changes, else None —
        the fast-path discriminator for movement solvers. Edge-list
        schedules always return None (use :meth:`static_edges`)."""
        if self._eindptr is not None:
            return None
        if self._full is not None or self._link_events:
            return None
        if self._mask and self._active is not None \
                and not self._active.all():
            return None
        return self._base

    def static_edges(self) -> tuple[np.ndarray, np.ndarray] | None:
        """Sparse fast-path discriminator: the lex-sorted ``(src, dst)``
        edge arrays if the link set never changes, else None."""
        if self._eindptr is None:
            st = self.static_adj
            if st is None:
                return None
            i, j = np.nonzero(np.asarray(st, bool))
            return i.astype(np.int64), j.astype(np.int64)
        if self._ev_t is not None and self._ev_t.size:
            return None
        if self._mask and self._active is not None \
                and not self._active.all():
            return None
        if self._up0.all():
            return self._esrc, self._edst
        return self._esrc[self._up0], self._edst[self._up0]

    def _dense_guard(self, what: str):
        if self.n > DENSE_VIEW_MAX_N:
            raise RuntimeError(
                f"{what} would materialize a dense ({self.n}, {self.n}) "
                f"array from an edge-list schedule (guard: "
                f"DENSE_VIEW_MAX_N={DENSE_VIEW_MAX_N}). Use edges_at / "
                f"neighbors_at / has_edges, or raise "
                f"repro_torch.core.schedule.DENSE_VIEW_MAX_N deliberately.")

    def adj_at(self, t: int) -> np.ndarray:
        """(n, n) adjacency of round t. Constant/full modes return the
        stored array (a view — treat as read-only); events/masked/
        edgelist modes return a reused scratch buffer valid until the
        next call. Edge-list schedules only serve this as a small-n
        compatibility view — above ``DENSE_VIEW_MAX_N`` it raises."""
        if not 0 <= t < self.T:
            raise IndexError(f"round {t} outside horizon [0, {self.T})")
        if self._eindptr is not None:
            self._dense_guard("adj_at")
            if self._mask_buf is None:
                self._mask_buf = np.zeros((self.n, self.n), bool)
            else:
                self._mask_buf[:] = False
            s, d = self.edges_at(t)
            self._mask_buf[s, d] = True
            return self._mask_buf
        if self._full is not None:
            return self._full[t]
        if self._link_events:
            return self._replay(t)
        if self._mask and self._active is not None:
            row = self._active[t]
            if row.all():
                return self._base
            if self._mask_buf is None:
                self._mask_buf = np.empty((self.n, self.n), bool)
            np.logical_and(self._base, row[:, None], out=self._mask_buf)
            np.logical_and(self._mask_buf, row[None, :],
                           out=self._mask_buf)
            return self._mask_buf
        return self._base

    def _replay(self, t: int) -> np.ndarray:
        ev = self._link_events
        if self._cur is None or (self._cur_ptr > 0
                                 and ev[self._cur_ptr - 1].t > t):
            self._cur = np.array(self._base, dtype=bool, copy=True)
            self._cur_ptr = 0
        while self._cur_ptr < len(ev) and ev[self._cur_ptr].t <= t:
            e = ev[self._cur_ptr]
            self._cur[e.node, e.peer] = e.kind == "link_up"
            self._cur_ptr += 1
        return self._cur

    def _ereplay(self, t: int) -> np.ndarray:
        """Edge-set replay: per-edge up mask of round t (reused buffer;
        sequential sweeps cost O(V) total, random access restarts)."""
        ev_t = self._ev_t
        if ev_t is None or ev_t.size == 0:
            return self._up0
        if self._eup is None or (self._eptr > 0
                                 and ev_t[self._eptr - 1] > t):
            self._eup = self._up0.copy()
            self._eptr = 0
        hi = int(np.searchsorted(ev_t, t, side="right"))
        if hi > self._eptr:
            sl = slice(self._eptr, hi)
            # fancy assignment: with duplicate edge ids the last value
            # wins — the sequential event-application order
            self._eup[self._ev_eids[sl]] = self._ev_up[sl]
            self._eptr = hi
        return self._eup

    def _live_mask(self, t: int) -> np.ndarray:
        """Per-union-edge liveness at round t: up-state AND (in masked
        mode) both endpoints active."""
        up = self._ereplay(t)
        if self._mask and self._active is not None:
            row = self._active[t]
            if not row.all():
                return up & row[self._esrc] & row[self._edst]
        return up

    def live_matrix(self) -> np.ndarray:
        """(T, E) liveness of every union edge at every round (the
        rows :meth:`edge_ids_at` reads), edge-list storage only;
        computed in one forward sweep at the first call and kept
        (T·E bytes). Read-only."""
        if self._eindptr is None:
            raise TypeError("live_matrix requires edge-list storage "
                            "(see to_edgelist)")
        if self._live_all is None:
            live = np.empty((self.T, self._edst.size), bool)
            for t in range(self.T):
                live[t] = self._live_mask(t)
            live.flags.writeable = False
            self._live_all = live
        return self._live_all

    def edges_at(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """The directed ``(src, dst)`` edge arrays of round t, lex-
        sorted by (src, dst). O(E) for edge-list schedules; dense modes
        derive it from ``adj_at`` (small-n compatibility)."""
        if self._eindptr is not None:
            if not 0 <= t < self.T:
                raise IndexError(f"round {t} outside horizon "
                                 f"[0, {self.T})")
            keep = self._live_mask(t)
            if keep.all():
                return self._esrc, self._edst
            return self._esrc[keep], self._edst[keep]
        i, j = np.nonzero(np.asarray(self.adj_at(t), bool))
        return i.astype(np.int64), j.astype(np.int64)

    def edge_ids_at(self, t: int) -> np.ndarray:
        """Positions (into the union CSR edge arrays) of the edges up
        at round t — edge-list schedules only."""
        if self._eindptr is None:
            raise TypeError("edge_ids_at requires edge-list storage "
                            "(see to_edgelist)")
        if not 0 <= t < self.T:
            raise IndexError(f"round {t} outside horizon [0, {self.T})")
        return np.nonzero(self._live_mask(t))[0]

    def neighbors_at(self, t: int, i: int) -> np.ndarray:
        """Out-neighbors of device i at round t (sorted device ids).
        O(deg(i)) for edge-list schedules."""
        if self._eindptr is not None:
            if not 0 <= t < self.T:
                raise IndexError(f"round {t} outside horizon "
                                 f"[0, {self.T})")
            lo, hi = int(self._eindptr[i]), int(self._eindptr[i + 1])
            keep = self._ereplay(t)[lo:hi]
            if self._mask and self._active is not None:
                row = self._active[t]
                if not row[i]:
                    return np.empty(0, np.int64)
                keep = keep & row[self._edst[lo:hi]]
            return self._edst[lo:hi][keep]
        return np.nonzero(np.asarray(self.adj_at(t), bool)[i])[0] \
            .astype(np.int64)

    def has_edges(self, t: int, src, dst) -> np.ndarray:
        """Vectorized membership test: for each (src[k], dst[k]), is
        that directed link up at round t? This is how the movement
        plane validates plan edges without dense rows."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if self._eindptr is not None:
            # look the links up in the union support, then in round t's
            # liveness: the same answer as a search of edges_at(t)
            if not 0 <= t < self.T:
                raise IndexError(f"round {t} outside horizon "
                                 f"[0, {self.T})")
            if self._ukeys is None:
                self._ukeys = _edge_keys(self._esrc, self._edst, self.n)
            keys = self._ukeys
            out = np.zeros(src.shape, bool)
            if keys.size == 0:
                return out
            q = _edge_keys(src, dst, self.n)
            pos = np.searchsorted(keys, q)
            inb = pos < keys.size
            inb[inb] = keys[pos[inb]] == q[inb]
            out[inb] = self.live_matrix()[t][pos[inb]]
            return out
        a = np.asarray(self.adj_at(t), bool)
        return a[src, dst]

    def union_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """The union link support as CSR ``(indptr, indices)`` — every
        edge that is ever up (edge-list schedules only)."""
        if self._eindptr is None:
            raise TypeError("union_csr requires edge-list storage "
                            "(see to_edgelist)")
        return self._eindptr, self._edst

    def active_at(self, t: int) -> np.ndarray:
        """(n,) active mask of round t (read-only view)."""
        if not 0 <= t < self.T:
            raise IndexError(f"round {t} outside horizon [0, {self.T})")
        if self._active is not None:
            return self._active[t]
        if self._ones_row is None:
            self._ones_row = np.ones(self.n, bool)
        return self._ones_row

    def activity(self) -> np.ndarray:
        """The dense (T, n) active trace — what the engines stage as the
        per-round churn mask (one source of truth)."""
        if self._active is not None:
            return self._active.copy()
        return np.ones((self.T, self.n), bool)

    def events_in(self, t0: int, t1: int) -> list[NetEvent]:
        """All events with t0 <= t < t1, sorted. Entry/exit events come
        from active-trace transitions; link events from the event list
        (events mode) or adjacent-round diffs (full mode — O(T·n²)
        compute on first use, cached)."""
        if self._events_cache is None:
            self._events_cache = self._build_events()
        return [e for e in self._events_cache if t0 <= e.t < t1]

    def _materialize_link_events(self) -> list[NetEvent]:
        """The link events as NetEvent objects — built lazily from the
        array representation when the schedule came in on the bulk
        (array-events) path."""
        if self._link_events is None:
            s = self._esrc[self._ev_eids]
            d = self._edst[self._ev_eids]
            self._link_events = [
                NetEvent(int(t), "link_up" if u else "link_down",
                         int(si), int(di))
                for t, u, si, di in zip(self._ev_t, self._ev_up, s, d)]
        return self._link_events

    def _build_events(self) -> list[NetEvent]:
        evs = list(self._materialize_link_events())
        if self._full is not None:
            for t in range(1, self.T):
                prev = np.asarray(self._full[t - 1], bool)
                cur = np.asarray(self._full[t], bool)
                for i, j in zip(*np.nonzero(cur & ~prev)):
                    evs.append(NetEvent(t, "link_up", int(i), int(j)))
                for i, j in zip(*np.nonzero(prev & ~cur)):
                    evs.append(NetEvent(t, "link_down", int(i), int(j)))
        if self._active is not None:
            prev = (self._active[0] if self._initial_active is None
                    else np.asarray(self._initial_active, bool))
            for t in range(self.T):
                row = self._active[t]
                for i in np.nonzero(row & ~prev)[0]:
                    evs.append(NetEvent(t, "entry", int(i)))
                for i in np.nonzero(prev & ~row)[0]:
                    evs.append(NetEvent(t, "exit", int(i)))
                prev = row
        return sorted(evs)

    # -- dense views (oracles / device kernels only) --------------------

    def adj_view(self) -> np.ndarray:
        """(T, n, n) adjacency. Constant schedules return a broadcast
        VIEW (no O(T·n²) pages — exactly what the pre-schedule
        ``_adj_t`` adapter produced); time-varying schedules materialize.
        For dense oracles, the convex mask and device kernels only."""
        if self._full is not None:
            return self._full
        static = self.static_adj
        if static is not None:
            return np.broadcast_to(static, (self.T, *static.shape))
        return np.stack([np.array(self.adj_at(t), dtype=bool, copy=True)
                         for t in range(self.T)])

    def __repr__(self) -> str:
        extra = (f", edges={self._edst.size}"
                 if self._eindptr is not None else "")
        n_ev = (int(self._ev_t.size) if self._ev_t is not None
                else len(self._link_events or ()))
        return (f"NetworkSchedule(T={self.T}, n={self.n}, "
                f"mode={self.storage}{extra}, events={n_ev}, "
                f"active={'all' if self._active is None else 'trace'})")


def as_schedule(adj, T: int) -> NetworkSchedule:
    """Adapter: accept a NetworkSchedule, a static (n, n) matrix or a
    (T, n, n) stack. Static matrices wrap WITHOUT copying, so adapted
    consumers stay bitwise identical to the pre-schedule code paths."""
    if isinstance(adj, NetworkSchedule):
        if adj.T != T:
            raise ValueError(f"schedule horizon T={adj.T} does not match "
                             f"the caller's T={T}")
        return adj
    a = np.asarray(adj)
    if a.ndim == 2:
        return NetworkSchedule.constant(a, T)
    if a.ndim == 3:
        if a.shape[0] != T:
            raise ValueError(f"(T, n, n) adjacency has T={a.shape[0]}, "
                             f"caller expects T={T}")
        return NetworkSchedule.full(a)
    raise TypeError(f"cannot interpret {type(adj).__name__} of ndim "
                    f"{a.ndim} as a network schedule")
