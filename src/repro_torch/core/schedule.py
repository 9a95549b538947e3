"""Per-round view of the fog network: adjacency, active mask, events.

The dense subset of :mod:`repro.core.schedule` that the static main
path uses. Two storage modes:

* **constant** — one (n, n) base adjacency shared by every round
  (``adj_at(t)`` returns the base array itself, so a raw static matrix
  adapted through :func:`as_schedule` is read as-is);
* **full** — an explicit (T, n, n) stack (``adj_at(t)`` is ``arr[t]``).

Both take an optional (T, n) active trace. The churn (masked), link
event and edge-list modes of the reference are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_KINDS = ("entry", "exit", "link_up", "link_down")


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
                 active=None):
        self.T, self.n = int(T), int(n)
        if self.T <= 0 or self.n <= 0:
            raise ValueError("NetworkSchedule requires T > 0 and n > 0")
        if (base_adj is None) == (adj_full is None):
            raise TypeError("NetworkSchedule requires exactly one of "
                            "base_adj and adj_full")
        if adj_full is not None and adj_full.shape != (self.T, n, n):
            raise ValueError(f"adj_full shape {adj_full.shape} != "
                             f"{(self.T, n, n)}")
        if base_adj is not None and base_adj.shape != (n, n):
            raise ValueError(f"base_adj shape {base_adj.shape} != {(n, n)}")
        if active is not None and active.shape != (self.T, n):
            raise ValueError(f"active shape {active.shape} != "
                             f"{(self.T, n)}")
        self._base = base_adj
        self._full = adj_full
        self._active = active
        self._events_cache: list[NetEvent] | None = None

    @classmethod
    def constant(cls, adj, T: int, *, active=None) -> "NetworkSchedule":
        """Static network: the adjacency object is kept as-is (no copy)."""
        adj = np.asarray(adj)
        return cls(T, adj.shape[0], base_adj=adj, active=active)

    @classmethod
    def full(cls, adj_full, *, active=None) -> "NetworkSchedule":
        """Explicit (T, n, n) stack (O(T·n²) — caller's choice)."""
        adj_full = np.asarray(adj_full)
        return cls(adj_full.shape[0], adj_full.shape[1], adj_full=adj_full,
                   active=active)

    @property
    def static_adj(self) -> np.ndarray | None:
        """The single (n, n) adjacency if it never changes, else None."""
        return self._base

    def adj_at(self, t: int) -> np.ndarray:
        """(n, n) adjacency of round t (a view — treat as read-only)."""
        if not 0 <= t < self.T:
            raise IndexError(f"round {t} outside horizon [0, {self.T})")
        return self._base if self._full is None else self._full[t]

    def has_edges(self, t: int, src, dst) -> np.ndarray:
        """For each (src[k], dst[k]), is that directed link up at t?"""
        a = np.asarray(self.adj_at(t), bool)
        return a[np.asarray(src, np.int64), np.asarray(dst, np.int64)]

    def activity(self) -> np.ndarray:
        """The dense (T, n) active trace the engines stage."""
        if self._active is not None:
            return self._active.copy()
        return np.ones((self.T, self.n), bool)

    def events_in(self, t0: int, t1: int) -> list[NetEvent]:
        """All events with t0 <= t < t1, sorted: link events from
        adjacent-round diffs of a full stack, entry/exit events from
        active-trace transitions."""
        if self._events_cache is None:
            self._events_cache = self._build_events()
        return [e for e in self._events_cache if t0 <= e.t < t1]

    def _build_events(self) -> list[NetEvent]:
        evs = []
        if self._full is not None:
            for t in range(1, self.T):
                prev = np.asarray(self._full[t - 1], bool)
                cur = np.asarray(self._full[t], bool)
                for i, j in zip(*np.nonzero(cur & ~prev)):
                    evs.append(NetEvent(t, "link_up", int(i), int(j)))
                for i, j in zip(*np.nonzero(prev & ~cur)):
                    evs.append(NetEvent(t, "link_down", int(i), int(j)))
        if self._active is not None:
            prev = self._active[0]
            for t in range(self.T):
                row = self._active[t]
                for i in np.nonzero(row & ~prev)[0]:
                    evs.append(NetEvent(t, "entry", int(i)))
                for i in np.nonzero(prev & ~row)[0]:
                    evs.append(NetEvent(t, "exit", int(i)))
                prev = row
        return sorted(evs)

    def adj_view(self) -> np.ndarray:
        """(T, n, n) adjacency: a broadcast VIEW for a constant schedule
        (no O(T·n²) pages), the stored stack otherwise."""
        if self._full is not None:
            return self._full
        return np.broadcast_to(self._base, (self.T, *self._base.shape))

    def __repr__(self) -> str:
        mode = "constant" if self._full is None else "full"
        return (f"NetworkSchedule(T={self.T}, n={self.n}, mode={mode}, "
                f"active={'all' if self._active is None else 'trace'})")


def as_schedule(adj, T: int) -> NetworkSchedule:
    """Adapter: accept a NetworkSchedule, a static (n, n) matrix or a
    (T, n, n) stack. Static matrices wrap WITHOUT copying."""
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
