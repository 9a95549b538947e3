"""Fog network topologies (paper §III-A, §V-C/D) — numpy, host side.

A topology is a boolean adjacency matrix ``adj`` (n, n) of directed
links (i, j) — ``adj[i, j]`` means i may offload to j. The aggregation
server is implicit (every device reaches it for parameters, never for
data). Dynamics: at each round, active devices exit w.p. ``p_exit`` and
inactive devices re-enter w.p. ``p_entry`` (paper §V-E), and links flap
down and back up. A copy of :mod:`repro.core.topology` with the same rng
stepping. The ``_edges`` producers take ``(src, dst)`` edge arrays and
build no (n, n) array, for device counts of 10⁵ and more.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schedule import NetEvent, NetworkSchedule


def fully_connected(n: int) -> np.ndarray:
    adj = np.ones((n, n), bool)
    np.fill_diagonal(adj, False)
    return adj


def random_graph(n: int, rho: float, rng: np.random.Generator) -> np.ndarray:
    """Directed Erdős–Rényi: P[(i,j) ∈ E] = rho (paper §V-C2)."""
    adj = rng.random((n, n)) < rho
    np.fill_diagonal(adj, False)
    return adj


def hierarchical(n: int, rng: np.random.Generator,
                 costs: np.ndarray | None = None) -> np.ndarray:
    """Paper §V-D: the n/3 lowest-processing-cost nodes act as "edge
    servers"; each remaining device links to two of them at random."""
    n_srv = max(n // 3, 1)
    order = np.argsort(costs) if costs is not None else rng.permutation(n)
    servers = order[:n_srv]
    adj = np.zeros((n, n), bool)
    for i in range(n):
        if i in servers:
            continue
        picks = rng.choice(servers, size=min(2, n_srv), replace=False)
        adj[i, picks] = True
    return adj


def watts_strogatz(n: int, k: int, beta: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Small-world social topology (each node linked to n/5 neighbours)."""
    k = max(2, min(k - (k % 2), n - 1))
    adj = np.zeros((n, n), bool)
    for i in range(n):
        for d in range(1, k // 2 + 1):
            adj[i, (i + d) % n] = True
            adj[i, (i - d) % n] = True
    for i in range(n):
        for j in np.nonzero(adj[i])[0]:
            if rng.random() < beta:
                choices = [c for c in range(n) if c != i and not adj[i, c]]
                if choices:
                    adj[i, j] = False
                    adj[i, rng.choice(choices)] = True
    return adj | adj.T  # social trust is mutual


def scale_free(n: int, m: int, rng: np.random.Generator) -> np.ndarray:
    """Barabási–Albert preferential attachment (Thm 5's N(k) ~ k^{1-γ})."""
    m = max(1, min(m, n - 1))
    adj = np.zeros((n, n), bool)
    deg = np.zeros(n)
    for i in range(1, n):
        if i <= m:
            targets = np.arange(i)
        else:
            p = deg[:i] + 1.0
            targets = rng.choice(i, size=m, replace=False, p=p / p.sum())
        adj[i, targets] = True
        adj[targets, i] = True
        deg[i] += len(np.atleast_1d(targets))
        deg[targets] += 1
    return adj


def ring_lattice_edges(n: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric k-regular ring lattice as ``(src, dst)`` edge arrays —
    O(n·k) memory, never (n, n). The deterministic backbone for
    sparse-plane benches at n=10⁵⁺."""
    k = max(2, min(k - (k % 2), n - 1))
    i = np.repeat(np.arange(n, dtype=np.int64), k)
    offs = np.concatenate([np.arange(1, k // 2 + 1, dtype=np.int64),
                           -np.arange(1, k // 2 + 1, dtype=np.int64)])
    j = (i + np.tile(offs, n)) % n
    keys = np.unique(i * np.int64(n) + j)
    return keys // n, keys % n


def random_sparse_edges(n: int, deg: int, rng: np.random.Generator
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric random graph with expected out-degree ~``deg`` as
    ``(src, dst)`` edge arrays — the O(E) analogue of
    :func:`random_graph` for device counts where an (n, n) mask is
    unaffordable. Self-loops excluded; both directions present."""
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = (src + rng.integers(1, n, size=src.size)) % n
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    keys = np.unique(s * np.int64(n) + d)
    return keys // n, keys % n


def make_topology(kind: str, n: int, rng: np.random.Generator, *,
                  rho: float = 1.0, costs: np.ndarray | None = None
                  ) -> np.ndarray:
    if kind == "full":
        return fully_connected(n)
    if kind == "random":
        return random_graph(n, rho, rng)
    if kind == "hierarchical":
        return hierarchical(n, rng, costs)
    if kind == "social":
        return watts_strogatz(n, max(2, n // 5), 0.2, rng)
    if kind == "scale_free":
        return scale_free(n, 2, rng)
    raise ValueError(f"unknown topology {kind!r}")


class ChurnProcess:
    """Node entry/exit dynamics (paper §V-E)."""

    def __init__(self, n: int, p_exit: float, p_entry: float,
                 rng: np.random.Generator):
        self.n, self.p_exit, self.p_entry = n, p_exit, p_entry
        self.rng = rng
        self.active = np.ones(n, bool)
        # nodes that re-entered mid-period wait for the next global sync
        self.waiting = np.zeros(n, bool)

    def step(self) -> np.ndarray:
        r = self.rng.random(self.n)
        exits = self.active & (r < self.p_exit)
        entries = (~self.active) & (r < self.p_entry)
        self.active = (self.active & ~exits) | entries
        self.waiting = (self.waiting | entries) & self.active
        return self.active.copy()

    def sync(self):
        """Global aggregation: waiting nodes receive parameters."""
        self.waiting[:] = False

    def contributing(self) -> np.ndarray:
        """Nodes whose updates count for the current aggregation."""
        return self.active & ~self.waiting


def churn_schedule(adj: np.ndarray, T: int, p_exit: float, p_entry: float,
                   rng: np.random.Generator, *,
                   tau: int | None = None) -> NetworkSchedule:
    """Node entry/exit as a masked schedule: :class:`ChurnProcess` steps
    once a round (``sync()`` every ``tau`` rounds), and each round's
    adjacency drops every link with an inactive endpoint. Every device
    starts active, so exits in round 0 are events."""
    n = np.asarray(adj).shape[0]
    proc = ChurnProcess(n, p_exit, p_entry, rng)
    rows = []
    for t in range(T):
        rows.append(proc.step())
        if tau and (t + 1) % tau == 0:
            proc.sync()
    return NetworkSchedule.masked(adj, np.stack(rows),
                                  initial_active=np.ones(n, bool))


def link_flap_schedule(adj: np.ndarray, T: int, rng: np.random.Generator,
                       *, p_down: float = 0.05,
                       p_up: float = 0.5) -> NetworkSchedule:
    """Seeded link flaps: each up link fails w.p. ``p_down`` per round
    and each failed base link recovers w.p. ``p_up`` (links absent from
    the base graph never appear). One uniform per unordered pair, so
    (i, j) and (j, i) flap together. Stored as an event list: O(n² +
    #events) memory, never O(T·n²)."""
    base = np.asarray(adj, bool)
    n = base.shape[0]
    lo = np.arange(n)[:, None] > np.arange(n)[None, :]
    up = base.copy()
    events: list[NetEvent] = []
    for t in range(1, T):
        r = rng.random(base.shape)
        r = np.where(lo, r.T, r)         # r[i, j] == r[j, i]
        down = up & (r < p_down)
        back = base & ~up & (r < p_up)
        for i, j in zip(*np.nonzero(down)):
            events.append(NetEvent(t, "link_down", int(i), int(j)))
        for i, j in zip(*np.nonzero(back)):
            events.append(NetEvent(t, "link_up", int(i), int(j)))
        up = (up & ~down) | back
    return NetworkSchedule.from_events(base, T, events)


def _tier_stream(rng: np.random.Generator,
                 node_offset: int) -> np.random.Generator:
    """Decorrelate per-tier schedule draws from ONE seed source:
    ``node_offset == 0`` returns ``rng`` untouched (bitwise-stable flat
    behavior), a nonzero offset consumes one draw from ``rng`` as
    entropy and spawns an independent child stream keyed by the
    offset. Two tiers built from the same seed with different offsets
    therefore churn/flap DIFFERENT edges, while the same (seed,
    offset) pair stays reproducible."""
    if not node_offset:
        return rng
    seq = np.random.SeedSequence(entropy=int(rng.integers(2 ** 63)),
                                 spawn_key=(int(node_offset),))
    return np.random.default_rng(seq)


def churn_schedule_edges(n: int, src, dst, T: int, p_exit: float,
                         p_entry: float, rng: np.random.Generator, *,
                         tau: int | None = None,
                         node_offset: int = 0) -> NetworkSchedule:
    """Sparse producer for node churn: identical :class:`ChurnProcess`
    rng stepping to :func:`churn_schedule` (same seed ⇒ bitwise-equal
    activity trace), but the topology enters as ``(src, dst)`` edge
    arrays and the result is an edge-list schedule — no dense mask is
    ever built, so this is the producer for n=10⁵⁺ scenarios.

    ``node_offset`` — tier/subset decorrelation: per-tier schedules
    drawn from one seed used to share the rng stream (two tiers with
    the same seed churned IDENTICAL node patterns); pass each tier's
    first node id (or any distinct int) to draw an independent stream
    per tier. ``0`` preserves the historical stream bitwise."""
    proc = ChurnProcess(n, p_exit, p_entry, _tier_stream(rng, node_offset))
    rows = []
    for t in range(T):
        rows.append(proc.step())
        if tau and (t + 1) % tau == 0:
            proc.sync()
    return NetworkSchedule.edgelist(n, T, src, dst, active=np.stack(rows),
                                    mask_inactive=True,
                                    initial_active=np.ones(n, bool))


def link_flap_schedule_edges(n: int, src, dst, T: int,
                             rng: np.random.Generator, *,
                             p_down: float = 0.05,
                             p_up: float = 0.5,
                             node_offset: int = 0) -> NetworkSchedule:
    """Sparse producer for link flap: one uniform draw per UNORDERED
    base pair per round (O(T·E), never an (n, n) draw), both directions
    of a pair flapping together, emitted as edge-delta link events on
    an edge-list schedule. Seeded and deterministic; the rng stream
    differs from the dense :func:`link_flap_schedule` (which burns an
    (n, n) draw per round) — equivalence suites compare replay
    semantics via ``to_edgelist``, not producer rng.

    ``node_offset`` — see :func:`churn_schedule_edges`: distinct
    offsets decorrelate per-tier flap streams drawn from one seed;
    ``0`` preserves the historical stream bitwise."""
    rng = _tier_stream(rng, node_offset)
    src = np.asarray(src, np.int64).ravel()
    dst = np.asarray(dst, np.int64).ravel()
    keys = np.unique(src * np.int64(n) + dst)
    es, ed = keys // n, keys % n
    # unordered pairs + which directions each pair carries
    pair_keys = np.unique(np.minimum(es, ed) * np.int64(n)
                          + np.maximum(es, ed))
    pa, pb = pair_keys // n, pair_keys % n
    fwd = np.isin(pa * np.int64(n) + pb, keys)   # (a, b) in base
    rev = np.isin(pb * np.int64(n) + pa, keys)   # (b, a) in base
    up = np.ones(pair_keys.size, bool)
    events: list[NetEvent] = []
    for t in range(1, T):
        r = rng.random(pair_keys.size)
        down = up & (r < p_down)
        back = ~up & (r < p_up)
        for p in np.nonzero(down)[0]:
            if fwd[p]:
                events.append(NetEvent(t, "link_down", int(pa[p]),
                                       int(pb[p])))
            if rev[p]:
                events.append(NetEvent(t, "link_down", int(pb[p]),
                                       int(pa[p])))
        for p in np.nonzero(back)[0]:
            if fwd[p]:
                events.append(NetEvent(t, "link_up", int(pa[p]),
                                       int(pb[p])))
            if rev[p]:
                events.append(NetEvent(t, "link_up", int(pb[p]),
                                       int(pa[p])))
        up = (up & ~down) | back
    return NetworkSchedule.edgelist(n, T, es, ed, events=events)


def make_schedule(kind: str, adj: np.ndarray, T: int,
                  rng: np.random.Generator, *, p_exit: float = 0.0,
                  p_entry: float = 0.0, p_flap: float = 0.05,
                  p_recover: float = 0.5,
                  tau: int | None = None) -> NetworkSchedule:
    """CLI dispatcher over the schedule producers: ``static``,
    ``churn`` or ``flap``."""
    if kind == "static":
        return NetworkSchedule.constant(adj, T)
    if kind == "churn":
        return churn_schedule(adj, T, p_exit, p_entry, rng, tau=tau)
    if kind == "flap":
        return link_flap_schedule(adj, T, rng, p_down=p_flap, p_up=p_recover)
    raise ValueError(f"unknown schedule kind {kind!r}")
