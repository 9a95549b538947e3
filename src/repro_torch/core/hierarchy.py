"""Hierarchical fog aggregation: the tier tree (port of
:mod:`repro.core.hierarchy`, numpy only, same behaviour).

A :class:`TierTree` puts L tiers of aggregators above the n devices:
device → edge gateway → regional fog → cloud. ``parents[0]`` maps the
devices to tier-1 gateways, ``parents[l]`` tier-l groups to tier-(l+1)
groups, and the top tier has exactly one group. The aggregation periods
``taus`` form a divisibility chain (τ_0 | τ_1 | … | τ_{L-1}), so a
tier-l round is a round for every tier below it, and the engine
composes the tiers bottom-up inside one round.

:func:`intra_tier_edges` is the support the movement plane may use
(data never crosses a gateway boundary), and :func:`tier_traffic`
counts the parameter bytes each tier moves. :func:`restrict_traces`
and :func:`restrict_schedule` drop every edge that crosses a gateway
boundary from the sparse cost plane and the schedule, so the edge
solvers route data strictly within a tier; :func:`solve_tier_movement`
is the one-call wrapper. All of it is O(n + E) numpy: no (n, n) array.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core import movement as mv
from repro_torch.core.costs import EdgeCostTraces
from repro_torch.core.schedule import NetworkSchedule


@dataclasses.dataclass(frozen=True, eq=False)
class TierTree:
    """L-tier aggregation tree over ``n`` devices.

    ``taus[l]`` is the aggregation period of tier l+1 (``taus[0]`` is
    the device→gateway period, the flat plane's τ); ``parents[l]``
    assigns each tier-l entity to its tier-(l+1) group (``parents[0]``
    has shape (n,)). Group ids must be dense 0..g_{l+1}-1 and the top
    tier must have exactly one group.
    """

    n: int
    taus: tuple
    parents: tuple

    def __post_init__(self):
        n = int(self.n)
        if n < 1:
            raise ValueError(f"n={n} must be >= 1")
        taus = tuple(int(t) for t in self.taus)
        parents = tuple(np.asarray(p, np.int64).ravel()
                        for p in self.parents)
        if not taus or len(taus) != len(parents):
            raise ValueError(f"{len(taus)} taus for {len(parents)} "
                             "parent maps (need one of each per tier)")
        for lo, hi in zip(taus, taus[1:]):
            if hi % lo != 0:
                raise ValueError(f"tau chain {taus} breaks divisibility:"
                                 f" {hi} % {lo} != 0")
        if any(t < 1 for t in taus):
            raise ValueError(f"taus must be >= 1, got {taus}")
        size = n
        for lvl, p in enumerate(parents):
            if p.shape != (size,):
                raise ValueError(f"parents[{lvl}] has shape {p.shape}, "
                                 f"expected ({size},)")
            if p.size and (p.min() < 0):
                raise ValueError(f"parents[{lvl}] has negative group ids")
            g = int(p.max()) + 1 if p.size else 1
            if np.unique(p).size != g:
                raise ValueError(f"parents[{lvl}] group ids are not "
                                 f"dense 0..{g - 1}")
            size = g
        if size != 1:
            raise ValueError(f"top tier has {size} groups; the tree "
                             "must close at a single root")
        object.__setattr__(self, "n", n)
        object.__setattr__(self, "taus", taus)
        object.__setattr__(self, "parents", parents)

    @property
    def levels(self) -> int:
        return len(self.taus)

    @property
    def group_counts(self) -> tuple:
        """(g_1, …, g_L) — groups per tier; g_L == 1."""
        return tuple(int(p.max()) + 1 for p in self.parents)

    @property
    def widest_bucket(self) -> int:
        """Largest tier-1 gateway population."""
        return int(np.bincount(self.parents[0]).max())

    def ancestors(self) -> tuple:
        """Per-level device→group maps: ``anc[l][i]`` is device i's
        tier-(l+1) group; the engine gathers each device's sync source
        with them."""
        anc = [self.parents[0]]
        for p in self.parents[1:]:
            anc.append(p[anc[-1]])
        return tuple(anc)

    def level_rounds(self, T: int) -> np.ndarray:
        """(T,) int32: the highest tier aggregating at each round (0 =
        no aggregation)."""
        lvl = np.zeros(T, np.int32)
        for l, tau in enumerate(self.taus, start=1):
            lvl[(np.arange(T) + 1) % tau == 0] = l
        return lvl

    def fingerprint(self) -> str:
        """Stable hash of the tree shape (the reference's hex string);
        the engine keys its cached segment layouts on it."""
        h = hashlib.blake2b(digest_size=16)
        h.update(np.int64([self.n, *self.taus]).tobytes())
        for p in self.parents:
            h.update(p.tobytes())
        return h.hexdigest()

    @classmethod
    def balanced(cls, n: int, groups, taus) -> "TierTree":
        """Contiguous balanced tree: ``groups`` = (g_1, …, g_L) with
        g_L == 1; tier-l entity q maps to group ``q * g_{l+1} // g_l``."""
        groups = tuple(int(g) for g in groups)
        parents, size = [], n
        for g in groups:
            parents.append(np.arange(size, dtype=np.int64) * g // size)
            size = g
        return cls(n=n, taus=tuple(taus), parents=tuple(parents))

    @classmethod
    def from_spec(cls, spec: str, n: int) -> "TierTree":
        """Parse the CLI form ``"g1@tau1,g2@tau2,…"`` (e.g.
        ``"32@5,4@10,1@20"``) into a balanced tree. The last group
        count must be 1 (the root)."""
        groups, taus = [], []
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            try:
                g, tau = part.split("@")
                groups.append(int(g))
                taus.append(int(tau))
            except ValueError:
                raise ValueError(
                    f"bad tier spec {part!r} in {spec!r}: expected "
                    "comma-separated 'groups@tau' entries, e.g. "
                    "'32@5,4@10,1@20'") from None
        if not groups:
            raise ValueError(f"empty tier spec {spec!r}")
        if groups[-1] != 1:
            raise ValueError(f"tier spec {spec!r} must close at the "
                             "root: last entry needs 1 group")
        return cls.balanced(n, groups, taus)


def intra_tier_edges(tree: TierTree, src, dst) -> np.ndarray:
    """Boolean keep-mask over directed edges: True where both endpoints
    share a tier-1 gateway."""
    g = tree.parents[0]
    src = np.asarray(src, np.int64).ravel()
    dst = np.asarray(dst, np.int64).ravel()
    return g[src] == g[dst]


def restrict_traces(tree: TierTree, etraces: EdgeCostTraces
                    ) -> EdgeCostTraces:
    """Drop every CSR column whose edge crosses a gateway boundary.
    Node-wise streams (c_node, f_err, cap_node) pass through untouched;
    link streams keep only intra-tier columns. O(E) — the dense (n, n)
    cost plane is never built."""
    keep = intra_tier_edges(tree, etraces.src, etraces.indices)
    src_kept = etraces.src[keep]
    indptr = np.searchsorted(src_kept, np.arange(tree.n + 1,
                                                 dtype=np.int64))
    return EdgeCostTraces(
        c_node=etraces.c_node, f_err=etraces.f_err,
        cap_node=etraces.cap_node, indptr=indptr,
        indices=etraces.indices[keep], c_link=etraces.c_link[:, keep],
        cap_link=etraces.cap_link[:, keep])


def restrict_schedule(tree: TierTree, sched: NetworkSchedule
                      ) -> NetworkSchedule:
    """The schedule each tier's solver sees: same rounds, same activity
    trace (churn is a device property, not a tier property), but every
    cross-gateway link removed from both the round-0 support and the
    event stream. Dense-mode schedules are converted with
    ``to_edgelist()`` first (bitwise replay), so the result is always
    an O(E) edge-list schedule."""
    s = sched.to_edgelist()
    base_keep = intra_tier_edges(tree, s._esrc, s._edst) & s._up0
    src0, dst0 = s._esrc[base_keep], s._edst[base_keep]
    events = ()
    if s._ev_t is not None and s._ev_t.size:
        es, ed = s._esrc[s._ev_eids], s._edst[s._ev_eids]
        ek = intra_tier_edges(tree, es, ed)
        events = (s._ev_t[ek], es[ek], ed[ek],
                  np.asarray(s._ev_up, bool)[ek])
    return NetworkSchedule.edgelist(
        s.n, s.T, src0, dst0, events=events, active=s._active,
        mask_inactive=s._mask, initial_active=s._initial_active)


def solve_tier_movement(tree: TierTree, etraces: EdgeCostTraces,
                        schedule, *, D: np.ndarray | None = None,
                        realize: bool = True,
                        device=None) -> mv.MovementPlan:
    """Movement solved strictly WITHIN tiers: restrict the cost plane
    and the schedule to intra-gateway links, run the sparse greedy
    solver, optionally capacity-repair against ``D``, and realize the
    plan against the (restricted) true schedule. Every edge of the
    returned plan has both endpoints under one gateway. ``device`` is
    where the repair's top-k runs (``cuda`` by default)."""
    tr = restrict_traces(tree, etraces)
    sched = (restrict_schedule(tree, schedule)
             if isinstance(schedule, NetworkSchedule)
             else restrict_schedule(tree, NetworkSchedule.constant(
                 np.asarray(schedule, bool), etraces.c_node.shape[0])))
    plan = mv.greedy_linear(tr, sched)
    if D is not None:
        plan = mv.repair_capacities_edges(plan, tr, sched, D,
                                          device=device)
    return mv.realize_plan(plan, sched) if realize else plan


def tier_traffic(tree: TierTree, param_count: int, *,
                 bytes_per_param: int = 4) -> dict:
    """Per-tier parameter traffic, averaged per τ_0 window.

    Tier l aggregates every ``taus[l-1]`` rounds and moves (uplink +
    downlink) ``2 · members_l · P · B`` bytes per event, where
    members_1 = n and members_l = g_{l-1} above.
    ``cross_tier_bytes_per_window`` is everything above tier 1, compared
    with the flat plane's all-to-server ``2 · n · P · B`` per window."""
    P, B = int(param_count), int(bytes_per_param)
    counts = (tree.n,) + tree.group_counts[:-1]
    tau0 = tree.taus[0]
    per_tier, cross = [], 0.0
    for l, (members, tau) in enumerate(zip(counts, tree.taus), start=1):
        up = members * P * B
        per_window = 2.0 * up * tau0 / tau
        per_tier.append({"level": l, "members": int(members),
                         "tau": int(tau), "up_bytes_per_agg": int(up),
                         "bytes_per_window": per_window})
        if l >= 2:
            cross += per_window
    flat = 2.0 * tree.n * P * B
    return {"per_tier": per_tier,
            "cross_tier_bytes_per_window": cross,
            "flat_bytes_per_window": flat,
            "cross_over_flat": cross / flat if flat else 0.0}
