"""Fog network topologies (paper §III-A, §V-C/D) — numpy, host side.

A topology is a boolean adjacency matrix ``adj`` (n, n) of directed
links (i, j) — ``adj[i, j]`` means i may offload to j. The aggregation
server is implicit (every device reaches it for parameters, never for
data). A copy of :mod:`repro.core.topology` with the same rng stepping.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schedule import NetworkSchedule


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


def make_schedule(kind: str, adj: np.ndarray, T: int) -> NetworkSchedule:
    """CLI dispatcher over the schedule producers. Only the static
    schedule is ported; churn and flap are ROADMAP.md queue 1 item 8."""
    if kind == "static":
        return NetworkSchedule.constant(adj, T)
    if kind in ("churn", "flap"):
        raise NotImplementedError(
            f"schedule {kind!r} is not ported yet (ROADMAP.md, queue 1 "
            "item 8: dynamics and prediction)")
    raise ValueError(f"unknown schedule kind {kind!r}")
