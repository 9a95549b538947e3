"""Executable forms of the paper's theoretical results.

Theorem 1  — upper bound on the local loss under FedAvg with movement
Lemma 1    — gradient-divergence bound δ_i ≲ γ_i/√G_i + γ/√|D_V| + Δ
Theorem 2  — capacity choice under exponential stragglers (D/M/1 queue)
Theorem 4  — hierarchical closed form lives in movement.py
Theorem 5  — expected cost savings of offloading, c_i ~ U(0,C)
Theorem 6  — expected number of capacity-constraint violations

A numpy/scipy copy of :mod:`repro.core.theory`: the same arithmetic in
the same order, and the Monte-Carlo draws in the same order from the
caller's generator.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import optimize


# ---------------------------------------------------------------------------
# Theorem 1 / Lemma 1
# ---------------------------------------------------------------------------


def g_i(x: float, delta: float, beta: float, eta: float) -> float:
    """g_i(x) = δ/β · ((ηβ+1)^x − 1)."""
    return delta / beta * ((eta * beta + 1.0) ** x - 1.0)


def h_tau(tau: float, delta: float, beta: float, eta: float) -> float:
    """h(τ) = δ/β((ηβ+1)^τ − 1) − ηδτ (from [5], used in Thm 1)."""
    return g_i(tau, delta, beta, eta) - eta * delta * tau


def theorem1_bound(t: int, tau: int, *, delta_i: float, beta: float,
                   eta: float, rho: float, omega: float) -> float:
    """Upper bound on L(w_i(t)) − L(w*): ε₀ + ρ·g_i(t − Kτ).

    ε₀ is the positive root of y(ε) = ε with
    y(ε) = [tωη(1−βη/2) − ρ(K·h(τ) + g_i(t−Kτ))/ε²]^{-1}.
    """
    assert eta <= 1.0 / beta + 1e-12, "Thm 1 requires η ≤ 1/β"
    K = t // tau
    resid = t - K * tau
    a = t * omega * eta * (1 - beta * eta / 2.0)
    b = rho * (K * h_tau(tau, delta_i, beta, eta)
               + g_i(resid, delta_i, beta, eta))
    # eps = 1/(a − b/eps²)  <=>  a·eps − b/eps = 1  <=>  a·eps² − eps − b = 0
    disc = 1.0 + 4.0 * a * b
    if a <= 0:
        return float("inf")
    eps0 = (1.0 + math.sqrt(max(disc, 0.0))) / (2.0 * a)
    return eps0 + rho * g_i(resid, delta_i, beta, eta)


def lemma1_delta(G: float, gamma_i: float, gamma_total: float,
                 D_V: float, Delta: float) -> float:
    """δ_i ≤ γ_i/√G_i + γ/√|D_V| + Δ (eq. 11)."""
    return gamma_i / math.sqrt(max(G, 1e-12)) \
        + gamma_total / math.sqrt(max(D_V, 1e-12)) + Delta


# ---------------------------------------------------------------------------
# Theorem 2: D/M/1 capacity under stragglers
# ---------------------------------------------------------------------------


def dm1_phi(C: float, mu: float) -> float:
    """Smallest root of φ = exp(−μ(1−φ)/C) (D/M/1, arrival rate C).

    Fixed-point iteration from φ=0 is monotone increasing and converges
    to the smallest root (the map is increasing and starts below it)."""
    if C >= mu:            # unstable queue: only root is 1
        return 1.0
    phi = 0.0
    for _ in range(10_000):
        new = math.exp(-mu * (1.0 - phi) / C)
        if abs(new - phi) < 1e-14:
            return new
        phi = new
    return phi


def dm1_wait(C: float, mu: float) -> float:
    """Expected waiting time of a D/M/1 queue with arrival rate C."""
    phi = dm1_phi(C, mu)
    if phi >= 1.0 - 1e-9:
        return float("inf")
    return phi / (mu * (1.0 - phi))


def theorem2_capacity(mu: float, sigma: float) -> float:
    """Largest C such that the average wait ≤ σ: solve
    φ(C) = σμ/(1+σμ) with φ the D/M/1 root (increasing in C)."""
    target = sigma * mu / (1.0 + sigma * mu)

    def g(C):
        return dm1_phi(C, mu) - target

    lo, hi = 1e-6, mu * 50
    if g(lo) > 0:
        return lo
    while g(hi) < 0 and hi < 1e9:
        hi *= 2
    return optimize.brentq(g, lo, hi)


# ---------------------------------------------------------------------------
# Theorem 5: value of offloading
# ---------------------------------------------------------------------------


def theorem5_savings_k(C: float, k: int) -> float:
    """Closed-form expected savings for a device with k neighbors,
    c ~ U(0,C), zero link costs (eq. 15 inner term):

      C/2 − C(−1)^k/(k+2) − Σ_{l=0}^{k−1} (k choose l) C(−1)^l (k+3)/((l+2)(l+3))
    """
    total = C / 2.0 - C * (-1.0) ** k / (k + 2.0)
    for l in range(k):
        total -= math.comb(k, l) * C * (-1.0) ** l * (k + 3.0) \
            / ((l + 2.0) * (l + 3.0))
    return total


def expected_savings_mc(C: float, k: int, rng: np.random.Generator,
                        n_samples: int = 200_000) -> float:
    """Monte-Carlo E[max(0, c_i − min_j c_j)] for validation."""
    ci = rng.uniform(0, C, n_samples)
    cj = rng.uniform(0, C, (n_samples, k)).min(axis=1)
    return float(np.maximum(0.0, ci - cj).mean())


def theorem5_network_savings(C: float, degree_hist: dict[int, float]) -> float:
    """Σ_k N(k) · savings(k) over a degree distribution (eq. 15)."""
    return sum(frac * theorem5_savings_k(C, k)
               for k, frac in degree_hist.items() if k >= 1)


def scale_free_degree_hist(n: int, gamma_exp: float = 2.5,
                           kmax: int | None = None) -> dict[int, float]:
    """N(k) ∝ k^{1−γ} for γ ∈ (2,3) (normalized)."""
    kmax = kmax or n - 1
    w = {k: k ** (1.0 - gamma_exp) for k in range(1, kmax + 1)}
    Z = sum(w.values())
    return {k: v / Z for k, v in w.items()}


# ---------------------------------------------------------------------------
# Theorem 6: expected capacity violations
# ---------------------------------------------------------------------------


def offload_probability(k: int, f_over_C: float = 1.0) -> float:
    """P_o(k): probability a device with k neighbors offloads under
    Thm 3 with c_i, c_j ~ U(0,C), zero link costs, discard cost f ≥ C
    (no discarding): P[min_j c_j < c_i] = ∫ (1−(1−x)^k) dx = k/(k+1),
    truncated by the discard threshold when f < C."""
    base = k / (k + 1.0)
    return base * min(f_over_C, 1.0)


def theorem6_expected_violations(degree_hist: dict[int, float], n: int,
                                 D: float, cap_samples: np.ndarray,
                                 p_neighbor_deg: dict[int, dict[int, float]]
                                 | None = None) -> float:
    """E[#devices whose capacity is violated] (eq. 16).

    Expected processed load of a device with k neighbors:
      load(k)/D = 1 − P_o(k) + k · Σ_n P_o(n)·p_k(n)/n
    (it keeps its data w.p. 1−P_o(k); each of its k neighbors with n
    neighbors offloads to it w.p. P_o(n)/n). Violated when load > C̃.
    """
    total = 0.0
    for k, frac in degree_hist.items():
        if k < 1:
            continue
        pk = p_neighbor_deg[k] if p_neighbor_deg else degree_hist
        recv = k * sum(offload_probability(m) * p / max(m, 1)
                       for m, p in pk.items() if m >= 1)
        load = D * (1.0 - offload_probability(k) + recv)
        p_viol = float(np.mean(cap_samples < load))
        total += frac * n * p_viol
    return total
