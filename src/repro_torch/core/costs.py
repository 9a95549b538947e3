"""Cost and capacity models (paper §III-A, §V-A) — numpy, host side.

Processing cost c_i(t) per datapoint, link cost c_ij(t) per offloaded
datapoint, error-cost weight f_i(t), node capacity C_i(t), link capacity
C_ij(t). A copy of :mod:`repro.core.costs` with the same rng stepping,
so the same seed gives bitwise-equal traces:

* ``synthetic``     — c_i, c_ij ~ U(0,1) i.i.d. (paper's synthetic setting)
* ``testbed_like``  — correlated traces emulating the paper's Raspberry-Pi
  measurements: a latent "device quality" factor shared by compute and
  link speed, plus AR(1) temporal noise, scaled to [0, 1].
* ``ici``           — per-point move and compute seconds between the
  model zoo's data shards (``launch/train.py --mode lm``).

:class:`EdgeCostTraces` holds the same traces over a static link
support in O(T·(n+E)) memory, for device counts where (T, n, n) link
arrays do not fit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CostTraces:
    """Time-indexed network characteristics. All arrays are float64.

    c_node (T, n)      per-datapoint processing cost c_i(t)
    c_link (T, n, n)   per-datapoint offload cost c_ij(t)
    f_err  (T, n)      error cost weight f_i(t)
    cap_node (T, n)    node capacity C_i(t) (datapoints per interval)
    cap_link (T, n, n) link capacity C_ij(t)
    """

    c_node: np.ndarray
    c_link: np.ndarray
    f_err: np.ndarray
    cap_node: np.ndarray
    cap_link: np.ndarray

    @property
    def T(self) -> int:
        return self.c_node.shape[0]

    @property
    def n(self) -> int:
        return self.c_node.shape[1]


@dataclasses.dataclass
class EdgeCostTraces:
    """Sparse O(E) cost traces over a static link support (the sparse
    analogue of :class:`CostTraces` for device counts where (T, n, n)
    link arrays are unaffordable).

    c_node (T, n)   per-datapoint processing cost c_i(t)
    f_err  (T, n)   error cost weight f_i(t)
    cap_node (T, n) node capacity C_i(t)
    indptr (n+1,), indices (E,)  CSR of the link support, lex-sorted
                    by (src, dst) — the same ordering
                    ``NetworkSchedule.union_csr`` uses
    c_link (T, E)   per-edge offload cost c_ij(t)
    cap_link (T, E) per-edge capacity C_ij(t)
    """

    c_node: np.ndarray
    f_err: np.ndarray
    cap_node: np.ndarray
    indptr: np.ndarray
    indices: np.ndarray
    c_link: np.ndarray
    cap_link: np.ndarray

    @property
    def T(self) -> int:
        return self.c_node.shape[0]

    @property
    def n(self) -> int:
        return self.c_node.shape[1]

    @property
    def E(self) -> int:
        return self.indices.shape[0]

    @property
    def src(self) -> np.ndarray:
        """Expanded (E,) source array (cached)."""
        s = getattr(self, "_src_cache", None)
        if s is None:
            s = np.repeat(np.arange(self.n, dtype=np.int64),
                          np.diff(self.indptr))
            self._src_cache = s
        return s

    def edge_ids(self, src, dst) -> np.ndarray:
        """Positions of directed edges (src[k], dst[k]) in the support
        (−1 where the edge is not in the support)."""
        keys = getattr(self, "_key_cache", None)
        if keys is None:
            keys = self.src * np.int64(self.n) + self.indices
            self._key_cache = keys
        q = (np.asarray(src, np.int64) * np.int64(self.n)
             + np.asarray(dst, np.int64))
        pos = np.searchsorted(keys, q)
        out = np.full(q.shape, -1, np.int64)
        inb = pos < keys.size
        hit = np.zeros(q.shape, bool)
        hit[inb] = keys[pos[inb]] == q[inb]
        out[hit] = pos[hit]
        return out


def edge_costs_from_dense(traces: CostTraces, src, dst) -> EdgeCostTraces:
    """Gather dense (T, n, n) link costs onto an edge support — the
    small-n bridge that makes sparse-vs-dense solver equivalence exact
    (same float values, same lex edge order)."""
    n = traces.n
    src = np.asarray(src, np.int64).ravel()
    dst = np.asarray(dst, np.int64).ravel()
    keys = np.unique(src * np.int64(n) + dst)
    s, d = keys // n, keys % n
    indptr = np.searchsorted(s, np.arange(n + 1, dtype=np.int64))
    return EdgeCostTraces(
        c_node=traces.c_node, f_err=traces.f_err,
        cap_node=traces.cap_node, indptr=indptr, indices=d,
        c_link=traces.c_link[:, s, d],
        cap_link=traces.cap_link[:, s, d],
    )


def synthetic_edge_costs(n: int, T: int, src, dst,
                         rng: np.random.Generator, *, f_err: float = 0.7,
                         cap: float = np.inf) -> EdgeCostTraces:
    """Sparse analogue of :func:`synthetic_costs`: U(0,1) node costs and
    one U(0,1) cost stream per support edge — O(T·(n+E)) memory."""
    src = np.asarray(src, np.int64).ravel()
    dst = np.asarray(dst, np.int64).ravel()
    keys = np.unique(src * np.int64(n) + dst)
    s, d = keys // n, keys % n
    indptr = np.searchsorted(s, np.arange(n + 1, dtype=np.int64))
    return EdgeCostTraces(
        c_node=rng.random((T, n)),
        f_err=np.full((T, n), f_err),
        cap_node=np.full((T, n), cap),
        indptr=indptr, indices=d,
        c_link=rng.random((T, keys.size)),
        cap_link=np.full((T, keys.size), cap),
    )


def _ar1(rng, T, shape, phi=0.9, sigma=0.1):
    x = np.empty((T, *shape))
    x[0] = rng.random(shape)
    for t in range(1, T):
        x[t] = phi * x[t - 1] + (1 - phi) * rng.random(shape) \
            + sigma * rng.standard_normal(shape)
    return x


def _minmax(x):
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo + 1e-12)


def synthetic_costs(n: int, T: int, rng: np.random.Generator, *,
                    f_err: float = 0.7, cap: float = np.inf) -> CostTraces:
    """c_i(t), c_ij(t) ~ U(0,1) (paper §V-A 'synthetic costs')."""
    return CostTraces(
        c_node=rng.random((T, n)),
        c_link=rng.random((T, n, n)),
        f_err=np.full((T, n), f_err),
        cap_node=np.full((T, n), cap),
        cap_link=np.full((T, n, n), cap),
    )


def testbed_like_costs(n: int, T: int, rng: np.random.Generator, *,
                       f_err: float = 0.7, cap: float = np.inf,
                       medium: str = "wifi") -> CostTraces:
    """Correlated compute/link costs emulating the paper's Pi testbed.

    ``medium``: "wifi" links are slower and noisier than "lte".
    """
    quality = rng.random(n)  # latent device quality: 0 = fast, 1 = slow
    c_node = _minmax(0.7 * quality[None, :] + 0.3 * _ar1(rng, T, (n,)))
    link_base = 0.5 * (quality[None, :, None] + quality[None, None, :])
    scale, noise = (1.0, 0.25) if medium == "wifi" else (0.6, 0.12)
    c_link = _minmax(link_base + noise * _ar1(rng, T, (n, n))) * scale
    return CostTraces(
        c_node=c_node,
        c_link=c_link,
        f_err=np.full((T, n), f_err),
        cap_node=np.full((T, n), cap),
        cap_link=np.full((T, n, n), cap),
    )


def with_capacity(traces: CostTraces, cap_node: float,
                  cap_link: float | None = None) -> CostTraces:
    return dataclasses.replace(
        traces,
        cap_node=np.full_like(traces.cap_node, cap_node),
        cap_link=np.full_like(traces.cap_link,
                              cap_link if cap_link is not None else cap_node),
    )


def ici_costs(n: int, T: int, *, bytes_per_point: float,
              link_bw: float = 50e9, chip_flops: float = 197e12,
              flops_per_point: float = 1e9,
              speed_factors: np.ndarray | None = None,
              f_err: float = 0.7) -> CostTraces:
    """Cost source between the data shards of the model zoo's training:
    seconds per data point to move (``bytes_per_point / link_bw``) and
    to process (``flops_per_point / (chip_flops · speed_factor)``).

    ``link_bw`` and ``chip_flops`` are the reference's cost-model
    constants (its ICI link and its chip's peak), kept so that the plans
    and routes equal the reference's; they are not this card's rates.
    ``speed_factors`` (n,) model heterogeneous throughput (co-tenancy,
    throttling, stragglers — Theorem 2's regime)."""
    sf = np.ones(n) if speed_factors is None else np.asarray(speed_factors)
    c_node = np.tile(flops_per_point / (chip_flops * sf), (T, 1))
    c_link = np.full((T, n, n), bytes_per_point / link_bw)
    return CostTraces(
        c_node=c_node, c_link=c_link,
        f_err=np.full((T, n), f_err),
        cap_node=np.full((T, n), np.inf),
        cap_link=np.full((T, n, n), np.inf),
    )


def effective_link_costs(traces: CostTraces, f_shift: bool = False
                         ) -> np.ndarray:
    """Paper §IV-A2: with the linear error model, redefining
    c_ij(t) <- c_ij(t) + f_i(t) - f_j(t+1) folds the offload terms of the
    error cost into the transmission cost."""
    if not f_shift:
        return traces.c_link
    f = traces.f_err
    f_next = np.concatenate([f[1:], f[-1:]], axis=0)
    return traces.c_link + f[:, :, None] - f_next[:, None, :]
