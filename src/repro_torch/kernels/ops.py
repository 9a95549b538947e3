"""Public wrappers over the kernels (the port of :mod:`repro.kernels.ops`).

The device of the tensors picks the path: CUDA tensors launch the
hand-written kernel, CPU tensors run its plain PyTorch version. There
is no ``use_pallas`` switch and no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.offload_greedy import offload_greedy_batched


def greedy_decision(c_link, c_next, c_node, f_err, adj):
    """One round of the Theorem-3 rule: c_link (n,n); c_next, c_node,
    f_err (n,); adj (n,n) bool. Returns (choice, best_j, best_cost),
    each (n,)."""
    out = offload_greedy_batched(c_link[None], c_next[None], c_node[None],
                                 f_err[None], adj[None])
    return tuple(a[0] for a in out)


def greedy_decision_batched(c_link, c_next, c_node, f_err, adj):
    """All T rounds of the Theorem-3 rule in one launch: every operand
    carries a leading time axis (c_link (T,n,n); c_next, c_node, f_err
    (T,n); adj (T,n,n))."""
    return offload_greedy_batched(c_link, c_next, c_node, f_err, adj)


def greedy_edges_batched(c_link, c_next, c_node, f_err, adj):
    """Theorem-3 rule for all T rounds with COO edge emission: returns
    fixed-shape (T·n,) ``(t, src, dst, keep)`` int32/bool tensors
    (keep=False marks discard rows) plus the (T, n) choice map, so the
    sparse plan is packed without a dense (T, n, n) share tensor. The
    epilogue is plain torch around the kernel, as it sits outside the
    kernel in the reference."""
    choice, best_j, _ = offload_greedy_batched(c_link, c_next, c_node,
                                               f_err, adj)
    T, n = choice.shape
    dev = choice.device
    t_idx = torch.arange(T, dtype=torch.int32, device=dev) \
        .repeat_interleave(n)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat(T)
    flat = choice.reshape(-1)
    dst = torch.where(flat == 1, best_j.reshape(-1), src)
    return t_idx, src, dst, flat != 2, choice
