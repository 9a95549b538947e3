"""Public wrappers over the kernels (the port of :mod:`repro.kernels.ops`).

The device of the tensors picks the path: CUDA tensors launch the
hand-written kernel, CPU tensors run its plain PyTorch version. There
is no ``use_pallas`` switch and no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import segment_reduce as sr
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.offload_greedy import offload_greedy_batched
from repro_torch.kernels.ssd_scan import ssd_scan


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


def segment_sum(data, segment_ids, *, num_segments, layout=None):
    """out[s] = Σ data[segment_ids == s] over (E,) float32 data and
    int32 ids; 0 for an empty segment, out-of-range ids add nothing.
    ``layout`` — :func:`repro_torch.kernels.segment_reduce.
    segment_layout` of the same ids, for callers that reduce over them
    again and again."""
    return sr.segment_sum(data, segment_ids, num_segments, layout=layout)


def segment_max(data, segment_ids, *, num_segments, layout=None):
    """out[s] = max data[segment_ids == s] (−inf for an empty
    segment)."""
    return sr.segment_max(data, segment_ids, num_segments, layout=layout)


def attention(q, k, v, *, causal=True, window=None, kv_map=None):
    """Flash attention forward in the reference kernel's layout: q
    (B,H,Sq,hd), k/v (B,KH,Sk,hd) float32 or bfloat16 -> (B,H,Sq,hd) of
    q's type. ``kv_map``
    (H,) int32 maps q heads to K/V heads; ``None`` gives ``h // (H //
    KH)``, the Pallas kernel's map."""
    return flash_attention(q, k, v, kv_map, causal=causal, window=window)


def ssd(xdt, a, Bm, Cm, *, chunk=128):
    """Mamba2 SSD chunked scan in the reference kernel's layout: xdt
    (B,H,S,P), Bm/Cm (B,S,N) float32 or bfloat16, a (B,H,S) float32 ->
    y (B,H,S,P) float32."""
    return ssd_scan(xdt, a, Bm, Cm, chunk=chunk)
