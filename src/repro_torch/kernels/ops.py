"""Public wrappers over the kernels (the port of :mod:`repro.kernels.ops`).

The device of the tensors picks the path: CUDA tensors launch the
hand-written kernel, CPU and meta tensors run its plain PyTorch
version. There is no ``use_pallas`` switch and no fallback from one to
the other.

On DTensors (the dry run, ``launch/dryrun.py``) ``attention`` and
``ssd`` run on each rank's own batch rows and heads
(``sharding.on_local_shards``), the tensor-parallel layout: their plain
versions flatten (batch, heads) into one batch of products, which
DTensor refuses while both are sharded (torch 2.11).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import on_local_shards
from repro_torch.kernels import segment_reduce as sr
from repro_torch.kernels.flash_attention import default_kv_map, flash_attention
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
    return greedy_edges_from_choice(choice, best_j)


def greedy_edges_from_choice(choice, best_j):
    """The COO epilogue of :func:`greedy_edges_batched` on the kernel's
    (T, n) ``choice`` and ``best_j``."""
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


def segment_sum_rows(data, segment_ids, *, num_segments, scale=None,
                     layout=None):
    """out[s] = Σ data[segment_ids == s] over (E, ...) ROW data, each
    segment's rows added in ascending order: the ND-payload sibling of
    :func:`segment_sum` (the reference's ``ops.segment_sum_rows``).
    Returns (num_segments, ...) float32. ``scale`` (E,) float32
    multiplies each row first (one product, then one add, per entry:
    eq. (4)'s H-weighted sum in one pass); ``layout`` is
    :func:`repro_torch.kernels.segment_reduce.segment_layout` of the
    same ids. One launch of the row kernel on CUDA tensors."""
    data = data.to(torch.float32)
    E, tail = data.shape[0], data.shape[1:]
    P = int(np.prod(tail, dtype=np.int64))
    out = sr.segment_sum_rows(data.reshape(E, P), segment_ids,
                              num_segments, scale=scale, layout=layout)
    return out.reshape((num_segments,) + tuple(tail))


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
    if not isinstance(q, DTensor):
        return flash_attention(q, k, v, kv_map, causal=causal, window=window)
    if kv_map is None:
        kv_map = default_kv_map(q.shape[1], k.shape[1])

    def local(ql, kl, vl, off):
        # the rank's q heads [off, off + Hl) read their own K/V heads
        km = torch.as_tensor(kv_map)[off[1]:off[1] + ql.shape[1]]
        return flash_attention(ql, kl, vl, km, causal=causal, window=window)

    return on_local_shards(local, q, (k, v))


def ssd(xdt, a, Bm, Cm, *, chunk=128, streaming=False):
    """Mamba2 SSD chunked scan in the reference kernel's layout: xdt
    (B,H,S,P), Bm/Cm (B,S,N) float32 or bfloat16, a (B,H,S) float32 ->
    y (B,H,S,P) float32. ``streaming`` (``cfg.ssm_streaming``) picks the
    reference's chunk-by-chunk scan for the plain version on CPU and
    meta tensors; the kernel serves both on the card."""
    if not isinstance(xdt, DTensor):
        return ssd_scan(xdt, a, Bm, Cm, chunk=chunk, streaming=streaming)
    return on_local_shards(
        lambda xl, al, bl, cl, off: ssd_scan(xl, al, bl, cl, chunk=chunk,
                                             streaming=streaming),
        xdt, (Bm, Cm), heads_too=(a,))


def topk_neighbors(c_link, c_next, adj, *, k=2):
    """Top-k cheapest offload targets per (t, i): masked min-plus over
    out-neighbours of c_link (T,n,n) + c_next (T,n) under adj (T,n,n)
    bool, returned as (costs (T,n,k'), dst (T,n,k')) in ascending cost
    order with k' = min(k, n). Equal costs keep the lower j first (a
    stable sort, as the reference's ``lax.top_k``; ``torch.topk`` does
    not order ties on the card). Rows with fewer than k' live
    neighbours are padded with (inf, -1). Plain PyTorch on the tensors'
    device."""
    T, n = c_next.shape
    kk = min(k, n)
    eye = torch.eye(n, dtype=torch.bool, device=c_next.device)
    eff = torch.where(adj & ~eye[None], c_link + c_next[:, None, :],
                      torch.tensor(float("inf"), device=c_next.device))
    return _stable_topk(eff, None, kk)


def _stable_topk(eff, cols, k):
    """The k smallest of each last-axis row of ``eff``, lowest position
    first among equals; their column (``cols`` gathered at the
    position, or the position itself when ``cols`` is None) where
    finite, -1 elsewhere."""
    cost, pos = torch.sort(eff, dim=-1, stable=True)
    cost, pos = cost[..., :k], pos[..., :k]
    dst = pos if cols is None else torch.gather(cols, -1, pos)
    return cost, torch.where(torch.isfinite(cost), dst,
                             torch.full_like(dst, -1))


def topk_neighbors_csr(c_link_e, c_next, indptr, indices, live, *, k=2):
    """The O(E) form of :func:`topk_neighbors` for edge cost traces:
    ``c_link_e`` (T, E) per-edge costs over the lex-sorted support
    (numpy ``indptr``/``indices``), ``live`` (T, E) bool per-round edge
    liveness; ``c_link_e``, ``c_next`` (T, n) and ``live`` are tensors
    on one device. Returns (costs (T,n,k'), dst (T,n,k')) with k' =
    min(k, max degree), ascending, padded with (inf, -1): the dense
    variant's selection and tie order on the gathered costs (support
    order is dst order). The (n, maxdeg) padded edge-id table is built
    on the host."""
    indptr = np.asarray(indptr)
    deg = np.diff(indptr)
    n = deg.shape[0]
    E = int(indptr[-1])
    maxdeg = max(int(deg.max()) if n else 0, 1)
    pad = np.full((n, maxdeg), -1, np.int64)
    slot = np.arange(maxdeg)[None, :] < deg[:, None]
    pad[slot] = np.arange(E)
    dev = c_link_e.device
    pad = torch.from_numpy(pad).to(dev)
    indices = torch.as_tensor(np.asarray(indices, np.int64)).to(dev)
    safe = pad.clamp(min=0)
    dstp = indices[safe]                              # (n, maxdeg)
    eff = c_link_e[:, safe] + c_next[:, dstp]         # (T, n, maxdeg)
    valid = (pad >= 0)[None] & live[:, safe]
    eff = torch.where(valid, eff, torch.tensor(float("inf"), device=dev))
    T = c_next.shape[0]
    return _stable_topk(eff, dstp[None].expand(T, n, maxdeg),
                        min(k, maxdeg))
