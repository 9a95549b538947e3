"""Timing a kernel on the card, and the least time the card could take
for the same work.

``time_ms`` is the median of CUDA-event windows, each launch after an L2
flush, the card spinning before the start event so that the window
holds the card's time alone. The bounds are the larger of two times:
the bytes the function must move (each input read once, each output
written once) at the HBM rate, and its operations at the peak rate of
the units that do them (the CUDA cores for float32 compares and adds,
the tensor cores at a third of the TF32 rate for the 3xTF32 products of
attention and the SSD scan).
"""
from __future__ import annotations

import torch

# H100 SXM: HBM bandwidth, float32 rate outside the tensor cores and
# dense TF32 tensor-core rate (NVIDIA data sheet). Float32 accuracy on
# the tensor cores takes three TF32 products (3xTF32), so a third of the
# TF32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32X3_OPS_PER_S = 495e12 / 3

SPIN_CYCLES = 1_000_000     # ~0.5 ms of the card's clock


def flush_buffer(device):
    """The buffer :func:`time_ms` reads: 128 MiB, over twice the L2."""
    return torch.zeros(128 * 1024 ** 2, dtype=torch.uint8, device=device)


def flush(buf) -> None:
    """Evict the L2 cache by reading ``buf`` (larger than the 50 MB L2):
    the lines it leaves are clean, so the timed call pays no write-back
    of the flush's own lines, as it would after a write."""
    buf.amax()


def time_ms(fn, args, buf, reps=30, spin=True) -> float:
    """Median time of one call on the card, each launch after an L2
    flush. With ``spin``, the card spins (``torch.cuda._sleep``) before
    each start event while the host queues the call behind it, so the
    window holds the card's time alone; without it the window also holds
    whatever part of the host's launch latency the card waits for."""
    for _ in range(3):
        fn(*args)
    times = []
    for _ in range(reps):
        flush(buf)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        times.append((e0, e1))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times)
    return ms[len(ms) // 2]


def _bound(t_bytes: float, t_ops: float) -> dict:
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def greedy_bounds(ins) -> dict:
    """Least times of one Theorem-3 call on these inputs, in ms. The
    bound: the bytes it must move (all of adj, c_link at live links
    only, each vector and output once) at the HBM rate, against its
    operations (one add and one compare a live link) on the CUDA cores.
    The sector floor: the same with c_link counted in the 32-B sectors
    that hold a live link, as DRAM moves them (c_link's storage starts
    on a sector boundary); the granule floor: in 64-B granules."""
    c_link, c_next, c_node, f_err, adj = ins
    T, n = c_node.shape
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    live = (adj & ~eye).reshape(-1)
    links = int(live.sum())

    def blocks(floats):         # blocks of c_link that hold a live link
        pad = live.new_zeros((-live.numel()) % floats)
        return int(torch.cat([live, pad]).view(-1, floats).any(1).sum())

    sectors, granules = blocks(8), blocks(16)
    rest = T * n * n + 3 * 4 * T * n + 3 * 4 * T * n
    return {**_bound((rest + 4 * links) / HBM_BYTES_PER_S,
                     2 * links / F32_OPS_PER_S),
            "sector_floor_ms": 1e3 * (rest + 32 * sectors) / HBM_BYTES_PER_S,
            "granule_floor_ms": 1e3 * (rest + 64 * granules)
            / HBM_BYTES_PER_S,
            "live_links": links, "live_sectors": sectors,
            "live_granules": granules}


def tensor_core_bounds(nbytes, ops) -> dict:
    """Least times of a tensor-core kernel whose products are 3xTF32:
    bytes at the HBM rate against flops at the 3xTF32 rate; and, for the
    log lines, the flops on the CUDA cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {**_bound(t_bytes, ops / TF32X3_OPS_PER_S),
            "bound_cuda_cores_ms": 1e3 * max(t_bytes, ops / F32_OPS_PER_S)}


def visible_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the masks leave, counted row by row."""
    i = torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(i, max=Sk - 1) if causal else torch.full_like(i, Sk - 1)
    lo = (torch.clamp(i - window + 1, min=0) if window
          else torch.zeros_like(i))
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def attention_work(B, H, KH, Sq, Sk, hd, causal, window) -> tuple:
    """(bytes, flops) of one attention call: q and the output, K and V
    once; q·k and p·v over the visible pairs, 2 flops a MAC each."""
    pairs = B * H * visible_pairs(Sq, Sk, causal, window)
    return (4 * (2 * B * H * Sq * hd + 2 * B * KH * Sk * hd),
            4 * hd * pairs)


def ssd_work(B, H, S, P, N, chunk) -> tuple:
    """(bytes, flops) of one SSD scan: x·dt, the output, a, B and C
    once; C·Bᵀ once per (batch, chunk) (B and C are shared by the
    heads), then per head the masked product with x, C·Sᵀ and the state
    update over the (i, j ≤ i) pairs of each chunk."""
    l = min(chunk, S)
    tri = l * (l + 1) // 2
    ops = B * (S // l) * (2 * tri * N
                          + H * (2 * tri * P + 2 * l * N * P + 2 * l * P * N))
    return 4 * (2 * B * H * S * P + B * H * S + 2 * B * S * N), ops


def row_sum_bounds(m_in, P, G, scaled) -> dict:
    """Least time of the row-segment sum over ``m_in`` rows in range
    (data, scale and ids read once, the sums written once; a product and
    an add an entry on the CUDA cores), and for the log lines the 1-D
    form's (the product and its E-length ids read, the sums written)
    and the product's own pass (data and scale read, the product
    written)."""
    E = m_in * P
    nbytes = 4 * E + 4 * m_in * (1 + scaled) + 4 * G * P
    return {**_bound(nbytes / HBM_BYTES_PER_S,
                     (1 + scaled) * E / F32_OPS_PER_S),
            "flat_bound_ms": 1e3 * (8 * E + 4 * G * P) / HBM_BYTES_PER_S,
            "product_pass_ms": 1e3 * (8 * E + 4 * m_in) / HBM_BYTES_PER_S}
