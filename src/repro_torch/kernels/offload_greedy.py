"""Theorem-3 offload decision rule for all T rounds at once.

For every round t and device i, the masked min-plus reduction
    k_i = argmin_{j : adj[t,i,j], j≠i} ( c_link[t,i,j] + c_next[t,j] ),
lowest j on equal cost, followed by the 3-way marginal-cost choice
{process, offload, discard} with ties resolved process < offload <
discard.

On a CUDA tensor :func:`offload_greedy_batched` launches the
hand-written kernel in ``csrc/offload_greedy.cu`` (it replaces the
Pallas TPU kernel of :mod:`repro.kernels.offload_greedy`; the source
says what bounds it and how: one warp a row, adjacency read as 16-byte
vectors, c_link as float4 only where a 4-column word holds a live link,
c_next staged once per block and round, a persistent grid sized by the
kernel itself; a view whose c_link and adjacency bases disagree mod 16
bytes is copied first, :func:`vector_aligned`). On a CPU tensor it runs
:func:`offload_greedy_plain`, the plain PyTorch version of
``repro.kernels.ref.offload_greedy_ref`` batched over T, which the card
also uses as the kernel's yardstick: both add in float32 with one
correctly rounded add per entry and take an order-free min, so they
agree bit for bit.

``launches`` counts kernel launches (never plain-version calls), so a
run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def offload_greedy_plain(c_link, c_next, c_node, f_err, adj):
    """Plain PyTorch version. c_link (T,n,n); c_next, c_node, f_err
    (T,n); adj (T,n,n) bool. Returns (choice (T,n) int32 — 0 process /
    1 offload / 2 discard, best_j (T,n) int32, best_cost (T,n) f32)."""
    n = c_node.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=c_link.device)
    eff = torch.where(adj & ~eye, c_link + c_next[:, None, :],
                      torch.tensor(float("inf"), device=c_link.device))
    best_j = eff.argmin(dim=2)                  # first index on ties
    off = eff.gather(2, best_j[..., None])[..., 0]
    stacked = torch.stack([c_node, off, f_err])
    choice = stacked.argmin(dim=0)              # process < offload < discard
    return (choice.to(torch.int32), best_j.to(torch.int32),
            stacked.amin(dim=0))


def _check(c_link, c_next, c_node, f_err, adj):
    if c_link.dim() != 3 or c_link.shape[1] != c_link.shape[2]:
        raise ValueError(f"c_link must be (T, n, n); got "
                         f"{tuple(c_link.shape)}")
    T, n = c_link.shape[:2]
    for name, a, shape, dtype in (
            ("c_link", c_link, (T, n, n), torch.float32),
            ("c_next", c_next, (T, n), torch.float32),
            ("c_node", c_node, (T, n), torch.float32),
            ("f_err", f_err, (T, n), torch.float32),
            ("adj", adj, (T, n, n), torch.bool)):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got "
                             f"{tuple(a.shape)}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}; got {a.dtype}")
        if a.device != c_link.device:
            raise ValueError(f"{name} is on {a.device}, c_link on "
                             f"{c_link.device}")
        if a.device.type == "cuda" and not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return T, n


def vector_aligned(c_link, adj):
    """``c_link`` and ``adj``, each copied afresh where needed so that
    ``c_link``'s base minus four times ``adj``'s is a multiple of 16
    bytes: the kernel reads a run's c_link as ``float4`` wherever it
    reads its adjacency as a 16-byte vector. Any two fresh allocations
    agree; only a view into other storage can disagree, and then each of
    the two that is not itself 16-byte aligned is copied."""
    if (c_link.data_ptr() - 4 * adj.data_ptr()) % 16 == 0:
        return c_link, adj
    return tuple(a if a.data_ptr() % 16 == 0 else a.clone()
                 for a in (c_link, adj))


def offload_greedy_batched(c_link, c_next, c_node, f_err, adj):
    """All-rounds Theorem-3 rule: the kernel on CUDA tensors (one launch
    for the whole horizon), the plain version on CPU tensors. Same
    arguments and results as :func:`offload_greedy_plain`."""
    global launches
    T, n = _check(c_link, c_next, c_node, f_err, adj)
    if c_link.device.type == "cpu":
        return offload_greedy_plain(c_link, c_next, c_node, f_err, adj)
    if c_link.device.type != "cuda":
        raise ValueError(f"no kernel for device {c_link.device}")
    c_link, adj = vector_aligned(c_link, adj)
    lib = _build.load("offload_greedy")
    fn = lib.offload_greedy_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    opts = dict(device=c_link.device)
    choice = torch.empty((T, n), dtype=torch.int32, **opts)
    best_j = torch.empty((T, n), dtype=torch.int32, **opts)
    best_cost = torch.empty((T, n), dtype=torch.float32, **opts)
    with torch.cuda.device(c_link.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(c_link.data_ptr(), c_next.data_ptr(), c_node.data_ptr(),
                 f_err.data_ptr(), adj.data_ptr(), choice.data_ptr(),
                 best_j.data_ptr(), best_cost.data_ptr(), T, n, stream)
    if err != 0:
        raise RuntimeError(f"offload_greedy kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return choice, best_j, best_cost
