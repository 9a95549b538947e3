"""Segment reductions ``out[s] = sum/max of data[ids == s]``.

Ids need not be sorted. A segment that no element names gives the
identity (0 for sum, −inf for max), and an element whose id lies
outside ``[0, num_segments)`` adds the identity, as in
``jax.ops.segment_sum`` / ``segment_max``. ``E = 0`` and
``num_segments = 0`` both work.

On a CUDA tensor :func:`segment_sum` and :func:`segment_max` launch the
hand-written kernel in ``csrc/segment_reduce.cu`` (it replaces the
Pallas TPU kernel of :mod:`repro.kernels.segment_reduce`; the source
says what bounds it and how). The kernel walks a CSR layout of the ids
(:func:`segment_layout`): exact integer work done with a stable sort,
which a caller that reduces many times over the same ids builds once
and passes in. Every floating-point operation happens in the kernel,
one segment per thread in ascending element order, so its sum is
bitwise repeatable and bitwise equal to a sequential float32 sum.

On a CPU tensor they run :func:`segment_sum_plain` /
:func:`segment_max_plain`, which the card also uses as the kernel's
yardstick. The CPU's ``index_add_`` adds in element order too, so the
plain sum keeps the same order on the CPU.

``launches`` counts kernel launches (never plain-version calls), so a
run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0

_INT32_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    global launches
    launches = 0


class SegmentLayout(NamedTuple):
    """CSR layout of a segment-id vector: segment s owns the element
    indices ``perm[offsets[s]:offsets[s + 1]]``, ascending. Elements
    with an id outside ``[0, num_segments)`` sit past ``offsets[-1]``
    and are never read."""
    offsets: torch.Tensor        # (num_segments + 1,) int32
    perm: torch.Tensor           # (num_elements,) int32
    num_segments: int
    num_elements: int


def segment_layout(ids: torch.Tensor, num_segments: int) -> SegmentLayout:
    """Build the kernel's layout of ``ids`` on their device: a stable
    sort of the ids (out-of-range ids moved past the last segment), and
    each segment's first place in the sorted ids. Integer work only, so
    it is exact on any device, and nothing in it waits for the host."""
    _check_ids(ids, num_segments)
    S = int(num_segments)
    valid = (ids >= 0) & (ids < S)
    key = torch.where(valid, ids, torch.full_like(ids, S))
    sorted_key, perm = torch.sort(key, stable=True)
    bounds = torch.arange(S + 1, dtype=torch.int32, device=ids.device)
    offsets = torch.searchsorted(sorted_key, bounds, out_int32=True)
    return SegmentLayout(offsets, perm.to(torch.int32), S,
                         int(ids.shape[0]))


def segment_sum_plain(data, ids, num_segments: int):
    """Plain PyTorch version: ``index_add_`` of the valid elements into
    zeros."""
    valid = (ids >= 0) & (ids < num_segments)
    out = torch.zeros(num_segments, dtype=torch.float32, device=data.device)
    return out.index_add_(0, ids[valid].long(), data[valid])


def segment_max_plain(data, ids, num_segments: int):
    """Plain PyTorch version: ``scatter_reduce_("amax")`` of the valid
    elements into −inf."""
    valid = (ids >= 0) & (ids < num_segments)
    out = torch.full((num_segments,), float("-inf"), dtype=torch.float32,
                     device=data.device)
    return out.scatter_reduce_(0, ids[valid].long(), data[valid], "amax")


def _check_ids(ids, num_segments):
    if ids.dim() != 1:
        raise ValueError(f"ids must be 1-D; got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be torch.int32; got {ids.dtype}")
    if num_segments < 0:
        raise ValueError(f"num_segments={num_segments} must be >= 0")
    if ids.shape[0] > _INT32_MAX or num_segments >= _INT32_MAX:
        raise ValueError("the kernel indexes elements and segments with "
                         "int32: E and num_segments must stay below 2**31")


def _check(data, ids, num_segments, layout):
    _check_ids(ids, num_segments)
    if data.dim() != 1 or data.shape != ids.shape:
        raise ValueError(f"data must be 1-D and match ids; got "
                         f"{tuple(data.shape)} and {tuple(ids.shape)}")
    if data.dtype != torch.float32:
        raise TypeError(f"data must be torch.float32; got {data.dtype}")
    if ids.device != data.device:
        raise ValueError(f"ids are on {ids.device}, data on {data.device}")
    if data.device.type == "cuda":
        for name, a in (("data", data), ("ids", ids)):
            if not a.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    if layout is not None:
        if (layout.num_segments, layout.num_elements) != \
                (num_segments, data.shape[0]):
            raise ValueError(
                f"layout is for (S={layout.num_segments}, "
                f"E={layout.num_elements}); the call is (S={num_segments}, "
                f"E={data.shape[0]})")
        if layout.perm.device != data.device:
            raise ValueError(f"layout is on {layout.perm.device}, data on "
                             f"{data.device}")


def _reduce(op, data, ids, num_segments, layout):
    global launches
    _check(data, ids, num_segments, layout)
    if data.device.type == "cpu":
        plain = segment_sum_plain if op == "sum" else segment_max_plain
        return plain(data, ids, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    out = torch.empty(num_segments, dtype=torch.float32, device=data.device)
    if num_segments == 0:               # nothing to compute, nothing to launch
        return out
    if layout is None:
        layout = segment_layout(ids, num_segments)
    lib = _build.load("segment_reduce")
    fn = getattr(lib, f"segment_{op}_launch")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(data.data_ptr(), layout.perm.data_ptr(),
                 layout.offsets.data_ptr(), out.data_ptr(), num_segments,
                 stream)
    if err != 0:
        raise RuntimeError(f"segment_{op} kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


def segment_sum(data, ids, num_segments: int, *, layout=None):
    """``out[s] = Σ data[ids == s]``: data (E,) float32, ids (E,) int32,
    out (num_segments,) float32. The kernel on CUDA tensors (one launch;
    ``layout``, from :func:`segment_layout` of the same ids, skips
    building it), the plain version on CPU tensors."""
    return _reduce("sum", data, ids, num_segments, layout)


def segment_max(data, ids, num_segments: int, *, layout=None):
    """``out[s] = max data[ids == s]`` (−inf for an empty segment); the
    same arguments and dispatch as :func:`segment_sum`."""
    return _reduce("max", data, ids, num_segments, layout)
