"""Segment reductions ``out[s] = sum/max of data[ids == s]``, and the
row-segment sum ``out[g] = Σ_{i: ids[i] = g} data[i] · scale[i]`` over
(m, P) rows.

Ids need not be sorted. A segment that no element names gives the
identity (0 for sum, −inf for max), and an element whose id lies
outside ``[0, num_segments)`` adds the identity, as in
``jax.ops.segment_sum`` / ``segment_max``. ``E = 0`` and
``num_segments = 0`` both work.

On a CUDA tensor :func:`segment_sum`, :func:`segment_max` and
:func:`segment_sum_rows` launch the hand-written kernels in
``csrc/segment_reduce.cu`` (they replace the Pallas TPU kernel of
:mod:`repro.kernels.segment_reduce`; the source says what bounds them
and how). Each walks a CSR layout of the ids (:func:`segment_layout`):
exact integer work done with a stable sort, which a caller that
reduces many times over the same ids builds once and passes in. Every
floating-point operation happens in the kernel, each segment's
elements (rows) in ascending order from +0, one correctly rounded add
each (and, in the row form, one correctly rounded product before it),
so a sum is bitwise repeatable and bitwise a sequential float32 sum.
The row form over ``m`` member ids is therefore bitwise the product
``data · scale[:, None]`` summed by :func:`segment_sum` over the ids
``g · P + p``, without either the product or those ids.

On a CPU tensor they run :func:`segment_sum_plain`,
:func:`segment_max_plain` and :func:`segment_sum_rows_plain`, which the
card also uses as the kernels' yardstick. The CPU's ``index_add_``
adds in element (row) order, so the plain sums keep the same order on
the CPU; on the card it adds by atomics, in no fixed order.

``launches`` counts kernel launches (never plain-version calls), so a
run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0

# the kernels index elements, segments and rows with int32 and read a
# few thousand past a walk's end in their loop bounds
_INDEX_LIMIT = 2 ** 31 - 2 ** 16


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


def segment_sum_rows_plain(data, ids, num_segments: int, *, scale=None):
    """Plain PyTorch version of :func:`segment_sum_rows`: the product
    ``data · scale[:, None]``, then ``index_add_`` of the valid rows
    into zeros."""
    prod = data if scale is None else data * scale[:, None]
    valid = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    return out.index_add_(0, ids[valid].long(), prod[valid])


def _check_ids(ids, num_segments):
    if ids.dim() != 1:
        raise ValueError(f"ids must be 1-D; got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be torch.int32; got {ids.dtype}")
    if num_segments < 0:
        raise ValueError(f"num_segments={num_segments} must be >= 0")
    if ids.shape[0] >= _INDEX_LIMIT or num_segments >= _INDEX_LIMIT:
        raise ValueError("the kernel indexes elements and segments with "
                         "int32: E and num_segments must stay below "
                         f"{_INDEX_LIMIT}")


def _check_tensor(name, a, device, dtype=torch.float32):
    if a.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {a.dtype}")
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, data on {device}")
    if device.type == "cuda" and not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_layout(layout, num_segments, num_elements, device):
    if layout is None:
        return
    if (layout.num_segments, layout.num_elements) != \
            (num_segments, num_elements):
        raise ValueError(
            f"layout is for (S={layout.num_segments}, "
            f"E={layout.num_elements}); the call is (S={num_segments}, "
            f"E={num_elements})")
    if layout.perm.device != device:
        raise ValueError(f"layout is on {layout.perm.device}, data on "
                         f"{device}")


def _check(data, ids, num_segments, layout):
    _check_ids(ids, num_segments)
    if data.dim() != 1 or data.shape != ids.shape:
        raise ValueError(f"data must be 1-D and match ids; got "
                         f"{tuple(data.shape)} and {tuple(ids.shape)}")
    _check_tensor("data", data, data.device)
    _check_tensor("ids", ids, data.device, torch.int32)
    _check_layout(layout, num_segments, data.shape[0], data.device)


def _check_rows(data, ids, num_segments, scale, layout):
    _check_ids(ids, num_segments)
    if data.dim() != 2 or data.shape[0] != ids.shape[0]:
        raise ValueError(f"data must be (m, P) with m = len(ids); got "
                         f"{tuple(data.shape)} and {tuple(ids.shape)}")
    if data.shape[1] >= _INDEX_LIMIT:
        raise ValueError(f"P = {data.shape[1]} must stay below "
                         f"{_INDEX_LIMIT}")
    _check_tensor("data", data, data.device)
    _check_tensor("ids", ids, data.device, torch.int32)
    if scale is not None:
        if scale.shape != ids.shape:
            raise ValueError(f"scale must be (m,) = {tuple(ids.shape)}; "
                             f"got {tuple(scale.shape)}")
        _check_tensor("scale", scale, data.device)
    _check_layout(layout, num_segments, data.shape[0], data.device)


# each C entry point's arguments between the data pointer and the stream
_ARGTYPES = {
    "segment_sum_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int],
    "segment_max_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int],
    "segment_sum_rows_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                        ctypes.c_longlong],
}


def _launch(name, data, *args):
    """Call C entry point ``name`` on ``data``'s device and stream;
    count the launch, or raise on its CUDA error."""
    global launches
    fn = getattr(_build.load("segment_reduce"), name)
    fn.argtypes = [ctypes.c_void_p, *_ARGTYPES[name], ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(data.device):
        err = fn(data.data_ptr(), *args,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    launches += 1


def _on_card(data):
    """True on a CUDA tensor, False on a CPU one; raises elsewhere."""
    if data.device.type == "cpu":
        return False
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    return True


def _reduce(op, data, ids, num_segments, layout):
    _check(data, ids, num_segments, layout)
    if not _on_card(data):
        plain = segment_sum_plain if op == "sum" else segment_max_plain
        return plain(data, ids, num_segments)
    out = torch.empty(num_segments, dtype=torch.float32, device=data.device)
    if num_segments == 0:               # nothing to compute, nothing to launch
        return out
    if layout is None:
        layout = segment_layout(ids, num_segments)
    _launch(f"segment_{op}_launch", data, layout.perm.data_ptr(),
            layout.offsets.data_ptr(), out.data_ptr(), num_segments)
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


def segment_sum_rows(data, ids, num_segments: int, *, scale=None,
                     layout=None):
    """``out[g, p] = Σ_{i: ids[i] = g, ascending i} data[i, p] ·
    scale[i]``: data (m, P) float32, ids (m,) int32 mapping row to
    group, scale (m,) float32 or None (no product), out (num_segments,
    P) float32. The row kernel on CUDA tensors (one launch; ``layout``
    is :func:`segment_layout` of the same ids: G + 1 offsets and the m
    rows), the plain version on CPU tensors."""
    _check_rows(data, ids, num_segments, scale, layout)
    if not _on_card(data):
        return segment_sum_rows_plain(data, ids, num_segments, scale=scale)
    m, P = data.shape
    out = torch.empty((num_segments, P), dtype=torch.float32,
                      device=data.device)
    if num_segments == 0 or P == 0:     # nothing to compute, nothing to launch
        return out
    if layout is None:
        layout = segment_layout(ids, num_segments)
    _launch("segment_sum_rows_launch", data,
            None if scale is None else scale.data_ptr(),
            layout.perm.data_ptr(), layout.offsets.data_ptr(),
            out.data_ptr(), num_segments, P)
    return out
