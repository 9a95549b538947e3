"""The port's collectives, counted.

The sharded fog engine's eq. (4) and the FedAvg round average across
ranks with an all-reduce over a mesh dim's process group, all of a
round's leaves in one flat buffer (:func:`all_reduce_flat`). Each call of
:func:`all_reduce_sum` adds one to ``all_reduces``, as each kernel
wrapper counts its launches, so a run can show how many it issued.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

all_reduces = 0


def reset_counts() -> None:
    global all_reduces
    all_reduces = 0


def all_reduce_sum(tensor, group):
    """Sum ``tensor`` over ``group``'s ranks, in place; returns it. On a
    group of one rank the values are left as they are."""
    global all_reduces
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    all_reduces += 1
    return tensor


def all_reduce_flat(tensors, group) -> list:
    """Sum tensors of one dtype over ``group``'s ranks with one
    all-reduce of their concatenation; returns the sums, each shaped as
    its input."""
    if len({t.dtype for t in tensors}) > 1:
        raise TypeError("one flat all-reduce needs one dtype, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]),
                          group)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]
