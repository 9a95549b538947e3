"""Process group and device meshes (the port of :mod:`repro.launch.mesh`).

JAX sees every device of its host without being asked; torch needs a
process group first. :func:`init_process_group` makes it, and nothing
else in the port does: under ``torchrun`` it joins the launcher's world
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), and without them it makes a world of one on a private
in-process store. The backend is ``nccl`` for a CUDA device and ``gloo``
for the CPU, and never the one in place of the other. The dry run's
fake group (:func:`init_fake_process_group`) is made here too.

The meshes are made by functions, as in the reference, so importing this
module touches no device and no group. Each is built on the default
group the caller made (the dry run's fake one included), or on a new
one from :func:`init_process_group` when there is none, and takes its
extent from that group's world. A mesh narrower than the world is built
over the first ranks; the others are not its members
(``mesh.get_coordinate()`` is None there).
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device=None):
    """The default process group for ``device`` (``cuda`` unless the
    caller asks for ``cpu``): the existing one, or a new one over
    torchrun's world, or a world of one. An existing group of another
    backend (the dry run's fake one too) raises; there is no
    fallback."""
    device = resolve_device(device)
    want = backend_for(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(f"a {have!r} process group exists; device "
                               f"{device} needs {want!r}")
        return dist.group.WORLD
    if all(k in os.environ for k in _TORCHRUN_ENV):
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(want, init_method="env://")
    else:
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.group.WORLD


def world_size() -> int:
    """The default group's size, 1 when there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _group_for(device) -> None:
    """The caller's default group, or a new one for ``device``."""
    if not dist.is_initialized():
        init_process_group(device)


def _mesh(shape: tuple, names: tuple, device):
    device = resolve_device(device)
    _group_for(device)
    if math.prod(shape) > world_size():
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the world has {world_size()}")
    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 (256 ranks) or 2x16x16 (512 ranks, two pods). Axes "data"
    (batch / fog-device axis) and "model" (tensor parallel), with an
    outer "pod" in the multi-pod case (batch sharded over ("pod",
    "data"), see :mod:`repro_torch.distributed.sharding`). The dry run
    builds it on a fake group of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A small (data, model) mesh (tests and demos)."""
    return _mesh((data, model), ("data", "model"), device)


def make_data_mesh(data: int | None = None, device=None):
    """1-D "data" mesh for the device-sharded fog engine, over ``data``
    ranks (default: the whole world). The engine pads the fog-device
    axis up to a multiple of the extent with phantom inactive devices,
    so any n works on any world size."""
    _group_for(device)
    return _mesh((data or world_size(),), ("data",), device)


def tier_mesh_axes(tree, world: int) -> dict:
    """{axis: extent} of :func:`tier_mesh_for`'s mesh for ``tree`` on a
    world of ``world`` ranks: (pod, data) where both extents exceed 1,
    else the 1-D data mesh."""
    pods = max(1, min(world, int(tree.group_counts[0])))
    data = max(1, min(world // pods, int(tree.widest_bucket)))
    if pods == 1 or data == 1:
        return {"data": max(1, min(world, int(tree.n)))}
    return {"pod": pods, "data": data}


def tier_mesh_for(tree, device=None):
    """2-D (pod, data) mesh for a :class:`repro_torch.core.hierarchy.
    TierTree`: "pod" spans tier-1 gateways and "data" devices within a
    gateway. The "pod" extent never exceeds the gateway count and the
    "data" extent never exceeds the widest tier-1 bucket. Falls back to
    the 1-D "data" mesh whenever either axis would have extent 1."""
    _group_for(device)
    axes = tier_mesh_axes(tree, world_size())
    return _mesh(tuple(axes.values()), tuple(axes), device)


def data_mesh_for(n: int, device=None):
    """1-D "data" mesh sized for a bucket of n fog devices: never wider
    than n, so padding the device axis up to a multiple of the extent
    makes no rank hold phantoms only."""
    _group_for(device)
    return make_data_mesh(max(1, min(world_size(), int(n))), device)


def init_fake_process_group(world: int) -> None:
    """A fake default group of ``world`` ranks in this one process
    (torch's ``FakeStore``, backend ``"fake"``): collectives return at
    once without moving data. The dry run's counterpart of the
    reference's ``--xla_force_host_platform_device_count=512``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already; the fake "
                           "group needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
