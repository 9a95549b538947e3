"""Logical-axis -> mesh-axis sharding rules (the port of
:mod:`repro.distributed.sharding`).

Every parameter and activation dimension carries a logical axis name
(``models/module.Spec.axes``). A rule table maps logical names to mesh
axes; a tensor's spec is derived dim by dim, with a divisibility guard
that falls back to replication when a dim does not divide the mesh
extent (the production meshes never need it; small smoke meshes do).

A spec is a plain tuple with one entry per tensor dim, as the
reference's ``PartitionSpec``: ``None``, a mesh axis name, or a tuple of
names. :func:`placements` turns it into DTensor placements on a torch
``DeviceMesh``, and a :class:`NamedSharding` holds a spec with its
mesh. The rules read only a mesh's ``mesh_dim_names`` and ``shape``.

The reference's ``shard_map`` shim has no counterpart here: a
manual-SPMD path takes the mesh dim's process group
(``mesh.get_group("data")``) and calls the collectives itself.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

from torch.distributed.tensor import DTensor, Replicate, Shard

# Default logical->mesh rules for the production meshes. "batch" maps to
# ("pod", "data"); on the single-pod mesh "pod" is absent and drops
# out. Fused projection output dims ("heads_fused", "mlp", "experts",
# "ssm_inner", "vocab") carry the tensor-parallel sharding; q-head counts
# are padded to multiples of the model-axis extent at config time.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "embed": (),
    "heads": ("model",),        # padded q heads
    "kv_heads": (),             # kv replicated at train/prefill (small)
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": ("model",),   # mixtral-style: shard within-expert ffn
    "ssm_heads": ("model",),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "conv_dim": ("model",),
    "cache_seq": ("model",),    # decode KV cache: sequence-sharded
    "seq": (),
    "layers": (),
    "groups": (),
    "frames": (),
    "stack": (),                # paper-scale per-fog-device axis
}


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: extent} of a ``DeviceMesh`` (anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _entry(mesh_axes: tuple):
    return mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]


def spec_for_axes(axes, shape, mesh, rules=None) -> tuple:
    """The spec of a tensor from its logical axis names and shape."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    out = []
    for dim, name in zip(shape, axes):
        mesh_axes = () if name is None else tuple(
            a for a in rules.get(name, ()) if a in sizes)
        if not mesh_axes or dim % math.prod(sizes[a]
                                            for a in mesh_axes) != 0:
            out.append(None)      # no rule, or the replication fallback
        else:
            out.append(_entry(mesh_axes))
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_pspecs(axes_tree, shape_tree, mesh, rules=None):
    """Map trees (nested dicts) of logical axes and of shapes (tuples or
    anything with ``.shape``) to a tree of specs."""
    if _is_axes(axes_tree):
        shape = getattr(shape_tree, "shape", shape_tree)
        return spec_for_axes(axes_tree, tuple(shape), mesh, rules)
    return {k: tree_pspecs(v, shape_tree[k], mesh, rules)
            for k, v in axes_tree.items()}


class NamedSharding(NamedTuple):
    """A spec on a mesh: the reference's ``NamedSharding``, with the
    spec's DTensor placements."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def tree_shardings(axes_tree, shape_tree, mesh, rules=None):
    """:func:`tree_pspecs`, each spec a :class:`NamedSharding` on
    ``mesh``."""
    specs = tree_pspecs(axes_tree, shape_tree, mesh, rules)

    def wrap(node):
        if isinstance(node, dict):
            return {k: wrap(v) for k, v in node.items()}
        return NamedSharding(mesh, node)

    return wrap(specs)


def batch_spec(mesh, rules=None) -> tuple:
    """The spec of a (batch, ...) tensor's leading dim: ``()`` when the
    mesh has none of the batch axes."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    axes = tuple(a for a in rules["batch"] if a in sizes)
    return (_entry(axes),) if axes else ()


def data_axis_size(mesh, rules=None) -> int:
    """The product of the mesh's batch-axis extents (1 without any)."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in rules["batch"] if a in sizes)


def placements(spec, mesh) -> tuple:
    """``spec`` as DTensor placements on ``mesh``: a mesh dim that the
    spec names for tensor dim d gets ``Shard(d)``, every other one
    ``Replicate()``. A dim sharded over ("pod", "data") gets ``Shard(d)``
    on both mesh dims, which DTensor splits in mesh-dim order (pod
    major), the layout of the reference's ``PartitionSpec``."""
    where = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            if name in where:
                raise ValueError(f"mesh axis {name!r} shards two dims of "
                                 f"spec {spec}")
            where[name] = d
    unknown = set(where) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} that "
                         f"mesh {mesh.mesh_dim_names} lacks")
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in mesh.mesh_dim_names)


def gather_dims(t, dims):
    """A DTensor ``t`` with every mesh dim that shards one of the tensor
    dims ``dims`` gathered (``Replicate()``), before a reshape that
    splits or merges them: DTensor refuses such a view when the sharded
    dim does not divide evenly into the new ones, where the reference's
    GSPMD reshards by itself. A plain tensor is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    place = [Replicate() if isinstance(p, Shard) and p.dim % t.dim() in dims
             else p for p in t.placements]
    if place == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, place)


def even_shards(t, dims):
    """A DTensor ``t`` with each of the tensor dims ``dims`` sharded only
    as far as it divides: the mesh dims that shard such a dim are kept
    in mesh order while their extents' product divides its size, and
    the others replicated. DTensor may shard a dim unevenly on a mesh
    dim that its inputs replicate (a strategy it picks, not one the
    rules asked for), and then cannot flatten it in a later op. A plain
    tensor is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    sizes = tuple(t.device_mesh.shape)
    place = list(t.placements)
    for d in dims:
        ext = 1
        for i, p in enumerate(place):
            if not (isinstance(p, Shard) and p.dim % t.dim() == d):
                continue
            if t.shape[d] % (ext * sizes[i]):
                place[i] = Replicate()
            else:
                ext *= sizes[i]
    if place == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, place)


def pin(t):
    """A DTensor ``t`` passed through a redistribution to its own
    placements: nothing happens forward, and backward its gradient is
    brought to those placements, where DTensor would otherwise leave it
    sharded unevenly on a dim that the next view merges. A plain tensor
    as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def on_vocab_shards(fn, logits, labels):
    """``fn(logits, labels)``, a per-token value (B, S) of (B, S, V)
    logits, with the logits vocab-sharded on the model axis, as the
    reference's XLA program keeps them into the loss. DTensor's own
    log-softmax rule replicates the reduced dim, which gathers the
    global vocab on every device; under
    ``torch.distributed.tensor.parallel.loss_parallel()`` (entered by
    the caller around forward and backward) the log-softmax and the
    pick run on the vocab shards instead.

    The logits are brought to their batch shards (each mesh dim that
    shards dim 0 kept, the others but the model axis replicated) with
    ``Shard(2)`` on the model axis: a reduce-scatter where they arrive
    ``Partial``, nothing where they are vocab-sharded already. The
    labels get the same batch shards, replicated on the model axis.
    ``fn`` then runs on each rank's batch rows as DTensors on the model
    axis's 1-D submesh, the only mesh that torch 2.11's loss-parallel
    handlers take, and its result is the (B, S) DTensor of those rows.
    Plain tensors: ``fn(logits, labels)``."""
    if not isinstance(logits, DTensor):
        return fn(logits, labels)
    mesh = logits.device_mesh
    (axis,) = DEFAULT_RULES["vocab"]
    model = mesh.mesh_dim_names.index(axis)
    batch = [p if isinstance(p, Shard) and p.dim % logits.dim() == 0
             else Replicate() for p in logits.placements]
    batch[model] = Replicate()
    vocab = [*batch[:model], Shard(2), *batch[model + 1:]]
    x = logits.redistribute(mesh, vocab).to_local()
    y = labels.redistribute(mesh, batch).to_local()
    sub = mesh[axis]
    n, s, v = x.shape[0], x.shape[1], logits.shape[2]
    out = fn(DTensor.from_local(x, sub, [Shard(2)], run_check=False,
                                shape=(n, s, v), stride=(s * v, v, 1)),
             DTensor.from_local(y, sub, [Replicate()], run_check=False))
    B, S = labels.shape
    return DTensor.from_local(out.full_tensor(), mesh, batch,
                              run_check=False, shape=(B, S), stride=(S, 1))


def on_local_shards(fn, lead, batch_only=(), heads_too=()):
    """``fn`` on each rank's own batch rows and heads, for an op whose
    work is independent across both (attention, the SSD scan): ``lead``
    and ``heads_too`` keep their shardings of dims 0 (batch) and 1
    (heads), ``batch_only`` tensors are sharded like ``lead``'s batch
    and replicated otherwise, everything else is gathered. ``fn`` gets
    the local tensors (lead, *heads_too, *batch_only) and ``lead``'s
    global offset, and returns a local tensor shaped like ``lead``'s
    shard; the result is that DTensor. On the local shards DTensor
    neither flattens (batch, heads) nor moves data inside the op."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = lead.device_mesh
    keep = [p if isinstance(p, Shard) and p.dim % lead.dim() in (0, 1)
            else Replicate() for p in lead.placements]
    batch = [p if isinstance(p, Shard) and p.dim % lead.dim() == 0
             else Replicate() for p in lead.placements]
    local = [t.redistribute(mesh, keep).to_local()
             for t in (lead, *heads_too)]
    local += [t.redistribute(mesh, batch).to_local() for t in batch_only]
    _, offset = compute_local_shape_and_global_offset(lead.shape, mesh, keep)
    out = fn(*local, offset)
    return DTensor.from_local(out, mesh, keep, run_check=False,
                              shape=lead.shape, stride=lead.stride())
