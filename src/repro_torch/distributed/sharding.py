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

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

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
# the tensor-parallel mesh axis
MODEL_AXIS = "model"


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


def pin(t):
    """A DTensor ``t`` passed through a redistribution to its own
    placements: nothing happens forward, and backward its gradient is
    brought to those placements, where DTensor would otherwise leave it
    sharded unevenly on a dim that the next view merges. A plain tensor
    as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def lead_shards(mesh, n: int, rules=None) -> list:
    """Placements that shard a leading dim of size ``n`` over the mesh's
    batch axes, each kept in mesh order (pod before data) while the
    extents' product divides ``n`` and replicated otherwise; every other
    mesh dim replicates."""
    batch = set((rules or DEFAULT_RULES)["batch"])
    place, ext = [], 1
    for name, size in zip(mesh.mesh_dim_names, tuple(mesh.shape)):
        if name in batch and n % (ext * size) == 0:
            ext *= size
            place.append(Shard(0))
        else:
            place.append(Replicate())
    return place


def _seq_axis(x):
    """The index of the model axis where :func:`seq_shards` shards the
    sequence of a (B, S, ...) DTensor x, or None."""
    names = x.device_mesh.mesh_dim_names
    if MODEL_AXIS not in names:
        return None
    i = names.index(MODEL_AXIS)
    return i if x.shape[1] >= x.device_mesh.shape[i] else None


def seq_shards(x):
    """The residual stream (B, S, D) on its batch shards
    (:func:`lead_shards`) with ``Shard(1)`` on the model axis, every other
    mesh dim replicated, and pinned (:func:`pin`), so that the gradient
    comes back at these placements too. DTensor's own choice at a block
    boundary differs between torch versions (the sequence shards, the
    stream whole on the model axis, or ``Partial`` after a row-parallel
    product). Where S does not divide the model extent (whisper's 1500
    frames) the sequence is sharded unevenly: replicated there, the
    stream would have every model rank compute the replicated K/V
    projections of all frames. Where S is shorter than that extent, it
    is replicated. A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    place = lead_shards(x.device_mesh, x.shape[0])
    i = _seq_axis(x)
    if i is not None:
        place[i] = Shard(1)
    if list(x.placements) != place:
        x = x.redistribute(x.device_mesh, place)
    return pin(x)


def stream_product(x, w):
    """``x @ w`` of a (B, S, K) activation of the stream and a (K, F)
    weight, on DTensors whose sequence :func:`seq_shards` shards, as the
    local products of sequence parallelism, mesh dim by mesh dim: where
    w shards its columns (column-parallel) x's sequence is gathered and
    the output is sharded by columns; where w shards its rows
    (row-parallel) x is sharded on K and the output is ``Partial``;
    where w is replicated (the K/V and the SSM's B/C projections) the
    product runs on x's own batch and sequence shards. The gradients
    come back as the matching partial sums; a gathered sequence is
    gathered again in the backward rather than kept, and a row-parallel
    product's gradient is gathered only once its block is recomputed
    (:class:`_Recompute`). Torch 2.11's
    DTensor cannot flatten a sequence-sharded x (or the gradient of a
    row-parallel product, which the next :func:`seq_shards` shards) into
    a product's rows, and its plan for such a product differs from
    2.13's; this one is the same on both.

    Where the sequence is shorter than the model axis (a decode step's
    one token, which :func:`seq_shards` keeps whole there) the same local
    products run on x's own batch shards, with no sequence to gather:
    column-parallel, x's whole local rows times w's local columns, the
    output ``Shard(2)``; row-parallel, x's local columns times w's local
    rows, the partial sum all-reduced at once to x's batch shards, whole
    on the model axis (as :func:`rows_product`); a replicated w, x's
    local rows times the whole weight. A plain tensor as ``x @ w``."""
    if not isinstance(x, DTensor):
        return x @ w
    mesh = x.device_mesh
    x_place, x_grad, w_place, w_grad, out_place = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if isinstance(pw, Shard) and pw.dim == 1:       # column-parallel
            x_place.append(Replicate())
            x_grad.append(Partial())
            out_place.append(Shard(2))
        elif isinstance(pw, Shard):                     # row-parallel
            x_place.append(Shard(2))
            x_grad.append(Shard(2))
            out_place.append(Partial())
        else:
            keep = (px if isinstance(px, Shard) and px.dim < 2
                    else Replicate())
            x_place.append(keep)
            x_grad.append(keep)
            out_place.append(keep)
        w_place.append(pw if isinstance(pw, Shard) else Replicate())
        w_grad.append(pw if isinstance(pw, Shard) else Partial()
                      if isinstance(x_place[-1], Shard) else Replicate())
    (B, S, _), F = x.shape, w.shape[1]
    if _seq_axis(x) is None:
        out = DTensor.from_local(
            x.redistribute(mesh, x_place).to_local(grad_placements=x_grad)
            @ w.redistribute(mesh, w_place).to_local(grad_placements=w_grad),
            mesh, out_place, run_check=False, shape=(B, S, F),
            stride=(S * F, F, 1))
        return out.redistribute(mesh, [Replicate() if isinstance(
            p, Partial) else p for p in out_place])
    row = any(isinstance(p, Partial) for p in out_place)

    def product(x, w):
        wl = w.redistribute(mesh, w_place).to_local(grad_placements=w_grad)
        if row:
            wl = _Anchor.apply(wl)
        out = DTensor.from_local(
            x.redistribute(mesh, x_place).to_local(grad_placements=x_grad)
            @ wl, mesh, out_place, run_check=False, shape=(B, S, F),
            stride=(S * F, F, 1))
        return _Recompute.apply(out, wl.grad_fn) if row else out
    if not any(isinstance(g, Partial) for g in x_grad):
        return product(x, w)
    return checkpoint(product, x, w, use_reentrant=False)


class _Anchor(torch.autograd.Function):
    """The identity on a product's weight, saving it before the product
    runs (see :class:`_Recompute`)."""

    @staticmethod
    def forward(ctx, w):
        ctx.save_for_backward(w)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Recompute(torch.autograd.Function):
    """The identity on a row-parallel product's output, whose backward
    first unpacks the weight its :class:`_Anchor` saved. In a recomputed
    block (``cfg.remat``) the block's forward then runs again before
    the output's gradient is gathered for the product's backward, and
    not while that gathered gradient waits; the recompute stops at the
    product, which it does not run again."""

    @staticmethod
    def forward(ctx, t, anchor):
        ctx.anchor = anchor
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if ctx.anchor is not None:
            ctx.anchor.saved_tensors
        return grad, None


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
    batch = _batch_placements(logits)
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


def local_range(t, dim, place=None) -> tuple[int, int]:
    """(global offset, length) of the local slice of dim ``dim`` of a
    DTensor t at placements ``place`` (t's own by default)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, place or t.placements)
    return offset[dim], shape[dim]


def _batch_placements(t) -> list:
    """t's placements with every mesh dim but those that shard its dim 0
    replicated."""
    return [p if isinstance(p, Shard) and p.dim % t.dim() == 0
            else Replicate() for p in t.placements]


def rows_of(t, like):
    """The local tensor of a (B, ...) DTensor t on ``like``'s batch
    shards, whole on every other mesh dim: a gather of what those shard
    (a decode step's q heads, one token's worth)."""
    return t.redistribute(t.device_mesh, _batch_placements(like)).to_local()


def layer_view(t, i: int):
    """``t[i]``, the i-th layer of a stacked tensor (a decode cache)
    whose leading dim no mesh dim shards. Of a DTensor, a DTensor on t's
    mesh whose local tensor is the view ``t.to_local()[i]``, so that a
    write into its local tensor lands in t's local storage."""
    if not isinstance(t, DTensor):
        return t[i]
    if any(isinstance(p, Shard) and p.dim % t.dim() == 0
           for p in t.placements):
        raise ValueError(f"layer_view: the layers of {t.placements} are "
                         f"sharded")
    place = [Shard(p.dim % t.dim() - 1) if isinstance(p, Shard) else p
             for p in t.placements]
    return DTensor.from_local(t.to_local()[i], t.device_mesh, place,
                              run_check=False, shape=t.shape[1:],
                              stride=t.stride()[1:])


def write_slot(t, dim, i: int, value) -> None:
    """``t[..., i, ...] = value`` at index i of dim ``dim``, in place, on
    a DTensor t (a decode cache): only the rank whose local slice of that
    dim holds i writes, at i less the slice's offset, into its local
    tensor; every rank writes where the dim is whole. ``value`` is a
    number or the rank's local part of the written slice."""
    lo, n = local_range(t, dim)
    if lo <= i < lo + n:
        t.to_local()[(slice(None),) * dim + (i - lo,)] = value


def shard_reduce(t, dim):
    """``reduce(x, op)``, the all-reduce (op ``"max"`` or ``"sum"``) of a
    local tensor x over the mesh dims that shard dim ``dim`` of the
    DTensor t, or None where no mesh dim does."""
    from torch.distributed import _functional_collectives as funcol

    mesh = t.device_mesh
    dims = [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim % t.dim() == dim]
    if not dims:
        return None

    def reduce(x, op):
        for i in dims:
            x = funcol.all_reduce(x, op, (mesh, i))
            if isinstance(x, funcol.AsyncCollectiveTensor):
                x = x.wait()
        return x
    return reduce


def rows_product(a, w, rows_like, local: bool = False):
    """``a @ w[:K]`` of a local activation a (B_l, S, K), on
    ``rows_like``'s batch shards and whole on every other mesh dim, and
    a DTensor weight w (K_pad, F) whose rows (the heads) the model axis
    may shard: each rank multiplies the columns of a that its rows of w
    cover, rows past K (padded heads) left out, and the products are a
    partial sum over the mesh dims that shard w's rows. With ``local``,
    a holds only those columns (the SSM decode's inner width on its
    head shards). The (B, S, F) result is all-reduced over those mesh
    dims and left on ``rows_like``'s batch shards, whole on every other
    mesh dim: neither a nor w is gathered."""
    mesh = w.device_mesh
    place = [p if isinstance(p, Shard) and p.dim % 2 == 0 else Replicate()
             for p in w.placements]
    wl = w.redistribute(mesh, place).to_local()
    if local:
        out = a @ wl
    else:
        lo, n = local_range(w, 0, place)
        hi = min(lo + n, a.shape[-1])
        out = a[..., lo:hi] @ wl[:max(hi - lo, 0)]
    batch = _batch_placements(rows_like)
    (B, S), F = (rows_like.shape[0], a.shape[1]), w.shape[1]
    return DTensor.from_local(
        out, mesh, [Partial() if isinstance(p, Shard) else b
                    for p, b in zip(place, batch)],
        run_check=False, shape=(B, S, F), stride=(S * F, F, 1)
    ).redistribute(mesh, batch)


def vocab_lookup(tokens, table):
    """``F.embedding(tokens, table)`` of a DTensor table whose rows (the
    vocab) the model axis shards, on the local rows, as the reference's
    lookup on its vocab-sharded table: each rank looks up the ids in its
    [lo, hi) rows and writes zeros for the others, so that the sum over
    the model axis, one nonzero addend an entry, is the lookup. That
    partial sum goes straight to the residual stream's placement on the
    tokens' batch shards: the sequence shards of :func:`seq_shards` (a
    reduce-scatter) where S reaches the model extent, else whole on the
    model axis (an all-reduce, a decode step's one token). The backward
    is the embedding backward of each rank's local ids into its own
    (V / m, D) rows: no rank holds the global table or its gradient.
    ``tokens`` (B, S) is a DTensor or, whole on every rank, a plain
    tensor."""
    mesh = table.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim % 2 == 0 else Replicate()
            for p in table.placements]
    if isinstance(tokens, DTensor):
        batch = _batch_placements(tokens)
        ids = tokens.redistribute(mesh, batch).to_local()
    else:
        batch, ids = [Replicate()] * mesh.ndim, tokens
    # a rank's rows serve only its batch rows: their gradient is a
    # partial sum over the mesh dims that shard the batch
    grad = [r if isinstance(r, Shard) else Partial() if isinstance(b, Shard)
            else Replicate() for r, b in zip(rows, batch)]
    local = table.redistribute(mesh, rows).to_local(grad_placements=grad)
    lo, n = local_range(table, 0, rows)
    mine = (ids >= lo) & (ids < lo + n)     # ids in their own int dtype
    y = torch.nn.functional.embedding(torch.where(mine, ids - lo, 0),
                                      local).masked_fill(~mine[..., None], 0)
    (B, S), D = tokens.shape, table.shape[1]
    x = DTensor.from_local(
        y, mesh, [Partial() if isinstance(r, Shard) else b
                  for r, b in zip(rows, batch)],
        run_check=False, shape=(B, S, D), stride=(S * D, D, 1))
    if _seq_axis(x) is not None:
        return seq_shards(x)
    return x.redistribute(mesh, [Replicate() if isinstance(p, Partial) else p
                                 for p in x.placements])


def on_local_shards(fn, lead, batch_only=(), heads_too=()):
    """``fn`` on each rank's own batch rows and heads, for an op whose
    work is independent across both (attention, the SSD scan): ``lead``
    and ``heads_too`` keep their shardings of dims 0 (batch) and 1
    (heads), ``batch_only`` tensors are sharded like ``lead``'s batch
    and replicated otherwise, everything else is gathered. ``fn`` gets
    the local tensors (lead, *heads_too, *batch_only) and ``lead``'s
    global offset, and returns a local tensor shaped like ``lead``'s
    shard; the result is that DTensor. On the local shards DTensor
    neither flattens (batch, heads) nor moves data inside the op. A
    ``batch_only`` tensor serves every head shard of its rows, so its
    gradient is a partial sum over the mesh dims that shard the heads."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = lead.device_mesh
    keep = [p if isinstance(p, Shard) and p.dim % lead.dim() in (0, 1)
            else Replicate() for p in lead.placements]
    batch = _batch_placements(lead)
    local = [t.redistribute(mesh, keep).to_local()
             for t in (lead, *heads_too)]
    over_heads = [Partial() if k != b else b for k, b in zip(keep, batch)]
    local += [t.redistribute(mesh, batch).to_local(grad_placements=over_heads)
              for t in batch_only]
    _, offset = compute_local_shape_and_global_offset(lead.shape, mesh, keep)
    out = fn(*local, offset)
    return DTensor.from_local(out, mesh, keep, run_check=False,
                              shape=lead.shape, stride=lead.stride())
