"""Steps and their input specs (the port of :mod:`repro.launch.steps`):
the train step, the prefill and decode steps, the movement plan's batch
routing, the per-shape config, and the shardings of every step input.

A train batch is ``{tokens, labels, weights, route}``: ``route`` (B,)
re-indexes the global batch (sample offloading between data shards),
``weights`` (B,) carries per-sample processing weights (0 = discarded),
and the loss normalises by Σ weights, as the paper's H_i-weighted
aggregation (eqs. (1)/(4)) does.

``input_specs(cfg, shape)`` gives the step's inputs as meta tensors
(shapes and dtypes, no storage), in the dtypes the port runs:

* train:   {tokens, labels, weights, route}  (+ frames / patch_embeds)
* prefill: {tokens}                          (+ frames / patch_embeds)
* decode:  {cache, batch: {tokens}, pos}

and ``batch_shardings``, ``param_shardings``, ``cache_shardings``,
``opt_state_shardings`` and ``accum_shardings`` give the reference's
trees with a :class:`repro_torch.distributed.sharding.NamedSharding`
(spec and DTensor placements) where it has a ``NamedSharding``. The dry
run (``launch/dryrun.py``) distributes meta tensors by them.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.parallel import loss_parallel

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as T
from repro_torch.models.module import abstract_params, logical_axes
from repro_torch.optim import optimizers as opt_lib

def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """The reference's per-shape overrides: full remat for training, a
    position table as long as the shape's sequence, and long_500k as
    the 4096-token sliding-window variant for full-attention archs."""
    kw = {}
    if shape.kind == "train":
        kw["remat"] = "full"
    if cfg.pos_embed == "learned" and shape.seq_len > cfg.max_positions:
        kw["max_positions"] = (shape.seq_len if shape.kind != "decode"
                               else cfg.max_positions)
    if (shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid")
            and not cfg.sliding_window):
        kw["sliding_window"] = 4096
    return cfg.with_overrides(**kw) if kw else cfg


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape, dtype=torch.float32):
    """The step inputs of ``shape`` as meta tensors (see the module
    docstring); the decode cache from ``T.init_cache_specs``."""
    B, S = shape.global_batch, shape.seq_len
    cfg = config_for_shape(cfg, shape)
    if shape.kind in ("train", "prefill"):
        S_text = S - (cfg.vision_patches or 0)
        batch = {"tokens": _meta((B, S_text), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), dtype)
        if cfg.vision_patches:
            batch["patch_embeds"] = _meta((B, cfg.vision_patches,
                                           cfg.d_model), dtype)
        if shape.kind == "train":
            batch["labels"] = _meta((B, S_text), torch.int32)
            batch["weights"] = _meta((B,), torch.float32)
            batch["route"] = _meta((B,), torch.int32)
        return batch
    # decode: one new token against a seq_len-deep cache
    cache = abstract_params(T.init_cache_specs(cfg, B, S), dtype)
    return {"cache": cache, "batch": {"tokens": _meta((B, 1), torch.int32)},
            "pos": _meta((), torch.int32)}


def batch_shardings(batch_specs, mesh, rules=None):
    """Each batch leaf's leading dim sharded over the batch axes, or
    replicated when it does not divide their extent; 0-d leaves
    replicated."""
    bspec = sh.batch_spec(mesh, rules)
    extent = sh.data_axis_size(mesh, rules)

    def f(x):
        if x.dim() == 0:
            return sh.NamedSharding(mesh, ())
        spec = bspec if x.shape[0] % extent == 0 else ()
        return sh.NamedSharding(mesh, (*spec, *([None] * (x.dim() - 1))))

    return opt_lib.tree_map(f, batch_specs)


def param_shardings(cfg: ModelConfig, mesh, rules=None):
    specs = T.specs(cfg)
    return sh.tree_shardings(logical_axes(specs), specs, mesh, rules)


def cache_shardings(cfg: ModelConfig, B: int, S: int, mesh, rules=None):
    specs = T.init_cache_specs(cfg, B, S)
    return sh.tree_shardings(logical_axes(specs), specs, mesh, rules)


def _data_axes(mesh, rules):
    rules = rules or sh.DEFAULT_RULES
    sizes = sh.mesh_axis_sizes(mesh)
    axes = tuple(a for a in rules["batch"] if a in sizes)
    return axes, sh.data_axis_size(mesh, rules)


def _shard_over_data(shard, leaf, data_axes):
    """``shard`` with the data axes added on the leaf's first replicated
    dim that their extent divides (``shard`` itself when none does)."""
    _, extent = data_axes
    spec = list(shard.spec) + [None] * (leaf.dim() - len(shard.spec))
    for d in range(leaf.dim()):
        if spec[d] is None and leaf.shape[d] % extent == 0:
            spec[d] = data_axes[0] if len(data_axes[0]) > 1 \
                else data_axes[0][0]
            return sh.NamedSharding(shard.mesh, tuple(spec))
    return shard


def opt_state_shardings(opt_state_abstract, pshard, mesh, *,
                        zero1: bool = False, rules=None):
    """Moments mirror the parameter shardings; scalars replicated.
    ``zero1`` also shards each moment over the data axes on its first
    replicated dim that they divide (ZeRO stage 1)."""
    rep = sh.NamedSharding(mesh, ())
    data_axes = _data_axes(mesh, rules)

    def upgrade(shard, leaf):
        if not zero1 or data_axes[1] <= 1:
            return shard
        return _shard_over_data(shard, leaf, data_axes)

    return {k: (opt_lib.tree_map(upgrade, pshard, v)
                if k in ("m", "v", "mu") else rep)
            for k, v in opt_state_abstract.items()}


def accum_shardings(params_abstract, pshard, mesh, rules=None):
    """ZeRO-2 shardings of the float32 gradient accumulator: each leaf's
    parameter sharding, also sharded over the data axes (a
    reduce-scatter per microbatch in place of a replicated float32
    copy)."""
    data_axes = _data_axes(mesh, rules)
    if data_axes[1] <= 1:
        return pshard
    return opt_lib.tree_map(
        lambda shard, leaf: _shard_over_data(shard, leaf, data_axes),
        pshard, params_abstract)


def frontend_inputs(cfg: ModelConfig, batch: int, device) -> dict:
    """The stubbed frontends' inputs as the reference's CLIs feed them,
    zeros: ``frames`` (B, encoder_seq, D) for an enc-dec arch,
    ``patch_embeds`` (B, vision_patches, D) for a VLM; {} otherwise."""
    out = {}
    if cfg.family == "encdec":
        out["frames"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                    dtype=torch.float32, device=device)
    if cfg.vision_patches:
        out["patch_embeds"] = torch.zeros(
            (batch, cfg.vision_patches, cfg.d_model), dtype=torch.float32,
            device=device)
    return out


def route_batch(batch):
    """Apply the data-movement plan: re-index every per-sample entry of
    the batch but ``weights`` (already in routed order) by ``route``."""
    r = batch.get("route")
    if r is None:
        return batch
    r = r.long()
    moved = {k: v[r] for k, v in batch.items()
             if k not in ("route", "weights") and hasattr(v, "shape")}
    return dict(batch, **moved)


def grads_of(params, batch, cfg):
    """Gradients of ``loss · wsum`` (wsum = max(Σ weights, 1), or 1
    without weights) with respect to every leaf of ``params``, as a tree
    like it; also ``loss_fn``'s metrics and wsum. On DTensor labels the
    forward and the backward run under ``loss_parallel()``, so that the
    loss keeps the logits vocab-sharded (``T.token_loss``)."""
    if "weights" in batch:
        wsum = torch.clamp(batch["weights"].sum(), min=1.0)
    else:
        wsum = torch.ones((), dtype=torch.float32,
                          device=batch["tokens"].device)

    def lf(p):
        loss, metrics = T.loss_fn(p, batch, cfg)
        return loss * wsum, metrics

    parallel = (loss_parallel() if isinstance(batch["labels"], DTensor)
                else contextlib.nullcontext())
    with parallel:
        (_, metrics), grads = opt_lib.value_and_grad(lf, params)
    return grads, {k: v.detach() for k, v in metrics.items()}, wsum


def apply_in_place(optimizer: opt_lib.Optimizer, grads: list, state,
                   params):
    """``optimizer.update`` then ``opt_lib.apply_updates``, leaf by leaf,
    written into ``params`` and the moments of ``state`` in place (the
    reference jits its train step with ``donate_argnums=(0, 1)``): the
    same arithmetic, with one leaf's new moments and update beside the
    state at a time instead of three new trees. ``grads`` is a list of
    leaves in ``tree_leaves`` order, emptied as it is used. Returns
    (params, state)."""
    moments = {k: opt_lib.tree_leaves(v) for k, v in state.items()
               if k != "count"}
    new = None
    for i, p in enumerate(opt_lib.tree_leaves(params)):
        g, grads[i] = grads[i], None
        ups, new = optimizer.update(
            g, {**{k: m[i] for k, m in moments.items()},
                "count": state["count"]}, p)
        for k, m in moments.items():
            m[i].copy_(new[k])
        p.add_(ups)
    if new is not None:
        state["count"] = new["count"]
    return params, state


def constrain(tree, shards):
    """Each DTensor leaf of ``tree`` redistributed to its sharding in
    ``shards`` (the reference's ``with_sharding_constraint``); plain
    tensors, and every leaf when ``shards`` is None, as they are."""
    if shards is None:
        return tree
    return opt_lib.tree_map(
        lambda a, s: (a.redistribute(s.mesh, s.placements)
                      if isinstance(a, DTensor) else a), tree, shards)


def accumulate(acc, grads, accum_shards=None):
    """One microbatch into the float32 gradient accumulator: ``acc +
    grads`` leaf by leaf, then :func:`constrain` to ``accum_shards``
    (ZeRO-2: a DTensor accumulator stays data-sharded, so the
    microbatch's gradient arrives by reduce-scatter)."""
    return constrain(opt_lib.tree_map(lambda a, g: a + g.float(), acc,
                                      grads), accum_shards)


def split_rows(v, M: int):
    """``v``'s rows cut into M equal consecutive microbatches, indexable
    by m. A DTensor is gathered over its mesh first and each part
    distributed back as ``v`` was: DTensor cannot split a dim sharded
    over more ranks than M into M parts (the reference's GSPMD reshards
    such a reshape itself)."""
    if not isinstance(v, DTensor):
        return v.reshape(M, v.shape[0] // M, *v.shape[1:])
    mesh, place = v.device_mesh, v.placements
    full = v.redistribute(mesh, [Replicate()] * mesh.ndim)
    return [part.redistribute(mesh, place)
            for part in full.reshape(M, v.shape[0] // M, *v.shape[1:])]


def make_train_step(cfg: ModelConfig, optimizer: opt_lib.Optimizer,
                    clip_norm: float = 1.0, microbatches: int = 1,
                    accum_shards=None):
    """(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}), the metrics 0-d tensors on the batch's device.

    The batch is routed, the gradient of the weighted loss taken and
    divided by max(Σ weights, 1), clipped to ``clip_norm`` by global
    norm and applied in place (:func:`apply_in_place`: ``params`` and
    ``opt_state`` are donated and returned). ``microbatches`` > 1
    accumulates float32 gradients over M equal slices of the routed
    batch, one after another (the reference's ``lax.scan``), so
    activation memory drops by about M. ``accum_shards`` (a tree from
    :func:`accum_shardings`) keeps the float32 accumulator of DTensor
    parameters data-sharded (ZeRO-2, see :func:`accumulate`); on plain
    tensors it changes nothing."""

    def train_step(params, opt_state, batch):
        batch = route_batch(batch)
        if microbatches <= 1:
            grads, metrics, wsum = grads_of(params, batch, cfg)
            grads = opt_lib.tree_map(lambda g: g / wsum, grads)
            loss = metrics["ce"]
        else:
            M = microbatches
            split = {k: split_rows(v, M)
                     for k, v in batch.items() if k != "route"}
            acc = constrain(opt_lib.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32),
                params), accum_shards)
            wacc = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            losses = []
            for m in range(M):
                g, met, w = grads_of(params, {k: v[m] for k, v in
                                              split.items()}, cfg)
                acc = accumulate(acc, g, accum_shards)
                del g
                wacc = wacc + w
                losses.append(met["ce"] * w)
            denom = torch.clamp(wacc, min=1.0)
            grads = opt_lib.tree_map(lambda g: g / denom, acc)
            del acc
            loss = torch.sum(torch.stack(losses)) / denom
        grads, gnorm = opt_lib.clip_by_global_norm(grads, clip_norm)
        leaves = opt_lib.tree_leaves(grads)
        del grads                         # each leaf freed once applied
        params, opt_state = apply_in_place(optimizer, leaves, opt_state,
                                           params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg):
    """(params, batch) -> the last position's logits (B, V_pad)."""
    def prefill(params, batch):
        logits, _ = T.forward(params, batch, cfg)
        return logits[:, -1, :]

    return prefill


def make_decode_step(cfg):
    """(params, cache, batch, pos) -> (logits (B,1,V_pad), cache)."""
    def decode(params, cache, batch, pos):
        return T.decode_step(params, cache, batch, pos, cfg)

    return decode
