"""Step builders (the port of :mod:`repro.launch.steps`): the train
step, the prefill and decode steps, the movement plan's batch routing
and the per-shape config.

A train batch is ``{tokens, labels, weights, route}``: ``route`` (B,)
re-indexes the global batch (sample offloading between data shards),
``weights`` (B,) carries per-sample processing weights (0 = discarded),
and the loss normalises by Σ weights, as the paper's H_i-weighted
aggregation (eqs. (1)/(4)) does.

On one card there is nothing to shard: the reference's abstract input
specs and sharding helpers (``input_specs``, ``*_shardings``) come with
ROADMAP.md queue 1 items 12 and 14d, and ``accum_shards`` raises.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as T
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
    like it; also ``loss_fn``'s metrics and wsum."""
    if "weights" in batch:
        wsum = torch.clamp(batch["weights"].sum(), min=1.0)
    else:
        wsum = torch.ones((), dtype=torch.float32,
                          device=batch["tokens"].device)

    def lf(p):
        loss, metrics = T.loss_fn(p, batch, cfg)
        return loss * wsum, metrics

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


def make_train_step(cfg: ModelConfig, optimizer: opt_lib.Optimizer,
                    clip_norm: float = 1.0, microbatches: int = 1,
                    accum_shards=None):
    """(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}), the metrics 0-d tensors on the batch's device.

    The batch is routed, the gradient of the weighted loss taken and
    divided by max(Σ weights, 1), clipped to ``clip_norm`` by global
    norm and applied in place (:func:`apply_in_place`: ``params`` and
    ``opt_state`` are donated and returned). ``microbatches`` > 1 accumulates float32 gradients
    over M equal slices of the routed batch, one after another (the
    reference's ``lax.scan``), so activation memory drops by about M.
    ``accum_shards`` (the reference's ZeRO-2 accumulator shardings)
    means nothing on one card and raises."""
    if accum_shards is not None:
        raise NotImplementedError(
            f"accum_shards (ZeRO-2 sharding of the gradient accumulator) "
            f"is not ported to repro_torch yet (ROADMAP.md, queue 1 item "
            f"12: multi-GPU)")

    def train_step(params, opt_state, batch):
        batch = route_batch(batch)
        if microbatches <= 1:
            grads, metrics, wsum = grads_of(params, batch, cfg)
            grads = opt_lib.tree_map(lambda g: g / wsum, grads)
            loss = metrics["ce"]
        else:
            M = microbatches
            split = {k: v.reshape(M, v.shape[0] // M, *v.shape[1:])
                     for k, v in batch.items() if k != "route"}
            acc = opt_lib.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            wacc = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            losses = []
            for m in range(M):
                g, met, w = grads_of(params, {k: v[m] for k, v in
                                              split.items()}, cfg)
                acc = opt_lib.tree_map(lambda a, gg: a + gg.float(), acc, g)
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
