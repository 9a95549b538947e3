"""Optimizers over parameter trees (the port of
:mod:`repro.optim.optimizers`): SGD, momentum and AdamW as pure
functions, the reference's gradient-transformation pattern:

    opt = adamw(3e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

A tree is a nested dict of tensors; its leaves go in sorted key order,
as ``jax.tree_util`` orders a dict. Moments are float32 trees shaped
like the parameters and ``count`` is a 0-d int32 tensor, so a state can
be averaged leaf by leaf (FedAvg) and carried across from the reference
(:func:`repro_torch.models.convert.opt_state_from_jax`). Nothing is
updated in place: ``update`` returns new moments and ``apply_updates``
new parameters.

The arithmetic is the reference's, not ``torch.optim``'s: AdamW divides
by ``sqrt(v / c2) + eps`` after bias-correcting m (``(m / c1) /
(sqrt(v / c2) + eps)``), adds the weight decay to that step before the
``-lr`` scale, and ``clip_by_global_norm`` scales by ``min(1, max_norm
/ (norm + 1e-9))``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (same structure), as a new tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves are ``leaves``, taken in
    :func:`tree_leaves` order."""
    return _unflatten(tree, iter(leaves))


def _unflatten(node, it):
    # a module-level recursion: a recursive closure would be a reference
    # cycle that keeps ``leaves`` (a whole gradient tree) alive until the
    # cyclic collector runs
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    return next(it)


def value_and_grad(fn, params):
    """``fn(params)`` (a tuple whose first item is a scalar tensor) and
    the gradient of that scalar with respect to every leaf of
    ``params``, as a tree like it: JAX's ``value_and_grad(has_aux=True)``
    over a tree of tensors. A leaf that does not reach the scalar gets
    zeros."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    out = fn(p)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(out[0], leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return out, tree_unflatten(params, grads)


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _count(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _eta(lr, step):
    return lr(step) if callable(lr) else lr


def sgd(lr: float | Callable) -> Optimizer:
    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params=None):
        step = state["count"] + 1
        eta = _eta(lr, step)
        ups = tree_map(lambda g: (-eta * g.float()).to(g.dtype), grads)
        return ups, {"count": step}

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": _zeros_like_f32(params), "count": _count(params)}

    def update(grads, state, params=None):
        step = state["count"] + 1
        mu = tree_map(lambda m, g: beta * m + g.float(), state["mu"], grads)
        ups = tree_map(lambda m, g: (-lr * m).to(g.dtype), mu, grads)
        return ups, {"mu": mu, "count": step}

    return Optimizer(init, update)


def adamw(lr: float | Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_f32(params), "v": _zeros_like_f32(params),
                "count": _count(params)}

    def update(grads, state, params):
        step = state["count"] + 1
        eta = _eta(lr, step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()

        def upd(m_, v_, p):
            # the reference's (m/c1) / (sqrt(v/c2) + eps), its in-place
            # steps on fresh temporaries: one leaf-sized temporary at a
            # time beside the update, the same arithmetic in the same order
            u = torch.sqrt(v_ / c2).add_(eps)
            u = (m_ / c1).div_(u)
            if weight_decay:
                u = u.add_(weight_decay * p.float())
            return u.mul_(-eta).to(p.dtype)

        ups = tree_map(upd, m, v, params)
        return ups, {"m": m, "v": v, "count": step}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in tree order, of the squares in
    float32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``min(1, max_norm / (norm + 1e-9))``, norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(name)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_frac · base_lr`` at ``total``; takes the step count
    tensor, returns a float32 tensor."""
    def f(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return f
