"""FedAvg with τ local steps for the model zoo (the port of
:mod:`repro.distributed.fedavg`; paper §III-B at model-zoo scale).

Between aggregations each data shard (a fog device group) takes τ local
optimizer steps on its own routed data, with no gradient exchange; at
the round's end the parameters are averaged with H_i weights (eq. (4)),
H_i = Σ of the sample weights the shard processed.

The reference runs the shards side by side under ``shard_map``, with
eq. (4) as a ``psum``. Given a process group, so does the port: rank r
runs shard r's τ steps, and eq. (4) is two all-reduces (sum) over the
group: one of H, and one of ``x · w_r`` for every parameter and
floating moment, all in one flat buffer. Without one, the shards run
one after another on one card: each starts from the round's parameters
and optimizer state, and its result is added into the weighted average
before the next starts, so the round holds two copies of the model and
its state whatever the shard count.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import (all_reduce_flat,
                                                 all_reduce_sum)
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as opt_lib


def _floating_moment(x) -> bool:
    """The state leaves eq. (4) averages: floating, with ndim > 0."""
    return x.is_floating_point() and x.dim() > 0


def make_fedavg_round(cfg, optimizer: opt_lib.Optimizer, tau: int,
                      n_shards: int = 1, group=None):
    """Returns ``round_fn(params, opt_state, batches) -> (params,
    opt_state, loss)``.

    ``batches`` — a dict of tensors with leading dims (tau, B, ...),
    already routed; shard i takes the contiguous slice ``[:, i·B/n :
    (i+1)·B/n]`` of every step's batch. Each of its τ steps takes the
    gradient of ``loss_fn``, clips it to global norm 1 and applies the
    optimizer. Parameters and every floating moment with ndim > 0 are
    then averaged with ``w_i = H_i / max(ΣH, 1e-9)``; ``count`` (the
    same on every shard) is kept. ``loss`` is the mean of the n·τ local
    losses, a 0-d tensor.

    ``group`` — a process group (the data mesh's, ``mesh.get_group(
    "data")``): the shard count is its size (``n_shards`` must be 1 or
    equal to it), rank r of the group runs shard r, every rank holds the
    whole batch, and the weighted average is all-reduced (H, then every
    averaged leaf in one buffer), so every rank returns the averaged
    parameters and state. On a group of one rank
    the round is bitwise the round without a group.
    """
    if group is not None:
        size = dist.get_world_size(group)
        if n_shards not in (1, size):
            raise ValueError(f"n_shards {n_shards} on a group of {size} "
                             "ranks")
        n_shards = size

    def local_steps(params, opt_state, batches, lo, hi):
        p, s = params, opt_state
        losses = []
        for t in range(tau):
            mb = {k: v[t, lo:hi] for k, v in batches.items()}
            (loss, _), grads = opt_lib.value_and_grad(
                lambda q: T.loss_fn(q, mb, cfg), p)
            grads, _ = opt_lib.clip_by_global_norm(grads, 1.0)
            ups, s = optimizer.update(grads, s, p)
            p = opt_lib.apply_updates(p, ups)
            losses.append(loss.detach())
        return p, s, torch.stack(losses)

    def shard_H(w, i, per):
        """H_i as the reference accumulates it: step by step, from 0."""
        h = torch.zeros((), dtype=torch.float32, device=w.device)
        for t in range(tau):
            h = h + w[t, i * per:(i + 1) * per].sum()
        return h

    def round_fn(params, opt_state, batches):
        w = batches["weights"]
        B = w.shape[1]
        if B % n_shards:
            raise ValueError(f"batch {B} is not a multiple of n_shards "
                             f"{n_shards}")
        per = B // n_shards
        if group is None:
            mine = range(n_shards)
            H = [shard_H(w, i, per) for i in mine]
            H_tot = torch.stack(H).sum()
        else:
            mine = [dist.get_rank(group)]
            H = [shard_H(w, mine[0], per)]
            H_tot = all_reduce_sum(H[0].clone(), group)
        H_tot = torch.clamp(H_tot, min=1e-9)
        avg_p = avg_s = None
        losses = []
        for h, i in zip(H, mine):
            p, s, ls = local_steps(params, opt_state, batches, i * per,
                                   (i + 1) * per)
            wi = h / H_tot
            p = opt_lib.tree_map(lambda x: x * wi, p)
            s = opt_lib.tree_map(
                lambda x: x * wi if _floating_moment(x) else x, s)
            if avg_p is None:
                avg_p, avg_s = p, s
            else:
                avg_p = opt_lib.tree_map(torch.add, avg_p, p)
                avg_s = opt_lib.tree_map(
                    lambda a, x: a + x if _floating_moment(x) else a,
                    avg_s, s)
            del p, s
            losses.append(ls)
        if group is None:
            return avg_p, avg_s, torch.cat(losses).mean()
        # eq. (4)'s sum over the ranks: one all-reduce of every averaged
        # leaf in one flat buffer
        p_l, s_l = opt_lib.tree_leaves(avg_p), opt_lib.tree_leaves(avg_s)
        moments = [i for i, x in enumerate(s_l) if _floating_moment(x)]
        sums = all_reduce_flat(p_l + [s_l[i] for i in moments], group)
        for i, x in zip(moments, sums[len(p_l):]):
            s_l[i] = x
        every = [torch.empty_like(losses[0]) for _ in range(n_shards)]
        dist.all_gather(every, losses[0], group=group)
        return (opt_lib.tree_unflatten(avg_p, sums[:len(p_l)]),
                opt_lib.tree_unflatten(avg_s, s_l), torch.cat(every).mean())

    return round_fn
