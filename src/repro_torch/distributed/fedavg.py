"""FedAvg with τ local steps for the model zoo (the port of
:mod:`repro.distributed.fedavg`; paper §III-B at model-zoo scale).

Between aggregations each data shard (a fog device group) takes τ local
optimizer steps on its own routed data, with no gradient exchange; at
the round's end the parameters are averaged with H_i weights (eq. (4)),
H_i = Σ of the sample weights the shard processed.

The reference runs the shards side by side under ``shard_map``. Here
they run one after another on one card: each starts from the round's
parameters and optimizer state, and its result is added into the
weighted average before the next starts, so the round holds two copies
of the model and its state whatever the shard count. Across several
cards, with the average as an all-reduce, is ROADMAP.md queue 1 item 12.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as opt_lib


def _floating_moment(x) -> bool:
    """The state leaves eq. (4) averages: floating, with ndim > 0."""
    return x.is_floating_point() and x.dim() > 0


def make_fedavg_round(cfg, optimizer: opt_lib.Optimizer, tau: int,
                      n_shards: int = 1):
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
    """

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

    def round_fn(params, opt_state, batches):
        w = batches["weights"]
        B = w.shape[1]
        if B % n_shards:
            raise ValueError(f"batch {B} is not a multiple of n_shards "
                             f"{n_shards}")
        per = B // n_shards
        # H_i as the reference accumulates it: step by step, from 0
        H = []
        for i in range(n_shards):
            h = torch.zeros((), dtype=torch.float32, device=w.device)
            for t in range(tau):
                h = h + w[t, i * per:(i + 1) * per].sum()
            H.append(h)
        H_tot = torch.clamp(torch.stack(H).sum(), min=1e-9)
        avg_p = avg_s = None
        losses = []
        for i in range(n_shards):
            p, s, ls = local_steps(params, opt_state, batches, i * per,
                                   (i + 1) * per)
            wi = H[i] / H_tot
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
        return avg_p, avg_s, torch.cat(losses).mean()

    return round_fn
