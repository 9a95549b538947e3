"""Mixture-of-Experts layer: GShard-style capacity-based top-k dispatch
(the port of :mod:`repro.models.moe`).

Dispatch is by scatter and gather, with no (T, E, C) one-hot product
tensors, so memory stays O(E·C·D + T·k). The router and its softmax
run in float32 (float64 in a float64 run); the aux load-balance loss is
Switch/ST-MoE's E · Σ_e f_e · P_e.

The reference's sharding constraints (experts or the expert hidden dim
over the model axis) mean nothing on one card and are left out: the
group-local dispatch (``cfg.moe_groups``) and the padded experts
(``cfg.moe_pad_experts``) keep their arithmetic. The per-expert products
and the dispatch are plain PyTorch, as they are plain ``jnp`` outside any
Pallas kernel in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import gather_dims, pin
from repro_torch.models.layers import upcast
from repro_torch.models.module import Spec


def _padded_experts(cfg) -> int:
    return max(int(getattr(cfg, "moe_pad_experts", 0) or 0), cfg.num_experts)


def moe_specs(cfg, layers_axis: int | None = None) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    E = _padded_experts(cfg)
    pad_ep = E > cfg.num_experts
    expert_axis = ("experts" if (cfg.expert_shard == "expert" or pad_ep)
                   else None)
    hidden_axis = ("expert_mlp" if (cfg.expert_shard == "ffn" and not pad_ep)
                   else None)

    def mk(shape, axes, **kw):
        if layers_axis is not None:
            return Spec((layers_axis, *shape), ("layers", *axes), **kw)
        return Spec(shape, axes, **kw)

    return {
        "router": mk((D, cfg.num_experts), ("embed", None), init="small"),
        "w_gate": mk((E, D, F_), (expert_axis, "embed", hidden_axis)),
        "w_up": mk((E, D, F_), (expert_axis, "embed", hidden_axis)),
        "w_down": mk((E, F_, D), (expert_axis, hidden_axis, "embed")),
    }


def expert_capacity(tokens: int, cfg) -> int:
    """Static per-expert capacity."""
    cap = math.ceil(tokens * cfg.experts_per_token * cfg.capacity_factor
                    / cfg.num_experts)
    return max(cap, cfg.experts_per_token)


def top_k(probs, k: int):
    """The k largest entries of the last axis and their indices, ties to
    the lowest index, as ``jax.lax.top_k`` takes them (``torch.topk``
    does not promise an order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt, router, cfg, C: int):
    """The router of ``moe_apply`` on xt (G, Tg, D): softmax probs
    (G, Tg, E), the renormalised gates and expert ids (G, Tg, k), and
    for every (token, choice) in flattened order its position in its
    expert's buffer and whether it is kept under capacity C (G, Tg·k)."""
    G, Tg, _ = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(upcast(xt) @ upcast(router), dim=-1)
    gate, eids = top_k(probs, k)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    # position in expert: the running count of the expert over the
    # flattened (token, choice) order of the group
    flat_e = eids.reshape(G, Tg * k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1,
                       2, flat_e[..., None])[..., 0]
    return probs, gate, eids, pos, pos < C


def moe_apply(x, p, cfg):
    """x (B,S,D) -> (out (B,S,D), aux_loss 0-d float32).

    ``cfg.moe_groups`` = G > 1 splits the tokens into G groups (G = 1
    when it does not divide B·S), each dispatching into its own (E, C)
    buffers with C from the group's token count. Padded experts
    (``cfg.moe_pad_experts``) get buffers and weights but no token.
    Every kept (token, choice) writes its row into its own (expert,
    position) slot; a dropped one writes into a spare row that is then
    cut off, so no slot is summed into and the scatter is exact."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    Ep = _padded_experts(cfg)
    T = B * S
    G = max(int(getattr(cfg, "moe_groups", 1) or 1), 1)
    if T % G:
        G = 1
    Tg = T // G
    C = expert_capacity(Tg, cfg)
    # pinned: on DTensors its gradient must come back in xt's own
    # placements, or the reshape's backward view fails on uneven shards
    xt = pin(x.reshape(G, Tg, D))
    probs, gate, eids, pos, keep = route(xt, p["router"], cfg, C)
    flat_e = eids.reshape(G, Tg * k)
    pos_c = torch.where(keep, pos, 0)
    e_c = torch.where(keep, flat_e, 0)

    # scatter into the (G, Ep, C, D) buffers, rows flattened, plus the
    # spare row G·Ep·C that the dropped choices land in
    g_off = torch.arange(G, device=x.device)[:, None] * Ep
    slot = (g_off + e_c) * C + pos_c                      # (G, Tg·k)
    dest = torch.where(keep, slot, G * Ep * C).reshape(-1)
    x_rep = xt.repeat_interleave(k, dim=1).reshape(G * Tg * k, D)
    rows = x.new_zeros((G * Ep * C + 1, D)).index_put((dest,), x_rep)
    # on DTensors (the dry run) the buffers are gathered before they are
    # split or merged, and pinned so that their gradients are too
    buf = pin(gather_dims(rows[:-1], (0,)).view(G, Ep, C, D))

    # per-expert SwiGLU
    g = torch.einsum("gecd,edf->gecf", buf, p["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    h = F.silu(upcast(g)).to(x.dtype) * u
    out_e = torch.einsum("gecf,efd->gecd", h, p["w_down"])

    # gather and gate-weighted combine
    flat_out = pin(gather_dims(out_e, (0, 1, 2)).reshape(G * Ep * C, D))
    out_tk = flat_out[slot.reshape(-1)].view(G, Tg * k, D)
    out_tk = out_tk * (keep[..., None]
                       * gate.reshape(G, Tg * k)[..., None]).to(x.dtype)
    out = out_tk.view(G, Tg, k, D).sum(dim=2)

    # Switch-style load-balance aux loss
    frac_tokens = F.one_hot(eids, E).sum(dim=2).reshape(T, E) \
        .to(probs.dtype).mean(dim=0) / k
    frac_probs = probs.reshape(T, E).mean(dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return out.reshape(B, S, D), aux
