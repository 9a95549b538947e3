"""Mixture-of-Experts layer: GShard-style capacity-based top-k dispatch
(the port of :mod:`repro.models.moe`).

Dispatch is by scatter and gather, with no (T, E, C) one-hot product
tensors, so memory stays O(E·C·D + T·k). The router and its softmax
run in float32 (float64 in a float64 run); the aux load-balance loss is
Switch/ST-MoE's E · Σ_e f_e · P_e. The group-local dispatch
(``cfg.moe_groups``) and the padded experts (``cfg.moe_pad_experts``)
keep the reference's arithmetic. The per-expert products and the
dispatch are plain PyTorch, as they are plain ``jnp`` outside any
Pallas kernel in the reference.

On DTensors (the dry run) the layer keeps the reference's two layouts
(its ``_maybe_shard`` constraints): the (G, Tg, D) tokens on the batch
axes and the (G, Ep, C, D) buffers on (batch axes, the model axis where
the experts are sharded). Each rank routes, scatters, multiplies and
combines its own groups and its own experts (or its slice of the expert
hidden dim) on local tensors, with the capacity slots split over any
mesh dim that splits neither (:func:`_on_shards`); nothing is gathered
whole but the tokens of the rank's groups, and the output is
``Partial`` on the model axis, as a row-parallel projection's is.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

from repro_torch.distributed import sharding as sh
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
    probs, gate, eids = _gates(xt, router, cfg)
    pos, keep = _positions(eids.reshape(G, Tg * cfg.experts_per_token),
                           cfg.num_experts, C)
    return probs, gate, eids, pos, keep


def _gates(x, router, cfg):
    """Softmax probs (..., E), renormalised top-k gates and expert ids
    (..., k) of tokens x (..., D)."""
    probs = torch.softmax(upcast(x) @ upcast(router), dim=-1)
    gate, eids = top_k(probs, cfg.experts_per_token)
    return probs, gate / gate.sum(dim=-1, keepdim=True), eids


def _positions(flat_e, E: int, C: int):
    """Each (token, choice)'s position in its expert's buffer, the
    running count of the expert over the flattened (token, choice) order
    of its group (G, Tg·k), and whether it is kept under capacity C."""
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1,
                       2, flat_e[..., None])[..., 0]
    return pos, pos < C


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
    if isinstance(x, DTensor):
        return _on_shards(x, p, cfg, G, C)
    xt = x.reshape(G, Tg, D)
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
    buf = rows[:-1].view(G, Ep, C, D)

    # per-expert SwiGLU
    g = torch.einsum("gecd,edf->gecf", buf, p["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    h = F.silu(upcast(g)).to(x.dtype) * u
    out_e = torch.einsum("gecf,efd->gecd", h, p["w_down"])

    # gather and gate-weighted combine
    flat_out = out_e.reshape(G * Ep * C, D)
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


def _on_shards(x, p, cfg, G: int, C: int):
    """``moe_apply`` of a DTensor x (B, S, D) in G groups of capacity C,
    each rank on its own share of the work.

    The router runs on x's own token shards, and only the gates and
    expert ids (B, S, k) are gathered to the groups. The dispatch splits
    one thing over every mesh dim. The batch axes split the groups as far
    as G (and B) divides (:func:`sharding.lead_shards`): each rank's
    batch rows are then whole groups, so the capacity cumsum and the
    scatter are local. The model axis splits what the weights shard
    there: the experts (``expert`` mode, padded experts) or the expert
    hidden dim (``ffn`` mode). Every other mesh dim (a batch axis that G
    does not divide, or a model axis that shards no weight) splits the
    capacity slots. A rank scatters only the kept (token, choice) rows
    that land in its experts and its capacity slots, by the inverse map
    slot -> token, into its local (G_l, Ep_l, C_l, D) buffer, multiplies
    them by its weights and adds their gate-weighted rows into its
    groups' tokens: the output is ``Partial`` on every dim but the
    groups'."""
    mesh = x.device_mesh
    names, sizes = mesh.mesh_dim_names, tuple(mesh.shape)
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T, Tg = B * S, B * S // G
    model = names.index(sh.MODEL_AXIS) if sh.MODEL_AXIS in names else None

    def model_shard(w):
        """The weight's placements: its shard on the model axis kept."""
        place = [Replicate()] * len(names)
        if model is not None and isinstance(w.placements[model], Shard):
            place[model] = w.placements[model]
        return place

    def weight(w):
        place = model_shard(w)
        grad = [q if isinstance(q, Shard) else Partial() for q in place]
        return w.redistribute(mesh, place).to_local(grad_placements=grad)

    # the router on the token shards; partial sums over them for the
    # router's gradient and the aux loss's counts and probabilities
    toks = [q if isinstance(q, Shard) and q.dim < 2 else Replicate()
            for q in x.placements]
    over_toks = [Partial() if isinstance(q, Shard) else Replicate()
                 for q in toks]
    router = p["router"].redistribute(mesh, [Replicate()] * len(names))
    probs, gate, eids = _gates(
        x.redistribute(mesh, toks).to_local(), router.to_local(
            grad_placements=over_toks), cfg)

    def on(t, place):
        """The DTensor of local ``t``: a (B, S, ...) tensor's shard, or a
        partial sum shaped like the whole."""
        shape = (B, S, *t.shape[2:]) if t.dim() > 1 else tuple(t.shape)
        return DTensor.from_local(t, mesh, place, run_check=False,
                                  shape=shape, stride=tuple(
                                      math.prod(shape[i + 1:])
                                      for i in range(len(shape))))

    # the dispatch: groups, experts (or hidden slice), capacity slots;
    # rank r of the R that share a group's slots takes [r·C_l, (r+1)·C_l)
    grp = sh.lead_shards(mesh, math.gcd(G, B))
    w_place = model_shard(p["w_gate"])
    R, r = 1, 0
    for i, q in enumerate(grp):
        if not isinstance(q, Shard) and not isinstance(w_place[i], Shard):
            R, r = R * sizes[i], r * sizes[i] + mesh.get_local_rank(i)
    Cl = -(-C // R)
    partial = [q if isinstance(q, Shard) else Partial() for q in grp]
    wg, wu, wd = (weight(p[n]) for n in ("w_gate", "w_up", "w_down"))
    _, lo = compute_local_shape_and_global_offset(p["w_gate"].shape, mesh,
                                                  w_place)
    e_lo, Epl = lo[0], wg.shape[0]
    xe = x.redistribute(mesh, grp).to_local(grad_placements=partial)
    Gl = xe.shape[0] * S // Tg
    gate = on(gate, toks).redistribute(mesh, grp).to_local(
        grad_placements=partial).reshape(Gl, Tg * k)
    flat_e = on(eids, toks).redistribute(mesh, grp).to_local() \
        .reshape(Gl, Tg * k)
    pos, keep = _positions(flat_e, E, C)

    # the inverse map: each of the rank's slots -> its local token row,
    # Gl·Tg (a spare row) where the slot is empty
    mine = (keep & (flat_e >= e_lo) & (flat_e < e_lo + Epl)
            & (pos >= r * Cl) & (pos < (r + 1) * Cl))
    n, rows = Gl * Epl * Cl, Gl * Tg
    g_off = torch.arange(Gl, device=x.device)[:, None] * Epl
    slot = torch.where(mine, (g_off + flat_e - e_lo) * Cl + pos - r * Cl, n)
    tok = torch.arange(rows, device=x.device).view(Gl, Tg, 1) \
        .expand(Gl, Tg, k).reshape(Gl, Tg * k)
    src = torch.full((n + 1,), rows, dtype=tok.dtype, device=x.device) \
        .scatter(0, slot.reshape(-1), tok.reshape(-1))[:n]
    buf = xe.reshape(rows, D)[src.clamp(max=rows - 1)].masked_fill_(
        (src == rows)[:, None], 0).view(Gl, Epl, Cl, D)

    # per-expert SwiGLU on the rank's experts (or hidden slice)
    g = torch.einsum("gecd,edf->gecf", buf, wg)
    u = torch.einsum("gecd,edf->gecf", buf, wu)
    h = F.silu(upcast(g)).to(x.dtype) * u
    out_e = torch.einsum("gecf,efd->gecd", h, wd).reshape(n, D)

    # combine: each slot's gate-weighted row added into its token
    w_slot = gate.new_zeros(n + 1).scatter(
        0, slot.reshape(-1), (gate * mine).reshape(-1))[:n]
    out = out_e.new_zeros((rows + 1, D)).index_add_(
        0, src, out_e * w_slot[:, None].to(x.dtype))[:rows]
    out = DTensor.from_local(out.view(-1, S, D), mesh, partial,
                             run_check=False, shape=(B, S, D),
                             stride=(S * D, D, 1))

    # Switch-style load-balance aux loss over all T tokens, from the
    # counts and probability sums of each rank's token shard
    counts = probs.new_zeros(E).index_add_(
        0, eids.reshape(-1), probs.new_ones(eids.numel()))
    frac_tokens = on(counts, over_toks) / (T * k)
    frac_probs = on(probs.reshape(-1, E).sum(dim=0), over_toks) / T
    aux = E * torch.sum(frac_tokens * frac_probs)
    return out, aux
