"""Mixture-of-Experts parameter specs (from :mod:`repro.models.moe`).

Only the specs are ported, so that the spec tree of every architecture
equals the reference's. The MoE layer itself (GShard top-k dispatch) is
not ported yet: ROADMAP.md, queue 1 item 14.
"""
from __future__ import annotations

from repro_torch.models.module import Spec


def _padded_experts(cfg) -> int:
    return max(int(getattr(cfg, "moe_pad_experts", 0) or 0), cfg.num_experts)


def moe_specs(cfg, layers_axis: int | None = None) -> dict:
    D, F = cfg.d_model, cfg.d_ff
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
        "w_gate": mk((E, D, F), (expert_axis, "embed", hidden_axis)),
        "w_up": mk((E, D, F), (expert_axis, "embed", hidden_axis)),
        "w_down": mk((E, F, D), (expert_axis, hidden_axis, "embed")),
    }
