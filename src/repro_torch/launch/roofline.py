"""Analytic roofline per (arch × shape × mesh) (the port of
:mod:`repro.launch.roofline`), at the H100's constants.

The arithmetic is the reference's:

  flops_useful   2·N_active·tokens (×3 for train), the MFU numerator
  flops_hw       what the implementation executes: padded heads,
                 full-rectangle blocked attention, MoE capacity factor,
                 remat recompute, SSD chunk quadratics
  bytes_hbm      per-device HBM traffic: params + optimizer states +
                 activation residuals (remat-aware) + KV/SSM cache
  bytes_coll     per-device link traffic: gradient all-reduce (train),
                 tensor-parallel activation all-reduces, decode softmax
                 reductions

The reference stores parameters, activations and caches in bfloat16
(2 bytes); the port stores them in float32. ``param_bytes`` is that
width: 4 for the port, and at 2 every count is the reference's. The
optimizer moments (float32), the float32 logits and the SSM state are
counted at 4 bytes either way, as the reference counts them.

The constants are one H100 SXM's, from NVIDIA's data sheet (dense
rates, 700 W). The port computes in float32 with TF32 off
(``device.set_f32_numerics``), so its products run outside the tensor
cores, at 67 TFLOP/s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.configs.base import InputShape, ModelConfig

PEAK_FLOPS = 67e12        # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12          # bytes/s of HBM3
# NVLink 4, bytes/s in one direction. Optimistic for the 16x16 mesh:
# 8-card nodes reach each other over the network, well below NVLink
LINK_BW = 450e9


def _param_counts(cfg: ModelConfig) -> dict:
    """Analytic parameter counts by component (matches models/*.py
    specs)."""
    D, L = cfg.d_model, cfg.num_layers
    hd = cfg.head_dim
    out: dict[str, float] = {"embed": cfg.vocab_padded * D
                             * (1 if cfg.tie_embeddings else 2)}
    if cfg.pos_embed == "learned":
        out["embed"] += cfg.max_positions * D

    def attn(hp):
        return D * hp * hd * 2 + 2 * D * cfg.num_kv_heads * hd

    def mlp():
        mult = 3 if cfg.act == "swiglu" else 2
        return mult * D * cfg.d_ff

    if cfg.family in ("ssm", "hybrid"):
        DI, H, N, G = (cfg.ssm_inner, cfg.ssm_heads, cfg.ssm_state,
                       cfg.ssm_groups)
        per = 2 * D * DI + 2 * D * G * N + D * H + DI * 4 + DI + DI * D
        out["ssm"] = L * per
        if cfg.family == "hybrid":
            out["attn"] = attn(cfg.num_heads_padded)   # one shared block
            out["mlp"] = mlp()
    elif cfg.family == "encdec":
        out["attn"] = (L * 2 + cfg.encoder_layers) * attn(
            cfg.num_heads_padded)
        out["mlp"] = (L + cfg.encoder_layers) * mlp()
    else:
        out["attn"] = L * attn(cfg.num_heads_padded)
        if cfg.num_experts:
            out["moe"] = L * (3 * D * cfg.d_ff * cfg.num_experts
                              + D * cfg.num_experts)
        else:
            out["mlp"] = L * mlp()
    return out


def params_total_active(cfg: ModelConfig) -> tuple[float, float]:
    pc = _param_counts(cfg)
    total = sum(pc.values())
    active = total
    if cfg.num_experts and "moe" in pc:
        active = total - pc["moe"] * (1 - cfg.experts_per_token
                                      / cfg.num_experts)
    return total, active


def _attention_flops_hw(cfg, B, S, heads) -> float:
    """Full-rectangle blocked attention: 4·B·H·S·S_k·hd MACs x2."""
    Sk = min(S, cfg.sliding_window) if cfg.sliding_window else S
    return 2.0 * 2 * B * heads * S * Sk * cfg.head_dim * 2


def _ssd_flops(cfg, B, S) -> float:
    l = cfg.ssm_chunk
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    nc = max(S // l, 1)
    per_chunk = 2 * (l * l * N + l * l * P + 2 * l * N * P)  # MACs x2
    return B * H * nc * per_chunk


def _attn_layers(cfg) -> int:
    """Layers that attend at decode: none (ssm), one shared block a
    group (hybrid), every layer otherwise."""
    if cfg.family == "ssm":
        return 0
    return (cfg.num_layers // cfg.attn_every if cfg.family == "hybrid"
            else cfg.num_layers)


def _flops_hw(cfg, shape, B, S, tokens, active, S_ctx) -> float:
    L = cfg.num_layers
    flops = 2.0 * active * tokens                # matmul base
    if cfg.num_experts:                          # capacity-factor overhead
        flops += 2.0 * tokens * _param_counts(cfg)["moe"] \
            * cfg.experts_per_token / cfg.num_experts \
            * (cfg.capacity_factor - 1)
    heads = cfg.num_heads_padded
    if shape.kind != "decode":                   # attention quadratics
        if cfg.family in ("ssm", "hybrid"):
            flops += L * _ssd_flops(cfg, B, S)
            if cfg.family == "hybrid":
                flops += (L // cfg.attn_every) * _attention_flops_hw(
                    cfg, B, S, heads)
        elif cfg.family == "encdec":
            flops += L * _attention_flops_hw(cfg, B, S, heads)
            flops += cfg.encoder_layers * _attention_flops_hw(
                dataclasses.replace(cfg, sliding_window=None), B,
                cfg.encoder_seq, heads)
            flops += L * 2 * 2 * B * heads * S * cfg.encoder_seq \
                * cfg.head_dim * 2
        else:
            flops += L * _attention_flops_hw(cfg, B, S, heads)
    else:                                        # q·cache, per layer
        if cfg.family in ("ssm", "hybrid"):
            flops += L * 2 * B * cfg.ssm_heads * cfg.ssm_headdim \
                * cfg.ssm_state * 2
        flops += _attn_layers(cfg) * 2 * 2 * B * cfg.num_heads * S_ctx \
            * cfg.head_dim * 2
    if shape.kind == "train":
        flops *= 3
        if cfg.remat == "full":
            flops *= 4.0 / 3.0                   # one extra forward
    return flops


def analytic_roofline(cfg: ModelConfig, shape: InputShape,
                      mesh_shape: tuple[int, ...], *,
                      param_bytes: int = 4) -> dict[str, Any]:
    """The roofline terms of one (config, shape) on a mesh of
    ``mesh_shape`` (the last extent tensor-parallel, the rest data
    parallel), with parameters, activations and caches ``param_bytes``
    wide (4: the port's float32; 2: the reference's bfloat16)."""
    b = param_bytes
    chips = math.prod(mesh_shape)
    model_par = mesh_shape[-1]
    data_par = chips // model_par
    B, S = shape.global_batch, shape.seq_len
    total, active = params_total_active(cfg)
    L = cfg.num_layers
    S_ctx = S
    if shape.kind == "decode":
        tokens = B
        if cfg.sliding_window and cfg.family != "ssm":
            S_ctx = min(S, cfg.sliding_window)
    else:
        tokens = B * S

    flops_useful = 2.0 * active * tokens
    if shape.kind == "train":
        flops_useful *= 3                        # forward + 2x backward
    flops_hw = _flops_hw(cfg, shape, B, S, tokens, active, S_ctx)

    # HBM bytes (per device)
    p_dev = total / model_par                    # params sharded over model
    act = b * tokens / data_par * cfg.d_model    # one activation's shard
    logits = tokens / data_par * cfg.vocab_padded / model_par * 4
    if shape.kind == "train":
        # p read + grad write/read + adam m,v fp32 r/w + p write
        bytes_hbm = p_dev * (b + 2 * b + 4 * 4 + b)
        bytes_hbm += L * (6 if cfg.remat == "full" else 14) * act
        bytes_hbm += logits * 2                  # f32 logits, r + w
    elif shape.kind == "prefill":
        bytes_hbm = p_dev * b + L * 8 * act + logits
    else:
        bytes_hbm = p_dev * b                    # weights stream once
        if cfg.family in ("ssm", "hybrid"):
            bytes_hbm += L * (B / min(B, data_par)) * cfg.ssm_heads \
                * cfg.ssm_headdim * cfg.ssm_state * 4 * 2
        cache = _attn_layers(cfg) * B * cfg.num_kv_heads * S_ctx \
            * cfg.head_dim * 2 * b
        bytes_hbm += cache / chips               # batch x seq sharded

    # collective bytes (per device)
    act_shard = (tokens / data_par) * cfg.d_model * b
    if shape.kind == "train":
        # gradient all-reduce over the data axes of each device's model
        # shard (ring: ~2x the buffer), then the tensor-parallel
        # all-reduces: 2 a layer, x3 forward+backward, ring 2x
        bytes_coll = 2 * (b * total / model_par)
        bytes_coll += L * 2 * 3 * 2 * act_shard / model_par
    elif shape.kind == "prefill":
        bytes_coll = L * 2 * 2 * act_shard / model_par
    else:
        bytes_coll = _attn_layers(cfg) * 3 * B * cfg.num_heads \
            * cfg.head_dim * 4
        bytes_coll += 2 * B * cfg.d_model * b * L / model_par

    return {
        "flops_useful": flops_useful,
        "flops_hw": flops_hw,
        "bytes_hbm_dev": bytes_hbm,
        "bytes_coll_dev": bytes_coll,
        "compute_s": flops_hw / (chips * PEAK_FLOPS),
        "compute_useful_s": flops_useful / (chips * PEAK_FLOPS),
        "memory_s": bytes_hbm / HBM_BW,
        "collective_s": bytes_coll / LINK_BW,
        "mfu_bound": flops_useful / max(flops_hw, 1.0),
        "params_total": total, "params_active": active,
    }


def dominant_term(r: dict) -> str:
    terms = {k: r[k] for k in ("compute_s", "memory_s", "collective_s")}
    return max(terms, key=terms.get)
