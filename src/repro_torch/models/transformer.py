"""Model composition for the dense, Mamba2 (ssm) and Zamba2-style
hybrid families (the port of :mod:`repro.models.transformer`).

The interface is the reference's:

* ``specs(cfg)``                          parameter spec tree (every family)
* ``forward(params, batch, cfg)``         logits (prefill)
* ``init_cache_specs(cfg, batch, seq)``   decode-cache spec tree
* ``decode_step(params, cache, batch, pos, cfg)`` one-token serve step

Stacked layers keep the reference's leading ``layers`` axis; where the
reference scans over it, the port loops in Python over views of each
layer. The hybrid family loops over ``num_layers // attn_every`` groups:
``attn_every`` SSM blocks, then the one SHARED attention+MLP block.
The moe, encdec and vlm families have specs only: their forward and
decode are ROADMAP.md queue 1 item 14.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.module import Spec

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES or cfg.num_experts \
            or cfg.vision_patches:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet (ROADMAP.md, queue 1 item 14: model zoo); "
            f"ported: {', '.join(PORTED_FAMILIES)}")


# ---------------------------------------------------------------------------
# Spec builders
# ---------------------------------------------------------------------------


def _stacked_norm(cfg, n: int):
    if cfg.norm == "rmsnorm":
        return Spec((n, cfg.d_model), ("layers", "embed"), init="ones")
    return {"scale": Spec((n, cfg.d_model), ("layers", "embed"), init="ones"),
            "bias": Spec((n, cfg.d_model), ("layers", "embed"),
                         init="zeros")}


def _block_specs(cfg, n_layers: int, *, cross: bool = False) -> dict:
    """Stacked decoder-block specs (attention + mlp/moe [+ cross-attn])."""
    p = {"ln1": _stacked_norm(cfg, n_layers),
         "attn": L.attention_specs(cfg, layers_axis=n_layers),
         "ln2": _stacked_norm(cfg, n_layers)}
    if cross:
        p["ln_x"] = _stacked_norm(cfg, n_layers)
        p["xattn"] = L.attention_specs(cfg, layers_axis=n_layers)
    if cfg.num_experts:
        p["moe"] = M.moe_specs(cfg, layers_axis=n_layers)
    else:
        p["mlp"] = L.mlp_specs(cfg, layers_axis=n_layers)
    return p


def specs(cfg) -> dict:
    p = {"embed": L.embed_specs(cfg),
         "ln_f": L.norm_spec(cfg.d_model, cfg.norm)}
    if cfg.family in ("ssm", "hybrid"):
        p["blocks"] = {"ln": _stacked_norm(cfg, cfg.num_layers),
                       "ssm": S.ssm_specs(cfg, layers_axis=cfg.num_layers)}
        if cfg.family == "hybrid":
            hybrid_shape(cfg)
            # one SHARED attention+mlp block, reused after every group
            p["shared"] = {"ln1": L.norm_spec(cfg.d_model, cfg.norm),
                           "attn": L.attention_specs(cfg),
                           "ln2": L.norm_spec(cfg.d_model, cfg.norm),
                           "mlp": L.mlp_specs(cfg)}
    elif cfg.family == "encdec":
        p["enc"] = {"blocks": _block_specs(cfg, cfg.encoder_layers),
                    "ln_f": L.norm_spec(cfg.d_model, cfg.norm)}
        p["blocks"] = _block_specs(cfg, cfg.num_layers, cross=True)
    else:  # dense / moe / vlm
        p["blocks"] = _block_specs(cfg, cfg.num_layers)
    if cfg.vision_patches:
        p["vis_proj"] = Spec((cfg.d_model, cfg.d_model), ("embed", None))
    return p


def hybrid_shape(cfg) -> tuple[int, int]:
    per = cfg.attn_every
    if per <= 0 or cfg.num_layers % per:
        raise ValueError(f"hybrid needs num_layers ({cfg.num_layers}) to be "
                         f"a multiple of attn_every ({per})")
    return cfg.num_layers // per, per


def _layer(tree, i: int):
    """The i-th layer of a stacked parameter (or cache) tree, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _norm(x, p, cfg):
    return L.apply_norm(x, p, cfg.norm)


def _attn_mlp_block(x, lp, cfg, *, window=None):
    x = x + L.attention_apply(_norm(x, lp["ln1"], cfg), lp["attn"], cfg,
                              causal=True, window=window)
    return x + L.mlp_apply(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg)


def _ssm_block(x, lp, cfg):
    return x + S.ssm_apply(_norm(x, lp["ln"], cfg), lp["ssm"], cfg)


def forward(params, batch, cfg):
    """Returns (logits (B,S,V_pad), aux_loss): aux is 0 for the ported
    families, which have no MoE."""
    _check_family(cfg)
    window = cfg.sliding_window
    x = L.embed_tokens(batch["tokens"], params["embed"], cfg)
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _ssm_block(x, _layer(params["blocks"], i), cfg)
    elif cfg.family == "hybrid":
        g, per = hybrid_shape(cfg)
        for gi in range(g):
            for j in range(per):
                x = _ssm_block(x, _layer(params["blocks"], gi * per + j), cfg)
            x = _attn_mlp_block(x, params["shared"], cfg, window=window)
    else:
        for i in range(cfg.num_layers):
            x = _attn_mlp_block(x, _layer(params["blocks"], i), cfg,
                                window=window)
    x = _norm(x, params["ln_f"], cfg)
    logits = L.lm_logits(x, params["embed"], cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Decode (serve step)
# ---------------------------------------------------------------------------


def cache_len_for(cfg, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache_specs(cfg, batch: int, seq_len: int) -> dict:
    _check_family(cfg)
    cl = cache_len_for(cfg, seq_len)
    if cfg.family == "ssm":
        return S.init_ssm_cache_specs(cfg, batch, cfg.num_layers)
    if cfg.family == "hybrid":
        g, _ = hybrid_shape(cfg)
        c = S.init_ssm_cache_specs(cfg, batch, cfg.num_layers)
        c["attn"] = L.init_cache_specs(cfg, batch, cl, g, groups_axis="groups")
        return c
    return L.init_cache_specs(cfg, batch, cl, cfg.num_layers)


def _ssm_decode_block(x, params, cache, i, cfg):
    lp = _layer(params["blocks"], i)
    h, _ = S.ssm_decode(_norm(x, lp["ln"], cfg), lp["ssm"], cfg,
                        {"h": cache["h"][i], "conv": cache["conv"][i]})
    return x + h


def _attn_mlp_decode(x, lp, cfg, cache, pos, window):
    h, _ = L.decode_attention(_norm(x, lp["ln1"], cfg), lp["attn"], cfg,
                              cache, pos, window=window)
    x = x + h
    return x + L.mlp_apply(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg)


def decode_step(params, cache, batch, pos: int, cfg):
    """One-token decode. batch['tokens'] (B,1). Updates the cache in
    place and returns (logits (B,1,V_pad), cache)."""
    _check_family(cfg)
    window = cfg.sliding_window
    x = L.embed_tokens(batch["tokens"], params["embed"], cfg)
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _ssm_decode_block(x, params, cache, i, cfg)
    elif cfg.family == "hybrid":
        g, per = hybrid_shape(cfg)
        for gi in range(g):
            for j in range(per):
                x = _ssm_decode_block(x, params, cache, gi * per + j, cfg)
            x = _attn_mlp_decode(x, params["shared"], cfg,
                                 _layer(cache["attn"], gi), pos, window)
    else:
        for i in range(cfg.num_layers):
            x = _attn_mlp_decode(x, _layer(params["blocks"], i), cfg,
                                 _layer(cache, i), pos, window)
    x = _norm(x, params["ln_f"], cfg)
    return L.lm_logits(x, params["embed"], cfg), cache
