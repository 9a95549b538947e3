"""Model composition: decoder LMs (dense and MoE), Mamba2 (ssm), the
Zamba2-style hybrid, the Whisper-style encoder-decoder and the VLM's
patch-embedding prefix (the port of :mod:`repro.models.transformer`).

The interface is the reference's:

* ``specs(cfg)``                          parameter spec tree
* ``forward(params, batch, cfg)``         (logits, aux) (train / prefill)
* ``loss_fn(params, batch, cfg)``         weighted next-token cross-entropy
* ``token_loss(logits, labels, weights)`` its tail on the logits
* ``encode(params, frames, cfg)``         enc-dec encoder + cross K/V
* ``init_cache_specs(cfg, batch, seq)``   decode-cache spec tree
* ``decode_step(params, cache, batch, pos, cfg)`` one-token serve step

Stacked layers keep the reference's leading ``layers`` axis; where the
reference scans over it, the port loops in Python over views of each
layer, and sums the per-layer MoE aux losses as the reference sums its
scan's. The hybrid family loops over ``num_layers // attn_every``
groups: ``attn_every`` SSM blocks, then the one SHARED attention+MLP
block. ``cfg.remat == "full"`` recomputes each block (and each hybrid
group) in the backward, where the reference wraps the same bodies in
``jax.checkpoint``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import on_vocab_shards
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.module import Spec


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


def _layers(tree, n: int) -> list:
    """The n layers of a stacked parameter tree, as views split once by
    ``torch.unbind``: its backward stacks the n layers' gradients into
    one leaf-sized tensor, where indexing each layer (``_layer``) would
    add a zero-padded leaf-sized gradient per layer (olmoe-1b-7b's six
    layers: 3 GB each for every expert weight)."""
    if isinstance(tree, dict):
        per = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree))


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _norm(x, p, cfg):
    return L.apply_norm(x, p, cfg.norm)


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _attn_mlp_block(x, lp, cfg, *, causal=True, window=None, enc_out=None,
                    cross=False):
    """One decoder block (attention, cross attention against ``enc_out``
    when ``cross``, then the MLP or the MoE layer); returns (x, aux)."""
    x = x + L.attention_apply(_norm(x, lp["ln1"], cfg), lp["attn"], cfg,
                              causal=causal, window=window)
    if cross:
        x = x + L.attention_apply(_norm(x, lp["ln_x"], cfg), lp["xattn"],
                                  cfg, causal=False, kv_input=enc_out)
    if cfg.num_experts:
        h, aux = M.moe_apply(_norm(x, lp["ln2"], cfg), lp["moe"], cfg)
    else:
        h, aux = L.mlp_apply(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg), \
            _zero_aux(x)
    return x + h, aux


def _ssm_block(x, lp, cfg):
    return x + S.ssm_apply(_norm(x, lp["ln"], cfg), lp["ssm"], cfg)


def _remat(fn, cfg):
    """``fn`` recomputed in the backward under ``cfg.remat == "full"``
    (the reference's ``jax.checkpoint``), else ``fn``."""
    if cfg.remat != "full":
        return fn
    return lambda *a, **kw: checkpoint(fn, *a, use_reentrant=False, **kw)


def _blocks(x, stacked, n: int, cfg, **kw):
    """The ``n`` stacked attention blocks in turn; returns (x, the sum of
    their aux losses)."""
    block = _remat(_attn_mlp_block, cfg)
    auxs = []
    for lp in _layers(stacked, n):
        x, aux = block(x, lp, cfg, **kw)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def _hybrid_group(x, group, shared, cfg, window):
    """One hybrid group: its SSM blocks (the layers of ``group``), then
    the shared attention+MLP block."""
    block = _remat(_ssm_block, cfg)
    for lp in group:
        x = block(x, lp, cfg)
    return _attn_mlp_block(x, shared, cfg, window=window)[0]


def _embed_input(params, batch, cfg):
    """Tokens, after the projected patch embeddings when the config has
    a vision prefix -> (B, S_total, D)."""
    x = L.embed_tokens(batch["tokens"], params["embed"], cfg)
    if cfg.vision_patches:
        vis = (batch["patch_embeds"] @ params["vis_proj"]).to(x.dtype)
        x = torch.cat([vis, x], dim=1)
    return x


def _encoder(params, frames, cfg):
    """The enc-dec encoder stack (non-causal) and its final norm."""
    enc, _ = _blocks(frames, params["enc"]["blocks"], cfg.encoder_layers,
                     cfg, causal=False)
    return _norm(enc, params["enc"]["ln_f"], cfg)


def forward(params, batch, cfg):
    """Returns (logits (B,S,V_pad), aux_loss): aux is the sum of the MoE
    layers' load-balance losses (0 without experts). An enc-dec batch
    carries ``frames`` (B, encoder_seq, D), a VLM batch ``patch_embeds``
    (B, vision_patches, D); a VLM's logits cover its text positions."""
    window = cfg.sliding_window
    if cfg.family == "encdec":
        enc = _encoder(params, batch["frames"], cfg)
        x = L.embed_tokens(batch["tokens"], params["embed"], cfg)
        x, aux = _blocks(x, params["blocks"], cfg.num_layers, cfg,
                         enc_out=enc, cross=True)
    elif cfg.family == "ssm":
        x = _embed_input(params, batch, cfg)
        block = _remat(_ssm_block, cfg)
        for lp in _layers(params["blocks"], cfg.num_layers):
            x = block(x, lp, cfg)
        aux = _zero_aux(x)
    elif cfg.family == "hybrid":
        # as in the reference, under remat each SSM block is checkpointed
        # inside its group and the group around them
        x = _embed_input(params, batch, cfg)
        g, per = hybrid_shape(cfg)
        layers = _layers(params["blocks"], cfg.num_layers)
        group = _remat(_hybrid_group, cfg)
        for gi in range(g):
            x = group(x, layers[gi * per:(gi + 1) * per], params["shared"],
                      cfg, window)
        aux = _zero_aux(x)
    else:
        x = _embed_input(params, batch, cfg)
        x, aux = _blocks(x, params["blocks"], cfg.num_layers, cfg,
                         window=window)
    x = _norm(x, params["ln_f"], cfg)
    logits = L.lm_logits(x, params["embed"], cfg)
    if cfg.vision_patches:
        logits = logits[:, cfg.vision_patches:, :]      # text positions
    return logits, aux


def loss_fn(params, batch, cfg):
    """Weighted next-token cross-entropy, in float32.

    ``batch["weights"]`` (B,) are per-sample weights from the
    network-aware data-movement plan (0 = discarded sample); the loss is
    normalised by the total processed weight (at least 1), as in eqs.
    (1)/(4) of the paper. Returns (loss + 0.01·aux, {"ce", "aux"}).
    """
    logits, aux = forward(params, batch, cfg)
    loss = token_loss(logits, batch["labels"], batch.get("weights"))
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def _log_likelihood(logits, labels):
    """log p(label) of each position, in float32. The pick is
    ``nll_loss`` rather than a gather: loss parallelism has handlers for
    the log-softmax and ``nll_loss`` pair only. It takes the (B·S, V)
    rows, a view: on (B, V, S) ``nll_loss`` would copy the
    log-probabilities into that layout and keep the copy for the
    backward."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = F.nll_loss(logp.flatten(0, 1), labels.flatten(), reduction="none")
    return -nll.view_as(labels)


def token_loss(logits, labels, weights=None):
    """``loss_fn``'s cross-entropy of (B, S, V) logits: the mean of
    -log p(label) over the tokens, each weighted by its sample's weight
    (1 without ``weights``), over the total weight (at least 1). On
    DTensors the log-softmax and the pick run on the vocab shards
    (:func:`repro_torch.distributed.sharding.on_vocab_shards`), inside
    the ``loss_parallel()`` that ``steps.grads_of`` enters."""
    ll = on_vocab_shards(_log_likelihood, logits, labels.long())
    if weights is None:
        weights = torch.ones(labels.shape[:1], dtype=torch.float32,
                             device=ll.device)
    tok_w = weights[:, None] * torch.ones_like(ll)
    return -(ll * tok_w).sum() / torch.clamp(tok_w.sum(), min=1.0)


def encode(params, frames, cfg):
    """Encoder pass of an enc-dec arch: (enc_out (B,S_enc,D), cross_k,
    cross_v), the cross K/V stacked over the decoder layers as
    (L,B,KH,S_enc,hd): the decode-time cross-attention cache."""
    enc = _encoder(params, frames, cfg)
    kv = [L.cross_kv(enc, lp, cfg)
          for lp in _layers(params["blocks"]["xattn"], cfg.num_layers)]
    return enc, torch.stack([k for k, _ in kv]), \
        torch.stack([v for _, v in kv])


# ---------------------------------------------------------------------------
# Decode (serve step)
# ---------------------------------------------------------------------------


def cache_len_for(cfg, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache_specs(cfg, batch: int, seq_len: int) -> dict:
    cl = cache_len_for(cfg, seq_len)
    if cfg.family == "ssm":
        return S.init_ssm_cache_specs(cfg, batch, cfg.num_layers)
    if cfg.family == "hybrid":
        g, _ = hybrid_shape(cfg)
        c = S.init_ssm_cache_specs(cfg, batch, cfg.num_layers)
        c["attn"] = L.init_cache_specs(cfg, batch, cl, g, groups_axis="groups")
        return c
    c = L.init_cache_specs(cfg, batch, cl, cfg.num_layers)
    if cfg.family == "encdec":
        # the encoder's K/V for every decoder layer, filled by ``encode``
        for name in ("cross_k", "cross_v"):
            c[name] = Spec((cfg.num_layers, batch, cfg.num_kv_heads,
                            cfg.encoder_seq, cfg.head_dim),
                           ("layers", "batch", None, "cache_seq", None),
                           init="zeros")
    return c


def _ssm_decode_block(x, params, cache, i, cfg):
    lp = _layer(params["blocks"], i)
    h, _ = S.ssm_decode(_norm(x, lp["ln"], cfg), lp["ssm"], cfg,
                        {"h": cache["h"][i], "conv": cache["conv"][i]})
    return x + h


def _attn_mlp_decode(x, lp, cfg, cache, pos, window):
    """One block's decode step; an enc-dec block adds cross attention
    against the encoder's K/V in its cache (no cache write)."""
    h, _ = L.decode_attention(_norm(x, lp["ln1"], cfg), lp["attn"], cfg,
                              cache, pos, window=window)
    x = x + h
    if cfg.family == "encdec":
        x = x + L.cross_decode_attention(_norm(x, lp["ln_x"], cfg),
                                         lp["xattn"], cfg, cache["cross_k"],
                                         cache["cross_v"])
    if cfg.num_experts:
        h, _ = M.moe_apply(_norm(x, lp["ln2"], cfg), lp["moe"], cfg)
    else:
        h = L.mlp_apply(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg)
    return x + h


def decode_step(params, cache, batch, pos: int, cfg):
    """One-token decode. batch['tokens'] (B,1). Updates the cache in
    place and returns (logits (B,1,V_pad), cache). A VLM decodes text
    only, as in the reference; an MoE layer dispatches the B tokens of
    the step with its own capacity."""
    window = cfg.sliding_window
    tok = batch["tokens"]
    x = L.embed_tokens(tok, params["embed"], cfg, positions=(
        torch.full((1,), pos, dtype=torch.long, device=tok.device)
        if cfg.pos_embed == "learned" else None))
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
