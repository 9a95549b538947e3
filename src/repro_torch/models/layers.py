"""Transformer layers: norms, RoPE, GQA attention (prefill and decode),
SwiGLU/ReLU²/GELU MLPs, embeddings (the port of
:mod:`repro.models.layers`).

Conventions are the reference's:

* activations are (batch, seq, d_model) — "B, S, D";
* q heads are padded at config time to ``cfg.num_heads_padded``; padded
  q heads read K/V head 0 (:func:`kv_head_map`);
* weights are (in, out) with any stacked ``layers`` axis leading.

Prefill attention always goes through :func:`repro_torch.kernels.ops.
attention` (the hand-written flash kernel on the card, its plain
version on the CPU), in the kernel's (B, H, S, hd) layout, cross
attention (Sq != Sk, non-causal) included; the reference's choice
between full and blocked attention is one function here. Decode
attention, self and cross, is plain torch, as in the reference; on a
DTensor cache it runs on each rank's local slots.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.distributed.sharding import (pin, rows_of, rows_product,
                                              shard_reduce, stream_product,
                                              vocab_lookup, write_slot)
from repro_torch.kernels import ops
from repro_torch.models.module import Spec

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def upcast(x):
    """x in float32, or as it is when float64: norms, softmax and
    activations compute in at least float32, as in the reference, and a
    float64 run stays float64 throughout."""
    return x if x.dtype == torch.float64 else x.float()


def rmsnorm_spec(dim: int, axis: str = "embed") -> Spec:
    return Spec((dim,), (axis,), init="ones")


def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = upcast(x)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm_specs(dim: int) -> dict:
    return {"scale": Spec((dim,), ("embed",), init="ones"),
            "bias": Spec((dim,), ("embed",), init="zeros")}


def layernorm(x, p, eps: float = 1e-5):
    x32 = upcast(x)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"] + p["bias"]


def apply_norm(x, p, kind: str):
    return rmsnorm(x, p) if kind == "rmsnorm" else layernorm(x, p)


def norm_spec(dim: int, kind: str):
    return rmsnorm_spec(dim) if kind == "rmsnorm" else layernorm_specs(dim)


# ---------------------------------------------------------------------------
# RoPE (GPT-NeoX rotate-half convention)
# ---------------------------------------------------------------------------


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions (...,) int -> cos, sin (..., head_dim // 2) float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), exps)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B,S,H,hd); cos/sin (B,S,half) or (S,half)."""
    half = x.shape[-1] // 2
    x1, x2 = upcast(x[..., :half]), upcast(x[..., half:])
    if cos.dim() == 2:       # (S, half) -> broadcast over batch and heads
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:                    # (B, S, half)
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_specs(cfg, layers_axis: int | None = None) -> dict:
    """Parameter specs for one (or a stack of) attention layer(s)."""
    D, hd = cfg.d_model, cfg.head_dim
    Hp, KH = cfg.num_heads_padded, cfg.num_kv_heads

    def mk(shape, axes, **kw):
        if layers_axis is not None:
            return Spec((layers_axis, *shape), ("layers", *axes), **kw)
        return Spec(shape, axes, **kw)

    p = {
        "wq": mk((D, Hp * hd), ("embed", "heads")),
        "wk": mk((D, KH * hd), ("embed", "kv_heads")),
        "wv": mk((D, KH * hd), ("embed", "kv_heads")),
        "wo": mk((Hp * hd, D), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = mk((Hp * hd,), ("heads",), init="zeros")
        p["bk"] = mk((KH * hd,), ("kv_heads",), init="zeros")
        p["bv"] = mk((KH * hd,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = mk((hd,), ("head_dim",), init="ones")
        p["k_norm"] = mk((hd,), ("head_dim",), init="ones")
    return p


def _project_qkv(x, p, cfg, kv_input=None):
    """Project to q (B,S,Hp,hd) and k, v (B,Skv,KH,hd); K and V come from
    ``kv_input`` (B,Skv,D) when given (cross attention), else from x."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    kv_in = x if kv_input is None else kv_input
    q, k, v = (stream_product(x, p["wq"]), stream_product(kv_in, p["wk"]),
               stream_product(kv_in, p["wv"]))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # pinned: on DTensors the gradients come back in the placements the
    # views left, which the merge of (heads, hd) needs
    q = pin(q.reshape(B, S, cfg.num_heads_padded, hd))
    k = pin(k.reshape(B, kv_in.shape[1], cfg.num_kv_heads, hd))
    v = pin(v.reshape(B, kv_in.shape[1], cfg.num_kv_heads, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return q, k, v


def kv_head_map(cfg, device=None) -> torch.Tensor:
    """Padded q-head index -> kv head index (padded heads map to 0), int32,
    computed on ``device`` (no copy from the host, so the card need not
    wait): every entry lies in [0, num_kv_heads)."""
    H, KH, Hp = cfg.num_heads, cfg.num_kv_heads, cfg.num_heads_padded
    h = torch.arange(Hp, dtype=torch.int32, device=device)
    return torch.where(h < H, h // (H // KH), 0)


def attention_apply(x, p, cfg, *, causal=True, kv_input=None,
                    positions=None, window=None):
    """Train/prefill attention for one layer. x (B,S,D) -> (B,S,D). Self
    attention, or cross attention against ``kv_input`` (B,Skv,D), which
    takes no RoPE. The scores go through ``ops.attention`` in the
    kernel's (B,H,S,hd) layout, with the reference's padded-head map."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, kv_input=kv_input)
    if cfg.rope and kv_input is None:
        pos = positions if positions is not None else \
            torch.arange(S, device=x.device)
        cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = ops.attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(),
                        causal=causal, window=window,
                        kv_map=kv_head_map(cfg, x.device))
    out = out.transpose(1, 2).reshape(B, S, cfg.num_heads_padded
                                      * cfg.head_dim)
    return stream_product(out, p["wo"])


# -- decode with KV cache ----------------------------------------------------
#
# Cache layout per layer: k, v (B, KH, S_cache, hd); slot_pos (S_cache,)
# int32 holds the absolute position stored in each slot (-1 = empty).
# Sliding-window archs use a ring buffer (S_cache = window).


def init_cache_specs(cfg, batch: int, cache_len: int, layers: int,
                     groups_axis: str = "layers"):
    B, KH, hd = batch, cfg.num_kv_heads, cfg.head_dim
    return {
        "k": Spec((layers, B, KH, cache_len, hd),
                  (groups_axis, "batch", None, "cache_seq", None),
                  init="zeros"),
        "v": Spec((layers, B, KH, cache_len, hd),
                  (groups_axis, "batch", None, "cache_seq", None),
                  init="zeros"),
        # -1 = empty slot: unwritten positions must never be attended
        "slot_pos": Spec((layers, cache_len), (groups_axis, "cache_seq"),
                         init="fill", scale=-1, dtype=torch.int32),
    }


def decode_attention(x, p, cfg, cache, pos: int, *, window=None):
    """One-token decode. x (B,1,D); cache {k, v, slot_pos} of THIS layer
    (no leading layer dim); pos the absolute position. Writes the new
    K/V into the cache in place (the reference returns a new cache; the
    in-place write saves a copy of every cache per token) and returns
    (out (B,1,D), cache). A DTensor cache runs on its local slots
    (:func:`_attend_on_shards`)."""
    B = x.shape[0]
    hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q, k_new, v_new = _project_qkv(x, p, cfg)
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    if isinstance(k, DTensor):
        # one token's q heads, K and V, whole on this rank's batch rows
        q, k_new, v_new = (rows_of(t, k) for t in (q, k_new, v_new))
    q = q[:, :, :H, :]                 # padded heads take no part in decode
    if cfg.rope:
        # a fill on the device, not a host copy (which would wait for
        # the stream at every layer of every token)
        cos, sin = rope_cos_sin(torch.full((1,), pos, device=q.device), hd,
                                cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    slot = pos % k.shape[2]            # ring for SWA; == pos when it fits
    if isinstance(k, DTensor):
        write_slot(k, 2, slot, k_new[:, 0])
        write_slot(v, 2, slot, v_new[:, 0])
        write_slot(slot_pos, 0, slot, pos)
        valid = _visible(slot_pos.to_local(), pos, window)
        return _attend_on_shards(x, q, k, v, valid, p["wo"], cfg), cache
    k[:, :, slot] = k_new[:, 0]
    v[:, :, slot] = v_new[:, 0]
    slot_pos[slot] = pos

    qg = q.reshape(B, KH, H // KH, hd)
    s = upcast(torch.einsum("bgrh,bgsh->bgrs", qg, k)) / math.sqrt(hd)
    s = s.masked_fill(~_visible(slot_pos, pos, window), float("-inf"))
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    og = torch.einsum("bgrs,bgsh->bgrh", pr, v)
    out = og.reshape(B, 1, H * hd) @ p["wo"][:H * hd]
    return out, cache


def _visible(slot_pos, pos: int, window):
    """The slots a decode step at ``pos`` attends: written ones, inside
    the window; the current token is always visible."""
    valid = slot_pos >= 0
    if window is not None:
        valid &= slot_pos > pos - window
    valid |= slot_pos == pos
    return valid


def _attend_on_shards(x, q, k, v, valid, wo, cfg):
    """Decode attention against a DTensor cache on each rank's local
    slots, as the reference's comment has it ("contract against the
    seq-sharded cache; softmax over the sharded seq dim lowers to small
    all-reduces"). q (B_l,1,H,hd) is local, whole on the model axis, on
    k's batch rows; k, v (B,KH,S,hd) are DTensors; ``valid`` masks the
    local slots (None: all visible). The scores are the local slots';
    the max over the slots is all-reduced (MAX), and each rank's sum of
    exp and its p·v are summed over the mesh dims that shard the slots.
    A rank whose slots are all masked adds exact zeros: its exp is taken
    against the global max, which the visible current token makes
    finite. Where the slots are whole on every rank this is the plain
    softmax. The output projection multiplies wo's local rows
    (:func:`rows_product`); no head, no weight and no slot is
    gathered."""
    Bl, hd, H, KH = q.shape[0], cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    kl, vl = k.to_local(), v.to_local()
    qg = q.reshape(Bl, KH, H // KH, hd)
    s = upcast(torch.einsum("bgrh,bgsh->bgrs", qg, kl)) / math.sqrt(hd)
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    reduce = shard_reduce(k, 2)
    if reduce is None:
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        og = torch.einsum("bgrs,bgsh->bgrh", pr, vl)
    else:
        e = torch.exp(s - reduce(s.amax(dim=-1, keepdim=True), "max"))
        pr = (e / reduce(e.sum(dim=-1, keepdim=True), "sum")).to(x.dtype)
        og = reduce(torch.einsum("bgrs,bgsh->bgrh", pr, vl), "sum")
    return rows_product(og.reshape(Bl, 1, H * hd), wo, k)


def cross_decode_attention(x, p, cfg, k, v):
    """Decode-time cross attention against the encoder's K/V. x (B,1,D);
    k, v (B,KH,S_enc,hd): no cache write, every position visible. Plain
    torch with the padded q heads dropped, as in the reference; DTensor
    K/V on their local positions (:func:`_attend_on_shards`)."""
    B = x.shape[0]
    hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, 1, cfg.num_heads_padded, hd)
    if isinstance(k, DTensor):
        if cfg.qk_norm:                # per head: before or after the drop
            q = rmsnorm(q, p["q_norm"])
        return _attend_on_shards(x, rows_of(q, k)[:, :, :H, :], k, v, None,
                                 p["wo"], cfg)
    q = q[:, :, :H, :]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    qg = q.reshape(B, KH, H // KH, hd)
    s = upcast(torch.einsum("bgrh,bgsh->bgrs", qg, k)) / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    og = torch.einsum("bgrs,bgsh->bgrh", pr, v)
    return og.reshape(B, 1, H * hd) @ p["wo"][:H * hd]


def cross_kv(enc_out, p, cfg):
    """The cross-attention K/V of one decoder layer from the encoder's
    output: enc_out (B,S_enc,D) -> k, v (B,KH,S_enc,hd)."""
    B, Se, _ = enc_out.shape
    hd, KH = cfg.head_dim, cfg.num_kv_heads
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, Se, KH, hd).transpose(1, 2)
    v = v.reshape(B, Se, KH, hd).transpose(1, 2)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    return k, v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_specs(cfg, layers_axis: int | None = None) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff

    def mk(shape, axes):
        if layers_axis is not None:
            return Spec((layers_axis, *shape), ("layers", *axes))
        return Spec(shape, axes)

    if cfg.act == "swiglu":
        return {"w_gate": mk((D, F_), ("embed", "mlp")),
                "w_up": mk((D, F_), ("embed", "mlp")),
                "w_down": mk((F_, D), ("mlp", "embed"))}
    return {"w_up": mk((D, F_), ("embed", "mlp")),
            "w_down": mk((F_, D), ("mlp", "embed"))}


def mlp_apply(x, p, cfg):
    if cfg.act == "swiglu":
        g = stream_product(x, p["w_gate"])
        u = stream_product(x, p["w_up"])
        h = F.silu(upcast(g)).to(x.dtype) * u
    elif cfg.act == "relu2":         # squared ReLU (nemotron/minitron)
        u = stream_product(x, p["w_up"])
        h = torch.square(torch.relu(upcast(u))).to(x.dtype)
    else:                            # jax.nn.gelu's default: tanh form
        u = stream_product(x, p["w_up"])
        h = F.gelu(upcast(u), approximate="tanh").to(x.dtype)
    return stream_product(h, p["w_down"])


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def embed_specs(cfg) -> dict:
    p = {"tok": Spec((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"),
                     init="embed")}
    if not cfg.tie_embeddings:
        p["lm_head"] = Spec((cfg.d_model, cfg.vocab_padded),
                            ("embed", "vocab"), init="normal")
    if cfg.pos_embed == "learned":
        p["pos"] = Spec((cfg.max_positions, cfg.d_model), (None, "embed"),
                        init="embed")
    return p


def embed_tokens(tokens, p, cfg, positions=None):
    """Token (and learned position) embeddings by ``F.embedding``: the
    reference's gather, whose backward is the embedding backward rather
    than an accumulating ``index_put`` (which DTensor cannot shard over
    batch-sharded ids in torch 2.11). A vocab-sharded DTensor table is
    looked up on its local rows (:func:`repro_torch.distributed.
    sharding.vocab_lookup`), whose sum lands on the residual stream's
    placement."""
    tok = p["tok"]
    if isinstance(tok, DTensor) and any(
            isinstance(q, Shard) and q.dim == 0 for q in tok.placements):
        x = vocab_lookup(tokens, tok)
    else:
        x = F.embedding(tokens.long(), tok)
    if cfg.pos_embed == "learned":
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = x + F.embedding(positions, p["pos"])
    return x


def lm_logits(x, p, cfg):
    w = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    return stream_product(x, w)
