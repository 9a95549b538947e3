"""Mamba2 SSD (state-space duality) blocks [arXiv:2405.21060] (the port
of :mod:`repro.models.ssm`).

The prefill path runs the chunked scan through
:func:`repro_torch.kernels.ops.ssd` (the hand-written kernel on the
card, its plain version on the CPU: the chunk-by-chunk one under
``cfg.ssm_streaming``, as the reference switches to
``ssd_chunked_streaming``) in the kernel's (B, H, S, P) layout; decode
is the O(1)-state recurrent step in plain torch, as in the reference,
on DTensors on each rank's own heads.
Projections are kept separate (w_z / w_x / w_B / w_C / w_dt) as in the
reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.distributed.sharding import (local_range, rows_of,
                                              rows_product, shard_reduce,
                                              stream_product)
from repro_torch.kernels import ops
from repro_torch.models.layers import rmsnorm, upcast
from repro_torch.models.module import Spec

KCONV = 4  # causal depthwise conv window (mamba2 default)


def ssm_specs(cfg, layers_axis: int | None = None) -> dict:
    D, DI, H = cfg.d_model, cfg.ssm_inner, cfg.ssm_heads
    GN = cfg.ssm_groups * cfg.ssm_state

    def mk(shape, axes, **kw):
        if layers_axis is not None:
            return Spec((layers_axis, *shape), ("layers", *axes), **kw)
        return Spec(shape, axes, **kw)

    return {
        "w_z": mk((D, DI), ("embed", "ssm_inner")),
        "w_x": mk((D, DI), ("embed", "ssm_inner")),
        "w_B": mk((D, GN), ("embed", None)),
        "w_C": mk((D, GN), ("embed", None)),
        "w_dt": mk((D, H), ("embed", "ssm_heads")),
        "conv_w": mk((DI, KCONV), ("ssm_inner", None), init="small"),
        "conv_b": mk((DI,), ("ssm_inner",), init="zeros"),
        "A_log": mk((H,), ("ssm_heads",), init="zeros"),
        "dt_bias": mk((H,), ("ssm_heads",), init="zeros"),
        "D_skip": mk((H,), ("ssm_heads",), init="ones"),
        "norm": mk((DI,), ("ssm_inner",), init="ones"),
        "w_out": mk((DI, D), ("ssm_inner", "embed")),
    }


def causal_conv1d(x, w, b):
    """Depthwise causal conv. x (B,S,C); w (C,K); b (C,)."""
    K, S = w.shape[-1], x.shape[1]
    # zeros before the sequence by a concatenation, not F.pad (which
    # DTensor cannot redistribute in torch 2.11): the same values
    xp = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[2])), x], dim=1)
    out = xp[:, 0:S, :] * w[:, 0]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[:, i]
    return out + b


def ssm_apply(x, p, cfg):
    """Full Mamba2 block (train/prefill). x (B,S,D) -> (B,S,D)."""
    B, S, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    z, xs, Bm, Cm, dt = (stream_product(x, p[n]) for n in (
        "w_z", "w_x", "w_B", "w_C", "w_dt"))

    xs = F.silu(upcast(causal_conv1d(xs, p["conv_w"], p["conv_b"]))) \
        .to(x.dtype)
    dt = F.softplus(upcast(dt) + p["dt_bias"])
    A = -torch.exp(upcast(p["A_log"]))
    a = dt * A                                        # (B,S,H)

    xh = xs.reshape(B, S, H, P)
    xdt = (upcast(xh) * dt[..., None]).to(x.dtype)
    y = ops.ssd(xdt.transpose(1, 2).contiguous(),
                a.transpose(1, 2).contiguous(),
                Bm.contiguous(), Cm.contiguous(),
                chunk=cfg.ssm_chunk, streaming=cfg.ssm_streaming
                ).transpose(1, 2).to(x.dtype)
    y = y + p["D_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, H * P)
    y = rmsnorm(y * F.silu(upcast(z)).to(y.dtype), p["norm"])
    return stream_product(y, p["w_out"])


# -- decode ------------------------------------------------------------------


def init_ssm_cache_specs(cfg, batch: int, layers: int) -> dict:
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    return {
        "h": Spec((layers, batch, H, P, N),
                  ("layers", "batch", "ssm_heads", None, None),
                  init="zeros", dtype=torch.float32),
        "conv": Spec((layers, batch, KCONV - 1, cfg.ssm_inner),
                     ("layers", "batch", None, "ssm_inner"), init="zeros"),
    }


def ssm_decode(x, p, cfg, cache):
    """Single-token recurrent step. x (B,1,D); cache {h, conv} of this
    layer. Updates the cache in place (the reference returns a new one)
    and returns (out (B,1,D), cache). DTensors run on each rank's own
    heads (:func:`_decode_on_shards`)."""
    if isinstance(x, DTensor):
        return _decode_on_shards(x, p, cfg, cache)
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    xt = x[:, 0]                                       # (B,D)
    z = xt @ p["w_z"]
    xs = xt @ p["w_x"]
    Bm = upcast(xt @ p["w_B"])                         # (B,N)
    Cm = upcast(xt @ p["w_C"])
    dt = xt @ p["w_dt"]

    # conv over [cached last K-1 inputs, current]
    hist = torch.cat([cache["conv"], xs[:, None, :]], dim=1)   # (B,K,DI)
    xs = torch.einsum("bki,ik->bi", hist, p["conv_w"]) + p["conv_b"]
    xs = F.silu(upcast(xs)).to(x.dtype)

    dt = F.softplus(upcast(dt) + p["dt_bias"])                 # (B,H)
    A = -torch.exp(upcast(p["A_log"]))
    decay = torch.exp(dt * A)                                  # (B,H)
    xh = upcast(xs.reshape(B, H, P))
    # h <- h * decay + dt * (B ⊗ x)
    h = (cache["h"] * decay[:, :, None, None]
         + (dt[:, :, None] * xh)[..., None] * Bm[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, Cm)                    # (B,H,P)
    y = y + p["D_skip"][None, :, None] * xh
    y = y.reshape(B, H * P).to(x.dtype)
    y = rmsnorm(y * F.silu(upcast(z)).to(y.dtype), p["norm"])
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:, :])
    return (y @ p["w_out"])[:, None, :], cache


def _decode_on_shards(x, p, cfg, cache, eps: float = 1e-6):
    """``ssm_decode`` of DTensors on each rank's batch rows, heads and
    the inner columns of those heads, as the reference's rules lay them
    out (``ssm_specs``; the cache's ``ssm_heads`` and ``ssm_inner``):
    z, xs and dt come from the local columns of w_z, w_x and w_dt, B
    and C from the whole (replicated) w_B and w_C; the conv, its cache,
    A, dt's bias, D and the norm's scale are the local shards. The state
    update and the readout run on the local heads of h, and h and conv
    are written in place into the rank's local storage of the cache
    (``cache``'s local tensors: :func:`repro_torch.distributed.sharding.
    layer_view` makes them views of the stacked cache's). The gated
    RMSNorm's mean of squares is a local sum all-reduced over the mesh
    dims that shard the inner width, and w_out multiplies its local rows
    (:func:`repro_torch.distributed.sharding.rows_product`): two small
    all-reduces a layer, nothing gathered. Where the head count does not
    divide the model extent the heads are whole on every rank (so is h,
    by the divisibility guard); the inner columns, still sharded, are
    then gathered after the conv (one token's (B_l, DI)) and each rank
    keeps its own columns of y for the norm and w_out."""
    hc, cc = cache["h"], cache["conv"]        # (B,H,P,N), (B,K-1,DI)
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    mesh = hc.device_mesh
    h0, hn = local_range(hc, 1)
    lo, n = local_range(cc, 2)
    if (any(local_range(p[k], 1) != (lo, n) for k in ("w_z", "w_x"))
            or local_range(p["w_dt"], 1) != (h0, hn)
            or (hn < H and (lo, n) != (h0 * P, hn * P))):
        raise ValueError("ssm decode: the heads, the inner columns and "
                         "the cache are not sharded alike")
    xt = rows_of(x, hc)[:, 0]                          # (B_l,D)
    z, xs, dt, Bm, Cm = (xt @ p[k].to_local() for k in (
        "w_z", "w_x", "w_dt", "w_B", "w_C"))
    Bm, Cm = upcast(Bm), upcast(Cm)                     # (B_l,N), whole

    hist = torch.cat([cc.to_local(), xs[:, None, :]], dim=1)  # (B_l,K,n)
    xs = (torch.einsum("bki,ik->bi", hist, p["conv_w"].to_local())
          + p["conv_b"].to_local())
    xs = F.silu(upcast(xs)).to(x.dtype)
    whole = hn * P > n                # the heads whole, the columns not
    if whole:
        inner = [Shard(1) if isinstance(q, Shard) and q.dim == 2 else q
                 for q in cc.placements]
        xs = rows_of(DTensor.from_local(
            xs, mesh, inner, run_check=False, shape=(cc.shape[0], H * P),
            stride=(H * P, 1)), cc)

    dt = F.softplus(upcast(dt) + p["dt_bias"].to_local())     # (B_l,hn)
    A = -torch.exp(upcast(p["A_log"].to_local()))
    decay = torch.exp(dt * A)
    Bl = xt.shape[0]
    xh = upcast(xs.reshape(Bl, hn, P))
    h = (hc.to_local() * decay[:, :, None, None]
         + (dt[:, :, None] * xh)[..., None] * Bm[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, Cm)
    y = y + p["D_skip"].to_local()[None, :, None] * xh
    y = y.reshape(Bl, hn * P).to(x.dtype)
    if whole:                                 # this rank's inner columns
        y = y[:, lo:lo + n]
    g = upcast(y * F.silu(upcast(z)).to(y.dtype))
    ss = (g * g).sum(dim=-1, keepdim=True)
    reduce = shard_reduce(cc, 2)
    if reduce is not None:
        ss = reduce(ss, "sum")
    y = (g * torch.rsqrt(ss / (H * P) + eps)).to(x.dtype) \
        * p["norm"].to_local()
    hc.to_local().copy_(h)
    cc.to_local().copy_(hist[:, 1:, :])
    return rows_product(y[:, None, :], p["w_out"], hc, local=True), cache
