"""Mamba2 SSD (state-space duality) blocks [arXiv:2405.21060] (the port
of :mod:`repro.models.ssm`).

The prefill path runs the chunked scan through
:func:`repro_torch.kernels.ops.ssd` (the hand-written kernel on the
card, its plain version on the CPU) in the kernel's (B, H, S, P)
layout; decode is the O(1)-state recurrent step in plain torch, as in
the reference. Projections are kept separate (w_z / w_x / w_B / w_C /
w_dt) as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import gather_dims
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
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    Bm = x @ p["w_B"]
    Cm = x @ p["w_C"]
    dt = x @ p["w_dt"]

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
                chunk=cfg.ssm_chunk).transpose(1, 2).to(x.dtype)
    y = y + p["D_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, H * P)
    y = rmsnorm(y * F.silu(upcast(z)).to(y.dtype), p["norm"])
    return y @ p["w_out"]


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
    and returns (out (B,1,D), cache)."""
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
    xh = upcast(gather_dims(xs, (1,)).reshape(B, H, P))
    # h <- h * decay + dt * (B ⊗ x)
    h = (cache["h"] * decay[:, :, None, None]
         + (dt[:, :, None] * xh)[..., None] * Bm[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, Cm)                    # (B,H,P)
    y = y + p["D_skip"][None, :, None] * xh
    y = gather_dims(y, (1, 2)).reshape(B, H * P).to(x.dtype)
    y = rmsnorm(y * F.silu(upcast(z)).to(y.dtype), p["norm"])
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:, :])
    return (y @ p["w_out"])[:, None, :], cache
