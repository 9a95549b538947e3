"""Flash attention forward: ``softmax(q·kᵀ/√hd + mask)·v`` with a causal
mask, an optional sliding window (``k > q − window``) and grouped K/V
heads.

q is (B, H, Sq, hd), k and v (B, KH, Sk, hd), float32; q head h reads
K/V head ``kv_map[h]``. Query i and key j sit at positions i and j
(both from 0), as in the reference. A row that the masks leave with no
key gives 0, as the Pallas kernel and ``ref.flash_attention_ref`` do.

On a CUDA tensor :func:`flash_attention` launches the hand-written
kernel in ``csrc/flash_attention.cu`` (it replaces the Pallas TPU
kernel of :mod:`repro.kernels.flash_attention`; the source says what
bounds it and how). On a CPU tensor it runs
:func:`flash_attention_plain`, the plain PyTorch version of
``ref.flash_attention_ref`` with the explicit head map, which the card
also uses as the kernel's yardstick.

``launches`` counts kernel launches (never plain-version calls), so a
run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = 0

MAX_HEAD_DIM = 128


def reset_launches() -> None:
    global launches
    launches = 0


def flash_attention_plain(q, k, v, kv_map, *, causal=True, window=None):
    """Materialised f32 scores, masked softmax, fully masked rows -> 0."""
    hd = q.shape[-1]
    Sq, Sk = q.shape[2], k.shape[2]
    idx = kv_map.long()
    kx, vx = k[:, idx], v[:, idx]
    s = torch.einsum("bhqd,bhkd->bhqk", q, kx) / math.sqrt(hd)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx)


def default_kv_map(H: int, KH: int) -> torch.Tensor:
    """``h // (H // KH)``: the Pallas kernel's head map."""
    return (torch.arange(H) // (H // KH)).to(torch.int32)


def _check(q, k, v, kv_map, window):
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.dim() != 4:
            raise ValueError(f"{name} must be 4-D; got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32; got {a.dtype} "
                            "(bfloat16 is later work, ROADMAP.md queue 2)")
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")
    B, H, Sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, KH, Sk, {hd}) with B={B}; "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    KH = k.shape[1]
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} outside 1..{MAX_HEAD_DIM}")
    if tuple(kv_map.shape) != (H,):
        raise ValueError(f"kv_map must be ({H},); got {tuple(kv_map.shape)}")
    if H and (int(kv_map.min()) < 0 or int(kv_map.max()) >= KH):
        raise ValueError(f"kv_map entries must lie in [0, {KH})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1; got {window}")


def flash_attention(q, k, v, kv_map=None, *, causal=True, window=None):
    """q (B,H,Sq,hd), k/v (B,KH,Sk,hd) float32 -> (B,H,Sq,hd) float32.
    ``kv_map`` (H,) integers on the host (default ``h // (H // KH)``). The
    kernel on CUDA tensors (one launch), the plain version on CPU
    tensors."""
    global launches
    if kv_map is None:
        H, KH = q.shape[1], k.shape[1]
        if KH < 1 or H % KH:
            raise ValueError(f"H={H} is not a multiple of KH={KH}; pass "
                             "kv_map")
        kv_map = default_kv_map(H, KH)
    kv_map = torch.as_tensor(kv_map).cpu()
    if kv_map.dtype.is_floating_point or kv_map.dtype == torch.bool:
        raise TypeError(f"kv_map must hold integers; got {kv_map.dtype}")
    kv_map = kv_map.to(torch.int32)
    _check(q, k, v, kv_map, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_map, causal=causal,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, Sq, hd = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    km = kv_map.to(q.device)
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(),
                 out.data_ptr(), B, H, KH, Sq, Sk, hd, int(causal),
                 -1 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
