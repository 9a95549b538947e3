"""Flash attention forward: ``softmax(q·kᵀ/√hd + mask)·v`` with a causal
mask, an optional sliding window (``k > q − window``) and grouped K/V
heads.

q is (B, H, Sq, hd), k and v (B, KH, Sk, hd), all float32 or all
bfloat16; the result has their type. bfloat16 is widened to float32 and
the arithmetic is float32, as in the Pallas kernel. q head h reads K/V
head ``kv_map[h]``. Query i and key j sit at positions i and j (both
from 0), as in the reference. A row that the masks leave with no key
gives 0, as the Pallas kernel and ``ref.flash_attention_ref`` do.

On a CUDA tensor :func:`flash_attention` launches the hand-written
kernel in ``csrc/flash_attention.cu`` (it replaces the Pallas TPU
kernel of :mod:`repro.kernels.flash_attention`; its products run on the
tensor cores by 3xTF32, and the source says what bounds it and how). On
a CPU tensor it runs :func:`flash_attention_plain`, the plain PyTorch
version of ``ref.flash_attention_ref`` with the explicit head map, which
the card also uses as the kernel's yardstick.

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

# the input types the kernel takes, and the code its C entry point reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global launches
    launches = 0


def widen(x):
    """bfloat16 -> float32, as the kernels load it; other types as they
    are."""
    return x.float() if x.dtype == torch.bfloat16 else x


def flash_attention_plain(q, k, v, kv_map, *, causal=True, window=None):
    """Materialised scores in float32 (float64 stays float64), masked
    softmax, fully masked rows -> 0; the result in q's type."""
    out_dtype = q.dtype
    q, k, v = widen(q), widen(k), widen(v)
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
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(out_dtype)


def default_kv_map(H: int, KH: int) -> torch.Tensor:
    """``h // (H // KH)``: the Pallas kernel's head map."""
    return (torch.arange(H) // (H // KH)).to(torch.int32)


def _check(q, k, v, kv_map, window, check_entries):
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.dim() != 4:
            raise ValueError(f"{name} must be 4-D; got {tuple(a.shape)}")
        if a.dtype not in DTYPES or a.dtype != q.dtype:
            raise TypeError(f"q, k and v must all be torch.float32 or all "
                            f"torch.bfloat16; got {name} {a.dtype}, q "
                            f"{q.dtype}")
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
    if check_entries and H and (int(kv_map.min()) < 0
                                or int(kv_map.max()) >= KH):
        raise ValueError(f"kv_map entries must lie in [0, {KH})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1; got {window}")


def flash_attention(q, k, v, kv_map=None, *, causal=True, window=None):
    """q (B,H,Sq,hd), k/v (B,KH,Sk,hd), float32 or bfloat16 ->
    (B,H,Sq,hd) of q's type. ``kv_map`` (H,) integers (default ``h //
    (H // KH)``), on the host, where its entries are checked and then
    copied to the card at every call, or already on q's card, where the
    caller guarantees them in [0, KH) (a check there would wait for the
    card). The kernel on CUDA tensors (one launch), the plain version on
    CPU tensors."""
    global launches
    if kv_map is None:
        H, KH = q.shape[1], k.shape[1]
        if KH < 1 or H % KH:
            raise ValueError(f"H={H} is not a multiple of KH={KH}; pass "
                             "kv_map")
        kv_map = default_kv_map(H, KH)
    kv_map = torch.as_tensor(kv_map)
    if kv_map.dtype.is_floating_point or kv_map.dtype == torch.bool:
        raise TypeError(f"kv_map must hold integers; got {kv_map.dtype}")
    on_card = kv_map.device == q.device and q.device.type == "cuda"
    kv_map = (kv_map if on_card else kv_map.cpu()).to(torch.int32)
    _check(q, k, v, kv_map, window, check_entries=not on_card)
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
    km = kv_map.to(q.device).contiguous()
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(),
                 out.data_ptr(), B, H, KH, Sq, Sk, hd, int(causal),
                 -1 if window is None else int(window), DTYPES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
