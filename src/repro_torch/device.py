"""Device resolution and float32 numerics.

The reference trains in full float32. On the card, cuDNN convolutions
use TF32 unless told otherwise, so every resolved device also turns
TF32 off for convolutions and matrix products.
"""
from __future__ import annotations

import torch


def set_f32_numerics() -> None:
    """Full float32 for cuDNN convolutions and cuBLAS matrix products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Asking for ``cuda`` on a machine without
    a card raises: nothing falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (--device cpu) to run on the CPU")
    set_f32_numerics()
    return dev


def synchronize(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    host clock read after it times the work and not its enqueueing."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
