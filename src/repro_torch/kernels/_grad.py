"""The guard of the kernel wrappers that have no backward yet.

Their CUDA kernels fill an output tensor through ``ctypes``, so autograd
cannot see through them, and a gradient would stop there without a
word. Until their backward is ported (ROADMAP.md, queue 1 item 14a)
they refuse inputs that require grad, on the card and on the CPU alike.
"""
from __future__ import annotations

import torch

BACKWARD_ITEM = "ROADMAP.md, queue 1 item 14a"


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward yet ({BACKWARD_ITEM}); call it on "
            "inputs that do not require grad, or under torch.no_grad()")
