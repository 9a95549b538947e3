"""Gradients around kernels that fill their outputs through ``ctypes``,
which autograd cannot see through.

:func:`recompute_grads` is the backward of flash attention and the SSD
scan: their plain versions run again on the saved inputs under autograd.
:func:`refuse_grad` guards ``segment_max``, the one wrapper without a
backward (no ported path differentiates a segment max), so that a
gradient does not stop there without a word, on the card and on the CPU
alike.
"""
from __future__ import annotations

import torch


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward; call it on inputs that do not "
            "require grad, or under torch.no_grad()")


def recompute_grads(plain, saved, needs, grad_out, **kw):
    """The gradients of ``plain(*saved, **kw)`` for the cotangent
    ``grad_out`` with respect to the tensors in ``saved`` whose ``needs``
    entry is True (None for the others), by running ``plain`` again
    under autograd."""
    ins = [t.detach().requires_grad_(w) for t, w in zip(saved, needs)]
    with torch.enable_grad():
        out = plain(*ins, **kw)
    grads = iter(torch.autograd.grad(
        out, [t for t, w in zip(ins, needs) if w], grad_out))
    return tuple(next(grads) if w else None for w in needs)
