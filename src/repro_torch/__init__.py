"""PyTorch and CUDA port of :mod:`repro` for one NVIDIA H100.

The package keeps the JAX package's module paths (``core/``, ``data/``,
``models/``, ``kernels/``, ``launch/``) so each function has an obvious
counterpart, and imports neither ``jax`` nor ``repro``. Every entry
point runs on ``cuda`` unless the caller passes ``device="cpu"``; see
:func:`repro_torch.device.resolve_device`.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
