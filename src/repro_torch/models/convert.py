"""Carry the reference's parameters across to the port's layouts.

:func:`params_from_jax` is for the paper's MNIST models,
:func:`lm_params_from_jax` for the model zoo.

The reference CNN (``repro.models.mnist``) is NHWC with HWIO kernels and
flattens its last feature map in (h, w, c) order; the port is NCHW with
OIHW kernels and flattens in (c, h, w) order. So the conv kernels are
permuted to OIHW and the rows of the CNN's ``w1`` are reordered from
(h, w, c) to (c, h, w). Dense weights are (in, out) in both packages.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params: dict[str, np.ndarray], *,
                    device=None) -> dict[str, torch.Tensor]:
    """Reference parameter dict (numpy arrays, float32) -> port dict."""
    out = {}
    is_cnn = "c1" in params
    for name, a in params.items():
        a = np.asarray(a, np.float32)
        if a.ndim == 4:                          # HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        elif is_cnn and name == "w1":            # rows (h, w, c) -> (c, h, w)
            c = np.asarray(params["c2"]).shape[-1]
            hw = int(round((a.shape[0] // c) ** 0.5))
            a = a.reshape(hw, hw, c, -1).transpose(2, 0, 1, 3) \
                .reshape(a.shape[0], -1)
        out[name] = torch.from_numpy(np.array(a, order="C")).to(device)
    return out


def lm_params_from_jax(tree, *, device=None):
    """Reference LM parameter tree (nested dicts of numpy arrays, from
    ``repro.models.module.init_params``) -> the port's tree of tensors
    on ``device``. The port keeps the reference's (in, out) weight
    layouts and its stacked leading ``layers`` axes, so this is a dtype
    and device move with no transposes: float leaves become float32
    tensors, integer leaves keep their type."""
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v, device=device)
                for k, v in tree.items()}
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C")).to(device)
