"""The paper's own models (§V-A): a 2-layer MLP, a small CNN and a
pooled linear model for 10-class 28×28 images, trained with constant-η
SGD and cross-entropy.

Models are plain functions over parameter dicts, as in
:mod:`repro.models.mnist`. Layouts are PyTorch's: the CNN runs NCHW
with OIHW kernels, and its flatten is in (c, h, w) order, so ``w1``'s
rows follow that order (``models/convert.py`` maps the reference's
NHWC/HWIO weights across). Dense weights are (in, out) as in the
reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def mlp_specs(hidden: int = 200, n_classes: int = 10) -> dict:
    return {"w1": (784, hidden), "b1": (hidden,),
            "w2": (hidden, n_classes), "b2": (n_classes,)}


def mlp_apply(params, x):
    """x (B, 28, 28) -> logits (B, 10)."""
    h = torch.relu(x.reshape(x.shape[0], -1) @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def linear_specs(n_classes: int = 10, pooled: int = 7) -> dict:
    return {"w": (pooled * pooled, n_classes), "b": (n_classes,)}


def linear_apply(params, x):
    """x (B, 28, 28) -> logits (B, 10): 4×4 average pooling down to
    7×7, then one linear layer."""
    B = x.shape[0]
    h = x.reshape(B, 7, 4, 7, 4).mean(dim=(2, 4)).reshape(B, 49)
    return h @ params["w"] + params["b"]


def cnn_specs(n_classes: int = 10) -> dict:
    return {"c1": (16, 1, 5, 5), "cb1": (16,),
            "c2": (32, 16, 5, 5), "cb2": (32,),
            "w1": (32 * 7 * 7, 128), "b1": (128,),
            "w2": (128, n_classes), "b2": (n_classes,)}


def _conv(x, w, b):
    # SAME padding for a 5×5 kernel at stride 1
    return torch.relu(F.conv2d(x, w, padding=2) + b[:, None, None])


def cnn_apply(params, x):
    """x (B, 28, 28) -> logits (B, 10)."""
    h = x[:, None]
    h = F.max_pool2d(_conv(h, params["c1"], params["cb1"]), 2)
    h = F.max_pool2d(_conv(h, params["c2"], params["cb2"]), 2)
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(h @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def ce_loss(logits, labels, weights=None):
    """Mean (or 0/1-weighted mean) cross-entropy; labels int64."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(1, labels[:, None])[:, 0]
    if weights is None:
        return -ll.mean()
    return -(ll * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()


MODELS = {
    "mlp": (mlp_specs, mlp_apply),
    "cnn": (cnn_specs, cnn_apply),
    "linear": (linear_specs, linear_apply),
}


def _fan_in(shape: tuple) -> int:
    """OIHW kernels: in-channels × receptive field; (in, out) weights:
    the first dimension."""
    return math.prod(shape[1:]) if len(shape) == 4 else shape[0]


def init_params(specs: dict, generator: torch.Generator, *,
                device=None) -> dict:
    """Normal·1/√fan_in for weights, zeros for biases (1-D entries) —
    the laws of :func:`repro.models.module.init_params`. The numbers
    differ from JAX's; tests inject the reference's via
    ``models/convert.py``. Drawn on the CPU from ``generator`` and moved
    to ``device``."""
    out = {}
    for name, shape in specs.items():
        if len(shape) == 1:
            p = torch.zeros(shape)
        else:
            p = torch.randn(shape, generator=generator) \
                / math.sqrt(_fan_in(shape))
        out[name] = p.to(device)
    return out
