"""Carry the reference's parameters across to the port's layouts.

:func:`params_from_jax` is for the paper's MNIST models (and
:func:`scan_state_from_jax` for a scan-engine checkpoint of them),
:func:`lm_params_from_jax` for the model zoo and
:func:`opt_state_from_jax` for its optimizer states.

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


def opt_state_from_jax(state, *, device=None):
    """A reference optimizer state (``repro.optim.optimizers``: sgd's
    ``{count}``, momentum's ``{mu, count}``, adamw's ``{m, v, count}``,
    as numpy) -> the port's (:mod:`repro_torch.optim.optimizers`):
    moments as float32 trees like the parameters, ``count`` a 0-d int32
    tensor, on ``device``; so both packages can continue from the same
    state."""
    unknown = set(state) - {"m", "v", "mu", "count"}
    if unknown:
        raise ValueError(f"not an optimizer state: keys {sorted(unknown)}")
    out = {k: lm_params_from_jax(v, device=device)
           for k, v in state.items() if k != "count"}
    out["count"] = torch.tensor(int(np.asarray(state["count"])),
                                dtype=torch.int32, device=device)
    return out


def scan_state_from_jax(state: dict, *, device=None) -> dict:
    """A reference scan-engine checkpoint state (``repro.checkpoint.
    checkpoint.restore`` of a ``run_network_aware(checkpoint_path=…)``
    snapshot: ``{"carry": {"W", "wg", "H", "waiting"}, "hist": {...},
    "round"}`` as numpy) -> the port's state, which
    ``repro_torch.checkpoint.checkpoint.save`` writes and the port's
    ``run_network_aware(resume=…)`` continues. The W stack is carried
    across device by device and the global model through
    :func:`params_from_jax`; H, waiting, the history and the round
    index as they are."""
    carry = state["carry"]
    W = {k: np.asarray(v) for k, v in carry["W"].items()}
    n = next(iter(W.values())).shape[0]
    rows = [params_from_jax({k: v[i] for k, v in W.items()}, device=device)
            for i in range(n)]
    Wt = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def tensor(a):
        return torch.from_numpy(np.array(a, order="C")).to(device)

    return {"carry": {"W": Wt,
                      "wg": params_from_jax(
                          {k: np.asarray(v) for k, v in carry["wg"].items()},
                          device=device),
                      "H": tensor(carry["H"]),
                      "waiting": tensor(carry["waiting"])},
            "hist": {k: tensor(v) for k, v in state["hist"].items()},
            "round": torch.tensor(int(state["round"]), dtype=torch.int64)}
