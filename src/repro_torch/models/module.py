"""Parameter specs for the model zoo (the port of
:mod:`repro.models.module`).

A model declares its parameters as a nested dict of :class:`Spec`
(shape, logical axis names, init law). :func:`init_params` turns such a
tree into tensors built directly on the target device,
:func:`abstract_params` into meta tensors, :func:`logical_axes` into its
axis names, and :func:`param_count` counts them. The trees, shapes and init laws are the
reference's; the random values cannot be ``jax.random``'s, so the tests
carry the reference's parameters across instead
(:func:`repro_torch.models.convert.lm_params_from_jax`).
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declaration of a single parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim (None = unsharded)
    init: str = "normal"          # normal | zeros | ones | embed | small | fill
    scale: float | None = None    # stddev override, or the fill value
    dtype: Any = None             # leaf dtype override (a torch.dtype)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def _fan_in_scale(spec: Spec) -> float:
    """1/sqrt(fan_in) for projection-like tensors (first dim = fan-in;
    the second where a stacked "layers"/"groups" axis leads)."""
    if spec.scale is not None:
        return spec.scale
    if len(spec.shape) == 4:      # conv HWIO: receptive field * in-channels
        fan_in = math.prod(spec.shape[:3])
    elif len(spec.shape) >= 2:
        fan_in = spec.shape[0]
        if spec.axes and spec.axes[0] in ("layers", "groups") \
                and len(spec.shape) >= 3:
            fan_in = spec.shape[1]
    else:
        fan_in = max(spec.shape[-1], 1)
    return 1.0 / math.sqrt(max(fan_in, 1))


def leaves(specs, prefix: str = ""):
    """(path, Spec) pairs of a spec tree, paths as in ``jax.tree_util.
    keystr`` (``['blocks']['ssm']['w_z']``), in sorted key order."""
    if isinstance(specs, Spec):
        yield prefix, specs
        return
    for k in sorted(specs):
        yield from leaves(specs[k], f"{prefix}['{k}']")


def init_leaf(spec: Spec, generator: torch.Generator, dtype,
              device) -> torch.Tensor:
    """One leaf, drawn in float32 on ``device`` and cast to its dtype."""
    dt = spec.dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "fill":
        return torch.full(spec.shape, spec.scale, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "embed":
        std = spec.scale or 0.02
    elif spec.init == "small":
        std = 0.02
    elif spec.init == "normal":
        std = _fan_in_scale(spec)
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    out = torch.empty(spec.shape, dtype=torch.float32, device=device)
    out.normal_(0.0, std, generator=generator)
    return out if dt == torch.float32 else out.to(dt)


def init_params(specs, seed: int = 0, dtype=torch.float32, device=None):
    """Materialise a spec tree into tensors on ``device``. Each leaf
    draws from its own generator, seeded with the crc32 of its path
    started from ``seed`` (as the reference folds its key per leaf), so
    a leaf's values do not depend on which other leaves the tree holds.
    ``seed`` lies in [0, 2**32): the CPU generator keeps 32 bits."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    device = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=device)

    def build(node, prefix):
        if isinstance(node, Spec):
            gen.manual_seed(zlib.crc32(prefix.encode(), seed))
            return init_leaf(node, gen, dtype, device)
        return {k: build(v, f"{prefix}['{k}']") for k, v in node.items()}

    return build(specs, "")


def _map_specs(fn, specs):
    if isinstance(specs, Spec):
        return fn(specs)
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def logical_axes(specs):
    """Tree of logical-axis tuples mirroring the spec tree."""
    return _map_specs(lambda s: s.axes, specs)


def abstract_params(specs, dtype=torch.float32):
    """The spec tree as tensors on the meta device (shapes and dtypes,
    no storage): the dry run's counterpart of the reference's
    ``ShapeDtypeStruct`` tree."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype or dtype,
                                            device="meta"), specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for _, s in leaves(specs))
