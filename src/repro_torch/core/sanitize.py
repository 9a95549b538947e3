"""Runtime sanitizer for the fog engine (the port of
:mod:`repro.core.sanitize`).

Static analysis (:mod:`repro_torch.analysis`) catches what it can at
parse time; this module puts runtime checkers around the engine for
small smoke runs, so that the remaining hazards fail loudly:

* a transfer guard around the round loops (:func:`hot_loop_guard`): a
  ``TorchDispatchMode`` that raises on every host sync and every copy
  between the host and a device inside them (``.item()``, ``float(t)``,
  ``bool(t)``, ``torch.nonzero``, ``.cpu()``, ``.to("cuda")`` of a host
  tensor), on any device, so the CPU runs exercise it too. On the card
  it also sets ``torch.cuda.set_sync_debug_mode("error")``, which
  catches the syncs hidden inside an op (a boolean mask index), and
  restores the previous mode on exit. Copies from one device to another
  stay allowed, as in the reference. Staging and the read-back of the
  history stay outside the guard: those transfers are the design;
* ``debug_nans``, with jax's semantics: under :func:`sanitized` every
  eager op that computes a floating result is checked, and a NaN raises
  ``FloatingPointError`` at the op that made it. Inside the guard (the
  reference's one jitted program) the per-op check is suspended, and on
  exit the loop's outputs that the engine hands to the guard (losses,
  parameters, H, accuracy) are checked instead, so a NaN that a guarded
  aggregation selected away passes and one that reached the outputs
  raises. Like jax's flag it looks for NaN only (infinities are
  ``jax_debug_infs``'s, which stays off). Data movement (copies, views,
  gathers, concatenations) and allocations are not checked: they make
  no value. The checker's own reductions run outside every mode;
* a recompile watchdog on :mod:`repro_torch.core.monitoring`'s fan-out
  (:class:`RecompileWatchdog`): under ``expect_warm`` a scope that
  builds a kernel or adds a sweep-engine program key raises
  :class:`RecompileError`.

Entry points: ``run_network_aware(..., sanitize=True)`` and
``launch/train.py --sanitize`` (a sanitized cold pass, then a warm one
that must compile nothing).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro_torch.core import monitoring


class RecompileError(RuntimeError):
    """A warm pass compiled when the watchdog expected zero compiles."""


@dataclasses.dataclass
class SanitizeConfig:
    transfer_guard: bool = True     # no host syncs or copies in the hot loop
    debug_nans: bool = True
    expect_warm: bool = False       # raise if the scope compiles anything

    @classmethod
    def coerce(cls, value) -> "SanitizeConfig | None":
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        raise TypeError(f"sanitize must be bool or SanitizeConfig, "
                        f"got {type(value).__name__}")


# ops that read a device value on the host
_SYNCS = ("_local_scalar_dense", "nonzero", "is_nonzero")
# copies, each with its (source, destination) devices
_COPIES = {
    "_to_copy": lambda a, kw: (a[0].device, kw.get("device") or a[0].device),
    "copy_": lambda a, kw: (a[1].device, a[0].device),
    "_copy_from": lambda a, kw: (a[0].device, a[1].device),
    "_copy_from_and_resize": lambda a, kw: (a[0].device, a[1].device),
}
# ops that make no new value: the NaN check skips them (views too)
_MOVES = frozenset((*_COPIES, "clone", "lift_fresh", "lift_fresh_copy",
                    "detach", "cat", "stack", "index", "index_select",
                    "gather", "index_put", "index_put_", "select_scatter",
                    "slice_scatter", "masked_select"))


def _name(func) -> str:
    return func.overloadpacket.__name__


class _TransferGuard(TorchDispatchMode):
    """Raises on host syncs and host<->device copies (see the module
    docstring)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        if name in _SYNCS:
            raise RuntimeError(
                f"Disallowed device-to-host transfer in the hot loop: "
                f"aten.{name} reads a tensor's value on the host")
        if name in _COPIES:
            src, dst = (torch.device(d) for d in _COPIES[name](args, kwargs))
            if (src.type == "cpu") != (dst.type == "cpu"):
                way = ("host-to-device" if src.type == "cpu"
                       else "device-to-host")
                raise RuntimeError(
                    f"Disallowed {way} transfer in the hot loop: "
                    f"aten.{name} from {src} to {dst}")
        return func(*args, **kwargs)


def _nan_in(t) -> bool:
    """True if ``t`` is a floating tensor holding a NaN (checked outside
    every dispatch mode)."""
    if not (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.device.type in ("cpu", "cuda") and t.numel()):
        return False
    with _disable_current_modes():
        return bool(torch.isnan(t).any())


def _computes(func) -> bool:
    """Whether ``func`` makes new values: not an allocation, a view or a
    data movement."""
    name = _name(func)
    if name in _MOVES or "empty" in name:
        return False
    returns = func._schema.returns
    return not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in returns)


class _NanCheck(TorchDispatchMode):
    """``debug_nans`` for eager ops; ``suspended`` inside the guard."""

    def __init__(self):
        super().__init__()
        self.suspended = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.suspended and _computes(func):
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if _nan_in(t):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func}")
        return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


_ACTIVE: list = []      # (config, its NaN check or None), innermost last


def active() -> SanitizeConfig | None:
    """The innermost active sanitize config, or None."""
    return _ACTIVE[-1][0] if _ACTIVE else None


@contextlib.contextmanager
def sanitized(config=True):
    """Run a block under the sanitizer: the NaN check on while it runs
    (``debug_nans``), the recompile watchdog armed under
    ``expect_warm``, and :func:`hot_loop_guard` live. ``False`` or None
    does nothing. The config gains ``last_compiles``, the compile events
    of the block."""
    cfg = SanitizeConfig.coerce(config)
    if cfg is None:
        yield None
        return
    nans = _NanCheck() if cfg.debug_nans else None
    _ACTIVE.append((cfg, nans))
    try:
        with nans if nans is not None else contextlib.nullcontext():
            with RecompileWatchdog(strict=cfg.expect_warm) as dog:
                yield cfg
        cfg.last_compiles = dog.compiles  # type: ignore[attr-defined]
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def hot_loop_guard():
    """The engine's hook around a round loop: a no-op outside
    :func:`sanitized`. Inside it, with ``transfer_guard``, host syncs
    and host<->device copies raise (and on the card the sync debug mode
    is "error"); with ``debug_nans``, the per-op check is suspended and
    the loop's outputs are checked on exit instead. Yields a list: the
    engine appends its outputs (tensors or dicts, lists and tuples of
    them) to it before the block ends."""
    outputs: list = []
    if not _ACTIVE:
        yield outputs
        return
    cfg, nans = _ACTIVE[-1]
    on_card = cfg.transfer_guard and torch.cuda.is_available()
    prev = torch.cuda.get_sync_debug_mode() if on_card else None
    if nans is not None:
        nans.suspended += 1
    try:
        if on_card:
            torch.cuda.set_sync_debug_mode("error")
        with (_TransferGuard() if cfg.transfer_guard
              else contextlib.nullcontext()):
            yield outputs
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(prev)
        if nans is not None:
            nans.suspended -= 1
    if nans is not None:
        for path, t in _leaves(outputs, "out"):
            if _nan_in(t):
                raise FloatingPointError(
                    f"invalid value (nan) in the hot loop's output {path}")


class RecompileWatchdog:
    """Counts compile events across a scope via the shared monitoring
    fan-out; ``strict`` raises on scope exit if anything compiled (warm
    re-runs must not)."""

    def __init__(self, strict: bool = False):
        self.strict = strict
        self._start = 0
        self.compiles = 0

    def __enter__(self) -> "RecompileWatchdog":
        self._start = monitoring.compile_events()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.compiles = monitoring.compile_events() - self._start
        if exc_type is None and self.strict and self.compiles:
            raise RecompileError(
                f"{self.compiles} compile(s) inside a warm scope that"
                " expected zero: a kernel was built or the sweep engine"
                " met a new (program, shape) key between runs")
