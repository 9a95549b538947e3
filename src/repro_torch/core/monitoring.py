"""The single process-wide compile-event fan-out (the port of
:mod:`repro.core.monitoring`).

The reference listens to XLA's ``backend_compile`` events. The port
compiles nothing behind the caller's back (no ``torch.compile``, no
CUDA graphs), so its compile events are the two things it does build:

* a kernel library that ``kernels/_build.build`` compiles with
  ``nvcc`` (a cache miss: a library loaded from an earlier build is not
  one), one event per library with its seconds;
* a new (bucket program, bucket shape) key of the sweep engine
  (``core/engine.batched_compile_count`` rises by one), the analogue of
  a jit cache entry, one event of 0 s.

The emitters call :func:`record_compile`; every consumer subscribes
here instead of keeping a counter of its own:

    from repro_torch.core import monitoring
    monitoring.subscribe_compile(lambda seconds: ...)
    monitoring.compile_events()     # process-wide compile count

The recompile watchdog of :mod:`repro_torch.core.sanitize` takes deltas
of ``compile_events``, and ``costmodel.install_listener`` subscribes the
cost model's ``observe_compile``.
"""
from __future__ import annotations

from typing import Callable

_SUBSCRIBERS: list = []
_STATE = {"events": 0}


def record_compile(seconds: float = 0.0) -> None:
    """One compile event of ``seconds``: counted, then handed to every
    subscriber. A subscriber that raises is skipped, so a broken one
    never takes down the build or starves the others."""
    _STATE["events"] += 1
    for fn in tuple(_SUBSCRIBERS):
        try:
            fn(float(seconds))
        except Exception:
            pass


def subscribe_compile(fn: Callable[[float], None]) -> Callable[[float], None]:
    """Add ``fn(duration_secs)`` to the fan-out (idempotent per fn)."""
    if fn not in _SUBSCRIBERS:
        _SUBSCRIBERS.append(fn)
    return fn


def unsubscribe_compile(fn: Callable[[float], None]) -> None:
    try:
        _SUBSCRIBERS.remove(fn)
    except ValueError:
        pass


def compile_events() -> int:
    """Compile events recorded in this process."""
    return _STATE["events"]


def listener_installed() -> bool:
    """Always true: the emitters are the port's own code, so there is
    no external registration that could fail (the reference's may)."""
    return True
