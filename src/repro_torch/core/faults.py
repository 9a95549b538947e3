"""Fault-injection plane: unannounced failures (a numpy copy of
:mod:`repro.core.faults`, with the same rng use, so the same seed gives
bitwise-equal events and views).

The :class:`NetworkSchedule` models changes devices *announce*
(entry/exit, link flaps). Production fog is dominated by failures
nobody announces: stragglers that miss the upload window, uploads
dropped by the transport, devices that crash mid-window, and corrupted
(non-finite or Byzantine-scaled) parameter updates over lossy wireless
links. A :class:`FaultSchedule` is the seeded, per-round record of
those events, composable with a NetworkSchedule and consumed by three
layers:

* the **engine** stages two ``(T, n)`` float views — ``upload_ok()``
  (0 where a straggled/dropped upload never reaches the aggregator)
  and ``corrupt()`` (the multiplier a lossy link applies to the
  uploaded parameters: NaN/Inf, or a Byzantine scale) — on the device
  once, and injects them at the aggregation rounds;
* **activity**: crash outages are an active-mask view
  (``activity_mask()``) ANDed into the announced schedule's trace, so
  a crashed device stops training/collecting exactly like a churned
  device — except nobody planned for it;
* **realization**: ``compose()`` merges the crash outages into the
  true :class:`NetworkSchedule` that ``movement.realize_plan`` executes
  against, so in-transit shares toward a crashed receiver are lost
  through the same receiver-side machinery as churn.

Upload faults (straggle / drop / corrupt) fire at window-last rounds —
the only rounds an upload exists. ``straggle`` and ``drop`` have the
same engine view (the update misses the aggregation but the device
still receives the new global); they are kept distinct in the event
taxonomy because their *cause* differs (delay vs. transport loss).
A drop wins over a corrupt on the same (round, device): an upload that
never arrives cannot poison anything.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.schedule import NetworkSchedule

FAULT_KINDS = ("straggle", "drop", "crash", "corrupt")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault.

    ``t`` — the round the fault fires (window-last round for upload
    faults; the outage start for crashes). ``value`` — the corruption
    multiplier for ``corrupt`` (NaN/Inf or a Byzantine scale); the
    outage length in rounds for ``crash`` (<= 0 means the remainder of
    the current aggregation window); unused otherwise."""

    t: int
    kind: str
    device: int
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")


class FaultSchedule:
    """Seeded per-round fault record over a (T, n, τ) horizon."""

    def __init__(self, T: int, n: int, tau: int, events=()):
        self.T, self.n, self.tau = int(T), int(n), int(tau)
        if self.T <= 0 or self.n <= 0 or self.tau <= 0:
            raise ValueError("FaultSchedule requires T, n, tau > 0")
        for e in events:
            if not 0 <= e.t < self.T:
                raise ValueError(f"fault round {e.t} outside horizon "
                                 f"[0, {self.T})")
            if not 0 <= e.device < self.n:
                raise ValueError(f"fault device {e.device} outside "
                                 f"[0, {self.n})")
            if e.kind != "crash" and (e.t + 1) % self.tau != 0:
                raise ValueError(
                    f"{e.kind} fault at round {e.t}: upload faults fire "
                    f"at window-last rounds (t+1 divisible by tau="
                    f"{self.tau}) — there is no upload to fault "
                    "elsewhere")
        self.events = tuple(sorted(
            events, key=lambda e: (e.t, e.kind, e.device)))
        self._views: tuple | None = None

    # -- seeded sampling ------------------------------------------------

    @classmethod
    def sample(cls, T: int, n: int, tau: int, *, rng,
               p_straggle: float = 0.0, p_drop: float = 0.0,
               p_crash: float = 0.0, p_corrupt: float = 0.0,
               corrupt: str = "nan", corrupt_scale: float = -10.0,
               crash_len: int = 0) -> "FaultSchedule":
        """Per-window, per-device independent draws (one fixed-order
        block of draws per window, so the stream is deterministic in
        the seed and identical across engines).

        ``p_straggle``/``p_drop``/``p_corrupt`` are per-upload
        probabilities (window-last rounds); ``p_crash`` is a per-window
        probability of an unannounced exit at a uniform round inside
        the window, lasting ``crash_len`` rounds (0 = the remainder of
        the window — the device misses the sync and re-enters waiting,
        like a churned node nobody planned for). ``corrupt`` picks the
        corruption payload: "nan", "inf", or "scale" (a Byzantine
        multiplier ``corrupt_scale`` that survives finite-masking)."""
        if isinstance(rng, (int, np.integer)):
            rng = np.random.default_rng(int(rng))
        if corrupt not in ("nan", "inf", "scale"):
            raise ValueError(f"unknown corrupt payload {corrupt!r}")
        val = {"nan": float("nan"), "inf": float("inf"),
               "scale": float(corrupt_scale)}[corrupt]
        events: list[FaultEvent] = []
        for w in range(T // tau):
            tl = (w + 1) * tau - 1                  # window-last round
            r = rng.random((4, n))
            off = rng.integers(0, tau, n)
            for i in range(n):
                if r[0, i] < p_straggle:
                    events.append(FaultEvent(tl, "straggle", i))
                if r[1, i] < p_drop:
                    events.append(FaultEvent(tl, "drop", i))
                if r[2, i] < p_corrupt:
                    events.append(FaultEvent(tl, "corrupt", i, val))
                if r[3, i] < p_crash:
                    events.append(FaultEvent(
                        w * tau + int(off[i]), "crash", i,
                        float(crash_len)))
        return cls(T, n, tau, events)

    # -- views ----------------------------------------------------------

    def _build_views(self):
        if self._views is not None:
            return self._views
        act = np.ones((self.T, self.n), bool)
        upl = np.ones((self.T, self.n), np.float32)
        cor = np.ones((self.T, self.n), np.float32)
        for e in self.events:
            if e.kind == "crash":
                length = int(e.value)
                if length <= 0:          # rest of the current window
                    length = self.tau - (e.t % self.tau)
                act[e.t:min(e.t + length, self.T), e.device] = False
            elif e.kind == "corrupt":
                cor[e.t, e.device] = np.float32(e.value)
            else:                        # straggle / drop
                upl[e.t, e.device] = 0.0
        # a drop wins over a corrupt on the same (t, device): an upload
        # that never arrives cannot inject NaN into the reduction
        cor[upl == 0.0] = 1.0
        self._views = (act, upl, cor)
        return self._views

    def activity_mask(self) -> np.ndarray:
        """(T, n) bool — False during crash outages."""
        return self._build_views()[0].copy()

    def upload_ok(self) -> np.ndarray:
        """(T, n) float32 — 0 where the upload never arrives."""
        return self._build_views()[1].copy()

    def corrupt(self) -> np.ndarray:
        """(T, n) float32 — the multiplier applied to uploaded params
        (NaN/Inf or Byzantine scale; 1 everywhere clean)."""
        return self._build_views()[2].copy()

    def engine_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The two (T, n) float32 views the engines stage:
        (upload_ok, corrupt)."""
        _, upl, cor = self._build_views()
        return upl, cor

    @property
    def has_crashes(self) -> bool:
        return any(e.kind == "crash" for e in self.events)

    @property
    def has_upload_faults(self) -> bool:
        return any(e.kind != "crash" for e in self.events)

    def summary(self) -> dict:
        """Event counts per kind (bench/CLI reporting)."""
        out = {k: 0 for k in FAULT_KINDS}
        for e in self.events:
            out[e.kind] += 1
        out["total"] = len(self.events)
        return out

    # -- composition with the announced network plane -------------------

    def compose(self, schedule: NetworkSchedule | None = None, *,
                adj=None) -> NetworkSchedule:
        """The TRUE network: the announced schedule with crash outages
        ANDed into its active trace (links touching a crashed node are
        masked, so ``movement.realize_plan`` loses in-transit shares
        toward a crashed receiver through the same receiver-side
        machinery as churn). Pass ``adj`` when the base network is a
        static matrix with no schedule."""
        if schedule is None:
            if adj is None:
                raise ValueError("compose() needs a schedule or a "
                                 "static adjacency")
            schedule = NetworkSchedule.constant(
                np.asarray(adj, bool), self.T)
        if (schedule.T, schedule.n) != (self.T, self.n):
            raise ValueError(
                f"fault schedule is (T={self.T}, n={self.n}) but the "
                f"network schedule is (T={schedule.T}, n={schedule.n})")
        mask = self._build_views()[0]
        if mask.all():
            return schedule
        active = schedule.activity() & mask
        return schedule.with_activity(active, mask_inactive=True)

    def __repr__(self) -> str:
        s = self.summary()
        kinds = ", ".join(f"{k}={s[k]}" for k in FAULT_KINDS if s[k])
        return (f"FaultSchedule(T={self.T}, n={self.n}, tau={self.tau}, "
                f"events={len(self.events)}{', ' + kinds if kinds else ''})")


def make_faults(kind: str | None, T: int, n: int, tau: int, *,
                rate: float, seed: int = 0, corrupt: str = "nan",
                corrupt_scale: float = -10.0,
                crash_len: int = 0) -> FaultSchedule | None:
    """CLI/Scenario dispatcher over the fault producers.

    ``kind`` — "none"/None (no faults), one of ``FAULT_KINDS`` (all of
    ``rate`` on that channel), or "mixed" (``rate`` split evenly across
    the four channels). Returns None when no fault can fire."""
    if kind in (None, "none") or rate <= 0:
        return None
    rng = np.random.default_rng(seed)
    p = dict.fromkeys(("p_straggle", "p_drop", "p_crash", "p_corrupt"),
                      0.0)
    if kind == "mixed":
        for k in p:
            p[k] = rate / 4.0
    elif kind in FAULT_KINDS:
        p["p_" + kind] = rate
    else:
        raise ValueError(f"unknown fault kind {kind!r}; expected "
                         f"'none', 'mixed' or one of {FAULT_KINDS}")
    return FaultSchedule.sample(T, n, tau, rng=rng, corrupt=corrupt,
                                corrupt_scale=corrupt_scale,
                                crash_len=crash_len, **p)
