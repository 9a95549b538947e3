"""Bucket dispatch cost model of the sweep engine: per-point loop or
batched bucket, dense or ragged staging (the port of
:mod:`repro.core.costmodel`).

The sweep (:func:`repro_torch.launch.tables.run_scenarios`)
prices each shape bucket before training it:

    predicted(path) = work_slots(path) · per_slot_cost(path)
                    + new_programs(path) · compile_cost
                    + fixed dispatch overhead

priced as the reference prices it: the same work slots (Σ T·n·P per
point for the loop, S·T_b·n_b·P_b for a dense bucket, T_b·R_b·C chunk-row
slots for a ragged one), the same registry of (path, model config,
shape) descriptors already run, the same per-slot, per-point, per-bucket
and evaluation constants, and the same EMA refinement of the per-slot
costs from runs that built nothing new (``observe_run``).

One term differs. The port compiles nothing at run time apart from its
``nvcc`` builds of the kernels (no ``torch.compile``, no CUDA graphs),
so the compile cost is 0 and :func:`install_listener` has nothing to
listen to. The descriptors are still recorded, so ``new_programs``
reports what the reference would compile, and a caller may price a
compile by passing ``compile_s``.

``MODEL`` is the process-wide singleton the dispatch uses; tests build
private instances with pinned parameters.
"""
from __future__ import annotations

import dataclasses

# the reference's constants, calibrated on its CPU at fig5 DEFAULT
# scale (not on the card): a padded dense/loop sample slot ≈ 10 µs; a
# ragged chunk-row slot ≈ 85 µs (each chunk row pays a per-row param
# gather and a scatter of its gradient, so ragged wins only when it
# removes >~8× padding inflation); a loop point ~50 ms host prep +
# dispatch, a batched bucket ~0.3 s staging + stacked eval
DEFAULT_SLOT_S = 1.0e-5
DEFAULT_RAGGED_SLOT_S = 8.5e-5
# the port builds no program at run time (module docstring)
DEFAULT_COMPILE_S = 0.0
DEFAULT_PER_POINT_S = 0.05
DEFAULT_PER_BUCKET_S = 0.3
# test evaluation costs the same on every path (same flops, streamed
# off the hot path): ~3.6 µs per (scenario × aggregation window × test
# sample) on the reference's CPU. Modeling it explicitly doesn't change a
# ranking, but keeps the per-slot EMAs clean — without it, small
# eval-dominated buckets would teach the model absurd slot costs.
DEFAULT_EVAL_SLOT_S = 3.6e-6
EMA_ALPHA = 0.3


@dataclasses.dataclass
class Decision:
    """One bucket's dispatch verdict plus the numbers behind it."""

    path: str                   # "loop" | "batched"
    staging: str | None         # "dense" | "ragged" (batched only)
    reason: str                 # "cost-model" | "S=1" | "forced"
    predicted_s: dict           # per-candidate predicted seconds
    slots: dict                 # per-candidate work-slot totals
    new_programs: dict          # per-candidate predicted compiles

    def as_row(self) -> dict:
        return {"path": self.path, "staging": self.staging,
                "reason": self.reason,
                "predicted_s": {k: round(float(v), 4)
                                for k, v in self.predicted_s.items()},
                "new_programs": dict(self.new_programs)}


class CostModel:
    def __init__(self, *, slot_s: float = DEFAULT_SLOT_S,
                 ragged_slot_s: float = DEFAULT_RAGGED_SLOT_S,
                 compile_s: float = DEFAULT_COMPILE_S,
                 per_point_s: float = DEFAULT_PER_POINT_S,
                 per_bucket_s: float = DEFAULT_PER_BUCKET_S,
                 eval_slot_s: float = DEFAULT_EVAL_SLOT_S):
        self.slot_s = float(slot_s)
        self.ragged_slot_s = float(ragged_slot_s)
        self.compile_s = float(compile_s)
        self.per_point_s = float(per_point_s)
        self.per_bucket_s = float(per_bucket_s)
        self.eval_slot_s = float(eval_slot_s)
        self._seen: set = set()
        self.compile_events = 0

    # -- descriptors --------------------------------------------------
    @staticmethod
    def _loop_descs(key, points, idents=None):
        # jit retraces per distinct point shape; ``idents`` are
        # prep-free per-point identities (shape-determining config
        # fields) so a forced loop run can mark its programs seen
        # without staging the data to learn P
        if idents is not None:
            return {("loop", key, i) for i in idents}
        return {("loop", key, (T, n, P)) for T, n, P in points}

    @staticmethod
    def _batched_desc(key, staging, S, dims):
        return ("batched", staging, key, S, dims)

    def mark_loop_seen(self, key, idents) -> None:
        """Record that the per-point loop just ran (and therefore
        compiled) these points — called by forced-loop sweeps so warm
        dispatch knows the loop path is already compiled."""
        self._seen |= self._loop_descs(key, None, idents)

    # -- prediction ---------------------------------------------------
    def choose(self, *, key, points, T_b: int, n_b: int, P_b: int,
               R_b: int, chunk: int, idents=None,
               eval_slots: int = 0,
               force_path: str | None = None,
               staging: str | None = None) -> Decision:
        """Price every candidate and pick the cheapest.

        ``key`` — the bucket's program-identity tuple (model, η, τ,
        fault config...); ``points`` — per-scenario true (T, n, P);
        ``T_b``/``n_b``/``P_b``/``R_b``/``chunk`` — the padded bucket
        dims of the dense and ragged stagings; ``idents`` — per-point
        identity tuples matching :meth:`mark_loop_seen` (defaults to
        the (T, n, P) shapes); ``eval_slots`` — the bucket's test-eval
        work S · windows · n_test, identical on every path (it can't
        change a ranking, but keeps predictions and the per-slot EMAs
        honest). ``force_path="batched"`` restricts the choice to
        batched stagings (engine="batched" callers); ``staging`` pins
        the batched staging instead of letting the model choose it.
        """
        S = len(points)
        loop_descs = self._loop_descs(key, points, idents)
        dense_desc = self._batched_desc(key, "dense", S,
                                        (T_b, n_b, P_b))
        ragged_desc = self._batched_desc(key, "ragged", S,
                                         (T_b, R_b, chunk))
        slots = {
            "loop": sum(T * n * P for T, n, P in points),
            "batched-dense": S * T_b * n_b * P_b,
            "batched-ragged": T_b * R_b * chunk,
        }
        new = {
            "loop": sum(1 for d in loop_descs if d not in self._seen),
            "batched-dense": int(dense_desc not in self._seen),
            "batched-ragged": int(ragged_desc not in self._seen),
        }
        eval_s = eval_slots * self.eval_slot_s
        predicted = {
            "loop": (slots["loop"] * self.slot_s
                     + new["loop"] * self.compile_s
                     + S * self.per_point_s + eval_s),
            "batched-dense": (slots["batched-dense"] * self.slot_s
                              + new["batched-dense"] * self.compile_s
                              + self.per_bucket_s + eval_s),
            "batched-ragged": (slots["batched-ragged"]
                               * self.ragged_slot_s
                               + new["batched-ragged"] * self.compile_s
                               + self.per_bucket_s + eval_s),
        }
        candidates = list(predicted)
        if staging is not None:
            candidates = ["loop", f"batched-{staging}"]
        if force_path == "batched":
            candidates = [c for c in candidates if c != "loop"]
            best = min(candidates, key=predicted.__getitem__)
            return Decision("batched", best.split("-", 1)[1], "forced",
                            predicted, slots, new)
        if S == 1:
            # a single point gains nothing from the bucket machinery;
            # the loop path is also the exact-staging oracle
            return Decision("loop", None, "S=1", predicted, slots, new)
        best = min(candidates, key=predicted.__getitem__)
        if best == "loop":
            return Decision("loop", None, "cost-model", predicted,
                            slots, new)
        return Decision("batched", best.split("-", 1)[1], "cost-model",
                        predicted, slots, new)

    def record(self, decision: Decision, *, key, points, T_b: int,
               n_b: int, P_b: int, R_b: int, chunk: int,
               idents=None, eval_slots: int = 0) -> None:
        """Mark the chosen path's programs as compiled-and-seen."""
        S = len(points)
        if decision.path == "loop":
            self._seen |= self._loop_descs(key, points, idents)
        else:
            dims = ((T_b, n_b, P_b) if decision.staging == "dense"
                    else (T_b, R_b, chunk))
            self._seen.add(self._batched_desc(key, decision.staging, S,
                                              dims))

    # -- online calibration -------------------------------------------
    def observe_compile(self, seconds: float) -> None:
        self.compile_events += 1
        if seconds > 0:
            self.compile_s += EMA_ALPHA * (seconds - self.compile_s)

    def observe_run(self, path: str, staging: str | None, slots: int,
                    seconds: float, new_compiles: int, *,
                    n_points: int = 1, eval_slots: int = 0) -> None:
        """Refine the per-slot EMA from a finished run — only when the
        run compiled nothing (else compile time would pollute the slot
        cost). The path's modeled fixed overhead and the bucket's eval
        work are subtracted first, so the EMA tracks the training-slot
        cost alone; overhead-dominated runs (remainder ≤ 0) teach
        nothing rather than teaching nonsense."""
        if new_compiles or slots <= 0 or seconds <= 0:
            return
        fixed = (n_points * self.per_point_s if path == "loop"
                 else self.per_bucket_s)
        train_s = seconds - fixed - eval_slots * self.eval_slot_s
        if train_s <= 0:
            return
        per_slot = train_s / slots
        if path == "batched" and staging == "ragged":
            self.ragged_slot_s += EMA_ALPHA * (per_slot
                                               - self.ragged_slot_s)
        else:
            self.slot_s += EMA_ALPHA * (per_slot - self.slot_s)


MODEL = CostModel()


def install_listener() -> None:
    """Kept for the reference's call sites: the port has no compile
    events to feed into ``MODEL`` (module docstring)."""
