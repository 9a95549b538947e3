"""Where the time of the fog main path goes, on one device.

    python -m repro_torch.launch.breakdown [train.py flags] [--reps N]

Builds the problem and the plan as ``launch/train.py`` does, then times
``run_network_aware`` cold (the first run in the process: library
initialisation included) and warm (``--reps`` more runs), and profiles
one more warm run with ``torch.profiler``: the device's busy time (the
union of the spans of its kernels and copies), its idle share of the
wall time, and the kernels that take the most device time. Prints one
JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import federated as F
from repro_torch.device import resolve_device
from repro_torch.launch import train


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) microsecond spans:
    the device is busy while any kernel or copy runs."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--top", type=int, default=8)
    own, rest = ap.parse_known_args(argv)
    args = train.parse_args(rest)
    device = resolve_device(args.device)
    pb = train.build_problem(args)
    t0 = time.perf_counter()
    plan = train.solve_setting(args.setting, pb["traces"], pb["schedule"],
                               pb["D"], device=device)
    plan_s = time.perf_counter() - t0

    def once():
        _sync(device)
        t = time.perf_counter()
        F.run_network_aware(pb["cfg"], pb["data"], pb["traces"], pb["adj"],
                            plan, streams=pb["streams"],
                            schedule=pb["schedule"], device=device)
        _sync(device)
        return time.perf_counter() - t

    cold = once()
    warm = [once() for _ in range(own.reps)]
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        wall = once()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _union_s([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:own.top]
    return {"argv": rest, "device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "T": args.T, "n": args.n, "model": args.model,
            "plan_s": plan_s, "train_cold_s": cold, "train_warm_s": warm,
            "profiled_wall_s": wall, "device_busy_s": busy,
            "device_idle_share": (1.0 - busy / wall) if device.type == "cuda"
            else None,
            "top_kernels_s": top}


if __name__ == "__main__":
    print(json.dumps(run(sys.argv[1:])))
