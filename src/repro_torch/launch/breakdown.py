"""Where the time of a path goes, on one device.

    python -m repro_torch.launch.breakdown [train.py flags] [--reps N]
    python -m repro_torch.launch.breakdown --prefill ARCH [--smoke]
        [--batch B] [--seq S] [--seed K] [--device D] [--reps N]

The first form builds the problem, the ``--faults`` schedule, the plan
and the ``--tiers`` tree (if any) as ``launch/train.py`` does, then
times ``run_network_aware``.
The second draws ARCH's parameters (the full config unless ``--smoke``)
on the device from the seed and times the serving prefill step
(``launch/steps.make_prefill_step``) on B x S seeded prompts. Both time
the work cold (the first run in the process: library initialisation
included) and warm (``--reps`` more runs), and profile one more warm
run with ``torch.profiler``: the device's busy time (the union of the
spans of its kernels and copies), its idle share of the wall time, and
the kernels that take the most device time. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import federated as F
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch import train


def _union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) microsecond spans:
    the device is busy while any kernel or copy runs."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def _timed(fn, device, reps: int, top: int) -> dict:
    """Cold, warm and profiled runs of ``fn``; see the module doc."""
    def once():
        synchronize(device)
        t = time.perf_counter()
        fn()
        synchronize(device)
        return time.perf_counter() - t

    cold = once()
    warm = [once() for _ in range(reps)]
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
    return {"device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "cold_s": cold, "warm_s": warm, "profiled_wall_s": wall,
            "device_busy_s": busy,
            "device_idle_share": (1.0 - busy / wall) if device.type == "cuda"
            else None,
            "top_kernels_s": sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:top]}


def run_prefill(own) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import frontend_inputs, make_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params

    device = resolve_device(own.device)
    cfg = get_config(own.prefill, smoke=own.smoke)
    params = init_params(T.specs(cfg), seed=own.seed, device=device)
    rng = np.random.default_rng(own.seed)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (own.batch, own.seq)).astype(np.int32)).to(device)
    batch = {"tokens": toks, **frontend_inputs(cfg, own.batch, device)}
    prefill = make_prefill_step(cfg)

    def fn():
        with torch.no_grad():
            prefill(params, batch)

    out = _timed(fn, device, own.reps, own.top)
    out["prefill_tokens_per_s_warm"] = [own.batch * own.seq / w
                                        for w in out["warm_s"]]
    return {"prefill": own.prefill, "config": "smoke" if own.smoke
            else "full", "batch": own.batch, "seq": own.seq, **out}


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--prefill", default=None, metavar="ARCH")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    own, rest = ap.parse_known_args(argv)
    if own.prefill is not None:
        return run_prefill(own)
    args = train.parse_args(rest + ["--device", own.device,
                                    "--seed", str(own.seed)])
    if args.mode != "fog":
        raise SystemExit("launch.breakdown times the fog path (or the "
                         "prefill, --prefill ARCH); --mode lm runs in "
                         "launch.train")
    train._check_ported(args)
    device = resolve_device(args.device)
    pb = train.build_problem(args)
    t0 = time.perf_counter()
    faults = train.make_fault_schedule(args, pb["cfg"])
    plan, _ = train.make_plan(args, pb, device, faults=faults)
    plan_s = time.perf_counter() - t0
    hierarchy = train.make_hierarchy(args, pb["cfg"])

    def fn():
        F.run_network_aware(pb["cfg"], pb["data"], pb["traces"], pb["adj"],
                            plan, streams=pb["streams"],
                            schedule=pb["schedule"], hierarchy=hierarchy,
                            device=device,
                            **train.fault_kwargs(args, faults))

    out = _timed(fn, device, own.reps, own.top)
    return {"argv": rest, "T": args.T, "n": args.n, "model": args.model,
            "tiers": args.tiers, "plan_s": plan_s,
            "train_cold_s": out.pop("cold_s"),
            "train_warm_s": out.pop("warm_s"), **out}


if __name__ == "__main__":
    print(json.dumps(run(sys.argv[1:])))
