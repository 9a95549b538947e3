#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports no JAX. It builds every CUDA kernel of the fog main path from
``src/repro_torch/kernels/csrc``, then runs four phases and fails (exit
1, no result line) if any of them fails:

(a) each kernel against its plain PyTorch version on the card, at a
    sweep of shapes plus tie and isolated-row cases: equality is exact
    on every output;
(b) the main path at the CLI defaults (cnn, n=10, T=100, τ=10): the
    device plan beside the numpy plan (differing decisions are reported,
    not asserted), then the defaults at T=20 once on the card and once
    on the CPU, held to each other: plan cost, agg_round, H_agg, active
    and processed_counts exactly; device_loss and test_loss within rtol
    2e-3, atol 1e-4 and test_acc within atol 1e-2 (the reference's
    scan-vs-legacy tolerances: summation order differs);
(c) the fog-scale main path (mlp, n=1000, T=20, τ=5, random topology
    ρ=0.1, 60,000 samples), with every kernel launch counter set to 0
    just before and read just after: each kernel must have launched,
    and the plan must equal the one the plain version gives on the card;
(d) each kernel timed on the inputs the fog-scale path gave it (CUDA
    events, warmed, the L2 cache flushed before each launch), beside its
    plain version and its least time on this card.

The line before the last is the JSON list of kernels; the one before it
the card's name and power limit; the last line is the result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM: HBM bandwidth and float32 rate outside the tensor cores
# (NVIDIA data sheet; the least times below are against these peaks)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

DEFAULT_ARGV = ["--mode", "fog"]
SHORT_ARGV = ["--mode", "fog", "--T", "20", "--n-train", "4000",
              "--n-test", "1000"]
FOG_ARGV = ["--mode", "fog", "--model", "mlp", "--n", "1000", "--T", "20",
            "--tau", "5", "--topology", "random", "--rho", "0.1",
            "--n-train", "60000", "--n-test", "10000"]


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_a_kernels(torch, og, cuda):
    """Kernel vs plain version, exact, over shapes, ties, isolated rows."""
    cases = [(1, 1, 1.0, False, 0), (3, 7, 0.5, False, 0),
             (4, 129, 0.3, False, 0), (2, 256, 0.1, False, 0),
             (20, 1000, 0.1, False, 0), (100, 1024, 1.0, False, 0),
             (8, 300, 0.6, True, 0), (5, 200, 0.4, False, 23)]
    for T, n, dens, ties, isolated in cases:
        g = torch.Generator().manual_seed(T * 7919 + n)
        if ties:                     # integer-valued costs: many ties
            c_link = torch.randint(0, 3, (T, n, n), generator=g).float()
            vec = [torch.randint(0, 3, (T, n), generator=g).float()
                   for _ in range(3)]
        else:
            c_link = torch.rand((T, n, n), generator=g)
            vec = [torch.rand((T, n), generator=g) for _ in range(3)]
        adj = torch.rand((T, n, n), generator=g) < dens
        adj[:, :isolated] = False
        args = [a.to(cuda) for a in (c_link, *vec, adj)]
        got = og.offload_greedy_batched(*args)
        want = og.offload_greedy_plain(*args)
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        log(f"(a) offload_greedy T={T} n={n} density={dens} ties={ties} "
            f"isolated={isolated}: choice/best_j/best_cost equal {same}")
        if not all(same):
            raise AssertionError(f"kernel != plain version at T={T} n={n}")


def _decisions(plan, np):
    """(T, n) destination per (t, i), -1 where discarded."""
    dec = np.full(plan.r.shape, -1, np.int64)
    e = plan.edges
    dec[e.t, e.src] = e.dst
    return dec


def _compare_histories(np, got, want):
    h, w = got["history"], want["history"]
    if got["cost"] != want["cost"]:
        raise AssertionError(f"cost differs: {got['cost']} vs {want['cost']}")
    if h["agg_round"] != w["agg_round"]:
        raise AssertionError("agg_round differs")
    for k in ("H_agg", "active"):
        if not np.array_equal(np.stack(h[k]), np.stack(w[k])):
            raise AssertionError(f"{k} differs")
    if h["processed_counts"] != w["processed_counts"]:
        raise AssertionError("processed_counts differs")
    np.testing.assert_allclose(np.stack(h["device_loss"]),
                               np.stack(w["device_loss"]),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(h["test_loss"], w["test_loss"],
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(h["test_acc"], w["test_acc"], atol=1e-2)
    dl = np.abs(np.stack(h["device_loss"]) - np.stack(w["device_loss"]))
    return float(dl.max()), float(np.max(np.abs(
        np.subtract(h["test_acc"], w["test_acc"]))))


def phase_b_defaults(torch, np, card, counters, cuda):
    from repro_torch.core import movement as mv
    from repro_torch.launch import train

    for c in counters.values():
        c.reset_launches()
    t0 = time.perf_counter()
    out = train.main(DEFAULT_ARGV)
    wall = time.perf_counter() - t0
    log(f"(b) defaults (cnn n=10 T=100 tau=10) on the card: wall {wall:.3f} s, "
        f"plan {out['timing']['plan_s']:.6f} s, train "
        f"{out['timing']['train_s']:.3f} s, final_acc {out['final_acc']}, "
        f"unit cost {out['cost']['unit']}, P {out['pad_size']}, kernel "
        f"launches {[c.launches for c in counters.values()]} [{card}]")
    hist = out["history"]
    dl = np.stack(hist["device_loss"])
    if dl.shape != (100, 10) or not np.isfinite(dl).all() \
            or not np.isfinite(hist["test_loss"]).all() \
            or len(hist["test_acc"]) != 10:
        raise AssertionError("default run: history of the wrong shape or "
                             "not finite")
    pb = train.build_problem(train.parse_args(DEFAULT_ARGV))
    p_dev = mv.greedy_linear(pb["traces"], pb["schedule"], backend="cuda",
                             device=cuda)
    p_np = mv.greedy_linear(pb["traces"], pb["schedule"], backend="numpy")
    diff = int((_decisions(p_dev, np) != _decisions(p_np, np)).sum())
    log(f"(b) plan at the defaults: cuda backend vs numpy backend differ "
        f"in {diff} of {p_np.r.size} decisions (float32 vs float64 adds; "
        f"expected 0, reported only); auto-backend plan equals numpy: "
        f"{mv.plans_equal(out['plan'], p_np)}")
    on_card = train.main(SHORT_ARGV)
    on_cpu = train.main(SHORT_ARGV + ["--device", "cpu"])
    dmax, amax = _compare_histories(np, on_card, on_cpu)
    log(f"(b) defaults at T=20 card vs CPU: cost, agg_round, H_agg, active, "
        f"processed_counts equal; max |device_loss diff| {dmax}, "
        f"max |test_acc diff| {amax} [{card}]")


def phase_c_fog(torch, np, card, counters, cuda):
    from repro_torch.core import movement as mv
    from repro_torch.kernels import offload_greedy as og
    from repro_torch.launch import train

    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset_launches()
    out = train.main(FOG_ARGV)
    launches = {name: c.launches for name, c in counters.items()}
    T = int(FOG_ARGV[FOG_ARGV.index("--T") + 1])
    tim = out["timing"]
    log(f"(c) fog scale (mlp n=1000 T=20 tau=5 random rho=0.1): P "
        f"{out['pad_size']}, plan {tim['plan_s']:.4f} s, train "
        f"{tim['train_s']:.3f} s, {T / tim['train_s']:.4f} rounds/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
        f"final_acc {out['final_acc']}, kernel launches {launches} [{card}]")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")
    hist = out["history"]
    if not (np.isfinite(np.stack(hist["device_loss"])).all()
            and np.isfinite(hist["test_loss"]).all()):
        raise AssertionError("fog-scale history is not finite")
    pb = train.build_problem(train.parse_args(FOG_ARGV))
    ins = mv.device_inputs(pb["traces"], pb["schedule"], cuda)
    choice, best_j, _ = og.offload_greedy_plain(*ins)
    plain = mv._plan_from_choice(choice.cpu().numpy(), best_j.cpu().numpy())
    if not mv.plans_equal(out["plan"], plain):
        raise AssertionError("fog-scale plan differs from the plain "
                             "version's plan on the card")
    log("(c) fog-scale plan equals the plain version's plan on the card")
    return launches, ins


def _time_ms(torch, fn, args, flush, reps=30):
    """Median time of one call, each launch after an L2 flush."""
    for _ in range(3):
        fn(*args)
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        times.append((e0, e1))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times)
    return ms[len(ms) // 2]


def phase_d_timing(torch, og, ins, launches):
    """offload_greedy on the fog-scale path's own inputs."""
    c_link, c_next, c_node, f_err, adj = ins
    T, n = c_node.shape
    flush = torch.empty(64 * 1024 ** 2, dtype=torch.uint8, device="cuda")
    got = og.offload_greedy_batched(*ins)
    want = og.offload_greedy_plain(*ins)
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, want))
    if err != 0.0:           # held exactly: same adds, order-free min
        raise AssertionError(f"kernel != plain version on the fog-scale "
                             f"inputs (max abs err {err})")
    ms = _time_ms(torch, og.offload_greedy_batched, ins, flush)
    plain_ms = _time_ms(torch, og.offload_greedy_plain, ins, flush)
    # least work for these inputs: every adjacency byte, the c_link
    # entries of live links only, each vector once, each output once
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    live = int((adj & ~eye).sum())
    nbytes = T * n * n + 4 * live + 3 * 4 * T * n + 3 * 4 * T * n
    ops = 2 * live                        # one add, one compare per link
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return {"name": "offload_greedy", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/offload_greedy.cu",
            "replaces": "src/repro/kernels/offload_greedy.py:80",
            "launches": launches["offload_greedy"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "shape": {"T": T, "n": n, "live_links": live}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np

        from repro_torch.device import resolve_device
        from repro_torch.kernels import _build
        from repro_torch.kernels import offload_greedy as og
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: "
              f"{e}", file=sys.stderr)
        return 2
    counters = {"offload_greedy": og}
    card = card_line()
    cuda = resolve_device("cuda")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"[{card}]")
    t0 = time.perf_counter()
    libs = _build.build(list(counters))
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s [{card}]")
    for name, path in libs.items():
        log(path.with_suffix(".log").read_text().strip())

    failed, kernels, ins, launches = [], [], None, None
    phases = [("a", lambda: phase_a_kernels(torch, og, cuda)),
              ("b", lambda: phase_b_defaults(torch, np, card, counters, cuda)),
              ("c", lambda: phase_c_fog(torch, np, card, counters, cuda))]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
            if name == "c":
                launches, ins = res
        except Exception:                  # report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        log(f"phase ({name}) {'FAILED' if name in failed else 'ok'} in "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
    if ins is not None:
        try:
            kernels.append(phase_d_timing(torch, og, ins, launches))
            k = kernels[-1]
            log(f"(d) {k['name']} on the fog-scale inputs {k['shape']}: "
                f"kernel {k['ms']} ms, least time {1e3 * k['bound_ms']} us "
                f"(bound by {k['bound_by']}), plain version "
                f"{k['plain_ms']} ms, library call none, launches on the "
                f"main path {k['launches']}, max abs err "
                f"{k['max_abs_err']} [{card}]")
        except Exception:
            traceback.print_exc()
            failed.append("d")
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
