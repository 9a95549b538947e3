#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports no JAX. It builds every CUDA kernel of the fog and serving
paths from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source,
all started together), then runs thirteen phases and fails (exit 1, no
result line) if any of them fails:

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
(d) the Theorem-3 kernel timed on the inputs the fog-scale path gave it
    (CUDA events, warmed, the L2 cache flushed before each launch),
    beside its plain version and its least time on this card;
(e) the segment-reduce kernel against its references on the card:
    random, mostly empty, out-of-range, empty, single-segment, ragged
    and non-finite cases; its sum bitwise equal to a sequential
    ascending-order float32 sum (small shapes) and within γ_k·Σ|x| of a
    float64 sum (large shapes), bitwise equal from run to run; its max
    exactly equal to the plain version; and each group's row of
    ``aggregate_tier`` bitwise equal to ``aggregate_edges`` over the
    group's members;
(f) the tiered fog-scale path (the fog-scale flags plus ``--tiers
    32@5,4@10,1@20``), with every launch counter set to 0 just before
    and read just after: both kernels must have launched, the history
    must be finite and the tier levels [1, 2, 1, 3];
(g) the tiered defaults (cnn, n=10, T=20, ``--tiers 5@10,1@20``) once on
    the card and once on the CPU, held to each other as in (b), plus
    ``tier_agg_round`` and ``tier_agg_level`` exactly;
(h) the segment sum timed on the tier-1 ``w1`` leaf that (f) gave it,
    beside its plain version, the library call (``index_add_``), the
    layout build on its own, and its least time on this card;
(i) the flash-attention and SSD-scan kernels against their plain
    versions on the card: MHA, GQA 2:1 and MQA, head_dim 16, 64, 100,
    112 and 128, lengths that are no multiple of a tile, causal or not,
    windows 32, 128 and 200, rows the window leaves with no key (must
    be 0); the SSD scan at several (H, P, N, chunk), mamba2-1.3b's full
    SSD shape (H=64, S=1024, P=64, N=128, chunk 128) and the
    state-carry impulse. The reference's float32 tolerances: 2e-5 for
    attention, 1e-4 of max|y| for the scan, whose output is float32 on
    bfloat16 inputs too; a bfloat16 attention output within one
    bfloat16 rounding (half a step) of the plain version's float32
    result on the same inputs, plus 2e-5;
(j) the serving path of zamba2-7b at full width and depth (6.75 B
    parameters, float32, drawn on the card from the seed), every launch
    counter set to 0 just before and read just after the prefill step
    on B=2 x S=4096 prompts: flash attention must launch exactly 9
    times and the SSD scan 81 times, and the logits must be finite.
    Cold and warm prefill time, prefill tokens/s and peak memory; then
    ``serve.greedy_generate`` at the reference CLI's defaults (batch 4,
    prompt 16, 32 generated) and its decode tokens/s;
(k) full-width, full-depth correctness through the path with no
    kernel, on (j)'s parameters and on the same parameters in float64,
    for B=2 x S=256 prompts (two SSD chunks): in float64 (the kernels'
    plain versions standing in for them) the prefill logits and
    teacher-forced ``decode_step`` logits at every position agree within
    2e-3 of the largest |logit| (the reference's 2e-3, scaled), which
    drives every one of the nine shared-block cache slots; in float32
    the kernels' prefill lies no further from the float64 prefill than
    twice the larger distance of the two kernel-free float32 paths
    (prefill through the plain versions, teacher-forced decode), nor
    than that tolerance; and the first token ``greedy_generate`` emits
    for each prompt has a float64 prefill logit within the float32
    tolerance of the row's maximum;
(l) both serving kernels timed on the inputs (j) gave them, beside
    their plain versions, the library call (scaled_dot_product_attention
    for attention; none for the scan), the CUDA kernels one call
    launches (counted by torch.profiler), and two least times on this
    card: ``bound_ms`` on the tensor cores (the larger of the bytes at
    3.35 TB/s and the flops at 495 / 3 TFLOP/s, the 3xTF32 rate) and,
    in the log line only, the flops at 67 TFLOP/s on the CUDA cores;
    attention's kernel and plain version also against float64 (batch 0,
    q heads 0-7);
(m) the smoke configs of zamba2-7b, mamba2-1.3b and qwen3-14b once on
    the card and once on the CPU through the port, with the same
    parameters: logits within 1e-4 of the largest |logit|, greedy
    tokens equal.

The line before the last is the JSON list of kernels; the one before it
the card's name and power limit; the last line is the result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM: HBM bandwidth, float32 rate outside the tensor cores and
# dense TF32 tensor-core rate (NVIDIA data sheet; the least times below
# are against these peaks). Float32 accuracy on the tensor cores takes
# three TF32 products (3xTF32), so a third of the TF32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32X3_OPS_PER_S = 495e12 / 3

DEFAULT_ARGV = ["--mode", "fog"]
SHORT_ARGV = ["--mode", "fog", "--T", "20", "--n-train", "4000",
              "--n-test", "1000"]
FOG_ARGV = ["--mode", "fog", "--model", "mlp", "--n", "1000", "--T", "20",
            "--tau", "5", "--topology", "random", "--rho", "0.1",
            "--n-train", "60000", "--n-test", "10000"]
TIERED_FOG_ARGV = FOG_ARGV + ["--tiers", "32@5,4@10,1@20"]
TIERED_SHORT_ARGV = SHORT_ARGV + ["--tiers", "5@10,1@20"]


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
    if launches["offload_greedy"] == 0:
        raise AssertionError("main path launched no offload_greedy kernel")
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


def _seq_sum(np, data, ids, S):
    """Sequential ascending-order float32 sums, on the CPU: np.cumsum
    adds one element at a time; adding the last partial sum to 0 gives
    the kernel's start value of +0."""
    out = np.zeros(S, np.float32)
    valid = (ids >= 0) & (ids < S)
    order = np.argsort(np.where(valid, ids, S), kind="stable")
    order = order[:int(valid.sum())]
    bounds = np.searchsorted(ids[order], np.arange(S + 1))
    for s_ in np.nonzero(np.diff(bounds))[0]:
        vals = data[order[bounds[s_]:bounds[s_ + 1]]]
        out[s_] = np.float32(0) + np.cumsum(vals, dtype=np.float32)[-1]
    return out


def _same_bits(np, a, b):
    """Bitwise equal, NaN matching NaN whatever its payload."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    na, nb = np.isnan(a), np.isnan(b)
    return bool((na == nb).all() and np.array_equal(
        a[~na].view(np.int32), b[~nb].view(np.int32)))


def _segment_cases(np):
    """(name, data f32, ids int32, S): the edge cases of phase (e)."""
    rng = np.random.default_rng(12)

    def normal(E):
        return rng.standard_normal(E).astype(np.float32)

    cases = [("random unsorted", normal(200_000),
              rng.integers(0, 3_001, 200_000), 3_001),
             ("mostly empty", normal(5_000),
              rng.choice(np.arange(0, 100_000, 97), 5_000), 100_000),
             ("out of range", normal(100_000),
              rng.integers(-500, 20_500, 100_000), 20_000),
             ("no elements", normal(0), np.zeros(0, np.int64), 17),
             ("one huge segment", normal(1 << 20), np.full(1 << 20, 3), 5),
             ("ragged S", normal(123_457),
              rng.integers(0, 7_919, 123_457), 7_919)]
    data = normal(1_000)
    ids = rng.integers(0, 50, 1_000)
    data[ids == 7] = 1.0
    hit = np.nonzero(ids == 7)[0]
    data[hit[0]], data[hit[-1]] = np.nan, np.inf
    data[np.nonzero(ids == 9)[0][0]] = -np.inf
    cases.append(("NaN and inf in one segment", data, ids, 50))
    return [(name, d, i.astype(np.int32), S) for name, d, i, S in cases]


def phase_e_segment(torch, np, sr, eng, card, cuda):
    """Segment-reduce kernel against its references on the card."""
    for name, data, ids, S in _segment_cases(np):
        d = torch.from_numpy(data).to(cuda)
        i = torch.from_numpy(ids).to(cuda)
        got = sr.segment_sum(d, i, S).cpu().numpy()
        again = sr.segment_sum(d, i, S).cpu().numpy()
        want = _seq_sum(np, data, ids, S)
        mx = sr.segment_max(d, i, S).cpu().numpy()
        mx_cpu = sr.segment_max_plain(torch.from_numpy(data),
                                      torch.from_numpy(ids), S).numpy()
        ok = {"sum == sequential sum": _same_bits(np, got, want),
              "sum repeats": _same_bits(np, got, again),
              "max == plain on CPU": _same_bits(np, mx, mx_cpu)}
        if np.isfinite(data).all():      # CUDA amax on NaN is no yardstick
            mx_card = sr.segment_max_plain(d, i, S).cpu().numpy()
            ok["max == plain on card"] = _same_bits(np, mx, mx_card)
        log(f"(e) segment_reduce {name} (E={len(data)}, S={S}): {ok}")
        if not all(ok.values()):
            raise AssertionError(f"segment kernel wrong on {name}: {ok}")
    # large shapes: within gamma_k * sum|x| of a float64 sum, and bitwise
    # repeatable
    E, S = 50_000_000, 1_000_003
    g = torch.Generator(device=cuda).manual_seed(5)
    d = torch.randn(E, generator=g, device=cuda)
    i = torch.randint(-1_000, S + 1_000, (E,), generator=g, device=cuda,
                      dtype=torch.int32)
    layout = sr.segment_layout(i, S)
    got = sr.segment_sum(d, i, S, layout=layout)
    for _ in range(2):
        again = sr.segment_sum(d, i, S, layout=layout)
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError("segment sum not bitwise repeatable")
    valid = (i >= 0) & (i < S)
    iv = i[valid].long()
    ref = torch.zeros(S, dtype=torch.float64, device=cuda).index_add_(
        0, iv, d[valid].double())
    mag = torch.zeros(S, dtype=torch.float64, device=cuda).index_add_(
        0, iv, d[valid].double().abs())
    k = torch.bincount(iv, minlength=S).double()
    u = 2.0 ** -24
    gamma = k * u / (1 - k * u)
    excess = ((got.double() - ref).abs() - gamma * mag).max().item()
    mx = sr.segment_max(d, i, S, layout=layout)
    mx_equal = bool(torch.equal(mx, sr.segment_max_plain(d, i, S)))
    log(f"(e) segment_reduce large (E={E}, S={S}, up to {int(k.max())} per "
        f"segment): sum repeats bitwise; max(|sum - f64 sum| - "
        f"gamma_k*sum|x|) = {excess} (must be <= 0); max == plain on card "
        f"{mx_equal} [{card}]")
    if excess > 0 or not mx_equal:
        raise AssertionError("large segment sum outside gamma_k*sum|x| or "
                             "max != plain")
    # aggregate_tier row g == aggregate_edges over group g, at full width
    from repro_torch.core.hierarchy import TierTree
    tree = TierTree.from_spec("32@5,4@10,1@20", 1000)
    g = torch.Generator(device=cuda).manual_seed(3)
    W = {"w1": torch.randn((1000, 784, 200), generator=g, device=cuda),
         "b1": torch.randn((1000, 200), generator=g, device=cuda)}
    H = torch.randint(0, 40, (1000,), generator=g, device=cuda).float()
    gids = tree.parents[0]
    Wg, Hg = eng.aggregate_tier(W, H, gids, 32)
    bad = [g_ for g_ in range(32) if not all(
        torch.equal(Wg[k_][g_], v)
        for k_, v in eng.aggregate_edges(W, H, np.nonzero(gids == g_)[0],
                                         None).items())]
    log(f"(e) aggregate_tier (m=1000, 32 groups, w1 784x200, b1 200) row g "
        f"== aggregate_edges over group g, bitwise: {not bad}")
    if bad:
        raise AssertionError(f"aggregate_tier rows {bad} differ from "
                             "aggregate_edges")


def phase_f_tiered_fog(torch, np, card, counters, ops):
    """The tiered fog-scale path; keeps the tier-1 w1 segment sum's
    inputs for phase (h)."""
    from repro_torch.launch import train

    biggest = {}
    real_sum = ops.segment_sum

    def keep_biggest(data, segment_ids, *, num_segments, layout=None):
        if data.shape[0] > biggest.get("E", -1):
            biggest.update(E=data.shape[0], data=data, ids=segment_ids,
                           S=num_segments, layout=layout)
        return real_sum(data, segment_ids, num_segments=num_segments,
                        layout=layout)

    torch.cuda.reset_peak_memory_stats()
    ops.segment_sum = keep_biggest
    try:
        for c in counters.values():
            c.reset_launches()
        out = train.main(TIERED_FOG_ARGV)
        launches = {name: c.launches for name, c in counters.items()}
    finally:
        ops.segment_sum = real_sum
    T = int(FOG_ARGV[FOG_ARGV.index("--T") + 1])
    tim = out["timing"]
    hist = out["history"]
    log(f"(f) tiered fog scale (mlp n=1000 T=20 tau=5 random rho=0.1, tiers "
        f"32@5,4@10,1@20): P {out['pad_size']}, plan {tim['plan_s']:.4f} s, "
        f"train {tim['train_s']:.3f} s, {T / tim['train_s']:.4f} rounds/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
        f"final_acc {out['final_acc']}, tier levels "
        f"{hist['tier_agg_level']}, kernel launches {launches} [{card}]")
    missing = [k for k in ("offload_greedy", "segment_reduce")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"tiered path launched no {missing} kernel")
    # one H_g sum and one sum per leaf (the mlp has four), for tiers
    # 1..level of each aggregation round
    want = sum(hist["tier_agg_level"]) * (1 + 4)
    if launches["segment_reduce"] != want:
        raise AssertionError(f"{launches['segment_reduce']} segment "
                             f"launches, expected {want}")
    if hist["tier_agg_level"] != [1, 2, 1, 3]:
        raise AssertionError(f"tier levels {hist['tier_agg_level']}")
    if not (np.isfinite(np.stack(hist["device_loss"])).all()
            and np.isfinite(hist["test_loss"]).all()
            and np.isfinite(np.stack(hist["H_agg"])).all()):
        raise AssertionError("tiered fog-scale history is not finite")
    return launches, biggest


def phase_g_tiered_defaults(np, card):
    from repro_torch.launch import train

    on_card = train.main(TIERED_SHORT_ARGV)
    on_cpu = train.main(TIERED_SHORT_ARGV + ["--device", "cpu"])
    dmax, amax = _compare_histories(np, on_card, on_cpu)
    h, w = on_card["history"], on_cpu["history"]
    for k in ("tier_agg_round", "tier_agg_level"):
        if h[k] != w[k]:
            raise AssertionError(f"{k} differs: {h[k]} vs {w[k]}")
    log(f"(g) tiered defaults (cnn n=10 T=20, tiers 5@10,1@20) card vs CPU: "
        f"cost, agg_round, H_agg, active, processed_counts, tier_agg_round "
        f"{h['tier_agg_round']}, tier_agg_level {h['tier_agg_level']} equal;"
        f" max |device_loss diff| {dmax}, max |test_acc diff| {amax} "
        f"[{card}]")


def phase_h_segment_timing(torch, sr, biggest, launches):
    """segment_sum on the tier-1 w1 leaf of the tiered fog-scale run."""
    d, ids, S, layout = (biggest[k] for k in ("data", "ids", "S", "layout"))
    layout = layout or sr.segment_layout(ids, S)
    E = d.shape[0]
    flush = torch.empty(64 * 1024 ** 2, dtype=torch.uint8, device="cuda")
    got = sr.segment_sum(d, ids, S, layout=layout)
    plain = sr.segment_sum_plain(d, ids, S)
    diff = (got.double() - plain.double()).abs()
    err = float(diff.max())
    # both are float32 sums of the same k terms in two orders, each within
    # gamma_k * sum|x| of the exact sum: they differ by at most twice that
    k = (layout.offsets[1:] - layout.offsets[:-1]).double()
    mag = torch.zeros(S, dtype=torch.float64, device=d.device).index_add_(
        0, ids.long(), d.double().abs())
    u = 2.0 ** -24
    if bool((diff > 2 * k * u / (1 - k * u) * mag).any()):
        raise AssertionError("segment sum and its plain version differ by "
                             "more than 2*gamma_k*sum|x| on the w1 leaf")
    idx64 = ids.long()

    def library_sum(d, ids, S):
        return torch.zeros(S, device=d.device).index_add_(0, ids, d)

    def library_max(d, ids, S):
        return torch.full((S,), float("-inf"), device=d.device) \
            .scatter_reduce_(0, idx64, d, "amax")

    def kernel_sum(d, ids, S):
        return sr.segment_sum(d, ids, S, layout=layout)

    def kernel_max(d, ids, S):
        return sr.segment_max(d, ids, S, layout=layout)

    args = (d, ids, S)
    ms = _time_ms(torch, kernel_sum, args, flush)
    plain_ms = _time_ms(torch, sr.segment_sum_plain, args, flush)
    library_ms = _time_ms(torch, library_sum, args, flush)
    layout_ms = _time_ms(torch, sr.segment_layout, (ids, S), flush, reps=10)
    max_ms = _time_ms(torch, kernel_max, args, flush)
    max_plain_ms = _time_ms(torch, sr.segment_max_plain, args, flush)
    max_library_ms = _time_ms(torch, library_max, args, flush)
    if not torch.equal(kernel_max(*args), sr.segment_max_plain(*args)):
        raise AssertionError("segment max != plain on the w1 leaf")
    # least work: each float and each int32 id read once, each sum written
    nbytes = 4 * E + 4 * E + 4 * S
    ops_ = E                                  # one add per element
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S
    return {"name": "segment_reduce", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_reduce.py:78",
            "launches": launches["segment_reduce"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "layout_ms": layout_ms, "max_ms": max_ms,
            "max_plain_ms": max_plain_ms, "max_library_ms": max_library_ms,
            "shape": {"E": E, "S": S}}


# zamba2-7b serving: the prefill shape, the correctness shape, the serve
# CLI's defaults
SERVE_ARCH = "zamba2-7b"
PREFILL_B, PREFILL_S = 2, 4096
CHECK_B, CHECK_S = 2, 256
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 32
SEED = 0
ATTN_TOL = 2e-5          # the reference's float32 tolerances
SSD_TOL = 1e-4           # (tests/test_kernels.py), the latter of max|y|
BF16_HALF_STEP = 2.0 ** -8   # half a bfloat16 step, relative
DECODE_TOL = 2e-3        # tests/test_models_smoke.py, of max|logit| here
PORT_TOL = 1e-4          # tests/test_torch_lm.py, of max|logit|


def _randn(torch, shape, seed, cuda, scale=1.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, generator=g, device=cuda) * scale


def bf16_excess(torch, got, want):
    """How far a bfloat16 result lies outside one rounding of the float32
    result plus the float32 tolerance: |got - want| - (half a bfloat16
    step of the larger of |got|, |want|, + ATTN_TOL); <= 0 passes."""
    got = got.float()
    room = BF16_HALF_STEP * torch.maximum(got.abs(), want.abs()) + ATTN_TOL
    return float(((got - want).abs() - room).max())


def phase_i_new_kernels(torch, fa, sd, cuda):
    """Flash attention and the SSD scan against their plain versions: in
    float32 at the reference's float32 tolerances; a bfloat16 attention
    output against the plain version in float32 on the same (widened)
    inputs, within one bfloat16 rounding plus the float32 tolerance; the
    scan's float32 output at its float32 tolerance whatever its inputs'
    type."""
    attn = [  # B, H, KH, Sq, Sk, hd, causal, window
        (1, 4, 4, 128, 128, 64, True, None),      # MHA
        (2, 4, 2, 256, 256, 64, False, None),     # GQA 2:1
        (1, 8, 1, 256, 256, 16, True, None),      # MQA
        (1, 2, 2, 100, 77, 112, True, None),      # ragged, zamba2's hd
        (1, 4, 2, 77, 100, 128, False, None),
        (1, 2, 2, 300, 300, 112, True, 32),
        (1, 2, 2, 300, 300, 64, True, 128),
        (2, 4, 2, 300, 300, 128, False, 200),
        (1, 4, 2, 200, 64, 112, True, 16),        # rows 79.. see no key
        (2, 32, 32, 1000, 1000, 112, True, None),  # zamba2's heads
        (1, 4, 2, 200, 200, 100, True, None),     # hd no multiple of 8
        (2, 4, 2, 256, 256, 64, True, None, torch.bfloat16),
        (1, 4, 4, 300, 300, 112, False, 128, torch.bfloat16),
        (1, 2, 2, 130, 130, 100, True, None, torch.bfloat16),
    ]
    for i, (B, H, KH, Sq, Sk, hd, causal, window, *dt) in enumerate(attn):
        dtype = dt[0] if dt else torch.float32
        q = _randn(torch, (B, H, Sq, hd), 3 * i, cuda).to(dtype)
        k = _randn(torch, (B, KH, Sk, hd), 3 * i + 1, cuda).to(dtype)
        v = _randn(torch, (B, KH, Sk, hd), 3 * i + 2, cuda).to(dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        fa.default_kv_map(H, KH),
                                        causal=causal, window=window)
        torch.cuda.synchronize()
        if got.dtype != dtype:
            raise AssertionError(f"flash_attention returned {got.dtype}")
        err = float((got.float() - want).abs().max())
        if dt:
            tol = "one bfloat16 rounding + 2e-05"
            if bf16_excess(torch, got, want) > 0:
                raise AssertionError(f"bfloat16 flash_attention != plain "
                                     f"at {B, H, KH, Sq, Sk, hd}")
        else:
            tol = ATTN_TOL
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        got = got.float()
        dead = ""
        if window is not None and Sq >= Sk + window:
            rows = got[:, :, Sk + window - 1:]
            if not bool((rows == 0).all()):
                raise AssertionError("fully masked rows are not 0")
            dead = f", {rows.shape[2]} fully masked rows all 0"
        log(f"(i) flash_attention B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} "
            f"hd={hd} causal={causal} window={window} {dtype}: max abs "
            f"err {err} (tolerance {tol}){dead}")
    ssd = [(1, 2, 128, 32, 16, 32), (2, 4, 256, 64, 64, 128),
           (1, 1, 64, 16, 128, 64), (2, 3, 64, 32, 16, 8),
           (2, 8, 1024, 64, 64, 128), (1, 4, 384, 112, 32, 96),
           (1, 64, 1024, 64, 128, 128),          # mamba2-1.3b's full shape
           (2, 4, 256, 64, 64, 128, torch.bfloat16),
           (1, 8, 512, 64, 128, 128, torch.bfloat16)]
    for i, (B, H, S, P, N, chunk, *dt) in enumerate(ssd):
        dtype = dt[0] if dt else torch.float32
        tol = SSD_TOL
        xdt = _randn(torch, (B, H, S, P), 50 + i, cuda, 0.3).to(dtype)
        a = -_randn(torch, (B, H, S), 60 + i, cuda, 0.3).abs()
        Bm = _randn(torch, (B, S, N), 70 + i, cuda, 0.3).to(dtype)
        Cm = _randn(torch, (B, S, N), 80 + i, cuda, 0.3).to(dtype)
        got = sd.ssd_scan(xdt, a, Bm, Cm, chunk=chunk)
        want = sd.ssd_scan_plain(xdt, a, Bm, Cm, chunk=chunk)
        rel = float((got - want).abs().max() / want.abs().max())
        log(f"(i) ssd_scan B={B} H={H} S={S} P={P} N={N} chunk={chunk} "
            f"{dtype}: max abs err / max|y| {rel} (tolerance {tol})")
        if got.dtype != torch.float32 or not rel <= tol:
            raise AssertionError(f"ssd_scan != plain at {B, H, S, P, N} "
                                 f"{dtype}")
    # state carried across chunks: an early impulse reaches the end
    xdt = torch.zeros((1, 1, 256, 8), device=cuda)
    xdt[0, 0, 3] = 1.0
    a = torch.full((1, 1, 256), -0.01, device=cuda)
    Bm = torch.full((1, 256, 8), 0.5, device=cuda)
    got = sd.ssd_scan(xdt, a, Bm, Bm, chunk=64)
    want = sd.ssd_scan_plain(xdt, a, Bm, Bm, chunk=64)
    err = float((got - want).abs().max())
    last = float(got[0, 0, -1].abs().max())
    log(f"(i) ssd_scan state-carry impulse (S=256, chunk 64): |y_last| "
        f"{last}, max abs err {err}")
    if not (last > 1e-3 and err <= 1e-5):
        raise AssertionError("the SSD state does not carry across chunks")


def _serve_modules():
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params, param_count
    return get_config, serve, steps, T, init_params, param_count


def phase_j_serve(torch, np, card, counters, ops, cuda):
    """zamba2-7b at full width and depth: prefill with launch counts,
    then greedy serving. Keeps the params and the kernels' first inputs
    for (k) and (l)."""
    get_config, serve, steps, T, init_params, param_count = _serve_modules()
    torch.cuda.empty_cache()
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_params(T.specs(cfg), seed=SEED, device=cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(T.specs(cfg))
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S)).astype(np.int32)).to(cuda)
    prefill = steps.make_prefill_step(cfg)
    first = {}

    def keep(name, real):
        def call(*args, **kw):
            first.setdefault(name, (args, kw))
            return real(*args, **kw)
        return call

    torch.cuda.reset_peak_memory_stats()
    with _ops_as(ops, {"attention": keep("attention", ops.attention),
                       "ssd": keep("ssd", ops.ssd)}):
        for c in counters.values():
            c.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    with torch.no_grad():
        again = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    log(f"(j) {SERVE_ARCH} full ({n_params} parameters, float32, "
        f"{cfg.num_layers} Mamba2 blocks + shared attention every "
        f"{cfg.attn_every}): init on the card {init_s:.3f} s; prefill "
        f"B={PREFILL_B} S={PREFILL_S}: cold {cold:.4f} s, warm "
        f"{warm:.4f} s, {PREFILL_B * PREFILL_S / warm:.1f} prefill "
        f"tokens/s, max_memory_allocated {peak} B, logits "
        f"{tuple(logits.shape)} finite {finite}, equal on a second run "
        f"{bool(torch.equal(logits, again))}, kernel launches {launches} "
        f"[{card}]")
    if launches["flash_attention"] != cfg.num_layers // cfg.attn_every \
            or launches["ssd_scan"] != cfg.num_layers:
        raise AssertionError(f"prefill launched {launches}; expected 9 "
                             "flash_attention and 81 ssd_scan")
    if not finite:
        raise AssertionError("prefill logits are not finite")
    prompts = rng.integers(0, cfg.vocab_size,
                           (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    t0 = time.perf_counter()
    out, tps = serve.greedy_generate(cfg, params, prompts, SERVE_GEN)
    wall = time.perf_counter() - t0
    log(f"(j) {SERVE_ARCH} full greedy_generate batch {SERVE_BATCH}, "
        f"prompt {SERVE_PROMPT}, {SERVE_GEN} generated: tokens "
        f"{out.shape}, {tps:.2f} decode tokens/s, wall {wall:.3f} s "
        f"(prefill through the decode step included), sample "
        f"{out[0, -8:].tolist()} [{card}]")
    if out.shape != (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN) \
            or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("greedy_generate gave tokens of the wrong "
                             "shape or range")
    return {"cfg": cfg, "params": params, "first": first,
            "launches": launches}


@contextlib.contextmanager
def _ops_as(ops, fns):
    """Route the named ``ops`` functions through ``fns`` for a while."""
    real = {name: getattr(ops, name) for name in fns}
    for name, fn in fns.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


def _plain_ops(torch, fa, sd):
    """ops.attention and ops.ssd through the kernels' plain versions,
    which take any device and float dtype."""
    def attention(q, k, v, *, causal=True, window=None, kv_map=None):
        km = (fa.default_kv_map(q.shape[1], k.shape[1]) if kv_map is None
              else torch.as_tensor(kv_map))
        return fa.flash_attention_plain(q, k, v, km, causal=causal,
                                        window=window)

    def ssd(xdt, a, Bm, Cm, *, chunk=128):
        return sd.ssd_scan_plain(xdt, a, Bm, Cm, chunk=chunk)

    return {"attention": attention, "ssd": ssd}


def _to_float64(torch, tree):
    """Every floating leaf of a nested dict in float64, in place: the
    largest first, each float32 leaf freed before the next is copied, so
    27 GB of float32 parameters become 54 GB of float64 on an 80 GB card."""
    found = []

    def walk(d):
        for key, val in d.items():
            if isinstance(val, dict):
                walk(val)
            elif val.is_floating_point():
                found.append((val.numel(), d, key))

    walk(tree)
    for _, d, key in sorted(found, key=lambda e: -e[0]):
        d[key] = d[key].double()
        torch.cuda.empty_cache()
    return tree


def _teacher_forced(torch, T, steps, init_params, cfg, params, toks, dtype):
    """decode_step logits at every position of toks (B, S), the cache in
    ``dtype`` (its SSM state spec says float32: cast to ``dtype`` too)."""
    B, S = toks.shape
    cache = init_params(T.init_cache_specs(cfg, B, S), dtype=dtype,
                        device=toks.device)
    cache["h"] = cache["h"].to(dtype)
    decode = steps.make_decode_step(cfg)
    out = []
    for i in range(S):
        lg, cache = decode(params, cache, {"tokens": toks[:, i:i + 1]}, i)
        out.append(lg[:, 0, :cfg.vocab_size])
    return torch.stack(out, dim=1)


def phase_k_decode_check(torch, np, card, served, ops, fa, sd):
    """Prefill against teacher-forced decode (no kernel) at full width
    and depth: in float64, to the reference's tolerance; in float32, the
    kernels' prefill against the float64 prefill, held to the float32
    rounding the kernel-free paths show. Leaves (j)'s parameters in
    float64."""
    _, serve, steps, T, init_params, _ = _serve_modules()
    cfg, params = served["cfg"], served["params"]
    V = cfg.vocab_size
    rng = np.random.default_rng(SEED + 1)
    prompts = rng.integers(0, V, (CHECK_B, CHECK_S)).astype(np.int32)
    toks = torch.from_numpy(prompts).cuda()
    plain = _plain_ops(torch, fa, sd)
    t0 = time.perf_counter()
    with torch.no_grad():
        kern32 = T.forward(params, {"tokens": toks}, cfg)[0][..., :V]
        with _ops_as(ops, plain):
            plain32 = T.forward(params, {"tokens": toks}, cfg)[0][..., :V]
        dec32 = _teacher_forced(torch, T, steps, init_params, cfg, params,
                                toks, torch.float32)
    out, _ = serve.greedy_generate(cfg, params, prompts, 1)
    torch.cuda.synchronize()
    s32 = time.perf_counter() - t0
    t0 = time.perf_counter()
    _to_float64(torch, params)
    with torch.no_grad():
        with _ops_as(ops, plain):
            ref64 = T.forward(params, {"tokens": toks}, cfg)[0][..., :V]
        dec64 = _teacher_forced(torch, T, steps, init_params, cfg, params,
                                toks, torch.float64)
    torch.cuda.synchronize()
    s64 = time.perf_counter() - t0
    top = float(ref64.abs().max())
    tol = DECODE_TOL * top
    d64 = float((dec64 - ref64).abs().max())
    err = {name: float((x.double() - ref64).abs().max())
           for name, x in (("kernel prefill", kern32),
                           ("plain prefill", plain32),
                           ("decode", dec32))}
    tol32 = max(tol, 2 * max(err["plain prefill"], err["decode"]))
    d32 = float((kern32 - dec32).abs().max())
    log(f"(k) {SERVE_ARCH} full width and depth ({cfg.num_layers} Mamba2 "
        f"blocks + the shared block {cfg.num_layers // cfg.attn_every} "
        f"times), B={CHECK_B} S={CHECK_S} ({CHECK_S // cfg.ssm_chunk} SSD "
        f"chunks): float64 prefill vs teacher-forced decode max abs diff "
        f"{d64} (tolerance {tol} = {DECODE_TOL} x max|logit| {top}); "
        f"float32 max abs diff from the float64 prefill: {err} (kernel "
        f"prefill tolerance {tol32}); float32 prefill vs teacher-forced "
        f"decode {d32}; float32 paths {s32:.3f} s, float64 paths "
        f"{s64:.3f} s [{card}]")
    if not d64 <= tol:
        raise AssertionError("float64 prefill and decode logits differ")
    if not err["kernel prefill"] <= tol32:
        raise AssertionError("the kernels' float32 prefill is further from "
                             "float64 than float32 rounding explains")
    first = torch.from_numpy(out[:, CHECK_S].astype(np.int64)).cuda()
    last = ref64[:, -1]
    gap = (last.max(dim=1).values
           - last.gather(1, first[:, None])[:, 0]).cpu().numpy()
    log(f"(k) greedy_generate first tokens {out[:, CHECK_S].tolist()}, "
        f"float64 prefill argmax {last.argmax(dim=1).tolist()}, its max "
        f"logit minus the token's logit {gap.tolist()} (tolerance {tol32})")
    if not (gap <= tol32).all():
        raise AssertionError("greedy_generate's first token is not the "
                             "prefill's maximum within the tolerance")


def _visible_pairs(np, Sq, Sk, causal, window):
    """(query, key) pairs the masks leave, counted row by row."""
    i = np.arange(Sq)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _bounds(nbytes, ops_):
    """Least times of a tensor-core kernel whose products are 3xTF32:
    bytes at the HBM rate against flops at the 3xTF32 rate; and, for the
    log line, the flops on the CUDA cores."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / TF32X3_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_cuda_cores_ms": 1e3 * max(t_bytes,
                                             ops_ / F32_OPS_PER_S)}


def _cuda_kernels(torch, fn, args):
    """CUDA kernels that one call of fn launches, counted in a profiler
    trace of a warm call (copies and memsets not counted)."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    if not names:
        raise AssertionError("the profiler saw no CUDA kernel")
    return len(names)


def phase_l_timing(torch, np, fa, sd, served):
    """Both new kernels on the inputs the zamba2-7b prefill gave them."""
    flush = torch.empty(64 * 1024 ** 2, dtype=torch.uint8, device="cuda")
    (q, k, v), kw = served["first"]["attention"]
    kv_map = kw.get("kv_map")
    B, H, Sq, hd = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    causal, window = kw["causal"], kw["window"]
    km = torch.as_tensor(kv_map, dtype=torch.int32)

    def kernel_attn(q, k, v):
        return fa.flash_attention(q, k, v, kv_map, causal=causal,
                                  window=window)

    def plain_attn(q, k, v):
        return fa.flash_attention_plain(q, k, v, km, causal=causal,
                                        window=window)

    def library_attn(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal)

    got, want = kernel_attn(q, k, v), plain_attn(q, k, v)
    attn_err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=ATTN_TOL, rtol=ATTN_TOL)
    del got, want
    # both against float64, on batch 0 and q heads 0..7
    qs, ks, vs = q[:1, :8].contiguous(), k[:1], v[:1]
    exact = fa.flash_attention_plain(qs.double(), ks.double(), vs.double(),
                                     km[:8], causal=causal, window=window)
    vs_f64 = {
        "kernel": float((fa.flash_attention(qs, ks, vs, km[:8].to(q.device),
                                            causal=causal, window=window)
                         - exact).abs().max()),
        "plain": float((fa.flash_attention_plain(
            qs, ks, vs, km[:8], causal=causal, window=window)
            - exact).abs().max())}
    del exact
    lib_ok = window is None and H == KH
    pairs = B * H * _visible_pairs(np, Sq, Sk, causal, window)
    nbytes = 4 * (2 * B * H * Sq * hd + 2 * B * KH * Sk * hd)
    ops_ = 4 * hd * pairs              # q.k and p.v: 2 flops a MAC each
    attn = {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:109",
            "launches": served["launches"]["flash_attention"],
            "max_abs_err": attn_err,
            "ms": _time_ms(torch, kernel_attn, (q, k, v), flush),
            "plain_ms": _time_ms(torch, plain_attn, (q, k, v), flush),
            **_bounds(nbytes, ops_),
            "library_ms": (_time_ms(torch, library_attn, (q, k, v), flush)
                           if lib_ok else None),
            "cuda_kernels": _cuda_kernels(torch, kernel_attn, (q, k, v)),
            "vs_float64": vs_f64,
            "shape": {"B": B, "H": H, "KH": KH, "Sq": Sq, "Sk": Sk,
                      "hd": hd, "causal": causal, "window": window,
                      "visible_pairs": pairs, "flops": ops_}}
    (xdt, a, Bm, Cm), kw = served["first"]["ssd"]
    chunk = kw["chunk"]
    B, H, S, P = xdt.shape
    N = Bm.shape[-1]

    def kernel_ssd(*args):
        return sd.ssd_scan(*args, chunk=chunk)

    def plain_ssd(*args):
        return sd.ssd_scan_plain(*args, chunk=chunk)

    args = (xdt, a, Bm, Cm)
    got, want = kernel_ssd(*args), plain_ssd(*args)
    ssd_err = float((got - want).abs().max())
    if not ssd_err <= SSD_TOL * float(want.abs().max()):
        raise AssertionError("ssd_scan != plain on the prefill's inputs")
    l = min(chunk, S)
    tri = l * (l + 1) // 2      # the (i, j <= i) pairs: L is 0 above them
    # C·Bᵀ once per (batch, chunk), as B and C are shared by the heads;
    # per head the masked product with x, C·Sᵀ and the state update
    ops_ = B * (S // l) * (2 * tri * N
                           + H * (2 * tri * P + 2 * l * N * P + 2 * l * P * N))
    nbytes = 4 * (2 * B * H * S * P + B * H * S + 2 * B * S * N)
    ssd = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:81",
           "launches": served["launches"]["ssd_scan"],
           "max_abs_err": ssd_err,
           "ms": _time_ms(torch, kernel_ssd, args, flush),
           "plain_ms": _time_ms(torch, plain_ssd, args, flush),
           **_bounds(nbytes, ops_),
           "library_ms": None,
           "cuda_kernels": _cuda_kernels(torch, kernel_ssd, args),
           "shape": {"B": B, "H": H, "S": S, "P": P, "N": N, "chunk": l,
                     "flops": ops_}}
    return attn, ssd


def phase_m_smoke_configs(torch, np, card, counters, cuda):
    """Smoke configs on the card and on the CPU with the same params."""
    get_config, serve, _, T, init_params, _ = _serve_modules()
    cpu = torch.device("cpu")
    for arch in ("zamba2-7b", "mamba2-1.3b", "qwen3-14b"):
        cfg = get_config(arch, smoke=True)
        p_cpu = init_params(T.specs(cfg), seed=SEED, device=cpu)
        p_card = {}

        def to_card(src, dst):
            for key, val in src.items():
                if isinstance(val, dict):
                    to_card(val, dst.setdefault(key, {}))
                else:
                    dst[key] = val.to(cuda)

        to_card(p_cpu, p_card)
        rng = np.random.default_rng(SEED + 2)
        toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
        for c in counters.values():
            c.reset_launches()
        with torch.no_grad():
            lc, _ = T.forward(p_card, {"tokens": torch.from_numpy(toks)
                                       .to(cuda)}, cfg)
            lh, _ = T.forward(p_cpu, {"tokens": torch.from_numpy(toks)}, cfg)
        launches = {n: c.launches for n, c in counters.items()}
        diff = float((lc.cpu() - lh).abs().max())
        tol = PORT_TOL * max(1.0, float(lh.abs().max()))
        prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        g_card, _ = serve.greedy_generate(cfg, p_card, prompts, 8)
        g_cpu, _ = serve.greedy_generate(cfg, p_cpu, prompts, 8)
        same = bool((g_card == g_cpu).all())
        log(f"(m) {arch} smoke card vs CPU: logits max abs diff {diff} "
            f"(tolerance {tol}), greedy tokens equal {same}, kernel "
            f"launches on the card's forward {launches} [{card}]")
        if not (diff <= tol and same):
            raise AssertionError(f"{arch} smoke: card and CPU disagree")
        want_ssd = cfg.num_layers if cfg.ssm_state else 0
        want_attn = (cfg.num_layers // cfg.attn_every if cfg.attn_every
                     else 0 if cfg.ssm_state else cfg.num_layers)
        if (launches["ssd_scan"], launches["flash_attention"]) != \
                (want_ssd, want_attn):
            raise AssertionError(f"{arch} smoke launched {launches}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np

        from repro_torch.core import engine as eng
        from repro_torch.device import resolve_device
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import offload_greedy as og
        from repro_torch.kernels import ops
        from repro_torch.kernels import segment_reduce as sr
        from repro_torch.kernels import ssd_scan as sd
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: "
              f"{e}", file=sys.stderr)
        return 2
    counters = {"offload_greedy": og, "segment_reduce": sr,
                "flash_attention": fa, "ssd_scan": sd}
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

    state: dict = {}
    kernels: dict = {}

    def c():
        state["c"] = phase_c_fog(torch, np, card, counters, cuda)

    def d():
        launches, ins = state["c"]
        k = kernels["offload_greedy"] = phase_d_timing(torch, og, ins,
                                                       launches)
        log(f"(d) {k['name']} on the fog-scale inputs {k['shape']}: "
            f"kernel {k['ms']} ms, least time {1e3 * k['bound_ms']} us "
            f"(bound by {k['bound_by']}), plain version {k['plain_ms']} ms, "
            f"library call none, launches on the main path "
            f"{k['launches']}, max abs err {k['max_abs_err']} [{card}]")

    def f():
        state["f"] = phase_f_tiered_fog(torch, np, card, counters, ops)

    def h():
        launches, biggest = state.pop("f")
        k = kernels["segment_reduce"] = phase_h_segment_timing(
            torch, sr, biggest, launches)
        log(f"(h) {k['name']} sum on the tier-1 w1 leaf {k['shape']}: "
            f"kernel {k['ms']} ms, least time {k['bound_ms']} ms (bound by "
            f"{k['bound_by']}), plain version {k['plain_ms']} ms, library "
            f"index_add_ {k['library_ms']} ms, layout build "
            f"{k['layout_ms']} ms; max: kernel {k['max_ms']} ms, plain "
            f"{k['max_plain_ms']} ms, library scatter_reduce_ amax "
            f"{k['max_library_ms']} ms; launches on the tiered path "
            f"{k['launches']}, max abs err vs plain {k['max_abs_err']} "
            f"[{card}]")

    def j():
        state["j"] = phase_j_serve(torch, np, card, counters, ops, cuda)

    def k_():
        phase_k_decode_check(torch, np, card, state["j"], ops, fa, sd)

    def l_():
        served = state.pop("j")
        served.pop("params")             # the timing does not need them
        torch.cuda.empty_cache()
        for k in phase_l_timing(torch, np, fa, sd, served):
            kernels[k["name"]] = k
            cores_ms = k.pop("bound_cuda_cores_ms")
            vs_f64 = k.pop("vs_float64", None)
            log(f"(l) {k['name']} on the {SERVE_ARCH} prefill's inputs "
                f"{k['shape']}: kernel {k['ms']} ms, least time "
                f"{k['bound_ms']} ms on the tensor cores at the 3xTF32 "
                f"rate (bound by {k['bound_by']}), {cores_ms} ms on the "
                f"CUDA cores, plain version {k['plain_ms']} ms, library "
                f"call {k['library_ms']} ms, {k['cuda_kernels']} CUDA "
                f"kernels a call (profiler), launches on the serving path "
                f"{k['launches']}, max abs err vs plain {k['max_abs_err']}"
                + (f"; on batch 0, heads 0-7, max abs err vs float64: "
                   f"kernel {vs_f64['kernel']}, plain float32 "
                   f"{vs_f64['plain']}" if vs_f64 else "") + f" [{card}]")
        del served
        torch.cuda.empty_cache()

    phases = [("a", lambda: phase_a_kernels(torch, og, cuda)),
              ("b", lambda: phase_b_defaults(torch, np, card, counters, cuda)),
              ("c", c), ("d", d),
              ("e", lambda: phase_e_segment(torch, np, sr, eng, card, cuda)),
              ("f", f), ("g", lambda: phase_g_tiered_defaults(np, card)),
              ("h", h),
              ("i", lambda: phase_i_new_kernels(torch, fa, sd, cuda)),
              ("j", j), ("k", k_), ("l", l_),
              ("m", lambda: phase_m_smoke_configs(torch, np, card, counters,
                                                  cuda))]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:                  # report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        log(f"phase ({name}) {'FAILED' if name in failed else 'ok'} in "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": [kernels[k] for k in counters]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
