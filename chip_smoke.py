#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports no JAX. It builds every CUDA kernel of the fog paths from
``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all started
together), then runs eight phases and fails (exit 1, no result line) if
any of them fails:

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
    layout build on its own, and its least time on this card.

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
    missing = [k for k, v in launches.items() if v == 0]
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
        from repro_torch.kernels import offload_greedy as og
        from repro_torch.kernels import ops
        from repro_torch.kernels import segment_reduce as sr
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: "
              f"{e}", file=sys.stderr)
        return 2
    counters = {"offload_greedy": og, "segment_reduce": sr}
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

    phases = [("a", lambda: phase_a_kernels(torch, og, cuda)),
              ("b", lambda: phase_b_defaults(torch, np, card, counters, cuda)),
              ("c", c), ("d", d),
              ("e", lambda: phase_e_segment(torch, np, sr, eng, card, cuda)),
              ("f", f), ("g", lambda: phase_g_tiered_defaults(np, card)),
              ("h", h)]
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
