#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports no JAX. It builds every CUDA kernel of the fog, serving and
training paths from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
source, all started together), then runs the phases below in the order
of ``PHASES`` and fails (exit 1, no result line) if any of them fails.

The CPU sides of the card-vs-CPU checks of (b), (g), (n), (o), (p) and
(s) run as jobs (``JOB_PLAN``): the same call into the port with
``--device cpu``, the same argv and seeds, in a pool of spawned worker
processes (``job_pool_size``: one CPU left to this process, one torch
thread a worker, niced), started as (r3) begins and so beside the card
work of (r3), (s2) and (t3), (s)'s first and then longest first
(``start_jobs``), and settled before (t1). (s) collects its
own jobs; the phases ``b/cpu``, ``g/cpu``, ``n/cpu``, ``o/cpu`` and
``p/cpu`` after (t) collect the others and hold each to its card side,
as those phases did in line. A job that raises or exits fails its collecting phase; one that has not
returned JOB_TIMEOUT s after the first job started fails it too; the
pool's workers are stopped when the phases end, whatever they hold.

The phases build each fog problem of ``launch/train.py`` once for each
value of the flags ``build_problem`` reads (``ProblemMemo``): a run,
or a phase that rebuilds a run's problem to check its plan, gets a deep
copy of that build, bit for bit the build and sharing no array with it.
The job pool's workers start with (n) and import the jobs' modules
beside (n) and (o); (w3)'s examples start with (v) and run beside it.

(a) the Theorem-3 kernel against its plain PyTorch version on the
    card, at a sweep of shapes plus tie and isolated-row cases, rows
    whose only link is the last column, density 0, rows that start off
    a 16-byte boundary (n = 1003, 4097) and bases that do, and c_next
    unstaged (n = 12000): equality is exact on every output;
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
    and on the same flags at full topology (the CLI's default), each
    held bitwise to its plain version, then timed three times in turns
    with it (CUDA events, warmed, the L2 cache flushed by a read before
    each launch, the card spinning before each start event so that the
    host's launch latency stays out of the window; the kernel also
    without that spin), the card's clocks, power and temperature read
    before each round; beside its byte bound and its sector floor; then
    the fog-scale plan on the host clock, whole and split into
    device_inputs, the kernel, and the COO epilogue with read-back and
    host packing;
(e) the segment-reduce kernels against their references on the card:
    random, mostly empty, out-of-range, empty, single-segment, ragged
    and non-finite cases; the 1-D sum bitwise equal to a sequential
    ascending-order float32 sum (small shapes) and within γ_k·Σ|x| of a
    float64 sum (large shapes), bitwise equal from run to run; its max
    exactly equal to the plain version; the row sum (``segment_sum_rows``)
    bitwise a sequential float32 row sum on the host, at P % 4 of 0 to
    3, bases off a 16-byte boundary, P = 1, w1's width, an empty group,
    out-of-range ids, NaN and inf rows, no rows and a group of 3000
    rows; the one huge segment timed; and each group's row of
    ``aggregate_tier`` bitwise equal to ``aggregate_edges`` over the
    group's members;
(f) the tiered fog-scale path (the fog-scale flags plus ``--tiers
    32@5,4@10,1@20``), with every launch counter set to 0 just before
    and read just after: both kernels must have launched, exactly one
    H_g sum and one row sum per leaf and tier (35), the history must be
    finite and the tier levels [1, 2, 1, 3];
(g) the tiered defaults (cnn, n=10, T=20, ``--tiers 5@10,1@20``) once on
    the card and once on the CPU, held to each other as in (b), plus
    ``tier_agg_round`` and ``tier_agg_level`` exactly;
(h) the row sum on the tier-1 ``w1`` leaf that (f) gave it, bitwise a
    sequential float32 row sum on the host, then timed beside its plain
    version, the library call (``index_add_`` of the product's rows),
    the layout build (of the m member ids) on its own, and its least
    times on this card in the row form and in the 1-D form;
(i) the flash-attention and SSD-scan kernels against their plain
    versions on the card: MHA, GQA 2:1 and MQA, head_dim 16, 64, 100,
    112 and 128, lengths that are no multiple of a tile, causal or not,
    windows 32, 128 and 200, rows the window leaves with no key (must
    be 0); the SSD scan at several (H, P, N, chunk), mamba2-1.3b's full
    SSD shape (H=64, S=1024, P=64, N=128, chunk 128) and the
    state-carry impulse; and the attention classes of the MoE, enc-dec
    and VLM archs (``ZOO_ATTN``): Sq != Sk non-causal, 32 q heads padded
    onto 20 KV heads at hd 64, GQA 4:1 with a window at hd 128. The
    reference's float32 tolerances: 2e-5 for
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
(k) full-width correctness through the path with no kernel, on the
    first 18 of (j)'s 81 blocks (two hybrid groups, so the shared
    block twice) and on a float64 copy of them, for B=2 x S=256 prompts
    (two SSD chunks): in float64 (the kernels' plain versions standing
    in for them) the prefill logits and teacher-forced ``decode_step``
    logits at every position agree within 2e-3 of the largest |logit|
    (the reference's 2e-3, scaled), which drives both shared-block cache
    slots; in float32
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
(m) the smoke configs of zamba2-7b, mamba2-1.3b, qwen3-14b,
    olmoe-1b-7b, mixtral-8x7b, whisper-large-v3 and phi-3-vision-4.2b
    (seeded frames and patch embeddings) once on the card and once on
    the CPU through the port, with the same parameters: logits within
    1e-4 of the largest |logit|, the MoE aux within 1e-6, greedy tokens
    equal, attention launches one a decoder layer (plus the encoder and
    cross layers of enc-dec);
(n) planning beyond setting B: the convex solver (800 Adam steps, plain
    PyTorch) at n=200, T=20, rho=0.1, sqrt and neg_G, on setting-B and
    setting-E inputs, on the card against the port on the CPU from the
    same z0: plans within 1e-3 and objectives within rtol 1e-4, or, on
    setting-E inputs, where a 1e-7 move of z0 moves the card's own plan
    by more than 1e-3, within twice that spread (the five points
    z0·(1 + k·1e-7), k = -2..2, in one batched descent); batched B=3
    within 1e-5 of sequential on the card. Then ``--setting E --error-model
    sqrt`` at fog scale: the plan feasible, within the capacities to
    1e-6, its objective no more than 1.02x the no-movement and the
    all-discard plans', the history complete and finite; the plan's
    time split into window estimates, operands to the card, the solve
    (CUDA events, steps/s, peak memory, launches, device time and top
    kernels a step from the profiler), read-back and the host repair.
    Settings C and D with ``discard`` at fog scale, every launch
    counter set to 0 just before each and read just after: one
    Theorem-3 launch each, the plan equal to the kernel's plain
    version's on the card (D repaired). Last, E/sqrt at the CLI
    defaults (cnn, n=10, T=20) on the card and on the CPU, both trained
    from the CPU's plan, held to each other as in (b);
(o) network dynamics: the Theorem-3 kernel against its plain version,
    bit for bit, on the operands ``device_inputs`` builds from a
    churn-masked schedule at fog scale (p_exit = p_entry = 0.05), a flap
    schedule (p_flap = 0.1), the ``predict_schedule`` of each, and an
    n = 1003 schedule with a round where every device has exited, a
    round whose rows each keep one live receiver column (the next
    round has a single device active) and that round itself; timed on
    the churn inputs beside its plain version and its bound on their
    live links (in the log only: the kernels line keeps the fog-scale
    static timing of (d)). Then the
    fog-scale CLI under ``--churn 0.05`` with ``--replan oracle``,
    ``predict`` and ``once`` and under ``--schedule flap --p-flap 0.1
    --replan predict``, every launch counter set to 0 just before each
    run and read just after: exactly one Theorem-3 launch a plan, the
    plan equal to the plain version's on the card, the oracle plan
    unchanged by ``realize_plan``, the history complete and finite with
    ``active`` equal to ``schedule.activity()``, and the plan's time by
    part (predict_schedule, device_inputs, the kernel, the epilogue with
    read-back, realize_plan). Then cnn, n=10, T=20, 2,000 samples under
    churn (the three replan modes), flap, and ``--tiers 5@10,1@20`` with
    churn, on
    the card and on the CPU, held as in (b) plus ``n_events`` and the
    tier fields; last, Table V at ``--quick`` on the card against the
    port on the CPU (costs and ``avg_active`` exactly, accuracies within
    1e-2);
(p) faults and recovery: (p1) the fog-scale CLI under ``--faults mixed
    --fault-rate 0.1 --quorum 0.25``, every launch counter set to 0 just
    before and read just after: one Theorem-3 launch, the fault summary
    ``make_faults`` gives for the same seed, a finite guarded history,
    its train time beside (c)'s; (p2) the tiered fog-scale CLI under the
    same faults: exactly the clean path's segment launches
    (``sum(tier_agg_level)·(1+4)``: the quorum stays on the card), and a
    tier-1 row sum whose rows a drop or the guard zeroed held bitwise
    to the plain version; (p3) at fog scale the clean run, an empty
    FaultSchedule under the guard and quorum 0.5, and the mixed faults,
    three times in turns (their train times: the guard's cost): the
    no-op gives the clean history bit for bit and every run repeats its
    own; (p4)
    at fog scale, clean and under the mixed faults, a run checkpointed
    and stopped at round 10 then resumed gives the uninterrupted history
    bit for bit, with the save and restore times and the file's size;
    (p5) cnn n=10 T=20 under mixed faults with a quorum, unguarded NaN
    corruption, and tiers with mixed faults, card against CPU as in (b)
    plus the fault fields exactly and NaN in the same places; (p6) the
    fault-tolerance study (``launch.tables --only faults``) at
    ``--quick`` on the card against the port on the CPU: the exact
    claims true, ``quorum_skips_q0`` 0, the unguarded arm collapsed, and
    ``quorum_skips_q60``, ``guard_within_2pp``, every fault summary and
    cost equal to the CPU's; (p7) ``launch.serve --checkpoint`` then
    ``--resume`` at the smoke config: the same tokens;
(q) the sparse O(E) plane at fog scale: (q1) ``launch.tables``'
    ``sparse_scale`` at full size, every launch counter set to 0 just
    before and read just after: plan rows at n = 1024, 10,240 and
    102,400, the n = 1024 sparse plan equal to the dense numpy plan and
    to the Theorem-3 kernel's (one launch), predictions equal, the
    5× floor, then the T = 50, n = 102,400 churn run on flat streams
    under the tracemalloc no-(n, n) guard, the card's peak memory below
    a float32 (n, n) array, ``active`` equal to the schedule's and
    every ``H_agg`` equal to a float32 replay on the host; (q2)
    ``counts_flat`` of its 5.12 M samples through the segment-reduce
    kernel (one launch) equal to ``np.bincount`` and to the plain
    version, and ``plan_cost`` on it within 1e-12 of the CPU's; (q3)
    ``hier_scale`` at full size, counters as in (q1): no movement edge
    across a gateway, exactly 3 segment launches per tier aggregation
    (51), the tier-1 ``w`` row sum bitwise its plain version on the
    CPU and its 1-D form through the generic kernel, histories replayed
    as in (q1), the L = 1 tree bitwise the flat scan on the card; both
    kernel-2 sites (and the 1-D form) timed beside their plain version,
    ``index_add_`` and their byte bound (with (e)'s huge segment, the
    ``sites`` of the segment_reduce entry); (q4) n = 2048, T = 20
    flat-stream scan and tiered runs on the card against the CPU, held
    as in (b);
(r) the sweep engine: (r1) ``launch.tables``' ``scenario_batched`` at
    ``--quick`` (the fig5, dynamics and prediction grids, each bucket
    dispatched by the cost model, against the per-point loop; bucket
    programs no more than buckets, accuracy within 1e-2 of the loop),
    then its fig5 buckets through the card's dispatch once on the card
    and once on the CPU, held as in (b); (r2) six seeds of the
    fog-scale path in one bucket (6,144 device rows), dense and ragged,
    every launch counter set to 0 just before each and read just
    after: exactly 5 kernel-2 launches a window (a row sum a leaf and
    the H total) and, ragged, 5 more a round (the gradient's row sums
    and the loss sum), no other kernel; each seed held as in (b) to its
    run on the scan engine and to itself run alone at the same staging
    (bit for bit reported, the tolerances asserted), with the bucket's
    and the six scan runs' host-clock times, phase times, peak memory,
    the cost model's decision and the segment lengths against the warp
    walk's 2048; (r3) kernel 2 at the two shapes (r2) gave it (eq.
    (4)'s rows into S, the busiest round's ragged gradient rows into
    S·n_b) bit for bit its plain version on the CPU, timed beside its
    byte bound, ``index_add_`` and the plain version (two more
    ``sites``), and the gradient of ``segment_sum_rows`` through the
    kernel equal to the gradient through the plain version on the card;
(s) model-zoo training: (s1) the gradients through the flash-attention
    and SSD-scan Functions (kernel forward, plain version recomputed in
    the backward) bit for bit those of autograd through the plain
    versions alone, for a fixed cotangent, at (i)'s shape classes (MHA,
    GQA 2:1, MQA, causal, windows, rows that see no key: zero gradient)
    in float32 and bfloat16, (i)'s MoE, enc-dec and VLM classes (Sq !=
    Sk non-causal, the 32 -> 20 padded map, hd 64, GQA 4:1 with a
    window), and the scan at two (H, P, N, chunk), all
    finite, one launch a call and none from the backward; (s2) zamba2-7b
    at full width cut to 18 layers (two hybrid groups; 1.84 B float32
    parameters drawn on the card), AdamW at the CLI's lr on B=2 x S=2048
    token batches routed and weighted by ``lm_movement_inputs``: the
    first step's gradients through the kernels against those through the
    plain versions and against a float64 gradient, then a cold and three
    warm ``make_train_step`` steps with every launch counter set to 0
    just before each and read just after (exactly 2 attention and 18
    scan launches, finite loss and grad_norm), step time, tokens/s and
    peak memory, a step split into forward, backward and optimizer by
    CUDA events, each Function's backward (the plain recompute) timed on
    the step's inputs, and a profiled step (top kernels, the backward
    nodes' device time, the idle share) (B = 1 if B = 2 does not fit,
    logged); (s3) ``--mode lm`` for the smoke configs of qwen3-14b,
    mamba2-1.3b, zamba2-7b, olmoe-1b-7b, mixtral-8x7b, whisper-large-v3
    and phi-3-vision-4.2b, 5 steps, and ``--lm-tau 2``, on the card and
    on the CPU from the same parameters, at the CLI's defaults and with
    SGD (see ``phase_s_cli`` for what each holds), exact launch counts;
(t) the model zoo's last families at full width, float32, drawn on the
    card from the seed, every launch counter set to 0 just before each
    prefill or step and read just after, (t3) first (its card work
    runs beside the last jobs, which settle after it), then (t1), (t2),
    (t4)-(t6): (t1) olmoe-1b-7b, full depth
    (6.92 B parameters), prefill B=2 x S=4096 (exactly 16 attention
    launches), cold and warm time, tokens/s, peak memory and the
    profiled device-time shares of the expert GEMMs, the dispatch and
    combine, and attention; then ``greedy_generate`` at the serve CLI's
    defaults; (t2) mixtral-8x7b cut to 4 of 32 layers (6.07 B), B=1 x
    S=8192 past the 4096 window (4 launches), the same numbers; (t3)
    olmoe cut to 6 layers (2.72 B), AdamW, B=2 x S=2048 (B by reckoning
    before the draw, logged): the first step's gradients through the
    kernel against the plain version as (s2) holds them, the router's
    gradient non-zero, the aux finite, then a cold and three warm steps
    (6 launches each), split and profile; (t4) whisper-large-v3 at full
    depth (1.72 B): prefill B=2 x 448 tokens on 1500 seeded frames (96
    launches: 32 encoder, 32 self, 32 cross), decode at the serve
    defaults (``encode`` and ``cross_decode_attention``), and training
    at B=2 (96 launches a step); (t5) phi-3-vision-4.2b (3.83 B)
    prefill B=2 x (144 patches + 3952 tokens), 32 launches, logits on
    the text positions only; (t6) olmoe and whisper at full width cut to
    2 layers, B=1 x S=256, capacity factor 8 (no drops): float64
    prefill and teacher-forced decode within 2e-3 of max|logit|, the
    float32 kernel prefill no further from float64 than twice the
    kernel-free float32 paths, routing equal to float64's wherever the
    top-k margin exceeds 1e-5 (smaller-margin flips logged, and the
    positions from the first one left out); and kernel 3 timed on the
    inputs (t1), (t2) and (t4) gave it (olmoe, mixtral's window,
    whisper's encoder and cross attention) beside its plain version,
    SDPA on K and V expanded to the q heads and its least time (the
    ``sites`` of the flash_attention entry);
(u) the distribution layer: (u1) an NCCL world of one made by
    ``launch/mesh.init_process_group``, on which the fog-scale flags run
    with ``--engine sharded`` and with ``--engine batched``, every
    launch counter and the port's all-reduce counter set to 0 just
    before each run and read just after: the histories bit for bit
    equal, kernel 2 launched as many times in both, one all-reduce of
    the numerator and one of the H total a window in the sharded run;
    both wall times, the all-reduce's time on the card, and kernel 2's
    eq. (4) row sum of the sharded run timed as a ``sites`` entry;
    (u2) the FedAvg round (qwen3-14b smoke config, τ = 2, AdamW) on that
    group bit for bit the one-card round with one shard; (u3) the
    analytic roofline (``launch/roofline.py``, H100 constants, float32,
    one card) beside the warm times (j), (s2), (t1), (t3), (t4) and (t5)
    measured: compute_useful_s, compute_s, memory_s, the dominant term
    and mfu = compute_useful_s / the warm time; (u4) the dry runs of
    qwen3-14b ``train_4k`` and of olmoe-1b-7b ``train_4k`` with
    ``--moe-groups 16`` on the fake (16, 16) mesh, each in a subprocess
    (``python -m repro_torch.launch.dryrun``) started in phase (t) after
    (t3), whose work is on the card while they trace on the host: PASS
    rows, residual
    placements pinned to (batch shards, Shard(1)), peaks below one H100
    (qwen3-14b's below one data shard's full-vocab float32 logits too,
    16 x 4096 x 152064 x 4 B), the dominant term, trace time and memory
    columns (a peak of live bytes, and the parameters and optimizer
    state the step updates in place aliased); and minitron-4b
    ``decode_32k`` beside them, which must move fewer bytes a device than
    one layer's global K cache and peak below the global float32 token
    table (the KV cache read on its sequence shards, the lookup on the
    table's vocab shards), and mamba2-1.3b ``decode_32k``, which must
    move fewer bytes a device than one layer's global SSM state (the SSM
    decode on its head shards); both decode streams pinned to (batch
    shards, whole on the model axis) at every block boundary;
(v) the runtime sanitizer (``core/sanitize.py``): (v1) ``--sanitize``
    at fog scale, flat, with ``--tiers 32@5,4@10,1@20`` and with
    ``--engine batched``, each in turns with the same flags without it
    (without, with, without): the ``sanitize`` block exactly the
    reference's (``warm_compiles`` 0), the warm pass's history bit for
    bit the unsanitized run's, every kernel's launches in each pass
    those of the unsanitized run, and the sanitizer's overhead in
    seconds; (v2) on the card a planted
    ``.item()``, a boolean mask index (a sync inside the op, caught by
    the sync debug mode) and a copy to the host inside the guard, a
    NaN from an eager op, and a new sweep-engine program key in a warm
    scope each raise, and the sync debug mode is restored; (v3), run
    right after (j) while its parameters are on the card: (j)'s
    zamba2-7b prefill once more with ``ssm_streaming``, bit for bit
    the default prefill, with the same 81 scan launches;
(w) the reference's remaining bench rows and the examples: (w1)
    ``engine_throughput``, ``kernels_micro``, ``solver_scaling``,
    ``movement_scale`` and ``convex_batched`` of ``launch/tables.py`` on
    the card at ``--quick`` scale: the three float64 Theorem-3 plans
    identical, the float32 kernel-1 plan bit for bit its plain version's
    with one launch, the sparse and dense movement plans identical, and
    each of the four kernels at its micro shape within its tolerance of
    its plain version (attention 2e-5, the scan 1e-4 of max|y|, kernels
    1 and 2 bit for bit), one launch a call, timed beside its plain
    version, the library call and its least time; (w2)
    ``dryrun_roofline`` on (u4)'s JSONL; (w3) the four examples
    (``examples/*_torch.py``) side by side in subprocesses with a
    timeout, each exiting 0, the planning example through kernel 1 and
    the serving example through kernels 3 and 4.

The line before the last is the JSON list of kernels; the one before it
the card's name and power limit; the last line is the result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM: HBM bandwidth, float32 rate outside the tensor cores and
# dense TF32 tensor-core rate (NVIDIA data sheet; the least times below
# are against these peaks). Float32 accuracy on the tensor cores takes
# three TF32 products (3xTF32), so a third of the TF32 rate. The same
# rates as ``launch/kernel_timing.py``; ``scripts/*_ab.py`` read these.
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
# the fog-scale flags at the CLI's default topology (full)
FULL_ARGV = FOG_ARGV[:FOG_ARGV.index("--topology")] + \
    FOG_ARGV[FOG_ARGV.index("--rho") + 2:]
TIERED_SHORT_ARGV = SHORT_ARGV + ["--tiers", "5@10,1@20"]


def log(*a):
    print(*a, flush=True)


class Clock:
    """Host-clock seconds of the phases and of their parts, in the order
    they end: each logged on a line of its own as it ends, all of them
    in one JSON line after the phases."""

    def __init__(self, card):
        self.card = card
        self.seconds: dict[str, float] = {}

    def add(self, name, s):
        self.seconds[name] = round(self.seconds.get(name, 0.0) + s, 3)
        log(f"clock ({name}) {s:.3f} s [{self.card}]")

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def run(self, fn, *args):
        """``fn(*args)`` timed under its name without ``phase_``."""
        return self.call(fn.__name__.removeprefix("phase_"), fn, *args)

    def call(self, name, fn, *args, **kw):
        """``fn(*args, **kw)`` timed under ``name``."""
        with self.span(name):
            return fn(*args, **kw)


JOB_TIMEOUT = 600        # s from the first job's start to the last's end


def _job_init(threads):
    """A job worker's start: no card (its jobs are CPU sides), its own
    intra-op thread count, a lower priority than the process that feeds
    the card and the dry runs, whose host time is measured, and the
    modules its jobs call, imported before the first job comes."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.nice(10)
    import torch
    torch.set_num_threads(threads)
    import repro_torch.launch.tables  # noqa: F401
    import repro_torch.launch.train  # noqa: F401


def _job(fn, args, kwargs):
    """``fn(*args, **kwargs)`` in a job worker, its printout dropped:
    (its result, its seconds on the worker's host clock). An exit (as
    argparse's) comes back as an error: it would end the worker and
    leave the job to time out."""
    import io

    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            out = fn(*args, **kwargs)
    except SystemExit as e:
        raise RuntimeError(f"the job exited with {e.code!r}") from None
    return out, time.perf_counter() - t0


class Jobs:
    """The CPU sides of card-vs-CPU checks, run as jobs in a pool of
    spawned worker processes beside phases whose work is on the card, and
    each collected by the phase that compares it with the card's side.
    A job that raises raises in its collecting phase; one that has not
    returned JOB_TIMEOUT s after the first job started fails it too. The
    pool starts with :meth:`open` or the first job, whichever comes
    first; :meth:`close` stops its workers, whatever they hold."""

    def __init__(self, workers, threads, clock):
        self.workers, self.threads, self.clock = workers, threads, clock
        self.pool = None
        self.pending = {}
        self.deadline = None

    def open(self):
        """Start the workers, which import the jobs' modules while this
        process goes on."""
        if self.pool is None:
            import multiprocessing

            self.pool = multiprocessing.get_context("spawn").Pool(
                self.workers, initializer=_job_init,
                initargs=(self.threads,))

    def start(self, key, fn, *args, **kwargs):
        self.open()
        if self.deadline is None:
            self.deadline = time.perf_counter() + JOB_TIMEOUT
        self.pending[key] = self.pool.apply_async(_job, (fn, args, kwargs))

    def _left(self):
        return max(0.0, self.deadline - time.perf_counter())

    def settle(self):
        """Wait until every job started has returned or raised (or the
        deadline has passed), so that the host work measured next runs
        without them; the wait goes to the clock."""
        t0 = time.perf_counter()
        for res in self.pending.values():
            res.wait(self._left())
        self.clock.add("jobs settled", time.perf_counter() - t0)

    def collect(self, key, timeout=None):
        """The job's result, once it has returned (waiting ``timeout`` s,
        or until the deadline); its seconds in the worker and the wait
        here go to the clock."""
        t0 = time.perf_counter()
        out, s = self.pending.pop(key).get(
            self._left() if timeout is None else timeout)
        self.clock.add(f"{key} (job)", s)
        self.clock.add(f"{key} (wait)", time.perf_counter() - t0)
        return out

    def close(self):
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None


# build_problem's reads of ``args`` are direct, or through the one helper
# it hands ``args`` to
PROBLEM_READERS = ("build_problem", "schedule_kind")


def problem_flags(train) -> tuple[str, ...]:
    """The ``args`` attributes that ``train.build_problem`` reads, itself
    or through ``train.schedule_kind``, from their source. Refuses a
    source that hands ``args`` to any other call, whose reads it cannot
    see."""
    import ast
    import inspect
    import textwrap

    flags = set()
    for name in PROBLEM_READERS:
        for node in ast.walk(ast.parse(textwrap.dedent(inspect.getsource(
                getattr(train, name))))):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "args":
                flags.add(node.attr)
            elif isinstance(node, ast.Call) and any(
                    isinstance(a, ast.Name) and a.id == "args"
                    for a in node.args + [k.value for k in node.keywords]) \
                    and not (isinstance(node.func, ast.Name)
                             and node.func.id in PROBLEM_READERS):
                raise RuntimeError(f"train.{name} hands args to "
                                   f"{ast.unparse(node.func)}")
    return tuple(sorted(flags))


class ProblemMemo:
    """``train.build_problem`` built once for each value of the flags it
    reads (:func:`problem_flags`): every call returns a deep copy of
    that first build, new arrays and stream and schedule objects bit for
    bit the build's. A copy, not the build: the engine's device cache is
    keyed on an array's ``id`` (so a run finds nothing of an earlier
    run's on the card, as with a build of its own), and a run that
    changes its problem in place (``run_network_aware`` empties the
    streams of crashed devices) leaves the next run's untouched.

    As a context manager it stands in for ``train.build_problem`` for the
    span of the block and restores it however the block ends; its
    builds, hits and the seconds the hits saved then go to the clock's
    seconds."""

    def __init__(self, train, clock):
        self.train, self.clock = train, clock
        self.build = train.build_problem
        self.flags = problem_flags(train)
        self.defaults = train.parse_args([])
        self.cache: dict = {}            # key -> (bundle, build seconds)
        self.builds = self.hits = 0
        self.saved_s = 0.0

    def key(self, args) -> tuple:
        return tuple(getattr(args, f) for f in self.flags)

    def __call__(self, args) -> dict:
        import copy

        key = self.key(args)
        if key not in self.cache:
            t0 = time.perf_counter()
            self.cache[key] = (self.build(args), time.perf_counter() - t0)
            self.builds += 1
            tag = ", ".join(f"{f} {v}" for f, v in zip(self.flags, key)
                            if v != getattr(self.defaults, f))
            self.clock.add(f"problem build {self.builds} ({tag})",
                           self.cache[key][1])
            return copy.deepcopy(self.cache[key][0])
        t0 = time.perf_counter()
        out = copy.deepcopy(self.cache[key][0])
        self.hits += 1
        self.saved_s += self.cache[key][1] - (time.perf_counter() - t0)
        return out

    def __enter__(self):
        self.train.build_problem = self
        return self

    def __exit__(self, *exc):
        self.train.build_problem = self.build
        self.clock.seconds["problem builds"] = self.builds
        self.clock.seconds["problem copies (hits)"] = self.hits
        self.clock.add("problem hits saved", self.saved_s)


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_line() -> str:
    return _smi("name,power.limit")


def card_state() -> str:
    """The card's SM and memory clocks, power draw and temperature now."""
    return _smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")


def _greedy_case(torch, T, n, dens, seed, *, ties=False, isolated=0,
                 last=0):
    """Seeded Theorem-3 inputs on the CPU. ``ties``: integer-valued costs
    (many equal sums); the first ``isolated`` rows have no link; the
    first ``last`` rows have only column n-1."""
    g = torch.Generator().manual_seed(seed)
    if ties:
        c_link = torch.randint(0, 3, (T, n, n), generator=g).float()
        vec = [torch.randint(0, 3, (T, n), generator=g).float()
               for _ in range(3)]
    else:
        c_link = torch.rand((T, n, n), generator=g)
        vec = [torch.rand((T, n), generator=g) for _ in range(3)]
    adj = torch.rand((T, n, n), generator=g) < dens
    adj[:, :isolated] = False
    if last:
        adj[:, :last] = False
        adj[:, :last, n - 1] = True
    return [c_link, *vec, adj]


def _unaligned(torch, a, off):
    """A contiguous copy of ``a`` that starts ``off`` elements into its
    storage, so off a 16-byte boundary."""
    flat = torch.zeros(a.numel() + off, dtype=a.dtype, device=a.device)
    flat[off:] = a.reshape(-1)
    return flat[off:].view(a.shape)


def phase_a_kernels(torch, og, cuda):
    """Kernel vs plain version, exact, over shapes, ties, isolated rows,
    rows whose only link is the last column, unaligned rows (n = 1003,
    4097) and bases, and c_next unstaged (n = 12000)."""
    # (T, n, density, ties, isolated, last, adj / c_link base offsets)
    cases = [(1, 1, 1.0, False, 0, 0, None), (3, 7, 0.5, False, 0, 0, None),
             (4, 129, 0.3, False, 0, 0, None),
             (2, 256, 0.1, False, 0, 0, None),
             (20, 1000, 0.1, False, 0, 0, None),
             (100, 1024, 1.0, False, 0, 0, None),
             (8, 300, 0.6, True, 0, 0, None),
             (5, 200, 0.4, False, 23, 0, None),
             (3, 1003, 0.1, False, 0, 0, None),
             (2, 4097, 0.05, False, 0, 0, None),
             (4, 1003, 0.0, False, 0, 0, None),
             (5, 1003, 0.3, False, 0, 40, None),
             (3, 4097, 0.02, False, 0, 300, None),
             (20, 1000, 0.1, True, 0, 0, None),
             (1, 12000, 0.01, False, 5, 7, None),
             (3, 517, 0.2, False, 0, 0, (3, 1)),
             (3, 517, 0.2, False, 0, 0, (5, 2))]
    for T, n, dens, ties, isolated, last, offs in cases:
        args = [a.to(cuda) for a in _greedy_case(
            torch, T, n, dens, T * 7919 + n, ties=ties, isolated=isolated,
            last=last)]
        if offs:
            args[4] = _unaligned(torch, args[4], offs[0])
            args[0] = _unaligned(torch, args[0], offs[1])
        got = og.offload_greedy_batched(*args)
        want = og.offload_greedy_plain(*args)
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        log(f"(a) offload_greedy T={T} n={n} density={dens} ties={ties} "
            f"isolated={isolated} last-column-only={last} base offsets "
            f"{offs}: choice/best_j/best_cost equal {same}")
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


def phase_b_defaults(torch, np, card, counters, cuda, clock):
    from repro_torch.core import movement as mv
    from repro_torch.launch import train

    for c in counters.values():
        c.reset_launches()
    t0 = time.perf_counter()
    out = train.main(DEFAULT_ARGV)
    wall = time.perf_counter() - t0
    clock.add("b defaults card", wall)
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
    return clock.call("b T=20 card", train.main, SHORT_ARGV)


def start_b(jobs):
    """(b)'s CPU side: the defaults at T=20 with --device cpu."""
    from repro_torch.launch import train

    jobs.start("b T=20 CPU", train.main, SHORT_ARGV + ["--device", "cpu"])


def collect_b(np, card, jobs, on_card):
    """(b)'s T=20 card run against its CPU side."""
    on_cpu = jobs.collect("b T=20 CPU")
    dmax, amax = _compare_histories(np, on_card, on_cpu)
    log(f"(b) defaults at T=20 card vs CPU: cost, agg_round, H_agg, active, "
        f"processed_counts equal; max |device_loss diff| {dmax}, "
        f"max |test_acc diff| {amax}; train_s card "
        f"{on_card['timing']['train_s']} CPU {on_cpu['timing']['train_s']} "
        f"[{card}]")


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
    return launches, pb, ins, tim["train_s"]


def _kt():
    """The port's timing and bounds (``launch/kernel_timing.py``: the
    H100's peak rates, the L2 flush and spin, the least-time formulas);
    importable once :func:`main` has put ``src`` on the path."""
    from repro_torch.launch import kernel_timing

    return kernel_timing


def flush_buffer(torch, device):
    """The buffer _time_ms reads to flush the L2: 128 MiB."""
    return _kt().flush_buffer(device)


def _time_ms(torch, fn, args, flush, reps=30, spin=True):
    """Median time of one call on the card, each launch after an L2
    flush, the card spinning before each start event unless ``spin`` is
    False (``kernel_timing.time_ms``)."""
    return _kt().time_ms(fn, args, flush, reps=reps, spin=spin)


def _greedy_bounds(torch, ins):
    """Least times of one Theorem-3 call on these inputs, in ms, with
    its 32-B sector and 64-B granule floors
    (``kernel_timing.greedy_bounds``)."""
    return _kt().greedy_bounds(ins)


def _in_turns(torch, fns, args, flush, reps=3):
    """Each of ``fns`` (name -> fn) timed ``reps`` times by _time_ms, in
    turns, the order reversed every other round, the card's state read
    before each round. A name ending in ``/host`` is timed without the
    spin. Returns name -> [ms, ...] and the states."""
    times = {k: [] for k in fns}
    states = []
    for r in range(reps):
        states.append(card_state())
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[k].append(_time_ms(torch, fns[k], args, flush,
                                     spin=not k.endswith("/host")))
    return times, states


def _spread(ms):
    s = sorted(ms)
    return {"min": s[0], "median": s[len(s) // 2], "max": s[-1]}


def _plan_parts(torch, mv, ops, og, pb, cuda, reps=3):
    """The fog-scale plan on the host clock, whole (``greedy_linear``)
    and in its three parts through the same functions: device_inputs
    (host float32 conversion, adjacency copy, host-to-device copies),
    the kernel, and the COO epilogue plus read-back and host packing;
    beside them device_inputs' two largest host steps on their own
    (c_link to float32, the adjacency copy)."""
    import numpy as np

    traces, sched = pb["traces"], pb["schedule"]
    T, n = traces.c_node.shape
    rows = []
    for _ in range(reps):
        h0 = time.perf_counter()
        np.ascontiguousarray(traces.c_link, np.float32)
        np.array(sched.adj_view(), dtype=bool, order="C")
        host_s = time.perf_counter() - h0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = mv.greedy_linear(traces, sched, device=cuda)
        t1 = time.perf_counter()
        ins = mv.device_inputs(traces, sched, cuda)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        choice, best_j, _ = og.offload_greedy_batched(*ins)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts = mv._plan_from_edges(T, n, ops.greedy_edges_from_choice(
            choice, best_j))
        t4 = time.perf_counter()
        if not mv.plans_equal(plan, parts):
            raise AssertionError("the plan built part by part differs")
        rows.append({"plan_s": t1 - t0, "device_inputs_s": t2 - t1,
                     "kernel_s": t3 - t2, "epilogue_readback_pack_s": t4 - t3,
                     "of_which_host_convert_s": host_s})
    return rows


def phase_d_timing(torch, og, ops, mv, c_state, cuda, card):
    """offload_greedy on the fog-scale path's own inputs and on the same
    flags at full topology, in turns with its plain version, and the
    fog-scale plan split into its parts."""
    from repro_torch.launch import train

    launches, pb, fog_ins = c_state[:3]
    full = train.build_problem(train.parse_args(FULL_ARGV))
    inputs = {"random rho=0.1": fog_ins,
              "full": mv.device_inputs(full["traces"], full["schedule"],
                                       cuda)}
    del full
    flush = flush_buffer(torch, cuda)
    fns = {"kernel": og.offload_greedy_batched,
           "plain": og.offload_greedy_plain,
           "kernel/host": og.offload_greedy_batched}
    rows = {}
    for name, ins in inputs.items():
        got = og.offload_greedy_batched(*ins)
        want = og.offload_greedy_plain(*ins)
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
        if err != 0.0:       # held exactly: same adds, order-free min
            raise AssertionError(f"kernel != plain version on the {name} "
                                 f"inputs (max abs err {err})")
        b = _greedy_bounds(torch, ins)
        times, states = _in_turns(torch, fns, ins, flush)
        rows[name] = dict(b, err=err, ms=_spread(times["kernel"])["median"],
                          plain_ms=_spread(times["plain"])["median"])
        log(f"(d) offload_greedy on the {name} inputs (T, n = "
            f"{tuple(ins[2].shape)}, {b['live_links']} live links in "
            f"{b['live_sectors']} sectors):"
            f" kernel {times['kernel']} ms, plain {times['plain']} ms "
            f"(3 rounds in turns, median of 30 each; min/median/max "
            f"{_spread(times['kernel'])} and {_spread(times['plain'])}); "
            f"the kernel without the spin before its start event "
            f"{times['kernel/host']} ms; "
            f"bound {b['bound_ms']} ms ({b['bound_by']}), sector floor "
            f"{b['sector_floor_ms']} ms, 64-B granule floor "
            f"{b['granule_floor_ms']} ms; card before each round "
            f"(clocks.sm, clocks.mem, power.draw, temperature) {states} "
            f"[{card}]")
    for k, r in enumerate(_plan_parts(torch, mv, ops, og, pb, cuda)):
        log(f"(d) fog-scale plan, repeat {k}: " + ", ".join(
            f"{key} {v}" for key, v in r.items()) + f" [{card}]")
    fog, full = rows["random rho=0.1"], rows["full"]
    T, n = fog_ins[2].shape
    log(f"(d) offload_greedy, median of the 3 rounds: fog scale {fog['ms']}"
        f" ms (bound {fog['bound_ms']} ms, sector floor "
        f"{fog['sector_floor_ms']} ms, plain {fog['plain_ms']} ms); full "
        f"topology {full['ms']} ms (bound {full['bound_ms']} ms, sector "
        f"floor {full['sector_floor_ms']} ms, plain {full['plain_ms']} ms) "
        f"[{card}]")
    return {"name": "offload_greedy", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/offload_greedy.cu",
            "replaces": "src/repro/kernels/offload_greedy.py:80",
            "launches": launches["offload_greedy"],
            "max_abs_err": fog["err"], "ms": fog["ms"],
            "plain_ms": fog["plain_ms"], "bound_ms": fog["bound_ms"],
            "bound_by": fog["bound_by"], "library_ms": None,
            "shape": {"T": T, "n": n, "live_links": fog["live_links"]}}


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


def _seq_rows(np, data, ids, G, scale=None):
    """Sequential float32 row sums on the CPU: each group's rows in
    ascending order from +0, one product (with ``scale``) and one add a
    entry. The groups' r-th rows are added together, one vector add a
    rank (at most one row of a group in each)."""
    out = np.zeros((G, data.shape[1]), np.float32)
    valid = np.nonzero((ids >= 0) & (ids < G))[0]
    order = valid[np.argsort(ids[valid], kind="stable")]
    g = ids[order]
    rank = np.arange(order.shape[0]) - np.searchsorted(g, g)
    for r in range(int(rank.max()) + 1 if order.size else 0):
        sel = order[rank == r]
        x = data[sel] if scale is None else data[sel] * scale[sel][:, None]
        out[ids[sel]] = out[ids[sel]] + x
    return out


def _row_cases(np):
    """(name, data (m, P) f32, ids int32, G, scale f32 or None, off): the
    row kernel's cases of phase (e); ``off`` floats of storage before
    the data, so its base lies off a 16-B boundary."""
    rng = np.random.default_rng(13)

    def normal(m, P):
        return rng.standard_normal((m, P)).astype(np.float32)

    def weights(m):
        return rng.integers(0, 40, m).astype(np.float32)

    cases = [(f"P={P}, base +{off}", normal(m, P), rng.integers(0, G, m),
              G, weights(m), off)
             for m, P, G, off in ((300, 156_800, 32, 0), (2000, 490, 20, 0),
                                  (2000, 490, 20, 1), (2000, 10, 20, 0),
                                  (700, 13, 7, 0), (700, 15, 7, 3),
                                  (700, 1, 7, 0))]
    ids = rng.integers(0, 9, 1500)
    ids[ids == 4] = 5
    cases.append(("an empty group, no scale", normal(1500, 202), ids, 9,
                  None, 0))
    cases.append(("out-of-range ids", normal(1500, 64),
                  rng.integers(-20, 29, 1500), 9, weights(1500), 0))
    cases.append(("one group of 3000 rows", normal(3000, 130),
                  np.zeros(3000, np.int64), 1, weights(3000), 2))
    data, ids = normal(1000, 2000), rng.integers(0, 10, 1000)
    data[np.nonzero(ids == 3)[0][0]] = np.nan
    data[np.nonzero(ids == 6)[0][-1], 17] = np.inf
    data[np.nonzero(ids == 6)[0][0], 18] = -np.inf
    cases.append(("NaN and inf rows", data, ids, 10, weights(1000), 0))
    cases.append(("no rows", normal(0, 8), np.zeros(0, np.int64), 4,
                  weights(0), 0))
    return [(name, d, i.astype(np.int32), G, h, off)
            for name, d, i, G, h, off in cases]


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
    """Segment-reduce kernels against their references on the card;
    returns the huge segment's timing (a ``sites`` entry)."""
    huge = None
    for name, data, ids, S in _segment_cases(np):
        d = torch.from_numpy(data).to(cuda)
        i = torch.from_numpy(ids).to(cuda)
        if name == "one huge segment":
            huge = (d, i, S)
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
    for name, data, ids, G, scale, off in _row_cases(np):
        m, P = data.shape
        store = torch.empty(off + m * P, device=cuda)
        store[off:] = torch.from_numpy(data.reshape(-1)).to(cuda)
        d = store[off:].view(m, P)
        i = torch.from_numpy(ids).to(cuda)
        h = None if scale is None else torch.from_numpy(scale).to(cuda)
        got = sr.segment_sum_rows(d, i, G, scale=h).cpu().numpy()
        again = sr.segment_sum_rows(d, i, G, scale=h).cpu().numpy()
        ok = {"(G, P)": got.shape == (G, P),
              "rows == sequential sum": _same_bits(
                  np, got, _seq_rows(np, data, ids, G, scale)),
              "rows repeat": _same_bits(np, got, again)}
        log(f"(e) segment_sum_rows {name} (m={m}, P={P}, G={G}): {ok}")
        if not all(ok.values()):
            raise AssertionError(f"row kernel wrong on {name}: {ok}")
        del store, d
    d, i, S = huge
    site = _segment_site(torch, np, sr, "one huge segment (e)", d, i, S,
                         sr.segment_layout(i, S), None,
                         flush_buffer(torch, cuda))
    log(f"(e) one huge segment (E={d.shape[0]} in S={S}): kernel "
        f"{site['ms']} ms (bound {site['bound_ms']} ms by "
        f"{site['bound_by']}; the fixed-order sum is {d.shape[0]} "
        f"dependent adds), plain {site['plain_ms']} ms, index_add_ "
        f"{site['library_ms']} ms, layout build {site['layout_ms']} ms "
        f"[{card}]")
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
    return [site]


def _keep_biggest_rows(ops, biggest):
    """A stand-in for ``ops.segment_sum_rows`` that keeps the inputs of
    the largest call in ``biggest`` and then makes the call."""
    real = ops.segment_sum_rows

    def keep(data, segment_ids, *, num_segments, scale=None, layout=None):
        if data.numel() > biggest.get("numel", -1):
            biggest.update(numel=data.numel(), data=data, ids=segment_ids,
                           G=num_segments, scale=scale, layout=layout)
        return real(data, segment_ids, num_segments=num_segments,
                    scale=scale, layout=layout)

    return keep


def phase_f_tiered_fog(torch, np, card, counters, ops):
    """The tiered fog-scale path; keeps the tier-1 w1 row sum's inputs
    for phase (h)."""
    from repro_torch.launch import train

    biggest = {}
    real_rows = ops.segment_sum_rows
    torch.cuda.reset_peak_memory_stats()
    ops.segment_sum_rows = _keep_biggest_rows(ops, biggest)
    try:
        for c in counters.values():
            c.reset_launches()
        out = train.main(TIERED_FOG_ARGV)
        launches = {name: c.launches for name, c in counters.items()}
    finally:
        ops.segment_sum_rows = real_rows
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
    # one H_g sum and one row sum per leaf (the mlp has four), for tiers
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


def phase_g_tiered_defaults(clock):
    """(g)'s card side (held to the CPU by :func:`collect_g`)."""
    from repro_torch.launch import train

    return clock.call("g card", train.main, TIERED_SHORT_ARGV)


def start_g(jobs):
    """(g)'s CPU side: the tiered defaults with --device cpu."""
    from repro_torch.launch import train

    jobs.start("g CPU", train.main, TIERED_SHORT_ARGV + ["--device", "cpu"])


def collect_g(np, card, jobs, on_card):
    """(g)'s card run against its CPU side, as in (b), plus the tier
    fields."""
    on_cpu = jobs.collect("g CPU")
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


def _row_site(torch, sr, name, d, ids, G, h, layout, launches, flush):
    """The row kernel timed at one launch site, beside its plain version
    (the product, then ``index_add_``, on the card), ``index_add_`` of
    the product's rows (the product made beforehand), the layout's
    build, and two least times: the row form's (data, scale and ids
    read once, the sums written once; a product and an add an entry)
    and the 1-D form's (the product and its E-length ids read, the sums
    written) with the product's own pass (data and scale read, the
    product written) beside it. ``h`` None: no product. Rows whose id
    lies outside [0, G) add nothing and count in no bound."""
    m, P = d.shape
    valid = (ids >= 0) & (ids < G)
    m_in = int(valid.sum())
    prod = d if h is None else d * h[:, None]
    if m_in < m:
        prod = prod[valid]
    idx64 = ids[valid].long()

    def kernel(d, ids, G):
        return sr.segment_sum_rows(d, ids, G, scale=h, layout=layout)

    def plain(d, ids, G):
        return sr.segment_sum_rows_plain(d, ids, G, scale=h)

    def library(d, ids, G):
        return torch.zeros((G, P), device=d.device).index_add_(0, idx64,
                                                               prod)

    args = (d, ids, G)
    site = {"site": name, "shape": {"m": int(m), "P": int(P), "G": int(G)},
            "launches": launches,
            "ms": _time_ms(torch, kernel, args, flush),
            "plain_ms": _time_ms(torch, plain, args, flush),
            "library_ms": _time_ms(torch, library, args, flush),
            "layout_ms": _time_ms(torch, sr.segment_layout, (ids, G), flush,
                                  reps=10),
            **_kt().row_sum_bounds(m_in, P, G, h is not None)}
    if m_in < m:
        site["shape"]["rows_in_range"] = m_in
    del prod
    return site


def phase_h_segment_timing(torch, np, sr, biggest, launches):
    """The row kernel on the tier-1 w1 leaf of the tiered fog-scale run:
    bitwise a sequential float32 replay on the host, then timed."""
    d, ids, G, h, layout = (biggest[k]
                            for k in ("data", "ids", "G", "scale", "layout"))
    got = sr.segment_sum_rows(d, ids, G, scale=h, layout=layout)
    got = got.cpu().numpy()
    want = _seq_rows(np, d.cpu().numpy(), ids.cpu().numpy(), G,
                     h.cpu().numpy())
    if not _same_bits(np, got, want):
        raise AssertionError("row kernel != the sequential row sum on the "
                             "w1 leaf")
    site = _row_site(torch, sr, "aggregate_tier tier-1 w1", d, ids, G, h,
                     layout, launches["segment_reduce"],
                     flush_buffer(torch, "cuda"))
    return {"name": "segment_reduce", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_reduce.py:78",
            "launches": launches["segment_reduce"],
            "max_abs_err": float(np.abs(got.astype(np.float64)
                                        - want).max()),
            **{k: site[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "layout_ms",
                                    "flat_bound_ms", "product_pass_ms",
                                    "shape")}}


# bounds computed beside bound_ms for the log lines and PERF.md; the
# kernels line carries only bound_ms and measured numbers
DERIVED_BOUNDS = ("flat_bound_ms", "product_pass_ms", "kernel_read_bound_ms")


def kernels_line_entry(k):
    """A kernels-line entry without the derived bounds, in it and in its
    ``sites``."""
    def strip(d):
        return {key: v for key, v in d.items() if key not in DERIVED_BOUNDS}

    entry = strip(k)
    if "sites" in entry:
        entry["sites"] = [strip(site) for site in entry["sites"]]
    return entry


# zamba2-7b serving: the prefill shape, the correctness shape, the serve
# CLI's defaults
SERVE_ARCH = "zamba2-7b"
PREFILL_B, PREFILL_S = 2, 4096
CHECK_B, CHECK_S = 2, 256
DECODE_LAYERS = 18       # (k): two hybrid groups of 9, as (s2) trains
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


# (B, Hp, H, KH, Sq, Sk, hd, causal, window): the MoE, enc-dec and VLM
# archs' attention classes, q heads padded from H to Hp (padded heads
# read KV head 0, as layers.kv_head_map maps them)
ZOO_ATTN = [
    (1, 32, 20, 20, 448, 1500, 64, False, None),    # whisper cross, 32 -> 20
    (1, 32, 20, 20, 1500, 1500, 64, False, None),   # whisper encoder
    (1, 16, 16, 16, 1024, 1024, 128, True, None),   # olmoe
    (1, 32, 32, 8, 2048, 2048, 128, True, 512),     # mixtral: GQA 4:1, window
]


def padded_head_map(torch, Hp, H, KH, device):
    """q head -> KV head with q heads H..Hp-1 padded (reading head 0)."""
    h = torch.arange(Hp, dtype=torch.int32, device=device)
    return torch.where(h < H, h // (H // KH), 0)


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
    for i, (B, Hp, H, KH, Sq, Sk, hd, causal, window) in enumerate(ZOO_ATTN):
        q = _randn(torch, (B, Hp, Sq, hd), 500 + 3 * i, cuda)
        k = _randn(torch, (B, KH, Sk, hd), 501 + 3 * i, cuda)
        v = _randn(torch, (B, KH, Sk, hd), 502 + 3 * i, cuda)
        km = padded_head_map(torch, Hp, H, KH, cuda)
        got = fa.flash_attention(q, k, v, km, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, km, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, atol=ATTN_TOL, rtol=ATTN_TOL)
        log(f"(i) flash_attention B={B} H={Hp} (padded from {H}) KH={KH} "
            f"Sq={Sq} Sk={Sk} hd={hd} causal={causal} window={window} "
            f"float32: max abs err {err} (tolerance {ATTN_TOL})")
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
            "launches": launches, "warm_s": warm}


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

    def ssd(xdt, a, Bm, Cm, *, chunk=128, streaming=False):
        return sd.plain_for(streaming)(xdt, a, Bm, Cm, chunk=chunk)

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


def _teacher_forced(torch, T, steps, init_params, cfg, params, toks, dtype,
                    frames=None):
    """decode_step logits at every position of toks (B, S), the cache in
    ``dtype`` (an SSM state's spec says float32: cast to ``dtype`` too);
    an enc-dec arch's cross K/V from ``encode`` of ``frames``."""
    B, S = toks.shape
    cache = init_params(T.init_cache_specs(cfg, B, S), dtype=dtype,
                        device=toks.device)
    if "h" in cache:
        cache["h"] = cache["h"].to(dtype)
    if frames is not None:
        _, cache["cross_k"], cache["cross_v"] = T.encode(params, frames, cfg)
    decode = steps.make_decode_step(cfg)
    out = []
    for i in range(S):
        lg, cache = decode(params, cache, {"tokens": toks[:, i:i + 1]}, i)
        out.append(lg[:, 0, :cfg.vocab_size])
    return torch.stack(out, dim=1)


def _first_blocks(tree, n):
    """A new nested dict of ``tree``'s leaves, its stacked ``blocks``
    cut to their first n layers (views)."""
    def cut(d, blocks):
        return {k: cut(v, blocks or k == "blocks") if isinstance(v, dict)
                else v[:n] if blocks else v for k, v in d.items()}
    return cut(tree, False)


def phase_k_decode_check(torch, np, card, served, ops, fa, sd, clock):
    """Prefill against teacher-forced decode (no kernel) at full width on
    (j)'s first DECODE_LAYERS blocks (the shared block after each group
    of 9: two of its cache slots): in float64, to the reference's
    tolerance; in float32, the kernels' prefill against the float64
    prefill, held to the float32 rounding the kernel-free paths show.
    (j)'s parameters stay as they are: the float64 copy is (k)'s own."""
    _, serve, steps, T, init_params, _ = _serve_modules()
    cfg = served["cfg"].with_overrides(num_layers=DECODE_LAYERS)
    params = _first_blocks(served["params"], DECODE_LAYERS)
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
    clock.add("k float32 paths", s32)
    clock.add("k float64 paths", s64)
    top = float(ref64.abs().max())
    tol = DECODE_TOL * top
    d64 = float((dec64 - ref64).abs().max())
    err = {name: float((x.double() - ref64).abs().max())
           for name, x in (("kernel prefill", kern32),
                           ("plain prefill", plain32),
                           ("decode", dec32))}
    tol32 = max(tol, 2 * max(err["plain prefill"], err["decode"]))
    d32 = float((kern32 - dec32).abs().max())
    log(f"(k) {SERVE_ARCH} full width, the first {cfg.num_layers} of "
        f"{served['cfg'].num_layers} Mamba2 blocks + the shared block "
        f"{cfg.num_layers // cfg.attn_every} times, B={CHECK_B} "
        f"S={CHECK_S} ({CHECK_S // cfg.ssm_chunk} SSD chunks): float64 "
        f"prefill vs teacher-forced decode max abs diff "
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


def _bounds(nbytes, ops_):
    """Least times of a tensor-core kernel whose products are 3xTF32,
    and for the log line on the CUDA cores
    (``kernel_timing.tensor_core_bounds``)."""
    return _kt().tensor_core_bounds(nbytes, ops_)


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
    flush = flush_buffer(torch, "cuda")
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
    pairs = B * H * _kt().visible_pairs(Sq, Sk, causal, window)
    nbytes, ops_ = _kt().attention_work(B, H, KH, Sq, Sk, hd, causal,
                                        window)
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
    nbytes, ops_ = _kt().ssd_work(B, H, S, P, N, chunk)
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


def attention_launches(cfg):
    """Flash-attention launches of one forward: one a decoder layer, one
    a hybrid group; an enc-dec arch adds its encoder and cross layers."""
    if cfg.attn_every:
        return cfg.num_layers // cfg.attn_every
    if cfg.ssm_state:
        return 0
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def seeded_frontends(torch, np, cfg, B, rng, device):
    """Seeded ``frames`` (enc-dec) or ``patch_embeds`` (VLM) of B rows."""
    out = {}
    for name, n, on in (("frames", cfg.encoder_seq, cfg.family == "encdec"),
                        ("patch_embeds", cfg.vision_patches,
                         bool(cfg.vision_patches))):
        if on:
            out[name] = torch.from_numpy(rng.standard_normal(
                (B, n, cfg.d_model)).astype(np.float32)).to(device)
    return out


SMOKE_ARCHS = ("zamba2-7b", "mamba2-1.3b", "qwen3-14b", "olmoe-1b-7b",
               "mixtral-8x7b", "whisper-large-v3", "phi-3-vision-4.2b")


def phase_m_smoke_configs(torch, np, card, counters, cuda):
    """Smoke configs on the card and on the CPU with the same params."""
    get_config, serve, _, T, init_params, _ = _serve_modules()
    cpu = torch.device("cpu")
    for arch in SMOKE_ARCHS:
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
        front = seeded_frontends(torch, np, cfg, 2, rng, cpu)
        for c in counters.values():
            c.reset_launches()
        with torch.no_grad():
            lc, ac = T.forward(p_card, {"tokens": torch.from_numpy(toks)
                                        .to(cuda), **{k: v.to(cuda) for k, v
                                                      in front.items()}}, cfg)
            lh, ah = T.forward(p_cpu, {"tokens": torch.from_numpy(toks),
                                       **front}, cfg)
        launches = {n: c.launches for n, c in counters.items()}
        diff = float((lc.cpu() - lh).abs().max())
        tol = PORT_TOL * max(1.0, float(lh.abs().max()))
        prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        g_card, _ = serve.greedy_generate(cfg, p_card, prompts, 8)
        g_cpu, _ = serve.greedy_generate(cfg, p_cpu, prompts, 8)
        same = bool((g_card == g_cpu).all())
        aux_diff = abs(float(ac) - float(ah))
        log(f"(m) {arch} smoke card vs CPU: logits {tuple(lc.shape)} max "
            f"abs diff {diff} (tolerance {tol}), aux {float(ac)} / "
            f"{float(ah)}, greedy tokens equal {same}, kernel launches on "
            f"the card's forward {launches} [{card}]")
        if not (diff <= tol and same and aux_diff <= 1e-6):
            raise AssertionError(f"{arch} smoke: card and CPU disagree")
        want_ssd = cfg.num_layers if cfg.ssm_state else 0
        want_attn = attention_launches(cfg)
        if (launches["ssd_scan"], launches["flash_attention"]) != \
                (want_ssd, want_attn):
            raise AssertionError(f"{arch} smoke launched {launches}")


# ---------------------------------------------------------------------------
# (n) planning beyond setting B: settings C/D/E, the convex solver
# ---------------------------------------------------------------------------

E_SQRT = ["--setting", "E", "--error-model", "sqrt"]
CONVEX_ARGV = FOG_ARGV[:FOG_ARGV.index("--n") + 1] + ["200"] + \
    FOG_ARGV[FOG_ARGV.index("--n") + 2:]
CONVEX_ITERS = 800
PLAN_ATOL, OBJ_RTOL = 1e-3, 1e-4   # tests/test_torch_convex.py


def _objective(mv, plan, tr, D, em):
    return mv.plan_cost(plan, tr, D, error_model=em)["total"]


SPREAD_KS = (-2, -1, 0, 1, 2)


def _card_spread(mv, tr, adj, D, em, z0, cuda):
    """The card's own plans from z0·(1 + k·1e-7), k in SPREAD_KS, in one
    batched descent: the largest |Δs|, |Δr| of the moved plans from the
    batch's own k = 0 plan and the five objectives' range."""
    import torch

    runs = mv.solve_convex_batched(
        [tr] * len(SPREAD_KS), [adj] * len(SPREAD_KS),
        [D] * len(SPREAD_KS), error_model=em,
        z0=torch.stack([z0 * (1 + k * 1e-7) for k in SPREAD_KS]),
        device=cuda)
    base = runs[SPREAD_KS.index(0)]
    objs = [_objective(mv, p, tr, D, em) for p in runs]
    return (max(max(abs(p.s - base.s).max(), abs(p.r - base.r).max())
                for p in runs if p is not base), max(objs) - min(objs))


CONVEX_RUNS = [(setting, em) for setting in ("B", "E")
               for em in ("sqrt", "neg_G")]


def _convex_problems():
    """(n)'s convex inputs from CONVEX_ARGV: {setting: (traces, schedule,
    D)} for settings B and E (estimated traces and counts), and z0."""
    from repro_torch.core import estimator as est
    from repro_torch.core import movement as mv
    from repro_torch.core.costs import with_capacity
    from repro_torch.launch import train

    pb = train.build_problem(train.parse_args(CONVEX_ARGV))
    tr, sched, D = pb["traces"], pb["schedule"], pb["D"]
    T, n = D.shape
    probs = {"B": (tr, sched, D),
             "E": (est.estimate_traces(with_capacity(tr, float(D.mean()))),
                   sched, est.estimate_counts(D))}
    return probs, mv.convex_z0(T, n, [0])[0]


def _convex_cpu(tr_, adj, D_, em, z0):
    """One of (n)'s convex solves on the CPU, from the card's inputs."""
    from repro_torch.core import movement as mv

    return mv.solve_convex(tr_, adj, D_, error_model=em, z0=z0,
                           device="cpu")


def phase_n_convex_card_vs_cpu(card, cuda, clock):
    """The convex solve at n=200, T=20, rho=0.1, sqrt and neg_G, on
    setting-B and setting-E inputs on the card (held to the CPU's by
    :func:`collect_n`); batched B=3 against sequential on the card."""
    from repro_torch.core import movement as mv

    probs, z0 = _convex_problems()
    got = {}
    for setting, em in CONVEX_RUNS:
        tr_, adj, D_ = probs[setting]
        t0 = time.perf_counter()
        got[setting, em] = mv.solve_convex(tr_, adj, D_, error_model=em,
                                           z0=z0, device=cuda)
        clock.add(f"n convex {setting}/{em} card", time.perf_counter() - t0)
    tr_, adj, D_ = probs["B"]
    seeds = [0, 1, 2]
    batched = mv.solve_convex_batched([tr_] * 3, [adj] * 3, [D_] * 3,
                                      seeds=seeds, device=cuda)
    # z0 is seed 0's point: got["B", "sqrt"] is the seed-0 solve (bit for
    # bit solve_convex(seed=0) on an H100)
    sequential = [got["B", "sqrt"]] + [
        mv.solve_convex(tr_, adj, D_, seed=sd, device=cuda)
        for sd in seeds[1:]]
    gap = max(max(abs(b.s - q.s).max(), abs(b.r - q.r).max())
              for b, q in zip(batched, sequential))
    log(f"(n) convex batched B=3 vs sequential on the card (setting-B "
        f"inputs, sqrt, seeds {seeds}): max |ds|,|dr| {gap} [{card}]")
    if gap > 1e-5:
        raise AssertionError(f"batched vs sequential gap {gap}")
    return probs, z0, got


def start_n(jobs):
    """(n)'s CPU sides: each convex solve of CONVEX_RUNS, its inputs built
    here from CONVEX_ARGV as the card's are."""
    probs, z0 = _convex_problems()
    for setting, em in CONVEX_RUNS:
        jobs.start(f"n convex {setting}/{em} CPU", _convex_cpu,
                   *probs[setting], em, z0)


def collect_n(card, cuda, jobs, card_side):
    """Each of (n)'s convex solves on the card against the port on the
    CPU from the same z0: plans within PLAN_ATOL and objectives within
    OBJ_RTOL, or, on setting-E inputs, within twice the card's own
    spread."""
    from repro_torch.core import movement as mv

    probs, z0, plans = card_side
    for setting, em in CONVEX_RUNS:
        tr_, adj, D_ = probs[setting]
        got = plans[setting, em]
        want = jobs.collect(f"n convex {setting}/{em} CPU")
        T, n = D_.shape
        d_plan = max(abs(got.s - want.s).max(), abs(got.r - want.r).max())
        o_got, o_want = (_objective(mv, p, tr_, D_, em)
                         for p in (got, want))
        d_obj = abs(o_got - o_want)
        strict = d_plan <= PLAN_ATOL and d_obj <= OBJ_RTOL * abs(o_want)
        note = "within 1e-3 / rtol 1e-4"
        if not strict:
            # capacity-bound inputs: the descent is chaotic in the
            # reference too (tests/test_torch_convex.py); hold the
            # card to twice its own spread under 1e-7 moves of z0
            s_spread, o_spread = _card_spread(mv, tr_, adj, D_, em, z0,
                                              cuda)
            note = (f"card's own spread from z0·(1 + k·1e-7), k = -2..2, "
                    f"in one batched descent: "
                    f"plan {s_spread}, objective {o_spread}")
            if setting == "B" or not (
                    s_spread > PLAN_ATOL and d_plan <= 2 * s_spread
                    and d_obj <= max(2 * o_spread,
                                     OBJ_RTOL * abs(o_want))):
                raise AssertionError(
                    f"convex {setting}/{em}: card vs CPU plan "
                    f"{d_plan}, objective {o_got} vs {o_want}; {note}")
        log(f"(n) convex n={n} T={T} rho=0.1 setting-{setting} inputs "
            f"{em}: card vs CPU max |ds|,|dr| {d_plan}, objective "
            f"{o_got} vs {o_want} (rel {d_obj / abs(o_want)}), {note} "
            f"[{card}]")


def _kernel_stats(torch, fn):
    """CUDA kernels, their summed device time (us) and that time by
    kernel name in a profiler trace of one warm call (copies and
    memsets not counted)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.name.startswith(("Memcpy", "Memset"))]
    by_name: dict = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    return len(ev), sum(by_name.values()), by_name


def _convex_plan_parts(torch, mv, est, with_capacity, pb, cuda):
    """solve_setting("E", sqrt) at fog scale through the same functions,
    part by part on the host clock (each part ends in a sync): window
    estimates, operands to the card, the 800-step solve (also by CUDA
    events, with peak memory), read-back into a plan with its edges,
    and the capacity repair; launches and device time a step from the
    profiler (a 10-step run less a 5-step run)."""
    traces, sched, D = pb["traces"], pb["schedule"], pb["D"]
    T, n = D.shape
    kw = dict(error_model="sqrt", gamma=1.0, lr=0.05, capacity_penalty=50.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cap = with_capacity(traces, float(D.mean()))
    tr, D_hat = est.estimate_traces(cap), est.estimate_counts(D)
    t1 = time.perf_counter()
    ins = mv.convex_device_inputs([tr], [sched], [D_hat], cuda)
    z0 = mv.convex_z0(T, n, [0]).to(cuda)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    s, r = mv.convex_run(*ins, z0, iters=CONVEX_ITERS, **kw)
    e1.record()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    plan = mv.plans_from_dense(s, r)[0]
    n_edges = len(plan.edges)
    t4 = time.perf_counter()
    plan = mv.repair_capacities(plan, cap, sched, D)
    t5 = time.perf_counter()
    del s, r
    stats = {k: _kernel_stats(torch, lambda k=k: mv.convex_run(
        *ins, z0, iters=k, **kw)) for k in (5, 10)}
    solve_ms = e0.elapsed_time(e1)
    return plan, {
        "estimate_s": t1 - t0, "device_inputs_s": t2 - t1,
        "solve_s": t3 - t2, "solve_ms_events": solve_ms,
        "steps_per_s": CONVEX_ITERS / (solve_ms / 1e3),
        "readback_s": t4 - t3, "repair_s": t5 - t4, "edges": n_edges,
        "launches_per_step": (stats[10][0] - stats[5][0]) / 5,
        "device_us_per_step": (stats[10][1] - stats[5][1]) / 5,
        "top_kernels_us_per_step": dict(sorted(
            ((name, (us - stats[5][2].get(name, 0.0)) / 5)
             for name, us in stats[10][2].items()),
            key=lambda kv: -kv[1])[:6]),
        "peak_bytes": peak, "held_before_solve_bytes": held}


def phase_n_fog_e_sqrt(torch, np, card, counters, cuda):
    """--setting E --error-model sqrt at fog scale end to end on the
    card, its plan checked against the capacities and the no-movement
    and all-discard plans, then the plan's time split into parts."""
    from repro_torch.core import estimator as est
    from repro_torch.core import movement as mv
    from repro_torch.core.costs import with_capacity
    from repro_torch.launch import train

    for c in counters.values():
        c.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = train.main(FOG_ARGV + E_SQRT)
    launches = {name: c.launches for name, c in counters.items()}
    run_peak = torch.cuda.max_memory_allocated()
    pb = train.build_problem(train.parse_args(FOG_ARGV + E_SQRT))
    traces, sched, D = pb["traces"], pb["schedule"], pb["D"]
    T, n = D.shape
    cap = with_capacity(traces, float(D.mean()))
    plan, hist = out["plan"], out["history"]
    plan.check(sched)
    G = plan.processed(D)
    e = plan.edges
    off = e.src != e.dst
    vol = e.qty[off] * D[e.t[off], e.src[off]]
    link_cap = cap.cap_link[e.t[off], e.src[off], e.dst[off]]
    if not (np.all(G <= cap.cap_node + 1e-6)
            and np.all(vol <= link_cap + 1e-6)):
        raise AssertionError(f"E/sqrt plan over capacity: G max {G.max()}, "
                             f"link volume over by "
                             f"{float((vol - link_cap).max())}")
    obj = _objective(mv, plan, traces, D, "sqrt")
    base = _objective(mv, mv.no_movement_plan(T, n), traces, D, "sqrt")
    empty = mv.PlanEdges(*(np.zeros(0, np.int64) for _ in range(3)),
                         qty=np.zeros(0))
    disc = _objective(mv, mv.MovementPlan(r=np.ones((T, n)), edges=empty,
                                          n=n), traces, D, "sqrt")
    dl = np.stack(hist["device_loss"])
    tau = int(FOG_ARGV[FOG_ARGV.index("--tau") + 1])
    if dl.shape != (T, n) or not np.isfinite(dl).all() \
            or not np.isfinite(hist["test_loss"]).all() \
            or len(hist["test_acc"]) != T // tau:
        raise AssertionError("E/sqrt fog-scale history incomplete or not "
                             "finite")
    log(f"(n) fog scale --setting E --error-model sqrt: plan "
        f"{out['timing']['plan_s']:.4f} s, train "
        f"{out['timing']['train_s']:.3f} s, P {out['pad_size']}, final_acc "
        f"{out['final_acc']}, {len(e)} plan edges, objective {obj} against "
        f"no movement {base} and all discard {disc}, G max {G.max()} (cap "
        f"{cap.cap_node.max()}), max_memory_allocated {run_peak} B, kernel "
        f"launches {launches} [{card}]")
    if not (obj <= 1.02 * base and obj <= 1.02 * disc):
        raise AssertionError(f"E/sqrt objective {obj} above 1.02x no "
                             f"movement {base} or all discard {disc}")
    for rep in range(2):
        again, parts = _convex_plan_parts(torch, mv, est, with_capacity, pb,
                                          cuda)
        log(f"(n) fog-scale E/sqrt plan by part (rep {rep}): "
            + ", ".join(f"{k} {v}" for k, v in parts.items())
            + f"; plan equals the run's: {mv.plans_equal(again, plan)} "
            f"[{card}]")
        if not mv.plans_equal(again, plan):
            raise AssertionError("the part-by-part E/sqrt plan differs from "
                                 "the run's: the split above is not of the "
                                 "path the run timed")


def phase_n_discard_fog(torch, np, card, counters, cuda, og):
    """Settings C and D with the discard model at fog scale: each run
    launches the Theorem-3 kernel once, and its plan equals the one the
    kernel's plain version gives on the card (D then repaired)."""
    from repro_torch.core import estimator as est
    from repro_torch.core import movement as mv
    from repro_torch.core.costs import with_capacity
    from repro_torch.launch import train

    for setting in ("C", "D"):
        argv = FOG_ARGV + ["--setting", setting]
        for c in counters.values():
            c.reset_launches()
        out = train.main(argv)
        launches = {name: c.launches for name, c in counters.items()}
        pb = train.build_problem(train.parse_args(argv))
        traces, sched, D = pb["traces"], pb["schedule"], pb["D"]
        cap = with_capacity(traces, float(D.mean()))
        tr = est.estimate_traces(traces) if setting == "C" else cap
        choice, best_j, _ = og.offload_greedy_plain(
            *mv.device_inputs(tr, sched, cuda))
        plain = mv._plan_from_choice(choice.cpu().numpy(),
                                     best_j.cpu().numpy())
        if setting == "D":
            plain = mv.repair_capacities(plain, cap, sched, D)
        same = mv.plans_equal(out["plan"], plain)
        hist = out["history"]
        log(f"(n) fog scale --setting {setting} (discard): plan "
            f"{out['timing']['plan_s']:.4f} s, train "
            f"{out['timing']['train_s']:.3f} s, final_acc "
            f"{out['final_acc']}, unit cost {out['cost']['unit']}, kernel "
            f"launches {launches}, plan equals the plain version's: {same} "
            f"[{card}]")
        if launches["offload_greedy"] != 1:
            raise AssertionError(f"setting {setting}: "
                                 f"{launches['offload_greedy']} Theorem-3 "
                                 "launches, expected 1")
        if not same:
            raise AssertionError(f"setting {setting}: plan differs from the "
                                 "plain version's")
        if not (np.isfinite(np.stack(hist["device_loss"])).all()
                and np.isfinite(hist["test_loss"]).all()):
            raise AssertionError(f"setting {setting} history not finite")


def phase_n_defaults_e_sqrt(np, card, cuda, clock):
    """The CLI defaults (cnn, n=10, T=20) with --setting E --error-model
    sqrt on the card and on the CPU, both trained from the CPU's plan and
    held to each other as in (b); the card's own plan beside it."""
    from repro_torch.core import movement as mv
    from repro_torch.launch import train

    argv = SHORT_ARGV + E_SQRT
    on_cpu = clock.call("n defaults E/sqrt CPU", train.main,
                        argv + ["--device", "cpu"])
    pb = train.build_problem(train.parse_args(argv))
    own = train.solve_setting("E", pb["traces"], pb["schedule"], pb["D"],
                              error_model="sqrt", device=cuda)
    want = on_cpu["plan"]
    o_own = mv.plan_cost(own, pb["traces"], pb["D"],
                         error_model="sqrt")["total"]
    solve = train.solve_setting
    train.solve_setting = lambda *a, **k: want
    try:
        on_card = clock.call("n defaults E/sqrt card", train.main, argv)
    finally:
        train.solve_setting = solve
    dmax, amax = _compare_histories(np, on_card, on_cpu)
    log(f"(n) defaults --setting E --error-model sqrt (cnn n=10 T=20), "
        f"card and CPU from the CPU's plan: cost, agg_round, H_agg, active, "
        f"processed_counts equal; max |device_loss diff| {dmax}, max "
        f"|test_acc diff| {amax}; the card's own plan: objective {o_own} "
        f"vs the CPU's {on_cpu['cost']['total']}, max |ds| "
        f"{abs(own.s - want.s).max()} [{card}]")


# ---------------------------------------------------------------------------
# (o) network dynamics: churn and flap schedules, predictive replanning,
# realized plans, the Theorem-3 kernel on per-round adjacency
# ---------------------------------------------------------------------------

CHURN = ["--churn", "0.05"]
FLAP = ["--schedule", "flap", "--p-flap", "0.1"]
DYN_FOG = [(CHURN + ["--replan", m], m) for m in ("oracle", "predict",
                                                  "once")] + \
    [(FLAP + ["--replan", "predict"], "predict")]
# the small case at half the samples of (b): its CPU runs set (o)'s time
DYN_SHORT_ARGV = SHORT_ARGV[:SHORT_ARGV.index("--n-train") + 1] + \
    ["2000"] + SHORT_ARGV[SHORT_ARGV.index("--n-train") + 2:]
DYN_SHORT = [DYN_SHORT_ARGV + ["--churn", "0.1", "--replan", m]
             for m in ("oracle", "predict", "once")] + \
    [DYN_SHORT_ARGV + ["--schedule", "flap"],
     DYN_SHORT_ARGV + ["--tiers", "5@10,1@20", "--churn", "0.1"]]


EDGE_ONE = 500          # the one device active in the edge cases' round 3


def _edge_schedule(np, ts):
    """n = 1003 (rows off a 16-byte boundary), T = 6: round 1 with every
    device exited, round 2 with every device active, round 3 with device
    ``EDGE_ONE`` alone, so that each row of round 2 keeps one live
    receiver column."""
    rng = np.random.default_rng(17)
    T, n = 6, 1003
    adj = rng.random((n, n)) < 0.2
    np.fill_diagonal(adj, False)
    active = rng.random((T, n)) < 0.8
    active[1] = False
    active[2] = True
    active[3] = False
    active[3, EDGE_ONE] = True
    return ts.NetworkSchedule.masked(adj, active,
                                     initial_active=np.ones(n, bool))


def _check_edge_operands(adj):
    """The edge cases' adjacency operand (T, n, n) as ``device_inputs``
    builds it: rounds 0, 1 and 3 empty (no receiver active at t+1, all
    exited, one device with no link to itself), and round 2's rows each
    keeping column ``EDGE_ONE`` alone where the base graph has it.
    Returns the count of round-2 rows with their one live column."""
    one = adj[2, :, EDGE_ONE]
    rest = adj[2].clone()
    rest[:, EDGE_ONE] = False
    if adj[[0, 1, 3]].any() or rest.any() or not one.any():
        raise AssertionError(
            "edge-case operands: rounds 0, 1 and 3 should be empty and "
            f"round 2 should keep column {EDGE_ONE} alone")
    return int(one.sum())


def phase_o_kernel(torch, np, og, cuda, card):
    """Kernel 1 against its plain version, bit for bit, on the operands
    ``device_inputs`` builds from churn-masked and flap schedules at fog
    scale, from their predictions, and from the edge cases; then timed
    on the churn inputs beside its plain version and its bound."""
    from repro_torch.core import estimator as est
    from repro_torch.core import movement as mv
    from repro_torch.core import schedule as ts
    from repro_torch.core.costs import synthetic_costs
    from repro_torch.launch import train

    problems = {}
    cases = {}
    for name, flags in (("churn 0.05", CHURN), ("flap 0.1", FLAP)):
        pb = problems[tuple(flags)] = train.build_problem(
            train.parse_args(FOG_ARGV + flags))
        sched = pb["schedule"]
        cases[name] = (pb["traces"], sched)
        cases[f"predicted {name}"] = (pb["traces"],
                                      est.predict_schedule(sched))
    edge = _edge_schedule(np, ts)
    cases["edge cases n=1003"] = (synthetic_costs(
        edge.n, edge.T, np.random.default_rng(18)), edge)
    churn_ins = None
    for name, (traces, sched) in cases.items():
        ins = mv.device_inputs(traces, sched, cuda)
        got = og.offload_greedy_batched(*ins)
        want = og.offload_greedy_plain(*ins)
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        adj = ins[4]
        rows_live = int(adj.any(2).sum())
        log(f"(o) offload_greedy on {name} ({sched.storage} storage, T, n = "
            f"{tuple(ins[2].shape)}, {int(adj.sum())} live links, "
            f"{rows_live} of {adj.shape[0] * adj.shape[1]} rows with a "
            f"link): choice/best_j/best_cost equal {same} [{card}]")
        if not all(same):
            raise AssertionError(f"kernel != plain version on {name}")
        if name == "churn 0.05":
            churn_ins = ins
    single = _check_edge_operands(mv.device_inputs(
        cases["edge cases n=1003"][0], edge, cuda)[4])
    log(f"(o) edge cases: rounds 0, 1 and 3 empty; round 2 has {single} "
        f"rows whose one live column is {EDGE_ONE}")
    flush = flush_buffer(torch, cuda)
    b = _greedy_bounds(torch, churn_ins)
    times, states = _in_turns(torch, {"kernel": og.offload_greedy_batched,
                                      "plain": og.offload_greedy_plain},
                              churn_ins, flush)
    log(f"(o) offload_greedy on the churn-masked fog-scale inputs "
        f"({b['live_links']} live links in {b['live_sectors']} sectors): "
        f"kernel {_spread(times['kernel'])} ms, plain "
        f"{_spread(times['plain'])} ms (3 rounds in turns, median of 30 "
        f"each), bound {b['bound_ms']} ms "
        f"({b['bound_by']}), sector floor {b['sector_floor_ms']} ms, 64-B "
        f"granule floor {b['granule_floor_ms']} ms; card before each round "
        f"{states} [{card}]")
    return problems


def _dyn_plan_parts(torch, mv, est, ops, og, pb, replan, cuda):
    """The plan of a dynamic fog-scale run part by part on the host
    clock: predict_schedule, device_inputs, the kernel, the COO epilogue
    with read-back and host packing, and realize_plan."""
    sched = pb["schedule"]
    T, n = pb["D"].shape
    t0 = time.perf_counter()
    net = (sched if replan == "oracle" else est.predict_schedule(sched)
           if replan == "predict" else pb["adj"])
    t1 = time.perf_counter()
    ins = mv.device_inputs(pb["traces"], net, cuda)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    choice, best_j, _ = og.offload_greedy_batched(*ins)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    plan = mv._plan_from_edges(T, n, ops.greedy_edges_from_choice(
        choice, best_j))
    t4 = time.perf_counter()
    realized = mv.realize_plan(plan, sched)
    t5 = time.perf_counter()
    return plan, realized, ins, {
        "predict_schedule_s": t1 - t0, "device_inputs_s": t2 - t1,
        "kernel_s": t3 - t2, "epilogue_readback_pack_s": t4 - t3,
        "realize_plan_s": t5 - t4}


def phase_o_fog(torch, np, og, ops, counters, cuda, card, problems):
    """The fog-scale CLI under churn (oracle, predict, once) and flap
    (predict): one Theorem-3 launch a plan, the plan equal to the plain
    version's, the oracle plan unchanged by realize_plan, the history
    complete and finite with the schedule's active trace; and the plan's
    time by part. ``problems``: the runs' problems by schedule flags
    (``build_problem`` does not read ``--replan``)."""
    from repro_torch.core import estimator as est
    from repro_torch.core import movement as mv
    from repro_torch.launch import train

    T = int(FOG_ARGV[FOG_ARGV.index("--T") + 1])
    tau = int(FOG_ARGV[FOG_ARGV.index("--tau") + 1])
    for flags, replan in DYN_FOG:
        argv = FOG_ARGV + flags
        for c in counters.values():
            c.reset_launches()
        out = train.main(argv)
        launches = {name: c.launches for name, c in counters.items()}
        pb = problems[tuple(flags[:-2])]
        sched = pb["schedule"]
        if out["replan"] != replan or sched.static_adj is not None:
            raise AssertionError(f"{flags}: replan {out['replan']}, "
                                 f"expected a dynamic {replan} run")
        if launches["offload_greedy"] != 1:
            raise AssertionError(f"{flags}: {launches['offload_greedy']} "
                                 "Theorem-3 launches, expected 1")
        hist = out["history"]
        dl = np.stack(hist["device_loss"])
        if dl.shape != (T, sched.n) or not np.isfinite(dl).all() \
                or not np.isfinite(hist["test_loss"]).all() \
                or len(hist["test_acc"]) != T // tau:
            raise AssertionError(f"{flags}: history incomplete or not "
                                 "finite")
        if not np.array_equal(np.stack(hist["active"]), sched.activity()):
            raise AssertionError(f"{flags}: active differs from the "
                                 "schedule's activity()")
        parts = []
        for rep in range(2):
            plan, realized, ins, split = _dyn_plan_parts(
                torch, mv, est, ops, og, pb, replan, cuda)
            if not mv.plans_equal(realized, out["plan"]):
                raise AssertionError(f"{flags}: the part-by-part plan "
                                     "differs from the run's")
            parts.append(split)
        choice, best_j, _ = og.offload_greedy_plain(*ins)
        plain = mv.realize_plan(mv._plan_from_choice(
            choice.cpu().numpy(), best_j.cpu().numpy()), sched)
        if not mv.plans_equal(out["plan"], plain):
            raise AssertionError(f"{flags}: plan differs from the plain "
                                 "version's")
        unchanged = mv.plans_equal(plan, realized)
        if replan == "oracle" and not unchanged:
            raise AssertionError("the oracle plan changed under "
                                 "realize_plan: the kernel's receiver mask "
                                 "is not the reference's")
        lost = float((realized.r - plan.r).sum())
        log(f"(o) fog scale {' '.join(flags)}: {out['n_events']} events, "
            f"replan {out['replan']}, run timing {out['timing']}, "
            f"final_acc {out['final_acc']}, unit cost {out['cost']['unit']},"
            f" kernel launches {launches}, plan equals the plain version's, "
            f"realize_plan left it unchanged: {unchanged} (shares lost in "
            f"realization {lost}); plan by part: {parts} [{card}]")


def _rerun_with_memory_held(torch, np, train, argv, first):
    """Run ``argv`` on the card again with all but 1 GiB of its free
    memory held, and require the same history bit for bit: the CNN's
    convolutions must not change their arithmetic with the workspace
    they can get (cuDNN did; ``device.set_f32_numerics`` turns it off)."""
    held = torch.empty(torch.cuda.mem_get_info()[0] - 2 ** 30,
                       dtype=torch.uint8, device="cuda")
    try:
        again = train.main(argv)
    finally:
        del held
        torch.cuda.empty_cache()
    for k in ("device_loss", "test_loss", "test_acc"):
        if not np.array_equal(np.asarray(again["history"][k]),
                              np.asarray(first["history"][k])):
            raise AssertionError(f"{k} changed with the card's memory held")


def phase_o_small(torch, np, clock):
    """cnn n=10 T=20 under churn (oracle, predict, once), flap, and
    tiers with churn, on the card (held to the CPU by
    :func:`collect_o`). The flap run, the most sensitive to its
    arithmetic, runs once more on the card with its memory held and must
    repeat its history bit for bit."""
    from repro_torch.launch import train

    runs = []
    for argv in DYN_SHORT:
        tag = " ".join(argv[len(DYN_SHORT_ARGV):])
        on_card = clock.call(f"o {tag} card", train.main, argv)
        if "flap" in argv:
            clock.call(f"o {tag} card, memory held",
                       _rerun_with_memory_held, torch, np, train, argv,
                       on_card)
        runs.append(on_card)
    return runs


def phase_o_table5(cuda, clock):
    """Table V at --quick on the card (held to the CPU by
    :func:`collect_o`)."""
    from repro_torch.launch import tables

    return clock.call("o Table V card", tables.table5_dynamics, tables.QUICK,
                      cuda)


def start_o(jobs):
    """(o)'s CPU sides: the DYN_SHORT runs and Table V at --quick."""
    from repro_torch.launch import tables, train

    for argv in DYN_SHORT:
        tag = " ".join(argv[len(DYN_SHORT_ARGV):])
        jobs.start(f"o {tag} CPU", train.main, argv + ["--device", "cpu"])
    jobs.start("o Table V CPU", tables.table5_dynamics, tables.QUICK, "cpu")


def collect_o(np, card, jobs, runs, table5):
    """(o)'s card runs against their CPU sides: the DYN_SHORT runs as in
    (b), plus n_events, schedule, replan and the tier fields; Table V's
    cost rows and avg_active exactly, accuracies within 1e-2."""
    for argv, on_card in zip(DYN_SHORT, runs):
        tag = " ".join(argv[len(DYN_SHORT_ARGV):])
        on_cpu = jobs.collect(f"o {tag} CPU")
        dmax, amax = _compare_histories(np, on_card, on_cpu)
        for k in ("n_events", "schedule", "replan"):
            if on_card[k] != on_cpu[k]:
                raise AssertionError(f"{k} differs: {on_card[k]} vs "
                                     f"{on_cpu[k]}")
        h, w = on_card["history"], on_cpu["history"]
        for k in ("tier_agg_round", "tier_agg_level"):
            if h.get(k) != w.get(k):
                raise AssertionError(f"{k} differs")
        log(f"(o) {tag} (cnn n=10 T=20, 2000 samples) card "
            f"vs CPU: cost, agg_round, H_agg, active, processed_counts, "
            f"n_events {on_card['n_events']}, replan {on_card['replan']} "
            f"equal; max |device_loss diff| {dmax}, max |test_acc diff| "
            f"{amax}; train_s card {on_card['timing']['train_s']} CPU "
            f"{on_cpu['timing']['train_s']}"
            f"{'; repeated bitwise with memory held' if 'flap' in argv else ''}"
            f" [{card}]")
    got, want = table5, jobs.collect("o Table V CPU")
    for row in ("static", "dynamic"):
        if got[row]["cost"] != want[row]["cost"]:
            raise AssertionError(f"Table V {row} cost differs")
        if abs(got[row]["acc"] - want[row]["acc"]) > 1e-2:
            raise AssertionError(f"Table V {row} accuracy differs by more "
                                 "than 1e-2")
    if got["headline"]["avg_active"] != want["headline"]["avg_active"]:
        raise AssertionError("Table V avg_active differs")
    log(f"(o) Table V --quick card vs CPU: costs and avg_active "
        f"{got['headline']['avg_active']} equal; accuracies "
        f"{[got[r]['acc'] for r in ('static', 'dynamic')]} vs "
        f"{[want[r]['acc'] for r in ('static', 'dynamic')]} [{card}]")


FAULT_FLAGS = ["--faults", "mixed", "--fault-rate", "0.1", "--quorum",
               "0.25"]
FAULT_SHORT = [SHORT_ARGV + ["--faults", "mixed", "--fault-rate", "0.2",
                             "--quorum", "0.4"],
               SHORT_ARGV + ["--faults", "corrupt", "--fault-rate", "0.3",
                             "--unguarded"],
               TIERED_SHORT_ARGV + ["--faults", "mixed", "--fault-rate",
                                    "0.2"]]
RESUME_STOP = 10                 # rounds; two windows of the fog scale
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"


def _finite_history(np, hist):
    return bool(np.isfinite(np.stack(hist["device_loss"])).all()
                and np.isfinite(hist["test_loss"]).all()
                and np.isfinite(np.stack(hist["H_agg"])).all())


def _history_diff(np, a, b, keys=("device_loss", "test_loss", "test_acc",
                               "H_agg", "agg_survivors", "agg_quorum_ok")):
    """The keys of two histories equal bit for bit (NaN in the same
    places); returns the keys that differ."""
    return [k for k in keys if (k in a) != (k in b) or (
        k in a and not np.array_equal(np.asarray(a[k], float),
                                      np.asarray(b[k], float),
                                      equal_nan=True))]


def phase_p_fog(torch, np, card, counters, train_c_s):
    """(p1) the fog-scale CLI under mixed faults: one Theorem-3 launch,
    the fault summary of make_faults for the same seed, a finite
    guarded history."""
    from repro_torch.core import faults as fl
    from repro_torch.launch import train

    argv = FOG_ARGV + FAULT_FLAGS
    for c in counters.values():
        c.reset_launches()
    out = train.main(argv)
    launches = {name: c.launches for name, c in counters.items()}
    args = train.parse_args(argv)
    want = fl.make_faults("mixed", args.T, args.n, args.tau,
                          rate=args.fault_rate, seed=args.seed + 7919,
                          corrupt=args.corrupt_mode).summary()
    hist = out["history"]
    log(f"(p1) fog scale under --faults mixed --fault-rate 0.1 --quorum "
        f"0.25: plan {out['timing']['plan_s']:.4f} s, train "
        f"{out['timing']['train_s']:.3f} s (clean, (c): {train_c_s:.3f} s, "
        f"the first mlp run of the process), fault_summary "
        f"{out['fault_summary']}, quorum_skips {out['quorum_skips']}, "
        f"survivors {hist['agg_survivors']}, final_acc "
        f"{out['final_acc']}, kernel launches {launches} [{card}]")
    if launches["offload_greedy"] != 1:
        raise AssertionError(f"{launches['offload_greedy']} Theorem-3 "
                             "launches on the faulted path, expected 1")
    if out["fault_summary"] != want:
        raise AssertionError(f"fault_summary {out['fault_summary']} != "
                             f"make_faults' {want}")
    if not _finite_history(np, hist):
        raise AssertionError("guarded fog-scale history is not finite")
    return out["timing"]["train_s"]


def phase_p_tiered(torch, np, card, counters, ops, sr):
    """(p2) the tiered fog-scale CLI under the same faults: the segment
    launches of the clean path exactly (quorum decisions stay on the
    card), and a tier-1 reduction with rows the faults zeroed held to
    the kernel's plain version bit for bit."""
    from repro_torch.core import faults as fl
    from repro_torch.launch import train

    argv = TIERED_FOG_ARGV + FAULT_FLAGS
    args = train.parse_args(argv)
    P_w2 = 200 * 10                      # the mlp's w2 leaf
    kept = []
    real_rows = ops.segment_sum_rows

    def keep_tier1_w2(data, segment_ids, *, num_segments, scale=None,
                      layout=None):
        if tuple(data.shape) == (args.n, P_w2):
            kept.append((data.clone(), segment_ids, num_segments,
                         scale.clone(), layout))
        return real_rows(data, segment_ids, num_segments=num_segments,
                         scale=scale, layout=layout)

    ops.segment_sum_rows = keep_tier1_w2
    try:
        for c in counters.values():
            c.reset_launches()
        out = train.main(argv)
        launches = {name: c.launches for name, c in counters.items()}
    finally:
        ops.segment_sum_rows = real_rows
    hist = out["history"]
    want = sum(hist["tier_agg_level"]) * (1 + 4)
    log(f"(p2) tiered fog scale under the same faults: train "
        f"{out['timing']['train_s']:.3f} s, tier levels "
        f"{hist['tier_agg_level']}, fault_summary {out['fault_summary']}, "
        f"quorum_skips {out['quorum_skips']}, kernel launches {launches} "
        f"(segment sums expected {want}, the clean path's) [{card}]")
    if launches["segment_reduce"] != want:
        raise AssertionError(f"{launches['segment_reduce']} segment "
                             f"launches under faults, expected {want}")
    if launches["offload_greedy"] != 1:
        raise AssertionError("the tiered faulted plan did not launch the "
                             "Theorem-3 kernel once")
    if not _finite_history(np, hist):
        raise AssertionError("guarded tiered history is not finite")
    upl, cor = fl.make_faults(args.faults, args.T, args.n, args.tau,
                              rate=args.fault_rate, seed=args.seed + 7919,
                              corrupt=args.corrupt_mode).engine_arrays()
    hit = None
    for t, (data, ids, G, h, layout) in zip(hist["tier_agg_round"], kept):
        bad = np.nonzero((upl[t] == 0) | ~np.isfinite(cor[t]))[0]
        sel = torch.from_numpy(bad).to(data.device)
        # what a row adds, its parameters times its weight: zero where a
        # drop took the weight or the guard the parameters
        rows = data[sel] * h[sel][:, None]
        if len(bad) and bool((rows == 0).all()):
            hit = (t, bad, data, ids, G, h, layout)
            break
    if hit is None:
        raise AssertionError("no tier-1 reduction with fault-zeroed rows")
    t, bad, data, ids, G, h, layout = hit
    # the plain version on the CPU adds each group's rows in ascending
    # order, one at a time from +0: the kernel's order (on the card its
    # index_add_ adds by atomics, in no fixed order)
    got = sr.segment_sum_rows(data, ids, G, scale=h, layout=layout).cpu()
    plain = sr.segment_sum_rows_plain(data.cpu(), ids.cpu(), G,
                                      scale=h.cpu())
    if not torch.equal(got, plain):
        raise AssertionError("row kernel != plain on the guarded rows")
    log(f"(p2) tier-1 w2 row sum of round {t} (m={data.shape[0]}, "
        f"P={data.shape[1]}, G={G}; rows of devices {bad.tolist()[:8]}"
        f"{'...' if len(bad) > 8 else ''} ({len(bad)}) zeroed by a drop or "
        f"the guard): kernel == plain (on the CPU) bitwise [{card}]")


def _timed_run(torch, F, pb, plan, cuda, **kw):
    """One fog-scale training run and its seconds on the host clock (the
    history's read-back ends it). Each run takes a copy of the streams:
    ``run_network_aware`` empties the collection of inactive (crashed)
    devices in place."""
    import copy

    streams = copy.deepcopy(pb["streams"])
    t0 = time.perf_counter()
    hist = F.run_network_aware(pb["cfg"], pb["data"], pb["traces"],
                               pb["adj"], plan, streams=streams,
                               schedule=pb["schedule"], device=cuda, **kw)
    return hist, time.perf_counter() - t0


def phase_p_noop_resume(torch, np, card, cuda):
    """(p3) an empty FaultSchedule under the guard and quorum 0.5 gives
    the clean fog-scale history bit for bit (clean, no-op and mixed
    faults run three times in turns, timed); (p4) checkpoint, stop at
    round 10 and resume, clean and under mixed faults, bit for bit the
    uninterrupted run; save and restore timed, the file's size."""
    import os
    import shutil

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import faults as fl
    from repro_torch.core import federated as F
    from repro_torch.launch import train

    args = train.parse_args(FOG_ARGV + FAULT_FLAGS)
    pb = train.build_problem(args)
    cfg = pb["cfg"]
    clean_plan, _ = train.make_plan(args, pb, cuda)
    faults = train.make_fault_schedule(args, cfg)
    fplan, _ = train.make_plan(args, pb, cuda, faults=faults)
    fkw = dict(faults=faults, guard=True, quorum=args.quorum)
    runs = {"clean": (clean_plan, {}),
            "guarded no-op": (clean_plan, dict(
                faults=fl.FaultSchedule(cfg.T, cfg.n, cfg.tau), guard=True,
                quorum=0.5)),
            "mixed": (fplan, fkw)}
    hists, secs = {}, {k: [] for k in runs}
    for _ in range(3):                   # in turns, the guard's cost
        for name, (plan, kw) in runs.items():
            hist, sec = _timed_run(torch, F, pb, plan, cuda, **kw)
            secs[name].append(round(sec, 4))
            if name in hists and _history_diff(np, hists[name], hist):
                raise AssertionError(f"{name} run does not repeat bitwise")
            hists.setdefault(name, hist)
    clean, noop, mixed = (hists[k] for k in runs)
    diff = _history_diff(np, clean, noop, keys=("device_loss", "test_loss",
                                                "test_acc", "H_agg"))
    log(f"(p3) fog scale, empty FaultSchedule, guard on, quorum 0.5: "
        f"history bitwise the clean run's: {not diff}; each run repeats "
        f"bitwise; train s in turns: {secs} (mixed: guarded, quorum "
        f"{args.quorum}, {mixed['fault_summary']}) [{card}]")
    if diff:
        raise AssertionError(f"clean no-op differs in {diff}")
    times = {"save": [], "restore": []}
    real = {"save": ckpt.save, "restore": ckpt.restore}

    def timed(name):
        def fn(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real[name](*a, **kw)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return res
        return fn

    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(CKPT_DIR / "fog.pt")
    ckpt.save, ckpt.restore = timed("save"), timed("restore")
    try:
        for name in ("clean", "mixed"):
            (plan, kw), whole = runs[name], hists[name]
            times["save"].clear()
            times["restore"].clear()
            part, part_s = _timed_run(torch, F, pb, plan, cuda,
                                      checkpoint_path=path,
                                      stop_after=RESUME_STOP, **kw)
            size = os.path.getsize(path)
            res, res_s = _timed_run(torch, F, pb, plan, cuda, resume=path,
                                    **kw)
            diff = _history_diff(np, whole, res)
            log(f"(p4) {name}: stopped at {part.get('stopped_at')} "
                f"({part_s:.3f} s with {len(times['save'])} saves), "
                f"resumed to T={cfg.T} ({res_s:.3f} s); resumed history "
                f"bitwise the uninterrupted one: {not diff}; save s "
                f"{[round(x, 4) for x in times['save']]}, restore s "
                f"{[round(x, 4) for x in times['restore']]}, file {size} B "
                f"[{card}]")
            if part.get("stopped_at") != RESUME_STOP:
                raise AssertionError(f"{name}: stopped at "
                                     f"{part.get('stopped_at')}")
            if diff:
                raise AssertionError(f"{name}: resumed run differs from "
                                     f"the uninterrupted one in {diff}")
    finally:
        ckpt.save, ckpt.restore = real["save"], real["restore"]
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


def phase_p_small(clock):
    """(p5) cnn n=10 T=20 under mixed faults with a quorum, unguarded
    corruption, and tiers with mixed faults, on the card (held to the
    CPU by :func:`collect_p`)."""
    from repro_torch.launch import train

    return [clock.call(f"p5 {' '.join(argv[len(SHORT_ARGV):])} card",
                       train.main, argv) for argv in FAULT_SHORT]


def start_p(jobs):
    """(p)'s CPU sides: the FAULT_SHORT runs and the fault study."""
    from repro_torch.launch import tables, train

    for argv in FAULT_SHORT:
        jobs.start(f"p5 {' '.join(argv[len(SHORT_ARGV):])} CPU", train.main,
                   argv + ["--device", "cpu"])
    jobs.start("p6 CPU", tables.fault_tolerance, tables.QUICK, "cpu")


def collect_p(np, card, jobs, runs, study):
    """(p5)'s card runs against their CPU sides, as in (b) and (g), the
    fault fields exactly and NaN in the same places; then (p6)'s study
    against its CPU side."""
    for argv, on_card in zip(FAULT_SHORT, runs):
        tag = " ".join(argv[len(SHORT_ARGV):])
        on_cpu = jobs.collect(f"p5 {tag} CPU")
        dmax, amax = _compare_histories(np, on_card, on_cpu)
        h, w = on_card["history"], on_cpu["history"]
        for k in ("fault_summary", "quorum_skips"):
            if on_card[k] != on_cpu[k]:
                raise AssertionError(f"{k} differs")
        for k in ("agg_survivors", "agg_quorum_ok", "tier_agg_round",
                  "tier_agg_level"):
            if h.get(k) != w.get(k):
                raise AssertionError(f"{k} differs")
        for k in ("device_loss", "test_loss"):
            if not np.array_equal(np.isnan(np.asarray(h[k], float)),
                                  np.isnan(np.asarray(w[k], float))):
                raise AssertionError(f"NaN positions of {k} differ")
        nan = int(np.isnan(np.asarray(h["test_loss"], float)).sum())
        log(f"(p5) {tag} (cnn n=10 T=20) card vs CPU: cost, agg_round, "
            f"H_agg, active, processed_counts, fault_summary "
            f"{on_card['fault_summary']}, quorum_skips "
            f"{on_card['quorum_skips']}, agg_survivors, agg_quorum_ok equal"
            f", NaN in the same places ({nan} NaN test losses); max "
            f"|device_loss diff| {dmax}, max |test_acc diff| {amax} "
            f"[{card}]")
    _check_p_study(card, *study, jobs.collect("p6 CPU"))


def phase_p_study(cuda, clock):
    """(p6) the fault-tolerance study at --quick on the card, its exact
    claims (held to the CPU by :func:`collect_p`): (result, seconds)."""
    from repro_torch.launch import tables

    t0 = time.perf_counter()
    got = tables.fault_tolerance(tables.QUICK, cuda)
    card_s = time.perf_counter() - t0
    clock.add("p6 card", card_s)
    h = got["headline"]
    if not (h["clean_noop_bitwise"] and h["resume_bitwise"]):
        raise AssertionError(f"exact claims fail on the card: {h}")
    if h["quorum_skips_q0"] != 0:
        raise AssertionError("quorum 0 skipped an aggregation")
    if not h["unguarded_near_random"]:
        raise AssertionError("the unguarded arm did not collapse")
    return got, card_s


def _check_p_study(card, got, card_s, want):
    """(p6)'s study on the card against the port on the CPU."""
    h, w = got["headline"], want["headline"]
    for k in ("quorum_skips_q60", "guard_within_2pp"):
        if h[k] != w[k]:
            raise AssertionError(f"{k} differs from the CPU's: {h[k]} vs "
                                 f"{w[k]}")
    for g, c in zip(got["rows"], want["rows"]):
        for k in ("fault_summary", "quorum_skips", "cost_total",
                  "avg_active"):
            if g[k] != c[k]:
                raise AssertionError(f"{g['arm']}: {k} differs")
        if abs(g["acc"] - c["acc"]) > 1e-2:
            raise AssertionError(f"{g['arm']}: accuracy differs by more "
                                 "than 1e-2")
    log(f"(p6) fault study --quick on the card ({card_s:.1f} s): "
        f"{json.dumps(h)}; CPU: guard_within_2pp {w['guard_within_2pp']} "
        f"(acc clean {w['acc_clean']}, guarded c10 {w['acc_guarded_c10']}),"
        f" quorum_skips_q60 {w['quorum_skips_q60']}; fault summaries, "
        f"quorum skips, costs equal; accuracies "
        f"{[r['acc'] for r in got['rows']]} vs "
        f"{[r['acc'] for r in want['rows']]} [{card}]")


def phase_p_serve(card):
    """(p7) serve --checkpoint, then --resume, at the smoke config on
    the card: the same tokens."""
    import shutil

    from repro_torch.launch import serve

    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(CKPT_DIR / "serve.pt")
    try:
        first = serve.main(["--arch", SERVE_ARCH, "--checkpoint", path])
        again = serve.main(["--arch", SERVE_ARCH, "--resume", path])
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if not again["resumed"] or again["sample"] != first["sample"]:
        raise AssertionError("resumed serve gave other tokens")
    log(f"(p7) serve {SERVE_ARCH} smoke --checkpoint then --resume on the "
        f"card: tokens equal {again['sample']} [{card}]")


# ---------------------------------------------------------------------------
# (q) the sparse O(E) plane at fog scale
# ---------------------------------------------------------------------------

SCALE_N, SCALE_T = 102_400, 50
SMALL_SCALE_N, SMALL_SCALE_T = 2048, 20


def _replay_H(np, hist, sync_rounds, reset_rounds):
    """H at each reset round, replayed in float32 on the host from the
    run's activity and processed counts: each round adds counts ×
    active (active = activity × (1 − waiting)); a sync round sets
    waiting to 1 − activity, a reset round records H and zeroes it.
    Sums of small integers, so exact."""
    act = np.stack(hist["active"]).astype(np.float32)
    cnt = np.stack(hist["processed_counts"]).astype(np.float32)
    H = np.zeros(act.shape[1], np.float32)
    waiting = np.zeros_like(H)
    out = []
    for t in range(act.shape[0]):
        H = H + cnt[t] * (act[t] * (np.float32(1) - waiting))
        if t in sync_rounds:
            waiting = np.float32(1) - act[t]
        if t in reset_rounds:
            out.append(H)
            H = np.zeros_like(H)
    return out


def _check_scale_history(np, keep, hist, tau, tiers=None):
    """A fog-scale history against what the host can recompute: the
    activity is the schedule's, the processed counts the flat stream's
    census after masking and routing, every H weight the float32 replay
    of :func:`_replay_H` bit for bit, the aggregation rounds the τ (or
    tier) rounds, and every loss finite."""
    sched, flat = keep["schedule"], keep["streams"]
    T, n = flat.T, flat.n
    if not np.array_equal(np.stack(hist["active"]), sched.activity()):
        raise AssertionError("active != schedule.activity()")
    cnt = np.stack(hist["processed_counts"])
    if cnt.shape != (T, n) or int(cnt.sum()) > flat.idx.shape[0]:
        raise AssertionError("processed_counts malformed")
    if tiers is None:
        sync = reset = {t for t in range(T) if (t + 1) % tau == 0}
    else:
        lvl = tiers.level_rounds(T)
        sync = set(np.nonzero(lvl > 0)[0].tolist())
        reset = set(np.nonzero(lvl == tiers.levels)[0].tolist())
    if hist["agg_round"] != sorted(reset):
        raise AssertionError(f"agg_round {hist['agg_round']}")
    want = _replay_H(np, hist, sync, reset)
    if not np.array_equal(np.stack(hist["H_agg"]), np.stack(want)):
        raise AssertionError("H_agg differs from the host replay")
    if not _finite_history(np, hist):
        raise AssertionError("fog-scale history is not finite")
    return float(np.stack(want).sum())


def phase_q_sparse(torch, np, card, counters, cuda):
    """(q1) sparse_scale at full size."""
    from repro_torch.launch import tables as tb

    keep = {}
    for c in counters.values():
        c.reset_launches()
    out = tb.sparse_scale(tb.DEFAULT, cuda, keep=keep)
    launches = {name: c.launches for name, c in counters.items()}
    tr, hd = out["train"], out["headline"]
    for r in out["rows"]:
        log(f"(q1) sparse plan n={r['n']} T={r['T']}: {r['edges']} plan "
            f"edges, {r['sparse_s']:.4f} s, tracemalloc peak "
            f"{r['sparse_peak_bytes']} B ({r['peak_over_nn']:.4f} n²) "
            f"[{card}]")
    do = out["dense_oracle"]
    log(f"(q1) n={do['n']}: sparse {do['sparse_s']:.4f} s, dense numpy "
        f"oracle {do['dense_s']:.4f} s ({hd['plan_speedup_vs_dense']:.2f}x);"
        f" plans identical {hd['plans_identical']}, kernel-1 plan identical"
        f" {hd['kernel_plan_identical']}, predictions identical "
        f"{hd['predictions_identical']} [{card}]")
    log(f"(q1) train n={tr['n']} T={tr['T']} tau={tr['tau']}: "
        f"{tr['samples']} samples, P {tr['max_points']}, "
        f"{tr['train_s']:.3f} s (parts {tr['parts']}), tracemalloc peak "
        f"{tr['train_peak_bytes']} B ({hd['train_peak_over_nn']:.4f} n²), "
        f"max_memory_allocated {tr['device_peak_bytes']} B, final_acc "
        f"{tr['final_acc']}, launches {launches} [{card}]")
    if (tr["n"], tr["T"]) != (SCALE_N, SCALE_T):
        raise AssertionError(f"trained n={tr['n']} T={tr['T']}")
    if not (hd["plans_identical"] and hd["kernel_plan_identical"]
            and hd["predictions_identical"]
            and hd["no_dense_nn_materialized"]):
        raise AssertionError(f"sparse_scale headline {hd}")
    if launches["offload_greedy"] != 1:
        raise AssertionError(f"{launches['offload_greedy']} Theorem-3 "
                             "launches; the n=1024 kernel plan makes one")
    if tr["device_peak_bytes"] >= 4 * SCALE_N ** 2:
        raise AssertionError("the card held a float32 (n, n) array's worth")
    h_total = _check_scale_history(np, keep, keep["hist"], tr["tau"])
    log(f"(q1) history: active == schedule, H_agg == host replay bit for "
        f"bit (ΣH {h_total}), agg rounds {keep['hist']['agg_round']}, "
        f"finite [{card}]")
    return keep


def _segment_site(torch, np, sr, name, d, ids, S, layout, launches, flush):
    """Kernel 2 timed at one launch site of (q), beside its plain
    version, ``index_add_`` and its byte bound."""
    def kernel_sum(d, ids, S):
        return sr.segment_sum(d, ids, S, layout=layout)

    idx64 = ids.long()

    def library_sum(d, ids, S):
        return torch.zeros(S, device=d.device).index_add_(0, idx64, d)

    args = (d, ids, S)
    E = d.shape[0]
    # the function's bytes: data and ids read once, the sums written
    # once; the kernel also reads its offsets, 4(S + 1) bytes
    nbytes = 4 * E + 4 * E + 4 * S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, E / F32_OPS_PER_S
    return {"site": name, "shape": {"E": int(E), "S": int(S)},
            "launches": launches,
            "ms": _time_ms(torch, kernel_sum, args, flush),
            "plain_ms": _time_ms(torch, sr.segment_sum_plain, args, flush),
            "library_ms": _time_ms(torch, library_sum, args, flush),
            "layout_ms": _time_ms(torch, sr.segment_layout, (ids, S), flush,
                                  reps=10),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kernel_read_bound_ms": 1e3 * (nbytes + 4 * (S + 1))
            / HBM_BYTES_PER_S}


def phase_q_counts(torch, np, card, sr, keep, cuda):
    """(q2) counts_flat through kernel 2, exactly; plan_cost on it."""
    from repro_torch.core import movement as mv
    from repro_torch.data import pipeline as pl

    flat = keep["streams"]
    T, n = flat.T, flat.n
    sr.reset_launches()
    D = pl.counts_flat(flat)
    launches = sr.launches
    key = flat.cell_key()
    want = np.bincount(key, minlength=T * n).reshape(T, n)
    ids = torch.from_numpy(key.astype(np.int32)).to(cuda)
    ones = torch.ones(key.shape[0], device=cuda)
    plain = sr.segment_sum_plain(ones, ids, T * n).cpu().numpy()
    ok = {"launches == 1": launches == 1,
          "== np.bincount": np.array_equal(D, want.astype(np.float64)),
          "== plain": np.array_equal(D, plain.astype(np.float64)
                                     .reshape(T, n)),
          "float64 (T, n)": D.dtype == np.float64 and D.shape == (T, n)}
    cost = mv.plan_cost(keep["plan"], keep["costs"], D)
    cost_cpu = mv.plan_cost(keep["plan"], keep["costs"],
                            pl.counts_flat(flat, "cpu"))
    worst = max(abs(cost[k] - cost_cpu[k]) / max(abs(cost_cpu[k]), 1e-300)
                for k in cost)
    ok["plan_cost within 1e-12"] = worst <= 1e-12
    site = _segment_site(torch, np, sr, "counts_flat", ones, ids, T * n,
                         sr.segment_layout(ids, T * n), launches,
                         flush_buffer(torch, cuda))
    log(f"(q2) counts_flat of {key.shape[0]} samples into T·n = {T * n} "
        f"cells: {ok}; plan_cost rel diff {worst}; unit cost "
        f"{cost['unit']}; kernel {site['ms']} ms (bound "
        f"{site['bound_ms']} ms by {site['bound_by']}, kernel reads "
        f"{site['kernel_read_bound_ms']} ms), plain {site['plain_ms']} ms, "
        f"index_add_ {site['library_ms']} ms, layout build "
        f"{site['layout_ms']} ms [{card}]")
    if not all(ok.values()):
        raise AssertionError(f"counts_flat on the card: {ok}")
    return site


def phase_q_hier(torch, np, card, counters, ops, sr, cuda):
    """(q3) hier_scale at full size; the tier-1 w row sum bitwise its
    plain version (on the CPU, where it adds in row order) and the 1-D
    form of the same sum through the generic kernel; returns both
    timings (``sites`` entries)."""
    from repro_torch.launch import tables as tb

    biggest = {}
    real_rows = ops.segment_sum_rows
    keep = {}
    ops.segment_sum_rows = _keep_biggest_rows(ops, biggest)
    try:
        for c in counters.values():
            c.reset_launches()
        out = tb.hier_scale(tb.DEFAULT, cuda, keep=keep)
        launches = {name: c.launches for name, c in counters.items()}
    finally:
        ops.segment_sum_rows = real_rows
    tr, hd = out["train"], out["headline"]
    lv = tr["tier_agg_level"]
    want = sum(lv) * 3                      # H_g, w and b per tier
    log(f"(q3) hier_scale n={tr['n']} T={tr['T']} tiers "
        f"{out['tiers']['group_counts']} taus {out['tiers']['taus']}: P "
        f"{tr['max_points']}, tier segments built in "
        f"{tr['tier_segments_s']:.3f} s, hier {tr['hier_s']:.3f} s, flat "
        f"plan {tr['flat_plan_s']:.3f} s, flat {tr['flat_s']:.3f} s, "
        f"cross-gateway edges {hd['cross_gateway_edges']}, cross/flat "
        f"bytes {hd['cross_over_flat']}, tracemalloc peaks "
        f"{out['peaks_bytes']}, max_memory_allocated "
        f"{out['device_peak_bytes']}, tier events {len(lv)} (Σlevel "
        f"{sum(lv)}), kernel launches {launches}, expected {want} "
        f"[{card}]")
    if (tr["n"], tr["T"]) != (SCALE_N, SCALE_T):
        raise AssertionError(f"trained n={tr['n']} T={tr['T']}")
    if hd["cross_gateway_edges"] != 0 or not hd["l1_collapse_bitwise"]:
        raise AssertionError(f"hier_scale headline {hd}")
    if launches["segment_reduce"] != want or tr["segment_launches"] != want:
        raise AssertionError(f"{launches['segment_reduce']} segment "
                             f"launches, expected {want}")
    tree = keep["tree"]
    h_total = _check_scale_history(np, keep, keep["hist"], 5, tiers=tree)
    _check_scale_history(np, keep, keep["hist_flat"], 5)
    d, ids, G, h, layout = (biggest[k]
                            for k in ("data", "ids", "G", "scale", "layout"))
    m, P = d.shape
    got = sr.segment_sum_rows(d, ids, G, scale=h, layout=layout)
    plain = sr.segment_sum_rows_plain(d.cpu(), ids.cpu(), G, scale=h.cpu())
    if not _same_bits(np, got.cpu().numpy(), plain.numpy()):
        raise AssertionError("tier-1 w row sum != its plain version bitwise")
    flush = flush_buffer(torch, cuda)
    rows = _row_site(torch, sr, "aggregate_tier tier-1 w", d, ids, G, h,
                     layout, launches["segment_reduce"], flush)
    # the same sum in its 1-D form (the product over the ids g·P + p)
    # through the generic kernel: bitwise the row form
    flat = (d * h[:, None]).reshape(-1)
    fids = (ids[:, None] * P + torch.arange(
        P, dtype=torch.int32, device=cuda)[None]).reshape(-1)
    flay = sr.segment_layout(fids, G * P)
    fgot = sr.segment_sum(flat, fids, G * P, layout=flay)
    if not torch.equal(fgot.view(torch.int32),
                       got.reshape(-1).view(torch.int32)):
        raise AssertionError("tier-1 w: the 1-D form != the row form")
    one_d = _segment_site(torch, np, sr, "aggregate_tier tier-1 w, 1-D form",
                          flat, fids, G * P, flay, None, flush)
    del flat, fids, flay
    log(f"(q3) histories: active, agg rounds, H_agg == host replay bit "
        f"for bit (ΣH {h_total}); tier-1 w row sum (m={m}, P={P}, G={G}) "
        f"== plain version on the CPU bit for bit and == its 1-D form "
        f"through the generic kernel; L=1 tree == flat scan on the card; "
        f"row kernel {rows['ms']} ms (bound {rows['bound_ms']} ms by "
        f"{rows['bound_by']}; 1-D form {rows['flat_bound_ms']} ms + the "
        f"product's pass {rows['product_pass_ms']} ms), plain "
        f"{rows['plain_ms']} ms, index_add_ {rows['library_ms']} ms, "
        f"layout build {rows['layout_ms']} ms; 1-D form through the "
        f"generic kernel {one_d['ms']} ms (E={one_d['shape']['E']}, "
        f"layout build {one_d['layout_ms']} ms) [{card}]")
    return [rows, one_d]


def phase_q_small(np, card, cuda, clock):
    """(q4) the flat-stream scan and tiered engines at n=2048, T=20, on
    the card against the CPU."""
    from repro_torch.core import federated as F
    from repro_torch.core import hierarchy as hr
    from repro_torch.core import movement as mv
    from repro_torch.core import topology as topo
    from repro_torch.core.costs import synthetic_edge_costs
    from repro_torch.data import pipeline as pl
    from repro_torch.launch import tables as tb

    n, T = SMALL_SCALE_N, SMALL_SCALE_T
    data, _ = tb._scale_data()
    src, dst = topo.random_sparse_edges(n, 8, np.random.default_rng(2))
    sched = topo.churn_schedule_edges(n, src, dst, T, 0.05, 0.2,
                                      np.random.default_rng(7), tau=5)
    etr = synthetic_edge_costs(n, T, src, dst, np.random.default_rng(1))
    plan = mv.realize_plan(mv.greedy_linear(etr, sched), sched)
    flat = pl.poisson_streams_flat(n, T, data[1],
                                   rng=np.random.default_rng(3),
                                   mean_per_round=2.0)
    cfg = F.FedConfig(n=n, T=T, tau=5, eta=0.1, model="linear", seed=0)
    tree = hr.TierTree.balanced(n, (20, 2, 1), (5, 10, 20))
    for label, hierarchy in (("flat scan", None), ("tiered", tree)):
        runs = [clock.call(f"q4 {label} {name}", F.run_network_aware, cfg,
                           data, etr, None, plan, streams=flat,
                           schedule=sched, hierarchy=hierarchy, device=dev)
                for name, dev in (("card", cuda), ("CPU", "cpu"))]
        # flat streams give processed_counts as (n,) count arrays
        dmax, amax = _compare_histories(np, *(
            {"history": {**h, "processed_counts": np.stack(
                h["processed_counts"]).tolist()}, "cost": None}
            for h in runs))
        if hierarchy is not None:
            for k in ("tier_agg_round", "tier_agg_level"):
                if runs[0][k] != runs[1][k]:
                    raise AssertionError(f"{k} differs")
        log(f"(q4) {label} n={n} T={T} on flat streams, card vs CPU: "
            f"agg_round, H_agg, active, processed_counts equal; max "
            f"|device_loss diff| {dmax}, max |test_acc diff| {amax} "
            f"[{card}]")



# (r) the sweep engine: the fog-scale main path's flags, six seeds in
# one bucket
SWEEP_SEEDS = 6
SWEEP_SCALE = dict(n_train=60000, n_test=10000, T=20, tau=5, eta=0.1)
SWEEP_POINT = dict(n=1000, model="mlp", topology="random", rho=0.1)
WARP_WALK = 2048          # kernel 2's warp walk of wide segments (ROADMAP q. 2)


def _hist_diff(np, got, want):
    """Hold two histories as (b) does: the exact fields equal, losses
    within rtol 2e-3 / atol 1e-4, accuracy within atol 1e-2. Returns the
    largest |difference| of device_loss, test_loss and test_acc."""
    if got["agg_round"] != want["agg_round"]:
        raise AssertionError("agg_round differs")
    for k in ("agg_survivors", "agg_quorum_ok"):
        if got.get(k) != want.get(k):
            raise AssertionError(f"{k} differs")
    if not np.array_equal(np.stack(got["H_agg"]), np.stack(want["H_agg"])):
        raise AssertionError("H_agg differs")
    dl = (np.stack(got["device_loss"]), np.stack(want["device_loss"]))
    np.testing.assert_allclose(*dl, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"], atol=1e-2)
    return (float(np.abs(dl[0] - dl[1]).max()),
            float(np.max(np.abs(np.subtract(got["test_loss"],
                                             want["test_loss"])))),
            float(np.max(np.abs(np.subtract(got["test_acc"],
                                            want["test_acc"])))))


def _finite(np, h):
    return bool(np.isfinite(np.stack(h["device_loss"])).all()
                and np.isfinite(h["test_loss"]).all()
                and np.isfinite(np.stack(h["H_agg"])).all())


def phase_r_tables(np, card, cuda, clock):
    """(r1) launch.tables' scenario_batched at --quick on the card; then
    its fig5 grid bucket by bucket through the card's dispatch, once on
    the card and once on the CPU, held to each other."""
    import copy

    from repro_torch.core import federated as F
    from repro_torch.launch import tables as tb

    out = tb.scenario_batched(tb.QUICK, cuda)
    for r in out["rows"]:
        disp = [(d["path"], d["staging"], d["reason"])
                for d in r["dispatch_cold"]]
        log(f"(r1) scenario_batched {r['grid']}: {r['points']} points, "
            f"{r['buckets']} buckets, dispatch (cold) {disp}, warm "
            f"{[(d['path'], d['staging']) for d in r['dispatch_warm']]}; "
            f"dispatched {r['dispatched_cold_s']:.3f} s cold, "
            f"{r['dispatched_warm_s']:.3f} s warm, loop "
            f"{r['loop_cold_s']:.3f} / {r['loop_warm_s']:.3f} s, speedup "
            f"{r['speedup_cold']:.3f} cold, {r['speedup_warm']:.3f} warm; "
            f"bucket programs {r['dispatched_train_programs']}; warm phases "
            f"{r['warm_phases']}; acc gap to the loop {r['acc_curve_gap']}; "
            f"in-bucket == alone bitwise: dense "
            f"{r['staged_histories_bitwise']} (largest |diff| "
            f"{r['staged_max_diff']}), ragged {r['ragged_alone_bitwise']} "
            f"({r['ragged_alone_max_diff']}) [{card}]")
    hd = out["headline"]
    if not hd["train_programs_leq_buckets"] or hd["max_acc_curve_gap"] > 1e-2:
        raise AssertionError(f"scenario_batched headline {hd}")
    scenarios = tb.scenario_grid(tb.QUICK, "fig5")
    plans = tb.solve_scenario_plans(scenarios, device="cpu")
    rows = tb.run_scenarios(scenarios, tb.QUICK, plans=plans, device=cuda)
    data = tb.dataset(tb.QUICK.n_train, tb.QUICK.n_test)
    worst = [0.0, 0.0, 0.0]
    for idxs in tb._buckets(scenarios):
        d = rows[idxs[0]]["dispatch"]
        runs = []
        for name, dev in (("card", cuda), ("CPU", "cpu")):
            with clock.span(f"r1 fig5 {name}"):
                if d["path"] == "batched":
                    runs.append(F.run_network_aware_batched(
                        [scenarios[b].cfg for b in idxs], data,
                        [plans[b] for b in idxs],
                        streams=[copy.deepcopy(scenarios[b].streams)
                                 for b in idxs], staging=d["staging"],
                        device=dev))
                else:
                    runs.append([F.run_network_aware(
                        scenarios[b].cfg, data, None, None, plans[b],
                        streams=copy.deepcopy(scenarios[b].streams),
                        engine="scan", device=dev) for b in idxs])
        for got, want in zip(*runs):
            worst = [max(a, b) for a, b in zip(worst,
                                               _hist_diff(np, got, want))]
        log(f"(r1) fig5 bucket n={scenarios[idxs[0]].cfg.n} "
            f"({len(idxs)} seeds) dispatched {d['path']} {d['staging']} "
            f"({d['reason']}, predicted {d['predicted_s']}): card vs CPU "
            f"exact fields equal [{card}]")
    log(f"(r1) fig5 card vs CPU: agg_round, H_agg equal; max |diff| "
        f"device_loss {worst[0]}, test_loss {worst[1]}, test_acc "
        f"{worst[2]} [{card}]")


def _keep_rows_by_segments(ops, keep, wanted):
    """A stand-in for ``ops.segment_sum_rows`` that keeps, for each
    segment count G in ``wanted``, the inputs of one call of its largest
    leaf: the ``wanted[G]``-th such call (0 is the first)."""
    real = ops.segment_sum_rows

    def kept(data, segment_ids, *, num_segments, scale=None, layout=None):
        G = num_segments
        if G in wanted:
            k = keep.setdefault(G, {"numel": -1})
            if data.numel() > k["numel"]:       # a larger leaf: count anew
                k.clear()
                k.update(numel=data.numel(), seen=0)
            if data.numel() == k["numel"]:
                if k["seen"] == wanted[G]:
                    k.update(data=data, ids=segment_ids, G=G, scale=scale,
                             layout=layout)
                k["seen"] += 1
        return real(data, segment_ids, num_segments=G, scale=scale,
                    layout=layout)

    return kept


def phase_r_full_width(torch, np, card, counters, ops, sr, cuda):
    """(r2) six seeds of the fog-scale main path in one bucket, dense and
    ragged, counted, held to the scan and to themselves alone; returns
    the two new kernel-2 sites' inputs for (r3)."""
    import dataclasses

    from repro_torch.core import costmodel as cm
    from repro_torch.core import engine as eng
    from repro_torch.core import federated as F
    from repro_torch.data import pipeline as pl
    from repro_torch.launch import tables as tb
    from repro_torch.models import mnist as mm

    scale = tb.BenchScale(**SWEEP_SCALE)
    tau = scale.tau
    scenarios = [tb.make_scenario(scale, key={"seed": s},
                                  error_model="discard", seed=s,
                                  **SWEEP_POINT)
                 for s in range(SWEEP_SEEDS)]
    t = time.perf_counter()
    plans = tb.solve_scenario_plans(scenarios, device=cuda)
    plan_s = time.perf_counter() - t
    data = tb.dataset(scale.n_train, scale.n_test)
    t = time.perf_counter()
    prepared = [F._prepare_streams(sc.cfg, data, plans[b], sc.streams,
                                   sc.activity, sc.schedule)
                for b, sc in enumerate(scenarios)]
    prep_s = time.perf_counter() - t
    cfgs = [sc.cfg for sc in scenarios]
    dims = tb._group_dims(prepared, tau, "pow2")
    decision = cm.MODEL.choose(
        key=tb.scenario_bucket_key(scenarios[0]),
        idents=[tb._point_ident(sc) for sc in scenarios],
        eval_slots=sum(T // tau for T, _, _ in dims["points"])
        * scale.n_test, **dims)
    S, T_b, n_b, P_b = SWEEP_SEEDS, dims["T_b"], dims["n_b"], dims["P_b"]
    M, n_win = S * n_b, T_b // tau
    L = len(mm.mlp_specs())
    # eq. (4): one row sum a leaf and one H total a window; ragged: also
    # a row sum a leaf (the gradient) and one (the losses) a round
    expected = {"dense": n_win * (L + 1),
                "ragged": n_win * (L + 1) + T_b * (L + 1)}
    # the ragged rows of each round (the engine stages the same table):
    # (r3) times the gradient sum of the round with the most real rows
    ragged = pl.stage_scenario_ragged([p[1] for p in prepared], data[1],
                                      [p[2] for p in prepared], tau)
    real_rows_t = (ragged.cell < M).sum(1)
    busiest = int(real_rows_t.argmax())
    keep: dict = {}
    real_rows = ops.segment_sum_rows
    runs = {}
    for staging in ("dense", "ragged"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng.reset_phase_timings()
        for c in counters.values():
            c.reset_launches()
        ops.segment_sum_rows = _keep_rows_by_segments(
            ops, keep, {S: 0, M: busiest})
        try:
            t = time.perf_counter()
            hs = F.run_network_aware_batched(cfgs, data, plans,
                                             prepared=prepared,
                                             staging=staging, device=cuda)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = {name: c.launches for name, c in counters.items()}
        finally:
            ops.segment_sum_rows = real_rows
        peak = torch.cuda.max_memory_allocated()
        runs[staging] = hs
        log(f"(r2) {staging} bucket of {S} fog-scale seeds (S·n_b = {M}, "
            f"T_b {T_b}, P_b {P_b}): wall {wall:.3f} s, phases "
            f"{eng.phase_timings()}, max_memory_allocated {peak} B, kernel "
            f"launches {launches}, kernel-2 launches expected "
            f"{expected[staging]} [{card}]")
        if launches["segment_reduce"] != expected[staging] or any(
                v for k, v in launches.items() if k != "segment_reduce"):
            raise AssertionError(f"{staging}: launches {launches}, kernel 2 "
                                 f"expected {expected[staging]}")
        if not all(_finite(np, h) for h in hs):
            raise AssertionError(f"{staging} bucket history is not finite")
        runs[staging + "_s"] = wall
    # the six points one by one on the scan engine
    torch.cuda.synchronize()
    t = time.perf_counter()
    scans = [F.run_network_aware(cfg, data, None, None, plans[b],
                                 prepared=prepared[b], engine="scan",
                                 device=cuda)
             for b, cfg in enumerate(cfgs)]
    scan_s = time.perf_counter() - t
    worst = {}
    for staging in ("dense", "ragged"):
        diffs = [_hist_diff(np, h, w) for h, w in zip(runs[staging], scans)]
        worst[staging] = [max(d[i] for d in diffs) for i in range(3)]
    # each point alone at the bucket's staging (dense: P pinned to P_b)
    alone = {"dense": [], "ragged": []}
    for b, cfg in enumerate(cfgs):
        st, proc, act, _ = prepared[b]
        alone["dense"].append(F.run_network_aware(
            dataclasses.replace(cfg, max_points=P_b), data, None, None,
            plans[b], prepared=(st, proc, act, P_b), engine="batched",
            device=cuda))
        alone["ragged"].append(F.run_network_aware_batched(
            [cfg], data, [plans[b]], prepared=[prepared[b]],
            staging="ragged", device=cuda)[0])
    same = {}
    for staging in ("dense", "ragged"):
        same[staging] = [tb._histories_equal(a, h) for a, h in
                         zip(alone[staging], runs[staging])]
        diffs = [_hist_diff(np, h, a) for h, a in zip(runs[staging],
                                                      alone[staging])]
        log(f"(r2) {staging}: in bucket vs alone bitwise per seed "
            f"{same[staging]}; max |diff| (device_loss, test_loss, "
            f"test_acc) {[max(d[i] for d in diffs) for i in range(3)]}; vs "
            f"the scan engine {worst[staging]} [{card}]")
    per_dev = max(int(np.bincount(c[c < M], minlength=M).max())
                  for c in ragged.cell)
    log(f"(r2) sweep {runs['dense_s']:.3f} s dense, {runs['ragged_s']:.3f} "
        f"s ragged, against the six scan runs {scan_s:.3f} s (plans "
        f"{plan_s:.3f} s, host stream preparation {prep_s:.3f} s, both "
        f"outside); cost model: {decision.as_row()}; ragged rows R_b "
        f"{ragged.dims[3]} (real {ragged.total_rows} over {T_b} rounds, "
        f"{int(real_rows_t[busiest])} in round {busiest}), "
        f"longest gradient segment {per_dev} rows, aggregation segments "
        f"{n_b} rows, against the warp walk's {WARP_WALK} [{card}]")
    accs = [h["test_acc"][-1] for h in runs["dense"]]
    log(f"(r2) final accuracy per seed (dense) {accs} [{card}]")
    return {"agg": keep[S], "grad": keep[M],
            "launches": {"dense": expected["dense"],
                         "ragged": expected["ragged"]}}


def phase_r_kernel(torch, np, card, sr, cuda, sites):
    """(r3) kernel 2 at the two shapes (r2) gave it, bitwise its plain
    version on the CPU, timed beside its bound, ``index_add_`` and the
    plain version; and the gradient through the kernel against the
    gradient through the plain version on the card."""
    flush = flush_buffer(torch, cuda)
    out = []
    for key, name, launches in (
            ("agg", "eq. (4) bucket rows (S·n_b, P) -> S",
             sites["launches"]["dense"]),
            ("grad", "ragged gradient rows (R_b, P) -> S·n_b",
             sites["launches"]["ragged"])):
        k = sites[key]
        d, ids, G, h, lay = (k[x] for x in ("data", "ids", "G", "scale",
                                            "layout"))
        got = sr.segment_sum_rows(d, ids, G, scale=h, layout=lay).cpu()
        plain = sr.segment_sum_rows_plain(
            d.cpu(), ids.cpu(), G, scale=None if h is None else h.cpu())
        if not _same_bits(np, got.numpy(), plain.numpy()):
            raise AssertionError(f"{name}: kernel != plain on the CPU")
        del got, plain
        site = _row_site(torch, sr, name, d, ids, G, h, lay, launches,
                         flush)
        site["max_abs_err"] = 0.0
        log(f"(r3) {name} {site['shape']}: kernel {site['ms']} ms (bound "
            f"{site['bound_ms']} ms by {site['bound_by']}), plain "
            f"{site['plain_ms']} ms, index_add_ {site['library_ms']} ms, "
            f"layout build {site['layout_ms']} ms; bitwise the CPU's "
            f"sequential row sum; launches in its run {launches} [{card}]")
        out.append(site)
    k = sites["agg"]
    m = min(1024, k["data"].shape[0])
    d0, ids0, h0, G = (k["data"][:m], k["ids"][:m].contiguous(),
                       k["scale"][:m].contiguous(), k["G"])
    cot = torch.randn((G, d0.shape[1]),
                      generator=torch.Generator().manual_seed(0)).to(cuda)
    grads = []
    for fn in (sr.segment_sum_rows, sr.segment_sum_rows_plain):
        d = d0.detach().clone().requires_grad_(True)
        s = h0.detach().clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(d, ids0, G, scale=s), (d, s),
                                         cot))
    if not all(torch.equal(a, b) for a, b in zip(*grads)):
        raise AssertionError("gradient through the row kernel != through "
                             "its plain version")
    log(f"(r3) gradients of segment_sum_rows (data and scale) on {m} rows "
        f"of the eq. (4) leaf: through the kernel == through the plain "
        f"version, bit for bit [{card}]")
    return out


# ---------------------------------------------------------------------------
# (s) model-zoo training: gradients through kernels 3 and 4, zamba2-7b at
# full width, the smoke configs and the --mode lm CLI
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 18        # zamba2-7b cut in depth only: two hybrid groups
TRAIN_B, TRAIN_S = 2, 2048
TRAIN_LR = 3e-3          # the CLI's --lr, AdamW (its --optimizer)
TRAIN_TIMED = 3
TRAIN_LOSS_RTOL = 1e-4   # kernels against plain versions, one step
TRAIN_NORM_RTOL = 1e-3
TRAIN_MIN_COS = 0.9999
LM_ARCHS = ("qwen3-14b", "mamba2-1.3b", "zamba2-7b", "olmoe-1b-7b",
            "mixtral-8x7b", "whisper-large-v3", "phi-3-vision-4.2b")
LM_ARGV = ["--mode", "lm", "--steps", "5"]   # the rest at the CLI defaults
LM_RTOL = 1e-4
LM_SGD = ["--optimizer", "sgd", "--lr", "0.01"]
# (B, H, KH, Sq, Sk, hd, causal, window, dtype): (i)'s shape classes
GRAD_ATTN = [
    (1, 4, 4, 256, 256, 64, True, None, "float32"),      # MHA
    (2, 4, 2, 200, 200, 112, True, None, "float32"),     # GQA 2:1
    (1, 8, 1, 128, 160, 128, False, None, "float32"),    # MQA
    (1, 4, 2, 300, 300, 112, True, 128, "float32"),      # window
    (1, 2, 2, 200, 64, 100, False, 32, "float32"),       # rows 95.. blind
    (1, 4, 2, 256, 256, 64, True, 32, "bfloat16"),
    (2, 2, 1, 128, 40, 112, False, 16, "bfloat16"),      # rows 55.. blind
]
# (B, Hp, H, KH, Sq, Sk, hd, causal, window, dtype): ZOO_ATTN's classes
GRAD_ZOO = [
    (1, 32, 20, 20, 96, 300, 64, False, None, "float32"),  # cross, 32->20
    (1, 32, 20, 20, 200, 200, 64, False, None, "float32"),
    (1, 32, 32, 8, 256, 256, 128, True, 64, "float32"),    # GQA 4:1 window
    (1, 32, 20, 20, 96, 300, 64, False, None, "bfloat16"),
]
# (B, H, S, P, N, chunk)
GRAD_SSD = [(2, 8, 256, 64, 64, 128), (1, 3, 192, 32, 128, 64)]


def _blind_rows(Sq, Sk, causal, window):
    """Query rows that no key can see."""
    rows = []
    for i in range(Sq):
        hi = min(i, Sk - 1) if causal else Sk - 1
        lo = max(i - window + 1, 0) if window else 0
        if hi < lo:
            rows.append(i)
    return rows


def phase_s_grads(torch, fa, sd, cuda, card):
    """(s1) Gradients through the attention and scan Functions (the
    kernel forward, the plain version recomputed backward) against
    autograd through the plain versions alone, on the card, for a fixed
    cotangent: bitwise, finite, zero on rows that see no key, one launch
    a call and none from the backward."""
    checked = 0
    cases = [(B, H, H, *rest) for B, H, *rest in GRAD_ATTN] + GRAD_ZOO
    for case in cases:
        B, H, H_real, KH, Sq, Sk, hd, causal, window, dt = case
        dtype = getattr(torch, dt)
        seed = 100 + checked
        q = _randn(torch, (B, H, Sq, hd), seed, cuda).to(dtype)
        k = _randn(torch, (B, KH, Sk, hd), seed + 1, cuda).to(dtype)
        v = _randn(torch, (B, KH, Sk, hd), seed + 2, cuda).to(dtype)
        g = _randn(torch, (B, H, Sq, hd), seed + 3, cuda).to(dtype)
        km = padded_head_map(torch, H, H_real, KH, cuda)
        a1 = [t.clone().requires_grad_() for t in (q, k, v)]
        a2 = [t.clone().requires_grad_() for t in (q, k, v)]
        before = fa.launches
        got = torch.autograd.grad(
            fa.flash_attention(*a1, km, causal=causal, window=window), a1, g)
        launched = fa.launches - before
        want = torch.autograd.grad(
            fa.flash_attention_plain(*a2, km, causal=causal, window=window),
            a2, g)
        torch.cuda.synchronize()
        blind = _blind_rows(Sq, Sk, causal, window)
        ok = (launched == 1
              and all(torch.equal(x, y) for x, y in zip(got, want))
              and all(bool(torch.isfinite(x).all()) and x.dtype == dtype
                      for x in got)
              and (not blind or not bool(got[0][:, :, blind].any())))
        if not ok:
            raise AssertionError(f"(s1) attention {case}: gradients through "
                                 f"the kernel differ from plain autograd, "
                                 f"are not finite, or launched {launched}")
        checked += 1
    for case in GRAD_SSD:
        B, H, S, P, N, chunk = case
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            seed = 200 + checked
            ins = [_randn(torch, (B, H, S, P), seed, cuda, 0.3).to(dtype),
                   -_randn(torch, (B, H, S), seed + 1, cuda, 0.3).abs(),
                   _randn(torch, (B, S, N), seed + 2, cuda, 0.3).to(dtype),
                   _randn(torch, (B, S, N), seed + 3, cuda, 0.3).to(dtype)]
            g = _randn(torch, (B, H, S, P), seed + 4, cuda)
            a1 = [t.clone().requires_grad_() for t in ins]
            a2 = [t.clone().requires_grad_() for t in ins]
            before = sd.launches
            got = torch.autograd.grad(sd.ssd_scan(*a1, chunk=chunk), a1, g)
            launched = sd.launches - before
            want = torch.autograd.grad(sd.ssd_scan_plain(*a2, chunk=chunk),
                                       a2, g)
            torch.cuda.synchronize()
            ok = (launched == 1
                  and all(torch.equal(x, y) for x, y in zip(got, want))
                  and all(bool(torch.isfinite(x).all()) and x.dtype == t.dtype
                          for x, t in zip(got, ins)))
            if not ok:
                raise AssertionError(f"(s1) ssd_scan {case} {dt}: gradients "
                                     "through the kernels differ from plain "
                                     f"autograd, or launched {launched}")
            checked += 1
    log(f"(s1) gradients through flash_attention ({len(cases)} cases: "
        f"MHA, GQA 2:1 and 4:1, MQA, causal, windows, rows with no key, "
        f"Sq != Sk non-causal, 32 q heads padded onto 20, hd 64 to 128, "
        f"f32 and bf16) and ssd_scan ({2 * len(GRAD_SSD)} cases, f32 and bf16) equal "
        f"plain autograd on the card bit for bit, finite, blind rows 0, "
        f"one launch a call and none from the backward [{card}]")


def _lm_modules():
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params, param_count
    from repro_torch.optim import optimizers as topt
    return (get_config, make_token_dataset, steps, train, T, init_params,
            param_count, topt)


def _split_step(torch, St, T, topt, cfg, opt, params, state, batch):
    """One train step as ``make_train_step`` takes it (microbatches 1),
    its forward, backward and optimizer (divide, clip, the update applied
    in place) timed by CUDA events. Returns the ms of each part."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    b = St.route_batch(batch)
    ev[0].record()
    p = topt.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = T.loss_fn(p, b, cfg)
    wsum = torch.clamp(b["weights"].sum(), min=1.0)
    ev[1].record()
    grads = topt.tree_unflatten(p, torch.autograd.grad(
        loss * wsum, topt.tree_leaves(p)))
    ev[2].record()
    del p, loss
    grads = topt.tree_map(lambda g: g / wsum, grads)
    grads, _ = topt.clip_by_global_norm(grads, 1.0)
    leaves = topt.tree_leaves(grads)
    del grads
    params, state = St.apply_in_place(opt, leaves, state, params)
    ev[3].record()
    torch.cuda.synchronize()
    return params, state, {name: ev[i].elapsed_time(ev[i + 1]) for i, name
                           in enumerate(("forward", "backward", "optimizer"))}


def _recompute_ms(torch, fa, sd, first, flush):
    """The backward of each Function on the first inputs the step gave
    it: the plain version recomputed under autograd, by CUDA events."""
    out = {}
    (q, k, v), kw = first["attention"]
    qa = [t.detach().requires_grad_() for t in (q, k, v)]
    gq = torch.ones_like(q)

    def attn():
        y = fa.flash_attention_plain(*qa, kw["kv_map"], causal=kw.get(
            "causal", True), window=kw.get("window"))
        torch.autograd.grad(y, qa, gq)

    out["attention"] = _time_ms(torch, attn, (), flush, reps=5)
    args, kw = first["ssd"]
    sa = [t.detach().requires_grad_() for t in args]
    gy = torch.ones(args[0].shape, dtype=torch.float32, device=args[0].device)

    def ssd():
        torch.autograd.grad(sd.ssd_scan_plain(*sa, chunk=kw.get(
            "chunk", 128)), sa, gy)

    out["ssd"] = _time_ms(torch, ssd, (), flush, reps=5)
    return out


def _profile_step(torch, step, params, state, batch, top=10):
    """One train step under torch.profiler: the top CUDA kernels by
    device time, the device time of the two Functions' backward nodes
    (the plain recomputes), and the device's busy time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + \
                e.device_time_total / 1e3
    nodes = {}
    for e in prof.key_averages():
        for name in ("_FlashAttentionBackward", "_SSDScanBackward"):
            if e.key.endswith(name) and "evaluate_function" in e.key:
                nodes[name] = e.device_time_total / 1e3
    busy = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return params, state, {"wall_ms": wall_ms, "busy_ms": busy,
                           "top": [(n[:60], round(ms, 3)) for n, ms in ranked],
                           "backward_nodes_ms": nodes}


def phase_s_train(torch, np, card, counters, ops, fa, sd, cuda, clock):
    """(s2) zamba2-7b training at full width, cut to 18 layers: AdamW at
    the CLI's lr, make_train_step on B x S token batches with the plan's
    weights and route; launch counts a step, finite metrics, the time
    split, the profile, the recomputes' share, and one step's gradients
    through the kernels against the plain versions. B = 2 unless the
    card's memory refuses it, then B = 1 (logged with the reason)."""
    import gc

    for B in (TRAIN_B, TRAIN_B // 2):
        try:
            return _train_full_width(torch, np, card, counters, ops, fa, sd,
                                     cuda, B, clock)
        except torch.cuda.OutOfMemoryError as e:
            if B == 1:
                raise
            log(f"(s2) B={B} x S={TRAIN_S} does not fit on the card: "
                f"{str(e).splitlines()[0]}; halving B [{card}]")
        gc.collect()
        torch.cuda.empty_cache()


def _train_full_width(torch, np, card, counters, ops, fa, sd, cuda, B,
                      clock):
    (get_config, make_token_dataset, St, train, T, init_params,
     param_count, topt) = _lm_modules()
    torch.cuda.empty_cache()
    cfg = get_config(SERVE_ARCH).with_overrides(num_layers=TRAIN_LAYERS)
    n_params = param_count(T.specs(cfg))
    t0 = time.perf_counter()
    params = init_params(T.specs(cfg), seed=SEED, device=cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_batches = 1 + TRAIN_TIMED + 2
    _, _, routes, weights = train.lm_movement_inputs(
        1, B, n_batches, np.random.default_rng(SEED))
    toks = make_token_dataset(n_batches * B * (TRAIN_S + 1) + 1,
                              cfg.vocab_size, seed=SEED)
    def batch(it):
        return train.lm_batch(toks, it, B, TRAIN_S, weights, routes, cuda,
                              cfg)

    _kernels_against_plain(torch, St, topt, ops, fa, sd, cfg, params,
                           St.route_batch(batch(0)), card, clock)
    opt = topt.adamw(TRAIN_LR)
    state = opt.init(params)
    step = St.make_train_step(cfg, opt)
    want = {"flash_attention": TRAIN_LAYERS // cfg.attn_every,
            "ssd_scan": TRAIN_LAYERS, "offload_greedy": 0,
            "segment_reduce": 0}
    first = {}

    def keep(name, real):
        def call(*args, **kw):
            first.setdefault(name, ([a.detach() for a in args], kw))
            return real(*args, **kw)
        return call

    torch.cuda.reset_peak_memory_stats()
    secs, metrics = [], []
    for it in range(1 + TRAIN_TIMED):
        b = batch(it)
        with _ops_as(ops, {"attention": keep("attention", ops.attention),
                           "ssd": keep("ssd", ops.ssd)}):
            for c in counters.values():
                c.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches = {n: c.launches for n, c in counters.items()}
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if launches != want:
            raise AssertionError(f"(s2) step {it} launched {launches}; "
                                 f"expected {want}")
        if not all(np.isfinite(metrics[-1])):
            raise AssertionError(f"(s2) step {it}: loss, grad_norm "
                                 f"{metrics[-1]}")
    peak = torch.cuda.max_memory_allocated()
    warm = sorted(secs[1:])[len(secs[1:]) // 2]
    params, state, split = _split_step(torch, St, T, topt, cfg, opt, params,
                                       state, batch(1 + TRAIN_TIMED))
    flush = flush_buffer(torch, "cuda")
    recompute = _recompute_ms(torch, fa, sd, first, flush)
    del flush, first
    params, state, prof = _profile_step(torch, step, params, state,
                                        batch(2 + TRAIN_TIMED))
    step_ms = 1e3 * warm
    share = (want["flash_attention"] * recompute["attention"]
             + want["ssd_scan"] * recompute["ssd"]) / step_ms
    nodes = prof["backward_nodes_ms"]
    tps = B * TRAIN_S / warm
    log(f"(s2) {SERVE_ARCH} at full width, {TRAIN_LAYERS} layers "
        f"({n_params} parameters, float32, drawn on the card in "
        f"{init_s:.3f} s), AdamW lr {TRAIN_LR}, B={B} x S={TRAIN_S}: "
        f"steps (host clock after a sync) cold {secs[0]:.4f} s, warm "
        f"{[round(x, 4) for x in secs[1:]]} s (median {warm:.4f} s, "
        f"{tps:.1f} tokens/s), loss / grad_norm {metrics}, "
        f"max_memory_allocated {peak} B, launches a step {want} [{card}]")
    log(f"(s2) split of one step by CUDA events: forward "
        f"{split['forward']:.2f} ms, backward {split['backward']:.2f} ms, "
        f"optimizer {split['optimizer']:.2f} ms; the plain recomputes in "
        f"the backward: attention {recompute['attention']:.3f} ms x "
        f"{want['flash_attention']}, scan {recompute['ssd']:.3f} ms x "
        f"{want['ssd_scan']}, {100 * share:.2f}% of the warm step [{card}]")
    log(f"(s2) profiled step (the profiler's host overhead in its wall "
        f"{prof['wall_ms']:.2f} ms): device busy {prof['busy_ms']:.2f} ms, "
        f"idle share of the warm step {1 - prof['busy_ms'] / step_ms:.4f}; "
        f"backward nodes (device ms, the plain recomputes) {nodes} "
        f"({100 * sum(nodes.values()) / step_ms:.2f}% of the warm step); "
        f"top kernels (ms) {prof['top']} [{card}]")
    del state, params
    torch.cuda.empty_cache()
    return {"attention": want["flash_attention"], "ssd": want["ssd_scan"],
            "B": B, "step_s": warm}


def _grads(torch, St, topt, ops, plain_fns, cfg, params, b, host=False):
    """``steps.grads_of`` (through ``plain_fns`` in place of the kernels
    when given): its leaves, moved to the host with ``host`` (so that the
    float64 tree needs no room on the card), and the loss."""
    ctx = _ops_as(ops, plain_fns) if plain_fns else contextlib.nullcontext()
    with ctx:
        g, m, _ = St.grads_of(params, b, cfg)
    leaves = topt.tree_leaves(g)
    if host:
        leaves = [x.cpu() for x in leaves]
        del g
        torch.cuda.empty_cache()
    return leaves, float(m["ce"])


def _grad_stats(torch, g_k, g_p, g_64):
    """In float64 on the card, leaf by leaf (``g_64``'s leaves copied
    there one at a time): the three global norms, each leaf's cosine of
    ``g_k`` and ``g_p``, and the relative distance ||a - c|| / ||c|| of
    each leaf of ``g_k`` and of ``g_p`` from ``g_64``'s."""
    sums = [0.0, 0.0, 0.0]         # the squares' sums, leaf by leaf
    cos, rel_k, rel_p = [], [], []
    for x, y, z in zip(g_k, g_p, g_64):
        x = x.double().reshape(-1)
        y = y.double().reshape(-1)
        z = z.to(x.device).double().reshape(-1)
        for i, t in enumerate((x, y, z)):
            sums[i] += float(t.square().sum())
        nx, ny, nz = float(x.norm()), float(y.norm()), float(z.norm())
        cos.append(1.0 if nx == ny == 0 else
                   float(x @ y) / max(nx * ny, 1e-300))
        rel_k.append(float((x - z).norm()) / max(nz, 1e-300))
        rel_p.append(float((y - z).norm()) / max(nz, 1e-300))
    return *(t ** 0.5 for t in sums), cos, rel_k, rel_p


def _kernels_against_plain(torch, St, topt, ops, fa, sd, cfg, params, b,
                           card, clock, tag="s2"):
    """The first step's gradients through the plain versions in float64
    (kept on the host), through the kernels and through their plain
    versions. Held:
    the kernels against the plain versions, loss within TRAIN_LOSS_RTOL
    and every leaf's cosine at least TRAIN_MIN_COS; against float64,
    every leaf of the kernels' gradient no further than twice the plain
    float32 gradient's farthest leaf, and the global norm within
    TRAIN_NORM_RTOL or within that distance, whichever is larger (at
    full width the plain float32 leaves lie up to ~1e-2 from float64:
    18 layers amplify float32 rounding)."""
    plain = _plain_ops(torch, fa, sd)
    # the plain versions keep (B, H, S, S) scores and (l, l) decay
    # matrices for their backward: recompute each block (remat "full",
    # the same arithmetic, bit for bit on the card)
    remat = cfg.with_overrides(remat="full")
    with clock.span(f"{tag} gradients in float64"):
        p64 = topt.tree_map(lambda t: t.double(), params)
        g_64, loss_64 = _grads(torch, St, topt, ops, plain, remat, p64, b,
                               host=True)
        del p64
        torch.cuda.empty_cache()
    with clock.span(f"{tag} gradients through the kernels"):
        g_k, loss_k = _grads(torch, St, topt, ops, None, cfg, params, b)
    with clock.span(f"{tag} gradients through the plain versions"):
        g_p, loss_p = _grads(torch, St, topt, ops, plain, remat, params, b)
    with clock.span(f"{tag} gradient stats"):
        gn_k, gn_p, gn_64, cos, rel_k, rel_p = _grad_stats(torch, g_k, g_p,
                                                           g_64)
    del g_k, g_p, g_64
    torch.cuda.empty_cache()
    norm_tol = max(TRAIN_NORM_RTOL, 2 * max(rel_p))
    log(f"({tag}) the first step's gradients, kernels / plain / plain in "
        f"float64: loss {loss_k} / {loss_p} / {loss_64}, global norm "
        f"{gn_k} / {gn_p} / {gn_64}; kernels against plain: least per-leaf "
        f"cosine {min(cos)} over {len(cos)} leaves; farthest leaf from "
        f"float64 (relative L2): kernels {max(rel_k)}, plain {max(rel_p)}; "
        f"the norm held to {norm_tol} of float64's [{card}]")
    if not (abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p)
            and min(cos) >= TRAIN_MIN_COS
            and max(rel_k) <= 2 * max(rel_p)
            and abs(gn_k - gn_64) <= norm_tol * gn_64):
        raise AssertionError(f"({tag}) the step through the kernels and "
                             "the step through the plain versions disagree")


def _drawn_on_cpu(specs, seed, _dtype, device):
    """(s3)'s ``init_params``: float32 parameters drawn on the CPU, then
    moved to ``device``, so the card and the CPU start from the same."""
    import torch

    from repro_torch.models.module import init_params
    from repro_torch.optim.optimizers import tree_map

    p = init_params(specs, seed, torch.float32, "cpu")
    return tree_map(lambda t: t.to(device), p)


def _lm_main(argv):
    """``train.main(argv)`` with its parameters from :func:`_drawn_on_cpu`,
    its output kept off stdout."""
    import io

    from repro_torch.launch import train

    real = train.init_params
    train.init_params = _drawn_on_cpu
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return train.main(argv)
    finally:
        train.init_params = real


LM_RUNS = [(a, x) for a in LM_ARCHS for x in ([], LM_SGD)] + \
    [("zamba2-7b", ["--lm-tau", "2"] + x) for x in ([], LM_SGD)]


def start_s(jobs):
    """(s3)'s CPU sides: each --mode lm run of LM_RUNS."""
    for arch, extra in LM_RUNS:
        jobs.start(f"s3 {' '.join([arch] + extra)} CPU", _lm_main,
                   LM_ARGV + ["--arch", arch] + extra + ["--device", "cpu"])


def phase_s_cli(np, card, counters, jobs, clock):
    """(s3) --mode lm for the smoke configs of LM_ARCHS and --lm-tau 2, on
    the card, each against its CPU side (:func:`start_s`) from the same
    parameters (drawn on the CPU).
    With LM_SGD every step's loss within LM_RTOL; at
    the CLI's defaults (AdamW) the first step's loss within LM_RTOL and
    every loss finite. The hybrid smoke config's trajectory is chaotic
    under AdamW at lr 3e-3 and under SGD at lr 0.05: on the CPU alone, a
    1e-7 relative move of the initial parameters moves its 3rd-5th
    losses by 1e-4 to 1.6e-3 (AdamW's first update is about ±lr on
    every weight whatever its gradient's size, so a rounding difference
    that flips a near-zero gradient's sign is a whole step). SGD at lr
    0.01 moves them by < 5e-7. Launch counts exact, moved_frac equal."""
    from repro_torch.launch import train

    for arch, extra in LM_RUNS:
        argv = LM_ARGV + ["--arch", arch] + extra
        for c in counters.values():
            c.reset_launches()
        tag = " ".join([arch] + extra)
        on_card = clock.call(f"s3 {tag} card", _lm_main, argv)
        launches = {n: c.launches for n, c in counters.items()}
        on_cpu = jobs.collect(f"s3 {tag} CPU")
        a, b = np.array(on_card["losses"]), np.array(on_cpu["losses"])
        rel = np.abs(a - b) / np.abs(b)
        held = rel if "sgd" in extra else rel[:1]
        log(f"(s3) --mode lm --arch {arch} {' '.join(extra)}: losses card "
            f"{on_card['losses']}, CPU {on_cpu['losses']}, relative "
            f"difference {rel.tolist()} (held at {LM_RTOL}: "
            f"{'every step' if 'sgd' in extra else 'the first step'}), "
            f"moved_frac {on_card['moved_frac']} / {on_cpu['moved_frac']}, "
            f"device {on_card['device']}, launches {launches} [{card}]")
        if len(a) != len(b) or not np.isfinite(a).all() \
                or held.max() > LM_RTOL \
                or on_card["moved_frac"] != on_cpu["moved_frac"] \
                or on_card["device"] != "cuda":
            raise AssertionError(f"(s3) {arch} {extra}: card and CPU "
                                 "disagree")
        cfg = train.get_config(arch, smoke=True)
        steps = len(a) * (2 if "--lm-tau" in extra else 1)
        n_attn = attention_launches(cfg)
        n_ssd = cfg.num_layers if cfg.ssm_state else 0
        if (launches["flash_attention"], launches["ssd_scan"]) != \
                (steps * n_attn, steps * n_ssd):
            raise AssertionError(f"(s3) {arch} {extra} launched {launches}")


# ---------------------------------------------------------------------------
# (t) the model zoo's last families at full width: MoE (olmoe, mixtral),
# enc-dec (whisper) and VLM (phi-3-vision)
# ---------------------------------------------------------------------------

OLMOE, MIXTRAL = "olmoe-1b-7b", "mixtral-8x7b"
WHISPER, PHI3V = "whisper-large-v3", "phi-3-vision-4.2b"
OLMOE_B, OLMOE_S = 2, 4096
MIXTRAL_LAYERS = 4       # of 32: the full model, 186.8 GB in float32, does
MIXTRAL_B, MIXTRAL_S = 1, 8192   # not fit one card; 8192 > the 4096 window
PHI3V_B, PHI3V_S = 2, 4096       # 144 patch embeddings + 3952 text tokens
WHISPER_B = 2                    # x max_positions (448) tokens, 1500 frames
MOE_TRAIN_LAYERS = 6
MOE_TRAIN_B, MOE_TRAIN_S = 2, 2048
MOE_ACT_BYTES_PER_LAYER = 2.3e9  # reckoned for B=2 x S=2048 (PERF.md §4)
CLIP_PEAK_BYTES_PER_PARAM = 20   # params, moments and two gradient trees
                                 # (the clip's input and output)
CHECK_LAYERS, CHECK_CF = 2, 8.0  # (t6): no token drops
ROUTE_MARGIN = 1e-5
# the ops whose own device time is the MoE dispatch and combine
DISPATCH_OPS = ("aten::cumsum", "aten::sort", "aten::one_hot",
                "aten::scatter_", "aten::index_put_", "aten::_index_put_impl_",
                "aten::index", "aten::index_select", "aten::gather",
                "aten::repeat_interleave")


def _capture_attention(ops, first):
    """ops.attention, keeping the first call's inputs of each (Sq, Sk,
    causal) class in ``first``."""
    real = ops.attention

    def call(q, k, v, **kw):
        first.setdefault((q.shape[2], k.shape[2], kw.get("causal", True)),
                         ((q.detach(), k.detach(), v.detach()), kw))
        return real(q, k, v, **kw)

    return call


def _device_shares(torch, prof):
    """Device time of a profiled run: the whole, and the shares of the
    expert GEMMs (aten::bmm: the forward's only batched products),
    the MoE dispatch and combine (DISPATCH_OPS) and flash attention."""
    total = attn = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += e.device_time_total
            if "flash" in e.name.lower():
                attn += e.device_time_total
    by_op: dict = {}
    for e in prof.key_averages():
        own = getattr(e, "self_device_time_total", None)
        if own is None:
            own = getattr(e, "self_cuda_time_total", 0.0)
        by_op[e.key] = by_op.get(e.key, 0.0) + own
    gemm = by_op.get("aten::bmm", 0.0)
    disp = sum(by_op.get(k, 0.0) for k in DISPATCH_OPS)
    share = (lambda x: x / total) if total else (lambda x: None)
    return {"device_ms": total / 1e3, "expert_gemm_share": share(gemm),
            "dispatch_combine_share": share(disp),
            "attention_share": share(attn)}


def _prefill_cell(torch, np, card, counters, ops, cuda, tag, cfg, B, S,
                  serve_too=True):
    """One model at full width on the card: params drawn from the seed,
    a prefill of B x S (S counts a VLM's patch prefix) with every launch
    counter set to 0 just before and read just after, warm and profiled
    reruns, then greedy serving at the serve CLI's defaults. Returns the
    cell's numbers and the first attention inputs of each class."""
    _, serve, steps, T, init_params, param_count = _serve_modules()
    torch.cuda.empty_cache()
    n_params = param_count(T.specs(cfg))
    t0 = time.perf_counter()
    params = init_params(T.specs(cfg), seed=SEED, device=cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    S_text = S - cfg.vision_patches
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S_text)).astype(np.int32)).to(cuda),
        **seeded_frontends(torch, np, cfg, B, rng, cuda)}
    prefill = steps.make_prefill_step(cfg)
    first: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with _ops_as(ops, {"attention": _capture_attention(ops, first)}):
        for c in counters.values():
            c.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            last = prefill(params, batch)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    with torch.no_grad():
        prefill(params, batch)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        logits, aux = T.forward(params, batch, cfg)
        torch.cuda.synchronize()
    shares = _device_shares(torch, prof)
    del prof
    finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    shape = tuple(logits.shape)
    same = bool(torch.equal(logits[:, -1], last))
    del logits, last
    want = {"flash_attention": attention_launches(cfg), "ssd_scan": 0,
            "offload_greedy": 0, "segment_reduce": 0}
    cell = {"params": n_params, "init_s": init_s, "cold_s": cold,
            "warm_s": warm, "prefill_tokens_per_s": B * S / warm,
            "peak_bytes": peak, "launches": launches, **shares}
    log(f"({tag}) {cfg.name} ({n_params} parameters, float32, "
        f"{cfg.num_layers} layers{', ' + str(cfg.encoder_layers) + ' encoder layers' if cfg.encoder_layers else ''}; "
        f"drawn on the card in {init_s:.3f} s): prefill B={B} x S={S}: "
        f"cold {cold:.4f} s, warm {warm:.4f} s, "
        f"{cell['prefill_tokens_per_s']:.1f} prefill tokens/s, "
        f"max_memory_allocated {peak} B, logits {shape} finite {finite}, "
        f"aux {float(aux)}, the prefill step's last logits equal the "
        f"forward's {same}, launches {launches}; profiled forward: device "
        f"{shares['device_ms']:.2f} ms, expert GEMMs (aten::bmm) "
        f"{shares['expert_gemm_share']}, dispatch/combine "
        f"{shares['dispatch_combine_share']}, flash attention "
        f"{shares['attention_share']} of it [{card}]")
    if launches != want:
        raise AssertionError(f"({tag}) {cfg.name} prefill launched "
                             f"{launches}; expected {want}")
    if not finite or shape != (B, S_text, cfg.vocab_padded):
        raise AssertionError(f"({tag}) {cfg.name}: logits {shape}, finite "
                             f"{finite}")
    if serve_too:
        prompts = rng.integers(0, cfg.vocab_size,
                               (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
        t0 = time.perf_counter()
        out, tps = serve.greedy_generate(cfg, params, prompts, SERVE_GEN)
        wall = time.perf_counter() - t0
        cell["decode_tokens_per_s"] = tps
        log(f"({tag}) {cfg.name} greedy_generate batch {SERVE_BATCH}, prompt "
            f"{SERVE_PROMPT}, {SERVE_GEN} generated: {tps:.2f} decode "
            f"tokens/s, wall {wall:.3f} s, sample {out[0, -8:].tolist()} "
            f"[{card}]")
        if out.shape != (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN) \
                or not ((out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"({tag}) {cfg.name}: greedy_generate gave "
                                 "tokens of the wrong shape or range")
    del params
    torch.cuda.empty_cache()
    return cell, first


def _sdpa(torch, q, k, v, kv_map, causal, window):
    """scaled_dot_product_attention on k and v expanded to the q heads,
    the window as a boolean mask."""
    idx = kv_map.long().to(q.device)
    kx, vx = k.index_select(1, idx), v.index_select(1, idx)
    mask = None
    if window is not None:
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = (j > i - window) & ((j <= i) if causal else True)
        causal = False
    return torch.nn.functional.scaled_dot_product_attention(
        q, kx, vx, attn_mask=mask, is_causal=causal)


def attention_site(torch, np, fa, name, entry, launches, flush):
    """Kernel 3 on the inputs a main path gave it: against its plain
    version, timed beside it, SDPA and its least time on this card."""
    (q, k, v), kw = entry
    kv_map, causal, window = kw["kv_map"], kw["causal"], kw["window"]
    B, H, Sq, hd = q.shape
    KH, Sk = k.shape[1], k.shape[2]

    def kernel(q, k, v):
        return fa.flash_attention(q, k, v, kv_map, causal=causal,
                                  window=window)

    def plain(q, k, v):
        return fa.flash_attention_plain(q, k, v, kv_map, causal=causal,
                                        window=window)

    def library(q, k, v):
        return _sdpa(torch, q, k, v, kv_map, causal, window)

    got, want = kernel(q, k, v), plain(q, k, v)
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=ATTN_TOL, rtol=ATTN_TOL)
    lib_err = float((library(q, k, v) - want).abs().max())
    del got, want
    pairs = B * H * _kt().visible_pairs(Sq, Sk, causal, window)
    bounds = _bounds(*_kt().attention_work(B, H, KH, Sq, Sk, hd, causal,
                                           window))
    bounds.pop("bound_cuda_cores_ms")
    site = {"name": name, "launches": launches, "max_abs_err": err,
            "ms": _time_ms(torch, kernel, (q, k, v), flush, reps=10),
            "plain_ms": _time_ms(torch, plain, (q, k, v), flush, reps=5),
            **bounds,
            "library_ms": _time_ms(torch, library, (q, k, v), flush,
                                   reps=10),
            "shape": {"B": B, "H": H, "KH": KH, "Sq": Sq, "Sk": Sk, "hd": hd,
                      "causal": causal, "window": window,
                      "visible_pairs": pairs}}
    log(f"(t) flash_attention at {name} {site['shape']}: kernel "
        f"{site['ms']} ms, plain {site['plain_ms']} ms, SDPA (k, v expanded "
        f"to the q heads) {site['library_ms']} ms (its max abs err vs plain "
        f"{lib_err}), least time {site['bound_ms']} ms (bound by "
        f"{site['bound_by']}), max abs err vs plain {err}, launches on its "
        f"path {launches}")
    return site


def _train_cell(torch, np, card, counters, ops, fa, sd, cuda, tag, cfg, B, S,
                check_grads, clock):
    """AdamW at the CLI's lr on B x S token batches routed and weighted by
    lm_movement_inputs (an enc-dec arch's frames seeded): (with
    ``check_grads``) the first step's gradients
    through the kernel against the plain version as (s2) holds them, the
    router's gradient non-zero and the aux finite; then a cold and
    TRAIN_TIMED warm steps with every launch counter set to 0 just before
    each and read just after, the split and a profiled step."""
    (get_config, make_token_dataset, St, train, T, init_params,
     param_count, topt) = _lm_modules()
    torch.cuda.empty_cache()
    n_params = param_count(T.specs(cfg))
    t0 = time.perf_counter()
    params = init_params(T.specs(cfg), seed=SEED, device=cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_batches = 1 + TRAIN_TIMED + 2
    _, _, routes, weights = train.lm_movement_inputs(
        1, B, n_batches, np.random.default_rng(SEED))
    toks = make_token_dataset(n_batches * B * (S + 1) + 1, cfg.vocab_size,
                              seed=SEED)

    # seeded frames: through 32 layernorms of zero frames (the CLI's stub)
    # the encoder's gradient grows by ~1/sqrt(eps) a layer, past float32
    front = seeded_frontends(torch, np, cfg, B, np.random.default_rng(SEED),
                             cuda)

    def batch(it):
        return {**train.lm_batch(toks, it, B, S, weights, routes, cuda, cfg),
                **front}

    if check_grads:
        _kernels_against_plain(torch, St, topt, ops, fa, sd, cfg, params,
                               St.route_batch(batch(0)), card, clock, tag)
        g, m, _ = St.grads_of(params, St.route_batch(batch(0)), cfg)
        router = g["blocks"]["moe"]["router"]
        rnorm, aux = float(router.norm()), float(m["aux"])
        del g
        log(f"({tag}) the first step's router gradient norm {rnorm} (all "
            f"layers), aux {aux} [{card}]")
        if not (np.isfinite(rnorm) and rnorm > 0 and np.isfinite(aux)):
            raise AssertionError(f"({tag}) router gradient {rnorm}, aux {aux}")
    opt = topt.adamw(TRAIN_LR)
    state = opt.init(params)
    step = St.make_train_step(cfg, opt)
    want = {"flash_attention": attention_launches(cfg), "ssd_scan": 0,
            "offload_greedy": 0, "segment_reduce": 0}
    torch.cuda.empty_cache()              # the check's blocks, returned
    torch.cuda.reset_peak_memory_stats()
    secs, metrics = [], []
    for it in range(1 + TRAIN_TIMED):
        b = batch(it)
        for c in counters.values():
            c.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = {n: c.launches for n, c in counters.items()}
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if launches != want:
            raise AssertionError(f"({tag}) step {it} launched {launches}; "
                                 f"expected {want}")
        if not all(np.isfinite(metrics[-1])):
            raise AssertionError(f"({tag}) step {it}: loss, grad_norm "
                                 f"{metrics[-1]}")
    peak = torch.cuda.max_memory_allocated()
    warm = sorted(secs[1:])[len(secs[1:]) // 2]
    params, state, split = _split_step(torch, St, T, topt, cfg, opt, params,
                                       state, batch(1 + TRAIN_TIMED))
    params, state, prof = _profile_step(torch, step, params, state,
                                        batch(2 + TRAIN_TIMED))
    log(f"({tag}) {cfg.name} training ({n_params} parameters, float32, "
        f"{cfg.num_layers} layers, drawn on the card in {init_s:.3f} s), "
        f"AdamW lr {TRAIN_LR}, B={B} x S={S}: steps (host clock after a "
        f"sync) cold {secs[0]:.4f} s, warm {[round(x, 4) for x in secs[1:]]}"
        f" s (median {warm:.4f} s, {B * S / warm:.1f} tokens/s), loss / "
        f"grad_norm {metrics}, max_memory_allocated {peak} B, launches a "
        f"step {want}; split by CUDA events: forward "
        f"{split['forward']:.2f} ms, backward {split['backward']:.2f} ms, "
        f"optimizer {split['optimizer']:.2f} ms; profiled step: device busy "
        f"{prof['busy_ms']:.2f} ms, idle share of the warm step "
        f"{1 - prof['busy_ms'] / (1e3 * warm):.4f}, top kernels (ms) "
        f"{prof['top']} [{card}]")
    del state, params
    torch.cuda.empty_cache()
    return {"step_s": warm, "peak_bytes": peak, "B": B}


def _moe_train_batch(torch, card, cfg):
    """B for (t3), reckoned before the draw: the larger of the backward's
    peak (parameters, gradients and two AdamW moments in float32 plus
    the activations, PERF.md §4) and the clip's (two gradient trees; the
    update is applied in place, a leaf at a time: three temporaries of
    the largest leaf) must fit the card with 5% to spare, else B = 1
    (logged)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.module import leaves, param_count

    n = param_count(T.specs(cfg))
    largest = max(4 * math.prod(s.shape) for _, s in leaves(T.specs(cfg)))
    states = 16 * n
    update = max(CLIP_PEAK_BYTES_PER_PARAM * n, states + 3 * largest)
    total = torch.cuda.get_device_properties(0).total_memory
    for B in (MOE_TRAIN_B, 1):
        need = max(states + cfg.num_layers * MOE_ACT_BYTES_PER_LAYER * B / 2,
                   update)
        if need <= 0.95 * total or B == 1:
            log(f"(t3) reckoned {need / 1e9:.2f} GB for B={B} x S="
                f"{MOE_TRAIN_S} (parameters, gradients and moments "
                f"{states / 1e9:.2f} GB + activations; the clip and the "
                f"in-place update {update / 1e9:.2f} GB) against "
                f"{total / 1e9:.2f} GB on the card: B={B} [{card}]")
            return B


def _routing(torch, rec, L):
    """The recorded (eids, probs) of ``route`` per layer, from a prefill's
    L calls or a decode's L calls a step: (tokens, k) and (tokens, E)."""
    def cat(xs):
        return torch.cat([x.reshape(-1, x.shape[-1]) for x in xs])

    return [(cat([e for e, _ in rec[i::L]]), cat([p for _, p in rec[i::L]]))
            for i in range(L)]


def _route_diffs(torch, got, ref, k):
    """(layer, token, margin) of every token routed to another expert set
    than in ``ref``; the margin is ref's gap between its k-th and
    (k+1)-th probabilities."""
    out = []
    for layer, ((e1, _), (e2, p2)) in enumerate(zip(got, ref)):
        diff = (e1.sort(dim=-1).values != e2.sort(dim=-1).values).any(-1)
        top = p2.double().sort(dim=-1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        for t in diff.nonzero().flatten().tolist():
            out.append((layer, t, float(gap[t])))
    return out


def _check_cell(torch, np, card, ops, fa, sd, cuda, arch):
    """(t6) prefill against teacher-forced decode with no kernel at full
    width, cut to CHECK_LAYERS layers (and encoder layers), B=1 x
    CHECK_S, capacity factor CHECK_CF (no token drops): in float64 within
    DECODE_TOL of max|logit|; the float32 kernel prefill no further from
    float64 than twice the kernel-free float32 paths; routing equal to
    float64's wherever the top-k margin exceeds ROUTE_MARGIN (tokens at
    or after a smaller-margin flip are logged and left out)."""
    from repro_torch.models import moe as M

    _, _, steps, T, init_params, _ = _serve_modules()
    over = {"num_layers": CHECK_LAYERS}
    if arch == WHISPER:
        over["encoder_layers"] = CHECK_LAYERS
    else:
        over["capacity_factor"] = CHECK_CF
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch).with_overrides(**over)
    V, L = cfg.vocab_size, cfg.num_layers
    params = init_params(T.specs(cfg), seed=SEED, device=cuda)
    cut_h = cfg.num_heads * cfg.head_dim
    for name in ("attn", "xattn"):     # decode drops the padded heads
        if name in params["blocks"]:
            params["blocks"][name]["wo"][:, cut_h:] = 0
    rng = np.random.default_rng(SEED + 3)
    toks = torch.from_numpy(rng.integers(0, V, (1, CHECK_S)).astype(
        np.int32)).to(cuda)
    front = seeded_frontends(torch, np, cfg, 1, rng, cuda)
    frames = front.get("frames")
    rec: list = []
    real_route = M.route

    def route(*a, **kw):
        out = real_route(*a, **kw)
        rec.append((out[2].detach(), out[0].detach()))
        return out

    def run(fn):
        rec.clear()
        out = fn()
        return out, _routing(torch, rec, L) if rec else []

    plain = _plain_ops(torch, fa, sd)
    batch = {"tokens": toks, **front}
    M.route = route
    try:
        with torch.no_grad():
            kern32, r_k = run(lambda: T.forward(params, batch, cfg)[0][..., :V])
            with _ops_as(ops, plain):
                plain32, r_p = run(
                    lambda: T.forward(params, batch, cfg)[0][..., :V])
                dec32, r_d = run(lambda: _teacher_forced(
                    torch, T, steps, init_params, cfg, params, toks,
                    torch.float32, frames))
            _to_float64(torch, params)
            b64 = {k: v.double() if v.is_floating_point() else v
                   for k, v in batch.items()}
            with _ops_as(ops, plain):
                ref64, r_64 = run(
                    lambda: T.forward(params, b64, cfg)[0][..., :V])
                dec64, r_d64 = run(lambda: _teacher_forced(
                    torch, T, steps, init_params, cfg, params, toks,
                    torch.float64, b64.get("frames")))
    finally:
        M.route = real_route
    del params
    torch.cuda.empty_cache()
    k = cfg.experts_per_token
    flips = {name: _route_diffs(torch, r, r_64, k) for name, r in
             (("kernel prefill", r_k), ("plain prefill", r_p),
              ("decode", r_d), ("float64 decode", r_d64))} if r_64 else {}
    hard = [(n, f) for n, fs in flips.items() for f in fs
            if f[2] > ROUTE_MARGIN]
    cut = min([f[1] for fs in flips.values() for f in fs] + [CHECK_S])
    top = float(ref64.abs().max())
    tol = DECODE_TOL * top
    d64 = float((dec64 - ref64)[:, :cut].abs().max())
    err = {name: float((x.double() - ref64)[:, :cut].abs().max())
           for name, x in (("kernel prefill", kern32),
                           ("plain prefill", plain32), ("decode", dec32))}
    tol32 = max(tol, 2 * max(err["plain prefill"], err["decode"]))
    log(f"(t6) {arch} at full width, {L} layers"
        f"{' + ' + str(cfg.encoder_layers) + ' encoder layers' if cfg.encoder_layers else ''}"
        f", B=1 x S={CHECK_S}{', capacity factor ' + str(CHECK_CF) if cfg.num_experts else ''}"
        f": float64 prefill vs teacher-forced decode max abs diff {d64} "
        f"(tolerance {tol} = {DECODE_TOL} x max|logit| {top}); float32 max "
        f"abs diff from the float64 prefill {err} (kernel prefill tolerance "
        f"{tol32}); routing differences from float64 (layer, token, top-k "
        f"margin): {flips}; positions compared {cut} [{card}]")
    if hard:
        raise AssertionError(f"(t6) {arch}: routing differs where the "
                             f"margin exceeds {ROUTE_MARGIN}: {hard}")
    if not d64 <= tol:
        raise AssertionError(f"(t6) {arch}: float64 prefill and decode "
                             "logits differ")
    if not err["kernel prefill"] <= tol32:
        raise AssertionError(f"(t6) {arch}: the kernel's float32 prefill is "
                             "further from float64 than float32 rounding "
                             "explains")


def phase_t_train(torch, np, card, counters, ops, fa, sd, cuda, clock):
    """(t3), olmoe's training cell; run before the rest of (t), so that
    the CPU sides' last jobs run beside its card work, not beside the
    host-bound decodes of (t1), (t2) and (t4)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(OLMOE).with_overrides(num_layers=MOE_TRAIN_LAYERS)
    return _train_cell(torch, np, card, counters, ops, fa, sd, cuda, "t3",
                       cfg, _moe_train_batch(torch, card, cfg), MOE_TRAIN_S,
                       check_grads=True, clock=clock)


def phase_t_zoo(torch, np, card, counters, ops, fa, sd, cuda, clock, cells):
    """(t1), (t2), (t4)-(t6) into ``cells``, which holds (t3)'s, then
    kernel 3 at the new shapes. Returns the sites and the cells."""
    from repro_torch.configs.registry import get_config

    flush = flush_buffer(torch, "cuda")
    sites = []

    def time_sites(first, names, launches):
        for key, name in names.items():
            sites.append(attention_site(torch, np, fa, name, first.pop(key),
                                        launches, flush))
        first.clear()
        torch.cuda.empty_cache()

    with clock.span("t1"):
        cells["t1"], first = _prefill_cell(
            torch, np, card, counters, ops, cuda, "t1", get_config(OLMOE),
            OLMOE_B, OLMOE_S)
        time_sites(first, {(OLMOE_S, OLMOE_S, True): "olmoe-1b-7b prefill"},
                   cells["t1"]["launches"]["flash_attention"])
    with clock.span("t2"):
        cfg = get_config(MIXTRAL).with_overrides(num_layers=MIXTRAL_LAYERS)
        cells["t2"], first = _prefill_cell(
            torch, np, card, counters, ops, cuda, "t2", cfg, MIXTRAL_B,
            MIXTRAL_S)
        time_sites(first, {(MIXTRAL_S, MIXTRAL_S, True):
                           "mixtral-8x7b prefill"},
                   cells["t2"]["launches"]["flash_attention"])
    with clock.span("t4"):
        cfg = get_config(WHISPER)
        S_w = cfg.max_positions
        cells["t4"], first = _prefill_cell(
            torch, np, card, counters, ops, cuda, "t4", cfg, WHISPER_B, S_w)
        time_sites(first, {(cfg.encoder_seq, cfg.encoder_seq, False):
                           "whisper-large-v3 encoder",
                           (S_w, cfg.encoder_seq, False):
                           "whisper-large-v3 cross"},
                   cells["t4"]["launches"]["flash_attention"])
        cells["t4_train"] = _train_cell(
            torch, np, card, counters, ops, fa, sd, cuda, "t4", cfg,
            WHISPER_B, S_w, check_grads=False, clock=clock)
    with clock.span("t5"):
        cells["t5"], _ = _prefill_cell(
            torch, np, card, counters, ops, cuda, "t5", get_config(PHI3V),
            PHI3V_B, PHI3V_S, serve_too=False)
    with clock.span("t6"):
        for arch in (OLMOE, WHISPER):
            _check_cell(torch, np, card, ops, fa, sd, cuda, arch)
    log(f"(t) cells {json.dumps(cells, default=float)} [{card}]")
    return sites, cells


# ---------------------------------------------------------------------------
# (u) the distribution layer: the sharded engine and the FedAvg round on
# an NCCL world of one, the roofline beside the measured cells, the dry
# run
# ---------------------------------------------------------------------------

FEDAVG_ARCH, FEDAVG_TAU, FEDAVG_B, FEDAVG_S = "qwen3-14b", 2, 8, 128
DRYRUN_ARGV = ["--arch", "qwen3-14b", "--shape", "train_4k"]
DRYRUN_MOE_ARGV = ["--arch", "olmoe-1b-7b", "--shape", "train_4k",
                   "--moe-groups", "16"]
DRYRUN_DECODE_ARGV = ["--arch", "minitron-4b", "--shape", "decode_32k"]
DRYRUN_SSM_ARGV = ["--arch", "mamba2-1.3b", "--shape", "decode_32k"]


def _fedavg_rounds(torch, np, dist, cuda):
    """(u2) one FedAvg round (the smoke config, τ = 2, AdamW at the
    CLI's lr, batches routed and weighted as ``--mode lm`` makes them)
    with one shard on the card and on the default group; returns both
    (params, state, loss) and the all-reduces of the group's round."""
    (get_config, make_token_dataset, St, train, T, init_params, _,
     topt) = _lm_modules()
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.fedavg import make_fedavg_round

    cfg = get_config(FEDAVG_ARCH, smoke=True)
    _, _, routes, weights = train.lm_movement_inputs(
        1, FEDAVG_B, FEDAVG_TAU, np.random.default_rng(SEED))
    toks = make_token_dataset(FEDAVG_TAU * FEDAVG_B * (FEDAVG_S + 1) + 1,
                              cfg.vocab_size, seed=SEED)
    bs = [St.route_batch(train.lm_batch(toks, i, FEDAVG_B, FEDAVG_S,
                                        weights, routes, cuda, cfg))
          for i in range(FEDAVG_TAU)]
    batches = {k: torch.stack([b[k] for b in bs]) for k in bs[0]
               if k != "route"}
    outs = []
    for group in (None, dist.group.WORLD):
        opt = topt.adamw(TRAIN_LR)
        p = init_params(T.specs(cfg), SEED, torch.float32, cuda)
        coll.reset_counts()
        outs.append(make_fedavg_round(cfg, opt, FEDAVG_TAU, n_shards=1,
                                      group=group)(p, opt.init(p), batches))
    torch.cuda.synchronize()
    return outs, coll.all_reduces, topt


def phase_u_sharded(torch, np, card, counters, ops, sr, cuda):
    """(u1) and (u2) on an NCCL world of one; returns kernel 2's sharded
    eq. (4) site."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import mnist as mm

    if dist.is_initialized():
        raise AssertionError("a process group exists before (u)")
    mesh_lib.init_process_group(cuda)
    try:
        if (dist.get_backend(), dist.get_world_size()) != ("nccl", 1):
            raise AssertionError(f"(u1) group {dist.get_backend()} of "
                                 f"{dist.get_world_size()} ranks")
        T = int(FOG_ARGV[FOG_ARGV.index("--T") + 1])
        tau = int(FOG_ARGV[FOG_ARGV.index("--tau") + 1])
        leaves = len(mm.mlp_specs())
        runs, keep = {}, {}
        real_rows = ops.segment_sum_rows
        # in turns, so that neither engine alone pays the first run's
        # start-up; the second run of each is the one compared in time
        for engine in ("batched", "sharded", "sharded", "batched"):
            for c in counters.values():
                c.reset_launches()
            coll.reset_counts()
            if engine == "sharded":
                ops.segment_sum_rows = _keep_rows_by_segments(ops, keep,
                                                              {1: 0})
            try:
                out = train.main(FOG_ARGV + ["--engine", engine])
            finally:
                ops.segment_sum_rows = real_rows
            runs.setdefault(engine, []).append((
                out, {n: c.launches for n, c in counters.items()},
                coll.all_reduces))
        (sh, sh_l, sh_ar), (ba, ba_l, ba_ar) = runs["sharded"][1], \
            runs["batched"][1]
        diff = _hist_diff(np, sh["history"], ba["history"])
        same = all(
            np.array_equal(np.asarray(r[0]["history"][k]),
                           np.asarray(ba["history"][k]))
            for r in runs["sharded"] + runs["batched"][:1]
            for k in ("agg_round", "H_agg", "device_loss", "test_loss",
                      "test_acc"))
        want_ar = 2 * (T // tau)
        times = {e: [round(r[0]["timing"]["train_s"], 4) for r in rs]
                 for e, rs in runs.items()}
        log(f"(u1) fog-scale flags on an NCCL world of one, in turns "
            f"(batched, sharded, sharded, batched): train_s {times}; the "
            f"second runs: --engine sharded {sh['timing']['train_s']:.4f} "
            f"s, --engine batched {ba['timing']['train_s']:.4f} s; all four "
            f"histories bitwise equal {same} (max |diff| device_loss, "
            f"test_loss, test_acc {diff}); launches sharded {sh_l}, "
            f"batched {ba_l}; all-reduces {sh_ar} (expected {want_ar}: one "
            f"numerator and one H total a window), batched {ba_ar} "
            f"[{card}]")
        if not same or sh["engine"] != "sharded":
            raise AssertionError("(u1) --engine sharded != --engine batched")
        if any(r[1] != ba_l or r[2] != (want_ar if e == "sharded" else 0)
               for e, rs in runs.items() for r in rs) \
                or ba_l["segment_reduce"] != (T // tau) * (leaves + 1):
            seen = [(e, r[1], r[2]) for e, rs in runs.items() for r in rs]
            raise AssertionError(f"(u1) launches and all-reduces {seen}")
        k = keep[1]
        d, ids, G, h, lay = (k[x] for x in ("data", "ids", "G", "scale",
                                            "layout"))
        got = sr.segment_sum_rows(d, ids, G, scale=h, layout=lay).cpu()
        plain = sr.segment_sum_rows_plain(d.cpu(), ids.cpu(), G,
                                          scale=h.cpu())
        if not _same_bits(np, got.numpy(), plain.numpy()):
            raise AssertionError("(u1) the sharded row sum: kernel != plain "
                                 "on the CPU")
        flush = flush_buffer(torch, cuda)
        site = _row_site(torch, sr, "eq. (4) sharded rows (n/ranks, P) -> 1,"
                         " then the all-reduce", d, ids, G, h, lay,
                         sh_l["segment_reduce"], flush)
        site["max_abs_err"] = 0.0
        n_num = sum(int(np.prod(shape)) for shape in mm.mlp_specs().values())
        buf = torch.zeros(n_num, device=cuda)
        site["all_reduce_ms"] = _time_ms(torch, lambda b: dist.all_reduce(b),
                                         (buf,), flush)
        site["all_reduces"] = sh_ar
        log(f"(u1) kernel 2 at the sharded eq. (4) rows {site['shape']}: "
            f"kernel {site['ms']} ms (bound {site['bound_ms']} ms by "
            f"{site['bound_by']}), plain {site['plain_ms']} ms, index_add_ "
            f"{site['library_ms']} ms; the all-reduce of the {n_num}-float "
            f"numerator {site['all_reduce_ms']} ms on the card; bitwise the "
            f"CPU's sequential row sum [{card}]")
        del buf, flush
        outs, ar, topt = _fedavg_rounds(torch, np, dist, cuda)
        (p0, s0, l0), (p1, s1, l1) = outs
        equal = bool(torch.equal(l0, l1)) and all(
            torch.equal(a, b) for a, b in zip(
                topt.tree_leaves(p0) + topt.tree_leaves(s0),
                topt.tree_leaves(p1) + topt.tree_leaves(s1)))
        log(f"(u2) FedAvg round ({FEDAVG_ARCH} smoke, tau {FEDAVG_TAU}, "
            f"B={FEDAVG_B} x S={FEDAVG_S}, AdamW) on the NCCL world of one "
            f"vs the one-card round with one shard: loss {float(l1)} / "
            f"{float(l0)}, params, moments and loss bitwise equal {equal}, "
            f"{ar} all-reduces [{card}]")
        if not equal or ar != 2:
            raise AssertionError(f"(u2) the group's round != the one-card "
                                 f"round, or {ar} all-reduces (not the H "
                                 f"total and one flat buffer)")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return site


def _encdec_useful_flops(R, cfg, B, S) -> float:
    """2·params·tokens for an encoder-decoder prefill, with the encoder's
    layers and the decoder's cross-attention K/V projections at the
    B·encoder_seq frames they process and the rest at the B·S decoder
    tokens (``roofline.analytic_roofline`` charges every parameter B·S
    tokens, as the reference does)."""
    pc = R._param_counts(cfg)
    attn = pc["attn"] / (2 * cfg.num_layers + cfg.encoder_layers)
    mlp = pc["mlp"] / (cfg.num_layers + cfg.encoder_layers)
    at_frames = (cfg.encoder_layers * (attn + mlp) + cfg.num_layers * 2
                 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim)
    _, active = R.params_total_active(cfg)
    return 2.0 * (at_frames * B * cfg.encoder_seq
                  + (active - at_frames) * B * S)


def phase_u_roofline(np, card, state):
    """(u3) the analytic roofline of six cells measured in (j), (s2)
    and (t), one card, float32, beside their warm times."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import roofline as R

    t = state["t"]
    cells = [
        ("(j) zamba2-7b prefill", get_config(SERVE_ARCH),
         InputShape("j", PREFILL_S, PREFILL_B, "prefill"),
         state["warm"]["j"]),
        ("(s2) zamba2-7b 18-layer AdamW step",
         get_config(SERVE_ARCH).with_overrides(num_layers=TRAIN_LAYERS),
         InputShape("s2", TRAIN_S, state["s2"]["B"], "train"),
         state["s2"]["step_s"]),
        ("(t1) olmoe-1b-7b prefill", get_config(OLMOE),
         InputShape("t1", OLMOE_S, OLMOE_B, "prefill"), t["t1"]["warm_s"]),
        ("(t3) olmoe-1b-7b 6-layer AdamW step",
         get_config(OLMOE).with_overrides(num_layers=MOE_TRAIN_LAYERS),
         InputShape("t3", MOE_TRAIN_S, t["t3"]["B"], "train"),
         t["t3"]["step_s"]),
        ("(t4) whisper-large-v3 prefill", get_config(WHISPER),
         InputShape("t4", get_config(WHISPER).max_positions, WHISPER_B,
                    "prefill"), t["t4"]["warm_s"]),
        ("(t5) phi-3-vision-4.2b prefill", get_config(PHI3V),
         InputShape("t5", PHI3V_S, PHI3V_B, "prefill"), t["t5"]["warm_s"])]
    rows = []
    for name, cfg, shape, warm in cells:
        r = R.analytic_roofline(cfg, shape, (1, 1))
        note = ""
        if cfg.family == "encdec":
            note = (f" (the roofline's decoder-token formula "
                    f"{r['flops_useful']:.6g} FLOP, mfu "
                    f"{r['compute_useful_s'] / warm:.6g}, charges the "
                    f"encoder {shape.seq_len} tokens, not its "
                    f"{cfg.encoder_seq} frames)")
            r = {**r, "flops_useful": _encdec_useful_flops(
                     R, cfg, shape.global_batch, shape.seq_len)}
            r["compute_useful_s"] = r["flops_useful"] / R.PEAK_FLOPS
        row = {"cell": name, "warm_s": warm,
               **{k: r[k] for k in ("flops_useful", "compute_useful_s",
                                    "compute_s", "memory_s")},
               "dominant": R.dominant_term(r),
               "mfu": r["compute_useful_s"] / warm}
        rows.append(row)
        log(f"(u3) {name} B={shape.global_batch} x S={shape.seq_len}: "
            f"useful {r['flops_useful']:.6g} FLOP{note}, compute_useful_s "
            f"{r['compute_useful_s']:.6g}, compute_s {r['compute_s']:.6g}, "
            f"memory_s {r['memory_s']:.6g}, dominant {row['dominant']}, "
            f"warm {warm:.6g} s, mfu {row['mfu']:.6g} (at "
            f"{R.PEAK_FLOPS:.3g} FLOP/s f32, {R.HBM_BW:.3g} B/s) [{card}]")
        if not (0 < row["mfu"] < 1.5 and np.isfinite(row["mfu"])):
            raise AssertionError(f"(u3) {name}: mfu {row['mfu']}")
    return rows


# one H100's memory: a production train step's peak a device must fit
H100_BYTES = 80_000_000_000


def _one_shard_logits_bytes(arch: str, shape_name: str, data: int) -> int:
    """Bytes of one data shard's full-vocab float32 logits: (B/data, S,
    V_pad), what a rank holds when the training loss gathers the
    vocab."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    shape = INPUT_SHAPES[shape_name]
    v_pad = T.specs(get_config(arch))["embed"]["tok"].shape[0]
    return shape.global_batch // data * shape.seq_len * v_pad * 4


def _decode_bounds(arch: str, shape_name: str) -> tuple[int, int]:
    """(one layer's global f32 K cache bytes, the global f32 token
    table's bytes) of ``arch`` at the decode shape ``shape_name``: what a
    decode step moved and held a device when DTensor gathered them."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    k = T.init_cache_specs(cfg, shape.global_batch, shape.seq_len)["k"]
    return (math.prod(k.shape[1:]) * 4,
            math.prod(T.specs(cfg)["embed"]["tok"].shape) * 4)


def _ssm_state_bytes(arch: str, shape_name: str) -> int:
    """One layer's global f32 SSM state (B·H·P·N·4 bytes) of ``arch`` at
    the decode shape ``shape_name``."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    h = T.init_cache_specs(cfg, shape.global_batch, shape.seq_len)["h"]
    return math.prod(h.shape[1:]) * 4


def _dryrun_runs():
    """(argv, out) of (u4)'s four dry runs."""
    build = ROOT / "build"
    return [(DRYRUN_ARGV, build / "chip_smoke_dryrun.jsonl"),
            (DRYRUN_MOE_ARGV, build / "chip_smoke_dryrun_moe.jsonl"),
            (DRYRUN_DECODE_ARGV, build / "chip_smoke_dryrun_decode.jsonl"),
            (DRYRUN_SSM_ARGV, build / "chip_smoke_dryrun_ssm.jsonl")]


def _dryrun_start(runs):
    """Each (argv, out) of ``runs`` started as ``python -m
    repro_torch.launch.dryrun ARGV --out OUT`` in a subprocess of its own
    (a process holds one default group), all at once: (process, argv,
    out, start) each, for :func:`_dryrun_rows`. They trace on the host's
    CPU and use no card, so they can run beside a phase that keeps the
    card busy."""
    procs = []
    for argv, out in runs:
        out.parent.mkdir(exist_ok=True)
        out.unlink(missing_ok=True)
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")}),
            argv, out, time.perf_counter()))
    return procs


def _dryrun_rows(procs):
    """Each started dry run's (PASS line, row, s from its start until it
    was collected), once it ends; every process is stopped. Raises where
    one fails."""
    rows = []
    for proc, argv, out, t0 in procs:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        passed = [ln for ln in stdout.splitlines() if ln.startswith("PASS")]
        if proc.returncode != 0 or not passed:
            raise AssertionError(f"(u4) dry run {argv} failed (exit "
                                 f"{proc.returncode}):\n{stdout[-3000:]}\n"
                                 f"{stderr[-3000:]}")
        rows.append((passed[0], json.loads(out.read_text().splitlines()[-1]),
                     time.perf_counter() - t0))
    return rows


def phase_u_dryrun(card, procs=None):
    """(u4) production dry runs, each in a subprocess: qwen3-14b
    ``train_4k`` and olmoe-1b-7b ``train_4k`` with ``--moe-groups 16``,
    both on the (16, 16) mesh, and minitron-4b ``decode_32k`` beside
    them. Each must PASS, and each train step's peak
    must fit one H100 (the loss runs vocab-parallel; with the global
    logits gathered qwen3-14b read 815 GB on torch 2.11, and olmoe's
    dispatch, gathered whole, 452 GB on 2.13). qwen3-14b's peak must also
    stay below one data shard's full-vocab float32 logits, now that the
    residual stream sits on its sequence shards on every torch version
    (on 2.11 DTensor kept it whole on the model axis: 74.6 GB). Each
    row's residual placements (as they arrived at the block boundaries,
    and as pinned) are logged. The decode step must move fewer bytes a
    device than one layer's global K cache and peak below the global
    float32 token table: with both gathered it moved 7.433e10 B and
    peaked at 6,291,456,064 B on 2.13. mamba2-1.3b ``decode_32k`` must
    move fewer bytes a device than one layer's global SSM state (the SSM
    decode on its head shards: before, 1.182e8 B on 2.13 and 2.53e7 on
    2.11). Both decode streams must leave every block boundary on their
    batch shards, whole on the model axis (``S(0),R``). ``procs``: the
    runs as :func:`_dryrun_start` started them (main starts them with
    phase (t)); started here otherwise."""
    ((line, row, wall), (m_line, m_row, m_wall), (d_line, d_row, d_wall),
     (s_line, s_row, s_wall)) = \
        _dryrun_rows(procs or _dryrun_start(_dryrun_runs()))
    top = list(row["flops_by_op"].items())[:4]
    log(f"(u4) {line}; torch {row['torch']}, dominant "
        f"{row['dominant']}, trace_s "
        f"{row['trace_s']}, flops_per_device {row['flops_per_device']}, "
        f"by op (per device, logical) {json.dumps(top)}, "
        f"bytes_per_device {row['bytes_per_device']}, collectives "
        f"{json.dumps(row['collectives']['per_op'])}, useful_flops_ratio "
        f"{row['useful_flops_ratio']}, memory {json.dumps(row['memory'])}, "
        f"collected {wall:.1f} s after its start, device meta [{card}]")
    for r, w in ((row, wall), (m_row, m_wall)):
        mem = r["memory"]
        if not (mem["temp_size_in_bytes"] > 0
                and 0 < mem["alias_size_in_bytes"]
                <= mem["argument_size_in_bytes"]):
            raise AssertionError(f"(u4) {r['arch']} memory columns {mem}")
        log(f"(u4) {r['arch']} {r['shape']} {json.dumps(r['variant'])} "
            f"peak temp_size_in_bytes {mem['temp_size_in_bytes']}, one "
            f"H100 {H100_BYTES}, residual placements "
            f"{json.dumps(r['residual_placements'])}, flops_per_device "
            f"{r['flops_per_device']}, collected {w:.1f} s after its start "
            f"(torch "
            f"{r['torch']}) [{card}]")
        if mem["temp_size_in_bytes"] >= H100_BYTES:
            raise AssertionError(f"(u4) {r['arch']} {r['variant']}: the "
                                 f"train step's peak "
                                 f"{mem['temp_size_in_bytes']} B does not "
                                 f"fit one H100 ({H100_BYTES} B)")
        if set(r["residual_placements"]["pinned"]) != {"S(0),S(1)"}:
            raise AssertionError(f"(u4) {r['arch']}: residual placements "
                                 f"{r['residual_placements']}")
    data = math.prod(int(e) for e in row["mesh"].split("x")[:-1])
    shard = _one_shard_logits_bytes(row["arch"], row["shape"], data)
    peak = row["memory"]["temp_size_in_bytes"]
    log(f"(u4) {row['arch']} peak {peak} against one data shard's "
        f"full-vocab f32 logits {shard} (torch {row['torch']}) [{card}]")
    if peak >= shard:
        raise AssertionError(f"(u4) {row['arch']}: the train step's peak "
                             f"{peak} B is not below one data shard's "
                             f"full-vocab logits ({shard} B)")
    layer, table = _decode_bounds(d_row["arch"], d_row["shape"])
    moved = d_row["collectives"]["moved_bytes_per_device"]
    d_peak = d_row["memory"]["temp_size_in_bytes"]
    log(f"(u4) {d_line}; torch {d_row['torch']}, moved a device {moved} B "
        f"against one layer's global K cache {layer} B, peak {d_peak} B "
        f"against the global f32 token table {table} B, flops_per_device "
        f"{d_row['flops_per_device']}, collectives "
        f"{json.dumps(d_row['collectives']['per_op'])}, dominant "
        f"{d_row['dominant']}, collective_s {d_row['collective_s']}, "
        f"collected {d_wall:.1f} s after its start [{card}]")
    if not (moved < layer and d_peak < table):
        raise AssertionError(f"(u4) {d_row['arch']} {d_row['shape']}: "
                             f"moved {moved} B (one layer's cache {layer} "
                             f"B), peak {d_peak} B (the table {table} B): "
                             f"the decode step gathers its cache or its "
                             f"table")
    state = _ssm_state_bytes(s_row["arch"], s_row["shape"])
    s_moved = s_row["collectives"]["moved_bytes_per_device"]
    log(f"(u4) {s_line}; torch {s_row['torch']}, moved a device {s_moved} "
        f"B against one layer's global SSM state {state} B, peak "
        f"{s_row['memory']['temp_size_in_bytes']} B, residual placements "
        f"{json.dumps(s_row['residual_placements'])}, collectives "
        f"{json.dumps(s_row['collectives']['per_op'])}, flops_per_device "
        f"{s_row['flops_per_device']}, collected {s_wall:.1f} s after its "
        f"start [{card}]")
    if s_moved >= state:
        raise AssertionError(f"(u4) {s_row['arch']} {s_row['shape']}: "
                             f"moved {s_moved} B, one layer's SSM state is "
                             f"{state} B: the SSM decode gathers its heads")
    for r in (d_row, s_row):
        if set(r["residual_placements"].get("pinned", ())) != {"S(0),R"}:
            raise AssertionError(f"(u4) {r['arch']} {r['shape']}: the "
                                 f"decode stream is not pinned: "
                                 f"{r['residual_placements']}")
    return row, m_row, d_row, s_row


# ---------------------------------------------------------------------------
# (v) the runtime sanitizer at fog scale, its refusals on the card, and
# the streaming scan flag through kernel 4
# ---------------------------------------------------------------------------

SANITIZE_ARGV = [("flat", FOG_ARGV), ("tiered", TIERED_FOG_ARGV),
                 ("batched", FOG_ARGV + ["--engine", "batched"])]
SANITIZE_BLOCK = {"transfer_guard": True, "debug_nans": True,
                  "warm_compiles": 0}


def _counted_runs(F, counters):
    """``F.run_network_aware`` wrapped to record, per call, its wall
    seconds and the launches of every kernel it made."""
    real = F.run_network_aware
    runs = []

    def wrapped(*a, **kw):
        before = {name: c.launches for name, c in counters.items()}
        t0 = time.perf_counter()
        out = real(*a, **kw)
        runs.append((time.perf_counter() - t0,
                     {name: c.launches - before[name]
                      for name, c in counters.items()}))
        return out
    return real, wrapped, runs


def phase_v_sanitize(torch, np, card, counters):
    """(v1) ``--sanitize`` at fog scale, flat, tiered and through the
    sweep engine: the reference's block, the warm pass's history bitwise
    the unsanitized run's, each pass's kernel launches the unsanitized
    run's, and the sanitizer's overhead."""
    from repro_torch.core import federated as F
    from repro_torch.launch import train

    real, wrapped, runs = _counted_runs(F, counters)
    F.run_network_aware = wrapped
    try:
        for tag, argv in SANITIZE_ARGV:
            outs = {}
            # in turns: unsanitized, sanitized (cold and warm passes),
            # unsanitized again, so that warm-up lands on neither side
            for key, extra in (("plain", []), ("sanitized", ["--sanitize"]),
                               ("again", [])):
                for c in counters.values():
                    c.reset_launches()
                del runs[:]
                out = train.main(argv + extra)
                outs[key] = (out, list(runs),
                             {name: c.launches
                              for name, c in counters.items()})
            (plain, p_runs, p_all), (san, s_runs, s_all) = \
                outs["plain"], outs["sanitized"]
            (again_s, _), = outs["again"][1]
            if san.get("sanitize") != SANITIZE_BLOCK:
                raise AssertionError(f"(v1) {tag}: sanitize block "
                                     f"{san.get('sanitize')}")
            a, b = san["history"], plain["history"]
            same = (a["test_acc"] == b["test_acc"]
                    and a["test_loss"] == b["test_loss"]
                    and np.array_equal(np.stack(a["device_loss"]),
                                       np.stack(b["device_loss"]))
                    and np.array_equal(np.stack(a["H_agg"]),
                                       np.stack(b["H_agg"])))
            if not same:
                raise AssertionError(f"(v1) {tag}: the sanitized history "
                                     "differs from the unsanitized run's")
            (p_s, p_l), = p_runs
            if len(s_runs) != 2 or any(l != p_l for _, l in s_runs):
                raise AssertionError(f"(v1) {tag}: launches per pass "
                                     f"{[l for _, l in s_runs]}, "
                                     f"unsanitized {p_l}")
            plan_l = {name: p_all[name] - p_l[name] for name in p_all}
            if (plan_l["offload_greedy"] == 0
                    or any(s_all[n] - sum(l[n] for _, l in s_runs)
                           != plan_l[n] for n in plan_l)):
                raise AssertionError(f"(v1) {tag}: plan launches "
                                     f"{plan_l}, sanitized total {s_all}")
            if p_l["segment_reduce"] == 0 and tag != "flat":
                raise AssertionError(f"(v1) {tag}: no kernel-2 launch")
            cold, warm = (t for t, _ in s_runs)
            base = (p_s + again_s) / 2
            log(f"(v1) --sanitize {tag} at fog scale: block "
                f"{san['sanitize']}, history bitwise the unsanitized "
                f"run's, final_acc {san['final_acc']}; training in turns: "
                f"unsanitized {p_s:.4f} s, sanitized cold {cold:.4f} s "
                f"and warm {warm:.4f} s, unsanitized {again_s:.4f} s "
                f"(sanitizer overhead {warm - base:.4f} s warm, "
                f"{cold - base:.4f} s cold, against their mean); kernel "
                f"launches a pass {p_l}, plan {plan_l} [{card}]")
    finally:
        F.run_network_aware = real


def phase_v_raises(torch, np, card, cuda):
    """(v2) what the sanitizer refuses, on the card: a planted sync and
    a sync hidden in an op inside the guard, a NaN from an eager op, a
    new program key in a warm scope; the sync debug mode restored."""
    from repro_torch.core import costs
    from repro_torch.core import federated as F
    from repro_torch.core import movement as mv
    from repro_torch.core import sanitize as sz
    from repro_torch.data.synthetic import make_image_dataset

    before = torch.cuda.get_sync_debug_mode()
    x = torch.arange(-4.0, 4.0, device=cuda)
    got = {}
    cases = [("item", RuntimeError, lambda: x.sum().item(), True),
             ("mask_index", RuntimeError, lambda: x[x > 0], True),
             ("to_host", RuntimeError, lambda: x.cpu(), True),
             ("nan", FloatingPointError, lambda: torch.log(x), False)]
    for name, err, fn, guarded in cases:
        try:
            with sz.sanitized(True):
                with sz.hot_loop_guard() if guarded \
                        else contextlib.nullcontext():
                    fn()
            got[name] = "no error"
        except err as e:
            got[name] = f"{type(e).__name__}: {str(e)[:60]}"
    data = make_image_dataset(n_train=600, n_test=200, seed=SEED)
    cfg = F.FedConfig(n=6, T=8, tau=2, eta=0.0123, model="mlp", seed=3)
    traces = costs.synthetic_costs(cfg.n, cfg.T, np.random.default_rng(1))
    plan = mv.no_movement_plan(cfg.T, cfg.n)
    try:
        with sz.sanitized(sz.SanitizeConfig(expect_warm=True)):
            F.run_network_aware(cfg, data, traces, None, plan,
                                engine="batched", device=cuda)
        got["warm_key"] = "no error"
    except sz.RecompileError as e:
        got["warm_key"] = f"RecompileError: {str(e)[:60]}"
    after = torch.cuda.get_sync_debug_mode()
    log(f"(v2) sanitizer refusals on the card: {got}; sync debug mode "
        f"{before} before, {after} after [{card}]")
    if any(v == "no error" for v in got.values()) or after != before:
        raise AssertionError(f"(v2) {got}, sync debug mode {after}")


def _scan_temporaries(cfg, B, S) -> dict:
    """Bytes of the SSD scan's temporaries at batch B and length S,
    reckoned from the shapes: the kernel's all-chunk scratch
    (``ssd_scan._launch``: the (B, H, nc, P, N) chunk states and the
    (B, nc, l', l') C·Bᵀ products), the streaming plain version's
    per-chunk (B, H, l, l) decay matrix and (B, H, P, N) state, and the
    default plain version's all-chunk (B, H, nc, l, l) decay matrix."""
    H, P, N, l = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    nc, lp = S // l, -(-l // 16) * 16
    return {"kernel_states": B * nc * H * P * N * 4,
            "kernel_cb": B * nc * lp * lp * 4,
            "streaming_chunk": B * H * l * l * 4,
            "streaming_state": B * H * P * N * 4,
            "plain_all_chunks": B * H * nc * l * l * 4}


def phase_v_streaming(torch, np, card, counters, served, cuda):
    """(v3) (j)'s zamba2-7b, already on the card, prefills once with
    ``ssm_streaming``: bitwise the default prefill, 81 scan launches."""
    _, _, steps, _, _, _ = _serve_modules()
    cfg, params = served["cfg"], served["params"]
    rng = np.random.default_rng(SEED)          # (j)'s prompts
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S)).astype(np.int32)).to(cuda)
    logits, launches = {}, {}
    for streaming in (False, True):
        prefill = steps.make_prefill_step(
            cfg.with_overrides(ssm_streaming=streaming))
        for c in counters.values():
            c.reset_launches()
        with torch.no_grad():
            logits[streaming] = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        launches[streaming] = {n: c.launches for n, c in counters.items()}
    equal = bool(torch.equal(logits[True], logits[False]))
    here = _scan_temporaries(cfg, PREFILL_B, PREFILL_S)
    long = _scan_temporaries(cfg, 1, 524288)
    log(f"(v3) {SERVE_ARCH} prefill B={PREFILL_B} S={PREFILL_S} with "
        f"ssm_streaming: bitwise the default prefill {equal}, launches "
        f"{launches[True]} (default {launches[False]}); the scan's "
        f"temporaries in bytes, reckoned from the shapes: here {here}, "
        f"at B=1 S=524288 (long_500k) {long} [{card}]")
    if not equal or launches[True] != launches[False] \
            or launches[True]["ssd_scan"] != cfg.num_layers:
        raise AssertionError(f"(v3) equal {equal}, launches {launches}")


# ---------------------------------------------------------------------------
# (w) the reference's remaining bench rows and the four examples
# ---------------------------------------------------------------------------

W_ROWS = ("engine_throughput", "kernels_micro", "solver_scaling",
          "movement_scale", "convex_batched")
# (script, arguments): each at a size that runs in seconds
W_EXAMPLES = (("quickstart_torch.py", []),
              ("offload_planning_torch.py", []),
              ("serve_llm_torch.py", []),
              ("fog_train_torch.py", ["--quick"]))
W_EXAMPLE_TIMEOUT = 240


def phase_w_rows(card):
    """(w1) the five timed rows of ``launch/tables.py`` on the card at
    ``--quick`` scale: the float64 plans identical, the kernel-1 plan
    bit for bit its plain version's with one launch, the sparse and
    dense movement plans identical, each ``kernels_micro`` kernel within
    its tolerance of its plain version with one launch a call; (w2)
    ``dryrun_roofline`` on the JSONL that (u4) wrote."""
    from repro_torch.launch import tables as TT

    rows = {}
    for name in W_ROWS:
        t0 = time.perf_counter()
        rows[name] = TT.TABLES[name](TT.QUICK, "cuda")
        rows[name]["seconds"] = time.perf_counter() - t0
    et = rows["engine_throughput"]
    log(f"(w1) engine_throughput {json.dumps(et, default=float)} [{card}]")
    mov = et["movement"]
    if not (mov["identical_plan"] and mov["device_plain_identical"]
            and mov["device_launches"] == 1):
        raise AssertionError(f"(w1) engine_throughput movement {mov}")
    for e in rows["kernels_micro"]["kernels"]:
        log(f"(w1) kernels_micro {e['name']} {e['shape']}: kernel "
            f"{e['ms']} ms, plain {e['plain_ms']} ms, library "
            f"{e['library_ms']} ms, least time {e['bound_ms']} ms (bound "
            f"by {e['bound_by']}), launches a call {e['launches']}, max abs "
            f"err vs plain {e['max_abs_err']} [{card}]")
        if not (e["within_tolerance"] and e["launches"] == 1):
            raise AssertionError(f"(w1) kernels_micro {e}")
    for name in ("solver_scaling", "movement_scale", "convex_batched"):
        log(f"(w1) {name} {json.dumps(rows[name], default=float)} [{card}]")
    if not rows["movement_scale"]["headline"]["identical_plans"]:
        raise AssertionError("(w1) movement_scale: plans differ")
    summary = TT.dryrun_roofline(
        TT.QUICK, "cuda", path=ROOT / "build" / "chip_smoke_dryrun.jsonl")
    log(f"(w2) dryrun_roofline on (u4)'s row: {json.dumps(summary)} "
        f"[{card}]")
    if summary.get("n_pass") != 1:
        raise AssertionError(f"(w2) dryrun_roofline {summary}")
    return rows


def _examples_start():
    """The four examples started side by side in subprocesses, for
    :func:`phase_w_examples`: ({script: process}, start). They start
    with phase (v), whose timings none of the quoted numbers read."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for name, args in W_EXAMPLES}, time.perf_counter()


def phase_w_examples(card, started=None):
    """(w3) the four examples on the card, side by side in subprocesses
    (``started`` by :func:`_examples_start`, or started here) with a
    timeout: each exits 0; the planning example launches kernel 1
    once, and the serving example the attention kernel for qwen3-14b
    and mixtral-8x7b and the scan kernel for mamba2-1.3b."""
    procs, t0 = started or _examples_start()
    outs, failed = {}, []
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=W_EXAMPLE_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs[name] = out
        if p.returncode != 0:
            failed.append(name)
            log(f"(w3) {name} exit {p.returncode}:\n{out[-2000:]}\n"
                f"{err[-3000:]}")
    wall = time.perf_counter() - t0
    launches = [ln for ln in outs["serve_llm_torch.py"].splitlines()
                if ln.startswith("kernel launches")]
    planning = [ln for ln in outs["offload_planning_torch.py"].splitlines()
                if ln.startswith(("kernel launches", "Theorem-3"))]
    unit = [ln for ln in outs["quickstart_torch.py"].splitlines()
            if ln.startswith(("unit cost", "test accuracy"))]
    log(f"(w3) examples in {wall:.1f} s side by side: quickstart {unit}; "
        f"offload_planning {planning}; serve_llm {launches} [{card}]")
    if failed:
        raise AssertionError(f"(w3) examples failed: {failed}")
    counts = [[int(x) for x in ln.replace(",", "").split()[3::2]]
              for ln in launches]
    if planning[-1] != "kernel launches: 1" or len(counts) != 3 or not (
            counts[0][0] > 0 and counts[1][0] > 0 and counts[2][1] > 0):
        raise AssertionError(f"(w3) kernel launches: {planning} {launches}")


# The phases in run order. "X/cpu" collects (X)'s CPU sides, which run
# as jobs (JOB_PLAN), and holds (X)'s card side to them.
PHASES = ("a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "v3", "k", "l",
          "m", "n", "o", "p", "q", "r", "s", "t", "b/cpu", "g/cpu", "n/cpu",
          "o/cpu", "p/cpu", "u", "v", "w")
# (starter, the phase that collects its jobs). Every job starts as (r3)
# begins (:func:`start_jobs`), beside the card work of (r3), (s) and
# (t3); they have settled before (t1).
JOB_PLAN = ((start_s, "s"), (start_b, "b/cpu"), (start_g, "g/cpu"),
            (start_n, "n/cpu"), (start_o, "o/cpu"), (start_p, "p/cpu"))
# The seconds of each job that (t) settles, in a one-thread worker of
# the pool of 7 on an H100 machine's 8-CPU host: only their order is
# used.
JOB_SECONDS = {
    "b T=20 CPU": 49.347,
    "g CPU": 49.423,
    "n convex B/sqrt CPU": 31.35,
    "n convex B/neg_G CPU": 40.003,
    "n convex E/sqrt CPU": 31.529,
    "n convex E/neg_G CPU": 40.571,
    "o --churn 0.1 --replan oracle CPU": 11.503,
    "o --churn 0.1 --replan predict CPU": 11.872,
    "o --churn 0.1 --replan once CPU": 12.853,
    "o --schedule flap CPU": 15.792,
    "o --tiers 5@10,1@20 --churn 0.1 CPU": 12.081,
    "o Table V CPU": 2.659,
    "p5 --faults mixed --fault-rate 0.2 --quorum 0.4 CPU": 49.7,
    "p5 --faults corrupt --fault-rate 0.3 --unguarded CPU": 48.152,
    "p5 --tiers 5@10,1@20 --faults mixed --fault-rate 0.2 CPU": 49.206,
    "p6 CPU": 17.758}


class _Queued(list):
    """A stand-in for :class:`Jobs` that keeps the jobs started on it."""

    def start(self, key, fn, *args, **kwargs):
        self.append((key, fn, args, kwargs))


def start_jobs(jobs):
    """Every job of JOB_PLAN: first those that a phase before (t)
    collects, in the order it collects them (it waits for them), then
    those that (t) settles, longest first by JOB_SECONDS, so that the
    pool's last jobs are short ones and its workers finish together."""
    early, late = _Queued(), _Queued()
    for starter, collected_in in JOB_PLAN:
        starter(early if PHASES.index(collected_in) < PHASES.index("t")
                else late)
    for key, fn, args, kwargs in early + sorted(
            late, key=lambda job: -JOB_SECONDS[job[0]]):
        jobs.start(key, fn, *args, **kwargs)


def job_pool_size(cpus):
    """(workers, torch threads each) for a host of ``cpus`` CPUs: one CPU
    left to the process that feeds the card (the jobs run while its work
    is on the card), one thread a worker (the jobs are many and small:
    one thread each keeps them busy), at most 8 workers."""
    return min(8, max(1, cpus - 1)), 1


def run_phases(phases, clock):
    """Each (name, fn) of ``phases`` in turn, timed and reported, a
    failure with its traceback; the names of those that failed."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:              # report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        clock.seconds[f"({name})"] = round(time.perf_counter() - t0, 3)
        log(f"phase ({name}) {'FAILED' if name in failed else 'ok'} "
            f"in {time.perf_counter() - t0:.1f} s [{clock.card}]")
    return failed


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
        from repro_torch.core import movement as mv
        from repro_torch.device import resolve_device
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import offload_greedy as og
        from repro_torch.kernels import ops
        from repro_torch.kernels import segment_reduce as sr
        from repro_torch.kernels import ssd_scan as sd
        from repro_torch.launch import train
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: "
              f"{e}", file=sys.stderr)
        return 2
    counters = {"offload_greedy": og, "segment_reduce": sr,
                "flash_attention": fa, "ssd_scan": sd}
    card = card_line()
    cuda = resolve_device("cuda")
    clock = Clock(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"[{card}]")
    log(f"host: os.cpu_count() {os.cpu_count()}, usable CPUs "
        f"{len(os.sched_getaffinity(0))}, torch intra-op threads "
        f"{torch.get_num_threads()}, inter-op threads "
        f"{torch.get_num_interop_threads()} [{card}]")
    jobs = Jobs(*job_pool_size(os.cpu_count() or 1), clock)
    log(f"CPU sides as jobs: {jobs.workers} spawned workers of "
        f"{jobs.threads} torch threads each [{card}]")
    t0 = time.perf_counter()
    libs = _build.build(list(counters))
    clock.add("build", time.perf_counter() - t0)
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s [{card}]")
    for name, path in libs.items():
        log(path.with_suffix(".log").read_text().strip())

    state: dict = {}
    kernels: dict = {}

    def c():
        state["c"] = phase_c_fog(torch, np, card, counters, cuda)
        state["c_train_s"] = state["c"][3]

    def d():
        k = kernels["offload_greedy"] = phase_d_timing(
            torch, og, ops, mv, state["c"], cuda, card)
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
            torch, np, sr, biggest, launches)
        log(f"(h) {k['name']} row sum on the tier-1 w1 leaf {k['shape']}: "
            f"kernel {k['ms']} ms, least time {k['bound_ms']} ms (bound by "
            f"{k['bound_by']}; the 1-D form's {k['flat_bound_ms']} ms + "
            f"the product's pass {k['product_pass_ms']} ms), plain version "
            f"{k['plain_ms']} ms, library index_add_ of the product "
            f"{k['library_ms']} ms, layout build (m ids) {k['layout_ms']} "
            f"ms; launches on the tiered path {k['launches']}, max abs err "
            f"vs the sequential sum {k['max_abs_err']} [{card}]")

    def j():
        state["j"] = phase_j_serve(torch, np, card, counters, ops, cuda)
        state["warm"] = {"j": state["j"]["warm_s"]}

    def b():
        state["b"] = phase_b_defaults(torch, np, card, counters, cuda, clock)

    def k_():
        phase_k_decode_check(torch, np, card, state["j"], ops, fa, sd, clock)

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

    def n_():
        # the jobs' workers start here and import the jobs' modules beside
        # (n) and (o), whose times no quoted number reads, so that they are
        # ready when the jobs start at (r3)
        jobs.open()
        state["n"] = clock.run(phase_n_convex_card_vs_cpu, card, cuda, clock)
        clock.run(phase_n_fog_e_sqrt, torch, np, card, counters, cuda)
        clock.run(phase_n_discard_fog, torch, np, card, counters, cuda, og)
        clock.run(phase_n_defaults_e_sqrt, np, card, cuda, clock)

    def o():
        problems = clock.run(phase_o_kernel, torch, np, og, cuda, card)
        clock.run(phase_o_fog, torch, np, og, ops, counters, cuda, card,
                  problems)
        state["o"] = (clock.run(phase_o_small, torch, np, clock),
                      clock.run(phase_o_table5, cuda, clock))

    def e():
        state["e_sites"] = phase_e_segment(torch, np, sr, eng, card, cuda)

    def q():
        keep = clock.run(phase_q_sparse, torch, np, card, counters, cuda)
        sites = [clock.run(phase_q_counts, torch, np, card, sr, keep, cuda)]
        del keep
        sites += clock.run(phase_q_hier, torch, np, card, counters, ops, sr,
                           cuda)
        kernels["segment_reduce"]["sites"] = state.pop("e_sites") + sites
        clock.run(phase_q_small, np, card, cuda, clock)

    def r():
        clock.run(phase_r_tables, np, card, cuda, clock)
        sites = clock.run(phase_r_full_width, torch, np, card, counters, ops,
                          sr, cuda)
        start_jobs(jobs)
        kernels["segment_reduce"].setdefault("sites", []).extend(
            clock.run(phase_r_kernel, torch, np, card, sr, cuda, sites))
        del sites
        torch.cuda.empty_cache()

    def s_():
        clock.run(phase_s_grads, torch, fa, sd, cuda, card)
        s2 = state["s2"] = clock.run(phase_s_train, torch, np, card,
                                     counters, ops, fa, sd, cuda, clock)
        kernels.setdefault("flash_attention", {})["train_step_launches"] = \
            s2["attention"]
        kernels.setdefault("ssd_scan", {})["train_step_launches"] = \
            s2["ssd"]
        clock.run(phase_s_cli, np, card, counters, jobs, clock)

    def t():
        cells = {"t3": clock.call("t3", phase_t_train, torch, np, card,
                                  counters, ops, fa, sd, cuda, clock)}
        jobs.settle()
        # (u4)'s dry runs trace on the host beside the rest of (t)
        state["dry"] = _dryrun_start(_dryrun_runs())
        kernels["flash_attention"]["sites"], state["t"] = phase_t_zoo(
            torch, np, card, counters, ops, fa, sd, cuda, clock, cells)

    def u():
        kernels["segment_reduce"].setdefault("sites", []).append(
            clock.run(phase_u_sharded, torch, np, card, counters, ops, sr,
                      cuda))
        clock.run(phase_u_roofline, np, card, state)
        clock.run(phase_u_dryrun, card, state.pop("dry", None))

    def v3():
        phase_v_streaming(torch, np, card, counters, state["j"], cuda)

    def v():
        # (w3)'s examples run on the host beside (v)
        state["examples"] = _examples_start()
        clock.run(phase_v_sanitize, torch, np, card, counters)
        clock.run(phase_v_raises, torch, np, card, cuda)

    def w():
        clock.run(phase_w_rows, card)
        clock.run(phase_w_examples, card, state.pop("examples", None))

    def p():
        clock.run(phase_p_fog, torch, np, card, counters, state["c_train_s"])
        clock.run(phase_p_tiered, torch, np, card, counters, ops, sr)
        clock.run(phase_p_noop_resume, torch, np, card, cuda)
        state["p"] = (clock.run(phase_p_small, clock),
                      clock.run(phase_p_study, cuda, clock))
        clock.run(phase_p_serve, card)

    def g():
        state["g"] = phase_g_tiered_defaults(clock)

    fns = {"a": lambda: phase_a_kernels(torch, og, cuda), "b": b, "c": c,
           "d": d, "e": e, "f": f, "g": g, "h": h,
           "i": lambda: phase_i_new_kernels(torch, fa, sd, cuda),
           "j": j, "v3": v3, "k": k_, "l": l_,
           "m": lambda: phase_m_smoke_configs(torch, np, card, counters,
                                              cuda),
           "n": n_, "o": o, "p": p, "q": q, "r": r, "s": s_,
           "b/cpu": lambda: collect_b(np, card, jobs, state.pop("b")),
           "g/cpu": lambda: collect_g(np, card, jobs, state.pop("g")),
           "n/cpu": lambda: collect_n(card, cuda, jobs, state.pop("n")),
           "o/cpu": lambda: collect_o(np, card, jobs, *state.pop("o")),
           "p/cpu": lambda: collect_p(np, card, jobs, *state.pop("p")),
           "t": t, "u": u, "v": v, "w": w}
    try:
        with ProblemMemo(train, clock):
            failed = run_phases([(name, fns[name]) for name in PHASES],
                                clock)
    finally:    # dry runs (u), examples (w) and jobs no phase collected
        for proc, *_ in state.pop("dry", []):
            proc.kill()
        for proc in state.pop("examples", ({},))[0].values():
            proc.kill()
        jobs.close()
    log(json.dumps({"seconds": clock.seconds}))
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": [kernels_line_entry(kernels[k])
                                for k in counters]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
