#!/usr/bin/env python3
"""Time other builds of the segment-reduce kernel beside the port's, on one card.

    python3 scripts/segment_reduce_ab.py [NAME=OTHER.cu ...] [--parent DIR]

Each OTHER.cu is a version of
``src/repro_torch/kernels/csrc/segment_reduce.cu`` with the same 1-D C
entry point (``segment_sum_launch``), for example an earlier commit's,
written out with ``git show REV:src/repro_torch/kernels/csrc/
segment_reduce.cu > build/ab/old.cu`` (``build/`` is git-ignored).
Every version is built with the port's ``nvcc`` flags, one ``nvcc``
each, started together, into ``build/ab/``, and called through one
ctypes wrapper, so the versions differ in their source alone.

Inputs, made on the card from fixed seeds at the shapes of the port's
launch sites: the tier-1 ``w1`` leaf of the tiered fog-scale run (m =
1000 rows of P = 156,800 into the 32 groups of ``--tiers
32@5,4@10,1@20``, H-weighted), the tier-1 ``w`` leaf of ``hier_scale``
(m = 102,400 rows of 490 into 1024 contiguous groups), ``counts_flat``
(5.12 M cells, Poisson(1) samples a cell, sorted keys), one segment of
2**20 elements, 50 M elements over 1,000,003 segments with ids drawn
at random (out-of-range ones among them), and 8 M over 2048 (about
4096 elements a segment, every one past the kernel's wide threshold). On the two leaves each version's route is timed:
the row kernel (the port's), and the product followed by the 1-D
kernel over the E-length ids ``g·P + p`` (every build; an OTHER's is
its commit's route); on the others the 1-D kernel. Every route is held
bit for bit to the port's, then all are timed in turns with
``index_add_`` by ``chip_smoke._time_ms`` (median of 30 launches, each
after an L2 flush, the card spinning before the start event), three
rounds, the order reversed every other round, the card's clocks, power
and temperature read before each round; the layouts' build times once
each. The port's build is also read by ``cuobjdump -sass``: its
kernels' FFMA, FADD and FMUL counts (a sum has no FFMA).

``--parent DIR`` (an unpacked earlier tree, e.g. ``git archive REV |
tar -x -C build/ab/parent``) also runs ``chip_smoke``'s tiered
fog-scale path (phase (f)) in a process of its own from DIR's source
and from this one's, in turns (parent, port, port, parent), and reports
each run's ``max_memory_allocated`` and train seconds.

Prints one log line per input and a JSON line last, and writes the JSON
to ``chiprun_out/segment_reduce_ab.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from scripts.offload_greedy_ab import build  # noqa: E402


def sass_fma(lib_path: str) -> dict:
    """Fused multiply-adds (FFMA) in each kernel's SASS, by
    ``cuobjdump -sass``: the sums must have none (every product and add
    rounds on its own)."""
    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"FFMA": 0, "FADD": 0, "FMUL": 0}
        elif fn is not None:
            for op in counts[fn]:
                if f" {op} " in line or f" {op}." in line:
                    counts[fn][op] += 1
    print(f"SASS op counts by kernel: {counts}", flush=True)
    return counts


def entry(lib, name):
    """C entry point ``name`` of a build, typed as the port's wrapper
    types it."""
    from repro_torch.kernels import segment_reduce as sr

    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p, *sr._ARGTYPES[name], ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flat_kernel(torch, lib):
    """``segment_sum`` through a build's 1-D entry point."""
    fn = entry(lib, "segment_sum_launch")

    def call(data, layout):
        out = torch.empty(layout.num_segments, device=data.device)
        err = fn(data.data_ptr(), layout.perm.data_ptr(),
                 layout.offsets.data_ptr(), out.data_ptr(),
                 layout.num_segments, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    return call


def row_kernel(torch, lib):
    """``segment_sum_rows`` through a build's row entry point."""
    fn = entry(lib, "segment_sum_rows_launch")

    def call(data, scale, layout):
        G, P = layout.num_segments, data.shape[1]
        out = torch.empty((G, P), device=data.device)
        err = fn(data.data_ptr(), scale.data_ptr(), layout.perm.data_ptr(),
                 layout.offsets.data_ptr(), out.data_ptr(), G, P,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    return call


def leaf(torch, sr, m, P, gids, seed):
    """(data, H, ids, row layout, flat ids, flat layout) of one leaf."""
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(seed)
    data = torch.randn((m, P), generator=g, device=cuda)
    H = torch.randint(0, 40, (m,), generator=g, device=cuda).float()
    ids = torch.as_tensor(gids, dtype=torch.int32, device=cuda)
    G = int(gids.max()) + 1
    fids = (ids[:, None] * P + torch.arange(P, dtype=torch.int32,
                                            device=cuda)[None]).reshape(-1)
    return (data, H, ids, sr.segment_layout(ids, G), fids,
            sr.segment_layout(fids, G * P))


def leaf_routes(torch, flat, rows, data, H, ids, lay, flay):
    """Name -> zero-argument call of every route on one leaf."""
    G, P = lay.num_segments, data.shape[1]
    fns = {}
    for k, f in rows.items():
        fns[f"{k}:rows"] = lambda f=f: f(data, H, lay)
    for k, f in flat.items():
        fns[f"{k}:route"] = lambda f=f: f(
            (data * H[:, None]).reshape(-1), flay).reshape(G, P)
    idx64 = ids.long()
    prod = data * H[:, None]
    fns["index_add_"] = lambda: torch.zeros(
        (G, P), device=data.device).index_add_(0, idx64, prod)
    return fns


def time_input(torch, name, fns, exact, flush, card, extra):
    """Check ``exact`` routes against the first, then time all."""
    first = fns[exact[0]]()
    for k in exact[1:]:
        if not torch.equal(fns[k]().view(torch.int32),
                           first.view(torch.int32)):
            raise AssertionError(f"{k} != {exact[0]} on {name}")
    times, states = cs._in_turns(torch, fns, (), flush)
    res = dict(extra, states=states, ms=times,
               spread={k: cs._spread(v) for k, v in times.items()})
    print(f"{name}: {', '.join(exact)} bitwise equal; min/median/max "
          f"{res['spread']}; {extra}; card before each round {states} "
          f"[{card}]", flush=True)
    return res


PARENT_RUN = """
import json, sys, time
sys.path.insert(0, {src!r})
import torch
from repro_torch.launch import train
torch.cuda.reset_peak_memory_stats()
out = train.main({argv!r})
print("AB_RESULT " + json.dumps({{
    "max_memory_allocated": torch.cuda.max_memory_allocated(),
    "train_s": out["timing"]["train_s"]}}))
"""


def tiered_runs(parent: Path, card):
    """Phase (f)'s path from ``parent``'s source and this tree's, in
    turns, each in a process of its own."""
    res = {"parent": [], "port": []}
    for who in ("parent", "port", "port", "parent"):
        top = parent if who == "parent" else ROOT
        code = PARENT_RUN.format(src=str(top / "src"),
                                 argv=cs.TIERED_FOG_ARGV)
        run = subprocess.run([sys.executable, "-c", code], cwd=top,
                             capture_output=True, text=True)
        line = [x for x in run.stdout.splitlines()
                if x.startswith("AB_RESULT ")]
        if run.returncode != 0 or not line:
            raise RuntimeError(f"{who} tiered run failed:\n{run.stderr}")
        res[who].append(json.loads(line[-1][len("AB_RESULT "):]))
        print(f"tiered fog scale ({who}): {res[who][-1]} [{card}]",
              flush=True)
    return res


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(usage=__doc__.split("\n\n")[1])
    ap.add_argument("others", nargs="*", metavar="NAME=OTHER.cu")
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args(argv)
    if any("=" not in a for a in args.others):
        ap.error("each OTHER is NAME=FILE.cu")
    if not torch.cuda.is_available():
        print("segment_reduce_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core.hierarchy import TierTree
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_reduce as sr

    card = cs.card_line()
    port = _build.source_path("segment_reduce")
    sources = {"port": port}
    sources.update((k, Path(v))
                   for k, v in (a.split("=", 1) for a in args.others))
    libs = build(sources)
    sass = sass_fma(libs["port"]._name)
    flat = {k: flat_kernel(torch, lib) for k, lib in libs.items()}
    rows = {"port": row_kernel(torch, libs["port"])}
    cuda = torch.device("cuda")
    flush = cs.flush_buffer(torch, cuda)
    result = {"card": card, "sass_ops": sass, "inputs": {}}

    leaves = (
        ("tier-1 w1 (fog scale)", 1000, 156_800,
         TierTree.from_spec("32@5,4@10,1@20", 1000).parents[0]),
        ("hier_scale tier-1 w", 102_400, 490,
         TierTree.balanced(102_400, (1024, 32, 1), (5, 10, 20)).parents[0]))
    for seed, (name, m, P, gids) in enumerate(leaves):
        data, H, ids, lay, fids, flay = leaf(torch, sr, m, P, gids, seed)
        G = lay.num_segments
        E = m * P
        extra = {
            "shape": {"m": m, "P": P, "G": G},
            "row_bound_ms": 1e3 * (4 * E + 8 * m + 4 * G * P)
            / cs.HBM_BYTES_PER_S,
            "flat_bound_ms": 1e3 * (8 * E + 4 * G * P) / cs.HBM_BYTES_PER_S,
            "product_pass_ms": 1e3 * (8 * E + 4 * m) / cs.HBM_BYTES_PER_S,
            "row_layout_ms": cs._time_ms(torch, sr.segment_layout, (ids, G),
                                         flush, reps=10),
            "flat_layout_ms": cs._time_ms(torch, sr.segment_layout,
                                          (fids, G * P), flush, reps=10)}
        fns = leaf_routes(torch, flat, rows, data, H, ids, lay, flay)
        result["inputs"][name] = time_input(
            torch, name, fns, [k for k in fns if k != "index_add_"], flush,
            card, extra)
        del data, H, ids, lay, fids, flay, fns
        torch.cuda.empty_cache()

    rng = np.random.default_rng(7)
    keys = np.repeat(np.arange(5_120_000), rng.poisson(1.0, 5_120_000))
    g = torch.Generator(device=cuda).manual_seed(5)
    flats = (
        ("counts_flat", torch.ones(keys.shape[0], device=cuda),
         torch.from_numpy(keys.astype(np.int32)).to(cuda), 5_120_000),
        ("one huge segment", torch.randn(1 << 20, generator=g, device=cuda),
         torch.full((1 << 20,), 3, dtype=torch.int32, device=cuda), 5),
        ("random 50M into 1M", torch.randn(50_000_000, generator=g,
                                           device=cuda),
         torch.randint(-1_000, 1_001_003, (50_000_000,), generator=g,
                       device=cuda, dtype=torch.int32), 1_000_003),
        ("random 8M into 2048", torch.randn(8_388_608, generator=g,
                                            device=cuda),
         torch.randint(0, 2048, (8_388_608,), generator=g, device=cuda,
                       dtype=torch.int32), 2048))
    for name, d, i, S in flats:
        lay = sr.segment_layout(i, S)
        fns = {k: (lambda f=f: f(d, lay)) for k, f in flat.items()}
        idx64 = i.long()
        valid = (i >= 0) & (i < S)
        dv, iv = d[valid], idx64[valid]
        fns["index_add_"] = lambda: torch.zeros(S, device=cuda).index_add_(
            0, iv, dv)
        E = d.shape[0]
        extra = {"shape": {"E": E, "S": S},
                 "bound_ms": 1e3 * (8 * E + 4 * S) / cs.HBM_BYTES_PER_S,
                 "layout_ms": cs._time_ms(torch, sr.segment_layout, (i, S),
                                          flush, reps=10)}
        result["inputs"][name] = time_input(torch, name, fns, list(flat),
                                            flush, card, extra)
        del d, i, lay, fns, dv, iv, idx64, valid
        torch.cuda.empty_cache()

    if args.parent is not None:
        result["tiered_fog_scale"] = tiered_runs(args.parent.resolve(), card)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "segment_reduce_ab.json").write_text(json.dumps(result))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
