#!/usr/bin/env python3
"""Time other builds of the Theorem-3 kernel beside the port's, on one card.

    python3 scripts/offload_greedy_ab.py NAME=OTHER.cu [NAME=OTHER.cu ...]

Each OTHER.cu is a version of
``src/repro_torch/kernels/csrc/offload_greedy.cu`` with the same C entry
point (``offload_greedy_launch``), for example an earlier commit's,
written out with ``git show REV:src/repro_torch/kernels/csrc/
offload_greedy.cu > build/ab/old.cu`` (``build/`` is git-ignored). The
port's own source (as ``port``) and every OTHER.cu are built with the
port's ``nvcc`` flags, one ``nvcc`` each, started together, into
``build/ab/``, and called through one ctypes wrapper, so the versions
differ in their source alone. On the inputs of ``chip_smoke.py``'s
phase (d) (the fog-scale flags at random topology ρ=0.1 and at full
topology) every version is held bit for bit to the plain version, then
timed in turns by ``chip_smoke._time_ms`` (median of 30 launches, each
after an L2 flush), three rounds, the order reversed every other round,
the card's clocks, power and temperature read before each round. Each
version is timed twice a round: with the card spinning before the start
event (NAME: the card's time alone) and without (NAME/host: the window
also holds the part of the host's launch time that the card waits
for). Prints one log line per input and a JSON line last.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, src in sources.items():
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        lib = out / f"lib{name}-{digest}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        print(f"built {name}: nvcc exit {proc.returncode}\n{log.strip()}",
              flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} did not build")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def as_wrapper(torch, lib):
    """``offload_greedy_batched`` through a build's entry point."""
    fn = lib.offload_greedy_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(c_link, c_next, c_node, f_err, adj):
        T, n = c_node.shape
        opts = dict(device=c_link.device)
        outs = (torch.empty((T, n), dtype=torch.int32, **opts),
                torch.empty((T, n), dtype=torch.int32, **opts),
                torch.empty((T, n), dtype=torch.float32, **opts))
        err = fn(c_link.data_ptr(), c_next.data_ptr(), c_node.data_ptr(),
                 f_err.data_ptr(), adj.data_ptr(),
                 *(o.data_ptr() for o in outs), T, n,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return outs

    return call


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not argv or any("=" not in a for a in argv):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("offload_greedy_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import movement as mv
    from repro_torch.kernels import _build
    from repro_torch.kernels import offload_greedy as og
    from repro_torch.launch import train

    card = cs.card_line()
    sources = {"port": _build.source_path("offload_greedy")}
    sources.update((k, Path(v)) for k, v in (a.split("=", 1) for a in argv))
    fns = {}
    for k, lib in build(sources).items():
        fns[k] = fns[f"{k}/host"] = as_wrapper(torch, lib)
    cuda = torch.device("cuda")
    flush = cs.flush_buffer(torch, cuda)
    result = {"card": card, "inputs": {}}
    for name, flags in (("random rho=0.1", cs.FOG_ARGV),
                        ("full", cs.FULL_ARGV)):
        pb = train.build_problem(train.parse_args(flags))
        ins = mv.device_inputs(pb["traces"], pb["schedule"], cuda)
        del pb
        want = og.offload_greedy_plain(*ins)
        for k, fn in fns.items():
            if not all(torch.equal(a, b) for a, b in zip(fn(*ins), want)):
                raise AssertionError(f"{k} != plain version on {name}")
        times, states = cs._in_turns(torch, fns, ins, flush)
        bounds = cs._greedy_bounds(torch, ins)
        result["inputs"][name] = dict(
            bounds, states=states, ms=times,
            spread={k: cs._spread(v) for k, v in times.items()})
        print(f"{name}: all versions equal the plain version bitwise; ms "
              f"in turns {times}; min/median/max "
              f"{result['inputs'][name]['spread']}; bound "
              f"{bounds['bound_ms']} ms, sector floor "
              f"{bounds['sector_floor_ms']} ms; card before each round "
              f"{states} [{card}]", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
