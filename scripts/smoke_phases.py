#!/usr/bin/env python3
"""Side by side, the phase times and the quoted numbers of chip_smoke.py logs.

    python3 scripts/smoke_phases.py A.log B.log [...]

Reads each log's ``phase (X) ok in S s`` lines (and, where the log has
it, the ``{"seconds": ...}`` line of every phase and part), and the
numbers PERF.md quotes from a smoke run: the fog-scale train time (c),
the zamba2-7b prefill and decode (j), the last families' prefill,
decode and step times (t), zamba2-7b's training step (s2), the sweep
bucket's walls (r2), the sparse run (q1), and each kernel's time,
launches and error from the kernels line. Prints one table of phase
seconds and one of those numbers, a column per log.
"""
from __future__ import annotations

import json
import re
import sys

QUOTED = {
    "(c) train s": r"^\(c\) fog scale .*?train ([0-9.]+) s",
    "(j) prefill warm s": r"^\(j\) zamba2-7b full \(.*?warm ([0-9.]+) s",
    "(j) decode tokens/s": r"^\(j\) zamba2-7b full greedy.*? ([0-9.]+) decode",
    "(s2) warm step s": r"^\(s2\) zamba2-7b at full.*?median ([0-9.]+) s",
    "(t1) prefill warm s": r"^\(t1\) olmoe.*?warm ([0-9.]+) s",
    "(t1) decode tokens/s": r"^\(t1\) olmoe.*? ([0-9.]+) decode tokens",
    "(t2) prefill warm s": r"^\(t2\) mixtral.*?warm ([0-9.]+) s",
    "(t2) decode tokens/s": r"^\(t2\) mixtral.*? ([0-9.]+) decode tokens/s",
    "(t3) warm step s": r"^\(t3\) olmoe-1b-7b training.*?median ([0-9.]+) s",
    "(t4) prefill warm s": r"^\(t4\) whisper.*?prefill .*?warm ([0-9.]+) s",
    "(t4) decode tokens/s": r"^\(t4\) whisper.*? ([0-9.]+) decode tokens/s",
    "(t4) warm step s": r"^\(t4\) whisper-large-v3 train.*?median ([0-9.]+)",
    "(t5) prefill warm s": r"^\(t5\) phi-3.*?warm ([0-9.]+) s",
    "(r2) dense, ragged wall s": r"^\(r2\) sweep ([0-9.]+) s dense, ([0-9.]+)",
    "(q1) train s": r"^\(q1\) train n=102400.*?samples, P \d+, ([0-9.]+) s",
}


def read(path):
    phases, seconds, quoted, kernels = {}, {}, {}, {}
    with open(path) as f:
        for line in f:
            m = re.match(r"phase \((\S+)\) (ok|FAILED) in ([0-9.]+) s", line)
            if m:
                phases[m[1]] = float(m[3]) if m[2] == "ok" else "FAILED"
            elif line.startswith('{"seconds"'):
                seconds = json.loads(line)["seconds"]
            elif line.startswith('{"kernels"'):
                for k in json.loads(line)["kernels"]:
                    kernels[k["name"]] = (k["ms"], k["launches"],
                                          k["max_abs_err"])
            for name, rx in QUOTED.items():
                m = re.search(rx, line)
                if m and name not in quoted:
                    quoted[name] = " / ".join(m.groups())
    return phases, seconds, quoted, kernels


def main(paths):
    logs = [read(p) for p in paths]
    names = list(dict.fromkeys(k for ph, *_ in logs for k in ph))
    parts = list(dict.fromkeys(k for _, sec, *_ in logs for k in sec
                               if not k.startswith("(")))
    print("| phase or part | " + " | ".join(paths) + " |")
    print("| - " * (len(paths) + 1) + "|")
    for n in names:
        print(f"| ({n}) | " + " | ".join(
            str(ph.get(n, "")) for ph, *_ in logs) + " |")
    print("| sum of phases | " + " | ".join(
        f"{sum(v for v in ph.values() if isinstance(v, float)):.1f}"
        for ph, *_ in logs) + " |")
    for n in parts:
        print(f"| {n} | " + " | ".join(
            str(sec.get(n, "")) for _, sec, *_ in logs) + " |")
    print()
    print("| quoted number | " + " | ".join(paths) + " |")
    print("| - " * (len(paths) + 1) + "|")
    for n in QUOTED:
        print(f"| {n} | " + " | ".join(
            q.get(n, "") for _, _, q, _ in logs) + " |")
    for k in dict.fromkeys(k for *_, ks in logs for k in ks):
        print(f"| {k} ms, launches, max_abs_err | " + " | ".join(
            ", ".join(map(str, ks.get(k, ()))) for *_, ks in logs) + " |")


if __name__ == "__main__":
    main(sys.argv[1:])
