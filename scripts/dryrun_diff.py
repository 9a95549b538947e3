"""Compare two sets of dry-run rows combo by combo.

Reads the JSONL rows that ``python -m repro_torch.launch.dryrun --out``
writes (each argument a file or a glob of files) and prints, for every
(arch, shape, mesh) in both, the peak of live local bytes
(``temp_size_in_bytes``), ``flops_per_device``, ``bytes_per_device`` and
the collectives' moved bytes a device, before and after, then which
columns changed by shape kind (the whole ``memory`` block and the
collectives' counts and bytes by op included).

Usage:
  python scripts/dryrun_diff.py 'before/*.jsonl' 'after/*.jsonl'
      [--shape train_4k] [--json OUT]
"""
from __future__ import annotations

import argparse
import glob
import json

COLUMNS = {"peak": lambda r: r["memory"]["temp_size_in_bytes"],
           "flops": lambda r: r["flops_per_device"],
           "bytes": lambda r: r["bytes_per_device"],
           "moved": lambda r: r["collectives"]["moved_bytes_per_device"],
           "memory": lambda r: r["memory"],
           "collectives": lambda r: r["collectives"]["per_op"]}


def load(pattern: str) -> dict:
    """(arch, shape, mesh) -> row; a FAIL row is kept as it is."""
    rows = {}
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                mesh = r.get("mesh") or ("2x16x16" if r.get("multi_pod")
                                         else "16x16")
                rows[(r["arch"], r["shape"], mesh)] = r
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    before, after = load(args.before), load(args.after)
    out, changed = [], {}
    for key in sorted(before.keys() & after.keys()):
        if args.shape and key[1] != args.shape:
            continue
        b, a = before[key], after[key]
        if "error" in b or "error" in a:
            print(*key, "FAIL", b.get("error"), a.get("error"))
            continue
        row = {"arch": key[0], "shape": key[1], "mesh": key[2],
               "torch": a["torch"]}
        for name, get in COLUMNS.items():
            row[name] = [get(b), get(a)]
            if get(b) != get(a):
                changed.setdefault(a["kind"], set()).add(name)
        out.append(row)
        print(f"{key[0]:18s} {key[1]:11s} {key[2]:8s} peak "
              f"{row['peak'][0]:>16,} -> {row['peak'][1]:>16,}  flops "
              f"{'=' if row['flops'][0] == row['flops'][1] else 'DIFF'}  "
              f"moved {row['moved'][0]:.4g} -> {row['moved'][1]:.4g}")
    print(f"{len(out)} combos in both of {len(before)} / {len(after)}; "
          f"changed columns by kind: "
          f"{ {k: sorted(v) for k, v in changed.items()} }")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
