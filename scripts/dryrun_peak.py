"""What is live at the peak of one production dry-run step.

Traces the step as ``python -m repro_torch.launch.dryrun`` does (a fake
group, the production 16x16 mesh, meta DTensors) and prints one JSON
line: the torch version, the peak of live local bytes, and the largest
local storages live when it was reached, each with the aten op that
made it, its shape, dtype, bytes and the last frames of the port's
Python stack that ran the op.

Usage:
  python scripts/dryrun_peak.py --arch qwen3-14b [--shape train_4k] [--top 12]
"""
from __future__ import annotations

import argparse
import json
import traceback

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as mesh_lib


class PeakTraffic(DR.LocalTraffic):
    """``LocalTraffic`` that also names each live storage and keeps the
    ``top`` largest of those live at the peak."""

    def __init__(self, top: int):
        super().__init__()
        self.top, self.op = top, None
        self.made: dict[int, list] = {}
        self.at_peak: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.op = func._overloadpacket.__name__
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _track(self, args, kwargs, out) -> None:
        before = set(self._live)
        super()._track(args, kwargs, out)
        new = set(self._live) - before
        if not new:
            return
        stack = [f"{f.filename.split('/src/')[-1]}:{f.lineno} {f.name}"
                 for f in traceback.extract_stack()
                 if "repro_torch" in f.filename
                 and not f.filename.endswith("launch/dryrun.py")][-4:]
        for t in DR._tensors(out):
            key = t.untyped_storage()._cdata
            if key in new:
                self.made[key] = [self.op, list(t.shape), str(t.dtype),
                                  self._live[key], stack]
        if self.live_bytes >= self.peak_bytes:
            live = [self.made[k] for k in self._live if k in self.made]
            self.at_peak = sorted(live, key=lambda m: -m[3])[:self.top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    mesh_lib.init_fake_process_group(256)
    mesh = mesh_lib.make_production_mesh(device="cpu")
    step, step_args, _ = DR.build_step(get_config(args.arch),
                                       INPUT_SHAPES[args.shape], mesh)
    local = PeakTraffic(args.top)
    with DR._uncounted_shape_inference(local), local, \
            implicit_replication():
        step(*step_args)
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "torch": torch.__version__,
                      "peak": local.peak_bytes, "at_peak": local.at_peak}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
