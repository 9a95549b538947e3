"""Data-movement planning on the PyTorch/CUDA port: the paper's solvers
on one fog scenario, then one round of the Theorem-3 rule through its
CUDA kernel.

    PYTHONPATH=src python examples/offload_planning_torch.py [--device cpu]

The same comparison as ``examples/offload_planning.py``, on
``repro_torch``. The convex solver and the kernel run on ``--device``
(``cuda`` by default; on the CPU the kernel's plain version runs).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import movement as mv
from repro_torch.core.costs import testbed_like_costs, with_capacity
from repro_torch.core.topology import make_topology
from repro_torch.kernels import offload_greedy as og
from repro_torch.kernels import ops

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

rng = np.random.default_rng(0)
n, T = 128, 12
traces = testbed_like_costs(n, T, rng, f_err=0.6)
adj = make_topology("social", n, rng)
D = rng.poisson(25, (T, n)).astype(float)

capped = with_capacity(traces, 40.0)
plans = {
    "no_movement": mv.no_movement_plan(T, n),
    "greedy_thm3": mv.greedy_linear(traces, adj, device=args.device),
    "greedy+capacity_repair": mv.repair_capacities(
        mv.greedy_linear(capped, adj, device=args.device), capped, adj, D),
    "convex_sqrt": mv.solve_convex(traces, adj, D, error_model="sqrt",
                                   gamma=3.0, iters=300, device=args.device),
}
print(f"{'plan':<24}{'unit':>8}{'process':>9}{'transfer':>9}{'discard':>9}")
for name, plan in plans.items():
    c = mv.plan_cost(plan, traces, D)
    print(f"{name:<24}{c['unit']:>8.3f}{c['process']:>9.1f}"
          f"{c['transfer']:>9.1f}{c['discard']:>9.1f}")


# The same Theorem-3 rule as the hand-written CUDA kernel (one warp a
# row, the min-plus over the row's live links):
def on_device(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(args.device, dtype)


t = 0
before = og.launches
choice, best_j, best_cost = ops.greedy_decision(
    on_device(traces.c_link[t]), on_device(traces.c_node[min(t + 1, T - 1)]),
    on_device(traces.c_node[t]), on_device(traces.f_err[t]),
    on_device(adj, torch.bool))
lab = {0: "process", 1: "offload", 2: "discard"}
frac = {v: float((choice == k).float().mean()) for k, v in lab.items()}
print("\nTheorem-3 kernel, round 0 decision mix:", frac)
print(f"kernel launches: {og.launches - before}")
