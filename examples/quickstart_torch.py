"""Quickstart on the PyTorch/CUDA port: network-aware federated learning
in ~40 lines.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The same experiment as ``examples/quickstart.py``, on ``repro_torch``:
training runs on ``--device`` (``cuda`` by default).
"""
import argparse

import numpy as np

from repro_torch.core import federated as F
from repro_torch.core import movement as mv
from repro_torch.core.costs import testbed_like_costs
from repro_torch.core.topology import make_topology
from repro_torch.data import pipeline as pl
from repro_torch.data.synthetic import make_image_dataset

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# 1. A fog network: 8 devices, testbed-like correlated costs, full graph.
rng = np.random.default_rng(0)
cfg = F.FedConfig(n=8, T=30, tau=5, eta=0.1, model="mlp", seed=0)
traces = testbed_like_costs(cfg.n, cfg.T, rng, f_err=0.7)
adj = make_topology("full", cfg.n, rng)

# 2. Data: synthetic 10-class images, Poisson arrivals per device.
data = make_image_dataset(n_train=12_000, n_test=2_000, seed=0)
streams = pl.poisson_streams(cfg.n, cfg.T, data[1], iid=True, rng=rng)
D = pl.counts(streams)

# 3. The paper's optimization (Theorem 3 greedy for linear discard cost).
plan = mv.greedy_linear(traces, adj, device=args.device)
cost = mv.plan_cost(plan, traces, D)
base = mv.plan_cost(mv.no_movement_plan(cfg.T, cfg.n), traces, D)
print(f"unit cost: {cost['unit']!r} vs no-movement {base['unit']!r} "
      f"({100 * (1 - cost['unit'] / base['unit']):.0f}% saved)")

# 4. Train: per-device SGD + H_i-weighted aggregation every tau rounds.
hist = F.run_network_aware(cfg, data, traces, adj, plan, streams=streams,
                           device=args.device)
print(f"test accuracy: {hist['test_acc'][-1]:.3f} "
      f"(federated no-movement would process every collected point)")
