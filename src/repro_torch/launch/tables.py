"""Paper Tables III and IV through the port.

    python -m repro_torch.launch.tables --only table3,table4 [--quick] \
        [--device cpu] [--out PATH]

One fog experiment = costs → topology → streams → plan → (training) →
plan cost, as :func:`benchmarks.fog.fog_experiment` runs it for the
reference, on the port and on ``--device`` (``cuda`` by default; the
convex solver and, at n ≥ 256 on a card, the Theorem-3 kernel run
there). Table III sweeps the settings A–E (paper: no movement, perfect
information, imperfect information, capacities, both); Table IV the
discard-cost models f·D·r, −f·G and f/√G under settings B and D. The
rows and headlines are printed as JSON, and written to ``--out`` when
given; nothing is written under ``results/``, which holds the
reference's artifacts.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.core import federated as F
from repro_torch.core import movement as mv
from repro_torch.core.costs import (synthetic_costs, testbed_like_costs,
                                    with_capacity)
from repro_torch.core.topology import make_topology
from repro_torch.data import pipeline as pl
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.train import solve_setting


@dataclasses.dataclass(frozen=True)
class BenchScale:
    n_train: int = 20_000
    n_test: int = 4_000
    T: int = 40
    tau: int = 5
    eta: float = 0.1


QUICK = BenchScale(n_train=8_000, n_test=2_000, T=20, tau=5)
DEFAULT = BenchScale()


@functools.lru_cache(maxsize=2)
def dataset(n_train: int, n_test: int, seed: int = 0):
    return make_image_dataset(n_train=n_train, n_test=n_test, seed=seed)


def fog_experiment(*, scale: BenchScale, n=10, model="mlp", iid=True,
                   costs="testbed", topology="full", rho=1.0,
                   setting="B", error_model="discard", medium="wifi",
                   f_err=0.7, seed=0, train=True, device=None,
                   z0=None) -> dict:
    """One experiment; returns the cost decomposition and, with
    ``train``, the accuracy curve. The plan is the training CLI's
    :func:`~repro_torch.launch.train.solve_setting` at 400 convex
    iterations, as the reference's benches plan; ``z0`` is the solver's
    initial point (None: its default)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = dataset(scale.n_train, scale.n_test)
    cfg = F.FedConfig(n=n, T=scale.T, tau=scale.tau, eta=scale.eta,
                      model=model, iid=iid, seed=seed)
    if costs == "testbed":
        traces = testbed_like_costs(n, scale.T, rng, f_err=f_err,
                                    medium=medium)
    else:
        traces = synthetic_costs(n, scale.T, rng, f_err=f_err)
    adj = make_topology(topology, n, rng, rho=rho,
                        costs=traces.c_node.mean(0))
    streams = pl.poisson_streams(n, scale.T, data[1], iid=iid, rng=rng)
    D = pl.counts(streams)
    plan = solve_setting(setting, traces, adj, D, error_model=error_model,
                         device=device, z0=z0, iters=400)
    if setting in ("D", "E"):
        traces = with_capacity(traces, float(D.mean()))
    cost = mv.plan_cost(plan, traces, D, error_model=error_model)
    out = {"setting": setting, "cost": cost, "n": n, "rho": rho,
           "tau": scale.tau, "topology": topology, "iid": iid}
    if train:
        hist = F.run_network_aware(cfg, data, traces, adj, plan,
                                   streams=streams, device=device)
        out.update(acc=hist["test_acc"][-1],
                   acc_curve=hist["test_acc"],
                   sim_before=hist["sim_before"],
                   sim_after=hist["sim_after"],
                   avg_active=float(np.mean([a.sum()
                                             for a in hist["active"]])))
    return out


def table3_settings(scale: BenchScale, device=None) -> dict:
    """Settings A–E: cost decomposition, and accuracy for A and B."""
    rows = {}
    for setting in "ABCDE":
        r = fog_experiment(scale=scale, setting=setting, model="mlp",
                           train=setting in "AB", device=device)
        rows[setting] = {"cost": r["cost"], "acc": r.get("acc")}
    unit_A = rows["A"]["cost"]["unit"]
    unit_B = rows["B"]["cost"]["unit"]
    return {"rows": rows, "headline": {
        "unit_cost_reduction_A_to_B": 1 - unit_B / unit_A,
        "claim_geq_40pct": bool((1 - unit_B / unit_A) >= 0.40),
        "process_reduction": 1 - rows["B"]["cost"]["process"]
        / max(rows["A"]["cost"]["process"], 1e-9)}}


def table4_error_costs(scale: BenchScale, device=None) -> dict:
    """The discard-cost models f·D·r, −f·G and f/√G under settings B
    and D; accuracy for B."""
    rows = {}
    for em in ("discard", "neg_G", "sqrt"):
        for setting in ("B", "D"):
            r = fog_experiment(scale=scale, setting=setting,
                               error_model=em, train=(setting == "B"),
                               device=device)
            rows[f"{em}/{setting}"] = {"cost": r["cost"],
                                       "acc": r.get("acc")}
    return {"rows": rows, "headline": {
        "negG_processes_most": bool(
            rows["neg_G/B"]["cost"]["processed_frac"]
            >= rows["sqrt/B"]["cost"]["processed_frac"] - 0.05),
        "negG_total_highest": bool(
            rows["neg_G/B"]["cost"]["process"]
            + rows["neg_G/B"]["cost"]["transfer"]
            >= rows["discard/B"]["cost"]["process"]
            + rows["discard/B"]["cost"]["transfer"] - 1e-6)}}


TABLES = {"table3": table3_settings, "table4": table4_error_costs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="table3,table4",
                    help=f"comma-separated subset of {sorted(TABLES)}")
    ap.add_argument("--quick", action="store_true",
                    help="the reference's CI scale (8,000 samples, T=20)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the JSON here (never under results/)")
    args = ap.parse_args(argv)
    names = [s for s in args.only.split(",") if s]
    unknown = sorted(set(names) - set(TABLES))
    if unknown:
        raise SystemExit(f"unknown table(s) {unknown}; choose from "
                         f"{sorted(TABLES)}")
    results = Path(__file__).resolve().parents[3] / "results"
    if args.out and results in Path(args.out).resolve().parents:
        raise SystemExit(f"--out {args.out}: results/ holds the "
                         "reference's artifacts; write elsewhere")
    scale = QUICK if args.quick else DEFAULT
    device = resolve_device(args.device)
    out = {"device": str(device), "scale": dataclasses.asdict(scale)}
    for name in names:
        t0 = time.perf_counter()
        out[name] = TABLES[name](scale, device)
        out[name]["seconds"] = time.perf_counter() - t0
    text = json.dumps(out, default=float, indent=2)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return out


if __name__ == "__main__":
    main()
