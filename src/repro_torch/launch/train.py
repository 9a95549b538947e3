"""Training launcher: the paper's fog experiment on one card.

Network-aware federated learning of an image classifier over n fog
devices, with the data-movement optimizer in the loop:

    python -m repro_torch.launch.train --mode fog --model cnn --n 10 \
        --T 100 --tau 10 --topology full --setting B --costs testbed

The flags and defaults are those of ``python -m repro.launch.train``,
plus ``--device`` (``cuda`` by default; ``cpu`` runs the same path on
the CPU, with the kernels' plain versions). Flags whose code is not
ported yet stop with a message naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core import federated as F
from repro_torch.core import movement as mv
from repro_torch.core.costs import synthetic_costs, testbed_like_costs
from repro_torch.core.hierarchy import TierTree
from repro_torch.core.topology import make_schedule, make_topology
from repro_torch.data import pipeline as pl
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.device import resolve_device


# what --mode lm waits for; serving the model zoo is launch/serve.py
LM_TRAINING = ("model zoo, training slice: train step, optimizers, "
               "FedAvg")


def _unported(what: str, item: int, title: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to repro_torch yet "
                      f"(ROADMAP.md, queue 1 item {item}: {title})")


def solve_setting(setting: str, traces, adj, D, error_model="discard",
                  device=None):
    """Paper Table III settings: A no movement; B perfect information.
    C–E (imperfect information, capacities) are not ported yet."""
    T_, n = D.shape
    if setting == "A":
        return mv.no_movement_plan(T_, n)
    if setting in ("C", "D", "E"):
        raise _unported(f"setting {setting}", 2, "planning")
    if setting != "B":
        raise ValueError(f"unknown setting {setting!r}")
    if error_model != "discard":
        raise _unported(f"error model {error_model!r}", 2, "planning")
    return mv.greedy_linear(traces, adj, device=device)


def _check_ported(args) -> None:
    checks = [
        (args.mode == "lm", "--mode lm", 14, LM_TRAINING),
        (args.setting in ("C", "D", "E"), f"--setting {args.setting}", 2,
         "planning"),
        (args.error_model != "discard", f"--error-model {args.error_model}",
         2, "planning"),
        (args.schedule != "static" or args.churn or args.p_exit
         or args.p_entry, "churn and flap schedules", 8,
         "dynamics and prediction"),
        (args.faults != "none", f"--faults {args.faults}", 9,
         "faults and recovery"),
        (args.checkpoint or args.resume, "--checkpoint/--resume", 9,
         "faults and recovery"),
        (args.engine == "batched", "--engine batched", 11, "sweep engine"),
        (args.engine == "sharded", "--engine sharded", 12, "multi-GPU"),
        (args.sanitize, "--sanitize", 13, "tooling"),
    ]
    for bad, what, item, title in checks:
        if bad:
            raise _unported(what, item, title)


def build_problem(args) -> dict:
    """Everything the plan and the training start from, drawn in the
    reference's order from one ``np.random.default_rng(args.seed)``:
    dataset, config, cost traces, topology, streams, counts D and the
    static schedule."""
    rng = np.random.default_rng(args.seed)
    data = make_image_dataset(n_train=args.n_train, n_test=args.n_test,
                              seed=args.seed)
    cfg = F.FedConfig(n=args.n, T=args.T, tau=args.tau, eta=args.eta,
                      model=args.model, iid=not args.non_iid, seed=args.seed)
    mk = testbed_like_costs if args.costs == "testbed" else synthetic_costs
    traces = mk(cfg.n, cfg.T, rng, f_err=args.f_err)
    adj = make_topology(args.topology, cfg.n, rng,
                        rho=args.rho, costs=traces.c_node.mean(0))
    streams = pl.poisson_streams(cfg.n, cfg.T, data[1], iid=cfg.iid, rng=rng)
    return {"data": data, "cfg": cfg, "traces": traces, "adj": adj,
            "streams": streams, "D": pl.counts(streams),
            "schedule": make_schedule("static", adj, cfg.T)}


def make_hierarchy(args, cfg) -> TierTree | None:
    """The ``--tiers`` tree over the run's devices, or None. Its first
    period must be ``--tau``."""
    if not args.tiers:
        return None
    tree = TierTree.from_spec(args.tiers, cfg.n)
    if tree.taus[0] != cfg.tau:
        raise SystemExit(f"--tiers first period {tree.taus[0]} must equal "
                         f"--tau {cfg.tau}")
    return tree


def run_fog(args) -> dict:
    """The main path: costs → topology → streams → plan → routing →
    training → plan cost. Prints the reference's summary JSON (plus the
    device, pad size and phase times) and returns it with the plan and
    the full training history under ``"plan"`` and ``"history"``."""
    _check_ported(args)
    device = resolve_device(args.device)
    pb = build_problem(args)
    cfg, traces, schedule, D = pb["cfg"], pb["traces"], pb["schedule"], \
        pb["D"]
    hierarchy = make_hierarchy(args, cfg)
    t0 = time.perf_counter()
    plan = solve_setting(args.setting, traces, schedule, D,
                         error_model=args.error_model, device=device)
    t1 = time.perf_counter()
    engine = "scan" if args.engine == "auto" else args.engine
    hist = F.run_network_aware(cfg, pb["data"], traces, pb["adj"], plan,
                               streams=pb["streams"], schedule=schedule,
                               engine=engine, hierarchy=hierarchy,
                               device=device)
    t2 = time.perf_counter()
    cost = mv.plan_cost(plan, traces, D, error_model=args.error_model)
    out = {"mode": "fog", "setting": args.setting, "engine": engine,
           "schedule": "static", "replan": "oracle",
           "n_events": len(schedule.events_in(0, cfg.T)),
           "final_acc": hist["test_acc"][-1] if hist["test_acc"] else None,
           "acc_curve": hist["test_acc"], "cost": cost,
           "sim_before": hist["sim_before"], "sim_after": hist["sim_after"],
           "device": str(device), "pad_size": hist["max_points"],
           "timing": {"plan_s": t1 - t0, "train_s": t2 - t1}}
    if hierarchy is not None:
        out["engine"] = "hierarchical"
        out["hierarchy"] = hist["hierarchy"]
    print(json.dumps(out, default=float, indent=2))
    return {**out, "plan": plan, "history": hist}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["fog", "lm"], default="fog")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda by default; cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    # fog
    ap.add_argument("--model", default="cnn",
                    choices=["cnn", "mlp", "linear"])
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--eta", type=float, default=0.1)
    ap.add_argument("--n-train", type=int, default=20000)
    ap.add_argument("--n-test", type=int, default=4000)
    ap.add_argument("--topology", default="full")
    ap.add_argument("--rho", type=float, default=1.0)
    ap.add_argument("--setting", default="B", choices=list("ABCDE"))
    ap.add_argument("--costs", default="testbed", choices=["testbed",
                                                           "synthetic"])
    ap.add_argument("--error-model", default="discard",
                    choices=["discard", "neg_G", "sqrt"])
    ap.add_argument("--f-err", type=float, default=0.7)
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--p-exit", type=float, default=0.0)
    ap.add_argument("--p-entry", type=float, default=0.0)
    ap.add_argument("--schedule", default="static",
                    choices=["static", "churn", "flap"])
    ap.add_argument("--churn", type=float, default=0.0)
    ap.add_argument("--p-flap", type=float, default=0.05)
    ap.add_argument("--p-recover", type=float, default=0.5)
    ap.add_argument("--replan", default="oracle",
                    choices=["oracle", "predict", "once"],
                    help="what the planner sees under a dynamic schedule; "
                         "on the static schedule every mode plans on the "
                         "true network")
    ap.add_argument("--plan-once", action="store_true")
    ap.add_argument("--tiers", default=None, metavar="SPEC")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "scan", "sharded", "batched",
                             "legacy"])
    ap.add_argument("--faults", default="none",
                    choices=["none", "straggle", "drop", "crash",
                             "corrupt", "mixed"])
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--corrupt-mode", default="nan",
                    choices=["nan", "inf", "scale"])
    ap.add_argument("--quorum", type=float, default=0.0)
    ap.add_argument("--unguarded", action="store_true")
    ap.add_argument("--checkpoint", default=None, metavar="PATH")
    ap.add_argument("--resume", default=None, metavar="CKPT")
    ap.add_argument("--sanitize", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "lm":
        raise _unported("--mode lm", 14, LM_TRAINING)
    return run_fog(args)


if __name__ == "__main__":
    main()
