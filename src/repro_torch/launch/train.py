"""Training launcher: the paper's fog experiment on one card.

Network-aware federated learning of an image classifier over n fog
devices, with the data-movement optimizer in the loop:

    python -m repro_torch.launch.train --mode fog --model cnn --n 10 \
        --T 100 --tau 10 --topology full --setting B --costs testbed

A changing network: ``--churn P`` (devices exit and re-enter with
probability P a round) or ``--schedule flap`` (links fail and recover),
with ``--replan oracle|predict|once`` for what the planner sees; the
plan is then realized against the true schedule.

Unannounced failures: ``--faults straggle|drop|crash|corrupt|mixed`` at
``--fault-rate`` (``--corrupt-mode nan|inf|scale``), aggregated through
the guard (``--unguarded`` turns it off) and gated by ``--quorum``;
``--checkpoint PATH`` snapshots the scan engine at every window
boundary and ``--resume PATH`` continues such a snapshot bit for bit.

``--engine batched`` trains through the sweep engine with one scenario
(exact pad sizes; eq. (4) as a sequential sum, through the
segment-reduce kernel's row form on the card); ``--engine sharded``
splits the fog devices across the ranks of the default process group
(a world of one without ``torchrun``), eq. (4) an all-reduce:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --mode fog \
        --device cpu --engine sharded --model mlp --n 5

``--engine auto`` is sharded under a launcher's world of more than one
rank and scan otherwise. Every rank runs the whole command; rank 0
prints the summary.

``--mode lm`` trains a model of the zoo (any registry arch) on
synthetic tokens, the batches routed and weighted by a
Theorem-3 plan across ``--data-shards`` shards, with the train step or,
with ``--lm-tau`` > 1, FedAvg rounds of τ local steps:

    python -m repro_torch.launch.train --mode lm --arch zamba2-7b \
        --steps 40 --batch 8 --seq 128

As in the reference, ``--smoke`` is on whatever the command line says
(the smoke config of ``--arch``, ``--layers`` overriding its depth), and
the shard count is ``min(--data-shards, cards)``. Under ``torchrun`` the
cards are the world's ranks, and a FedAvg round whose shard count is the
world size runs shard r on rank r, eq. (4) an all-reduce over the data
mesh's group.

The flags and defaults are those of ``python -m repro.launch.train``,
plus ``--device`` (``cuda`` by default; ``cpu`` runs the same path on
the CPU, with the kernels' plain versions). Flags whose code is not
ported yet stop with a message naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.core import estimator as est
from repro_torch.core import faults as fl
from repro_torch.core import federated as F
from repro_torch.core.engine import resolve_engine
from repro_torch.core import movement as mv
from repro_torch.core import sanitize as sz
from repro_torch.core.costs import (ici_costs, synthetic_costs,
                                    testbed_like_costs, with_capacity)
from repro_torch.core.hierarchy import TierTree
from repro_torch.core.topology import make_schedule, make_topology
from repro_torch.data import pipeline as pl
from repro_torch.data.synthetic import make_image_dataset, make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as St
from repro_torch.models import transformer as T
from repro_torch.models.module import init_params
from repro_torch.optim import optimizers as opt_lib


def solve_setting(setting: str, traces, adj, D, error_model="discard",
                  device=None, z0=None, iters=800):
    """Paper Table III settings: A no movement; B perfect information;
    C imperfect information; D perfect information + capacity; E
    imperfect information + capacity. ``error_model`` "discard" plans
    by the Theorem-3 rule, "neg_G" and "sqrt" by ``iters`` steps of the
    convex solver on ``device`` (from ``z0`` when given; the paper
    tables take 400). C and E plan on window estimates; D and E are
    repaired against the true traces and counts."""
    T_, n = D.shape
    if setting == "A":
        return mv.no_movement_plan(T_, n)
    if setting not in ("B", "C", "D", "E"):
        raise ValueError(f"unknown setting {setting!r}")
    if setting in ("D", "E"):
        traces = with_capacity(traces, float(D.mean()))
    tr = traces
    if setting in ("C", "E"):
        tr = est.estimate_traces(traces)
    if error_model == "discard":
        plan = mv.greedy_linear(tr, adj, device=device)
    else:
        plan = mv.solve_convex(tr, adj, est.estimate_counts(D)
                               if setting in ("C", "E") else D,
                               error_model=error_model, iters=iters,
                               z0=z0, device=device)
    if setting in ("D", "E"):
        plan = mv.repair_capacities(plan, traces, adj, D)
    return plan


def _print_summary(out: dict, **kw) -> None:
    """The summary JSON, from rank 0 of the default group only."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(out, **kw))


def fog_engine(args) -> str:
    """``--engine`` through ``resolve_engine``, with the reference's
    exceptions to "auto": checkpointing and tiers run on the scan
    engine."""
    engine = resolve_engine(args.engine)
    if args.engine == "auto" and (args.checkpoint or args.resume
                                  or args.tiers):
        engine = "scan"
    return engine


def schedule_kind(args) -> tuple[str, float, float]:
    """The schedule the flags ask for and its churn rates: ``--churn``
    is ``--schedule churn`` with p_exit = p_entry = CHURN (explicit
    ``--p-exit``/``--p-entry`` win), and ``--p-exit``/``--p-entry`` on
    the static schedule turn it into churn. Flap takes no churn rates."""
    kind, p_exit, p_entry = args.schedule, args.p_exit, args.p_entry
    if args.churn:
        kind = "churn"
        p_exit = p_exit or args.churn
        p_entry = p_entry or args.churn
    if kind == "static" and (p_exit or p_entry):
        kind = "churn"
    if kind == "flap" and (p_exit or p_entry):
        raise SystemExit("--schedule flap does not model node churn; "
                         "drop --p-exit/--p-entry/--churn or use "
                         "--schedule churn")
    return kind, p_exit, p_entry


def build_problem(args) -> dict:
    """Everything the plan and the training start from, drawn in the
    reference's order from one ``np.random.default_rng(args.seed)``:
    dataset, config, cost traces, topology, streams, counts D and the
    network schedule."""
    kind, p_exit, p_entry = schedule_kind(args)
    rng = np.random.default_rng(args.seed)
    data = make_image_dataset(n_train=args.n_train, n_test=args.n_test,
                              seed=args.seed)
    cfg = F.FedConfig(n=args.n, T=args.T, tau=args.tau, eta=args.eta,
                      model=args.model, iid=not args.non_iid, seed=args.seed,
                      p_exit=p_exit, p_entry=p_entry)
    mk = testbed_like_costs if args.costs == "testbed" else synthetic_costs
    traces = mk(cfg.n, cfg.T, rng, f_err=args.f_err)
    adj = make_topology(args.topology, cfg.n, rng,
                        rho=args.rho, costs=traces.c_node.mean(0))
    streams = pl.poisson_streams(cfg.n, cfg.T, data[1], iid=cfg.iid, rng=rng)
    D = pl.counts(streams)
    schedule = make_schedule(kind, adj, cfg.T, rng, p_exit=p_exit,
                             p_entry=p_entry, p_flap=args.p_flap,
                             p_recover=args.p_recover, tau=cfg.tau)
    return {"data": data, "cfg": cfg, "traces": traces, "adj": adj,
            "streams": streams, "D": D, "schedule": schedule,
            "schedule_kind": kind}


def resolve_replan(args, schedule) -> str:
    """What the planner sees (``--replan``; ``--plan-once`` is
    ``once``): on a static network every mode is ``oracle``."""
    if args.plan_once and args.replan not in ("oracle", "once"):
        raise SystemExit(f"--plan-once conflicts with --replan "
                         f"{args.replan}; drop one of the two")
    if schedule.static_adj is not None:
        return "oracle"
    return "once" if args.plan_once else args.replan


def make_fault_schedule(args, cfg) -> fl.FaultSchedule | None:
    """The ``--faults`` schedule, from its own generator (``--seed`` +
    7919) so that streams, costs and topology are those of the clean
    run; None when no fault can fire."""
    return fl.make_faults(args.faults, cfg.T, cfg.n, cfg.tau,
                          rate=args.fault_rate, seed=args.seed + 7919,
                          corrupt=args.corrupt_mode)


def fault_kwargs(args, faults) -> dict:
    """The fault and checkpoint keywords of ``run_network_aware``."""
    return dict(faults=faults, guard=not args.unguarded,
                quorum=args.quorum, checkpoint_path=args.checkpoint,
                resume=args.resume)


def make_plan(args, pb: dict, device, timing: dict | None = None,
              faults: fl.FaultSchedule | None = None):
    """The run's movement plan and its replan mode. The planner sees the
    true schedule (``oracle``), the schedule predicted from the observed
    history (``predict``) or the base graph (``once``); on a dynamic
    network the plan is then realized against the true schedule. Crash
    ``faults`` are never visible to the planner: with them the plan is
    realized against the true schedule with the outages composed in.
    The times of the three steps go into ``timing`` when given."""
    schedule = pb["schedule"]
    replan = resolve_replan(args, schedule)
    t0 = time.perf_counter()
    network = (schedule if replan == "oracle" else
               est.predict_schedule(schedule) if replan == "predict"
               else pb["adj"])
    t1 = time.perf_counter()
    plan = solve_setting(args.setting, pb["traces"], network, pb["D"],
                         error_model=args.error_model, device=device)
    t2 = time.perf_counter()
    dynamic = schedule.static_adj is None
    if faults is not None and faults.has_crashes:
        plan = mv.realize_plan(plan, faults.compose(
            schedule if dynamic else None, adj=pb["adj"]))
    elif dynamic:
        plan = mv.realize_plan(plan, schedule)   # oracle greedy: a no-op
    t3 = time.perf_counter()
    if timing is not None:
        timing.update(predict_s=t1 - t0, plan_s=t2 - t1, realize_s=t3 - t2)
    return plan, replan


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
    """The main path: costs → topology → streams → schedule → plan
    (→ realized on the true schedule) → routing → training → plan cost. Prints the reference's summary JSON (plus the
    device, pad size and phase times) and returns it with the plan and
    the full training history under ``"plan"`` and ``"history"``."""
    device = resolve_device(args.device)
    pb = build_problem(args)
    cfg, traces, schedule, D = pb["cfg"], pb["traces"], pb["schedule"], \
        pb["D"]
    hierarchy = make_hierarchy(args, cfg)
    faults = make_fault_schedule(args, cfg)
    timing: dict = {}
    plan, replan = make_plan(args, pb, device, timing, faults)
    t1 = time.perf_counter()
    engine = fog_engine(args)
    run_kw = dict(streams=pb["streams"], schedule=schedule, engine=engine,
                  hierarchy=hierarchy, device=device,
                  **fault_kwargs(args, faults))
    sanitize_report = None
    if args.sanitize:
        # the reference's smoke protocol: a cold pass under the
        # sanitizer, then a warm one that raises RecompileError if it
        # builds a kernel or meets a new program key; the transfer guard
        # around the round loops and debug_nans on both
        F.run_network_aware(cfg, pb["data"], traces, pb["adj"], plan,
                            sanitize=True, **run_kw)
        warm = sz.SanitizeConfig(expect_warm=True)
        hist = F.run_network_aware(cfg, pb["data"], traces, pb["adj"], plan,
                                   sanitize=warm, **run_kw)
        sanitize_report = {
            "transfer_guard": True, "debug_nans": True,
            "warm_compiles": int(getattr(warm, "last_compiles", 0))}
    else:
        hist = F.run_network_aware(cfg, pb["data"], traces, pb["adj"], plan,
                                   **run_kw)
    timing["train_s"] = time.perf_counter() - t1
    cost = mv.plan_cost(plan, traces, D, error_model=args.error_model)
    out = {"mode": "fog", "setting": args.setting, "engine": engine,
           "schedule": pb["schedule_kind"], "replan": replan,
           "n_events": len(schedule.events_in(0, cfg.T)),
           "final_acc": hist["test_acc"][-1] if hist["test_acc"] else None,
           "acc_curve": hist["test_acc"], "cost": cost,
           "sim_before": hist["sim_before"], "sim_after": hist["sim_after"],
           "device": str(device), "pad_size": hist["max_points"],
           "timing": timing}
    if hierarchy is not None:
        out["engine"] = "hierarchical"
        out["hierarchy"] = hist["hierarchy"]
    if faults is not None:
        out["fault_summary"] = hist["fault_summary"]
        out["quorum_skips"] = int(sum(
            not ok for ok in hist.get("agg_quorum_ok", [])))
    if sanitize_report is not None:
        out["sanitize"] = sanitize_report
    _print_summary(out, default=float, indent=2)
    return {**out, "plan": plan, "history": hist}


def lm_movement_inputs(n_shards: int, batch: int, T_rounds: int,
                       rng: np.random.Generator, het: float = 0.5):
    """Movement plan across data shards -> per-round (route, weights).

    Shards have heterogeneous per-point costs (straggler factors); links
    are cheap and uniform. The Theorem-3 rule decides which shards'
    samples move; a round's route (B,) int32 permutes the global batch
    so that each shard's samples sit with the shard that processes
    them, and its weights (B,) float32, in routed order, zero the
    discarded ones. Returns (plan, traces, routes, weights), numpy, as
    the reference's."""
    speed = 1.0 + het * rng.standard_normal(n_shards).clip(-0.9, 4.0)
    traces = ici_costs(n_shards, T_rounds, bytes_per_point=4 * 2048,
                       flops_per_point=5e9, speed_factors=speed.clip(0.2),
                       f_err=1e9)  # critical task: never discard
    # c_node and c_link scaled alike, to magnitudes where plans move data
    traces.c_node[:] *= 1e6
    traces.c_link[:] *= 1e6
    adj = make_topology("full", n_shards, rng)
    plan = mv.greedy_linear(traces, adj)
    per_shard = batch // n_shards
    routes, weights = [], []
    for t in range(T_rounds):
        dest = np.repeat(np.arange(n_shards), per_shard)
        for i in range(n_shards):
            # foglint: disable=dense-materialization -- LM-demo sharding: n here is the shard count (<= 8), not the fog-device axis
            j = int(np.argmax(plan.s[t, i]))
            if j != i:  # shard i's samples processed by shard j
                dest[i * per_shard:(i + 1) * per_shard] = j
        order = np.argsort(dest, kind="stable")
        routes.append(order.astype(np.int32))
        w = np.ones(batch, np.float32)
        for i in range(n_shards):
            w[i * per_shard:(i + 1) * per_shard] = 1.0 - plan.r[t, i]
        weights.append(w[order])
    return plan, traces, routes, weights


def lm_batch(toks, it: int, batch: int, seq: int, weights, routes,
             device, cfg) -> dict:
    """Step ``it``'s batch: ``batch`` rows of ``seq`` + 1 tokens, cut
    into inputs and next-token labels, with the plan's weights and
    route, on ``device``, and the zero inputs of ``cfg``'s stubbed
    frontend (``steps.frontend_inputs``), as in the reference."""
    off = it * batch * (seq + 1)
    chunk = toks[off: off + batch * (seq + 1)].reshape(batch, seq + 1)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"tokens": dev(chunk[:, :-1]), "labels": dev(chunk[:, 1:]),
            "weights": dev(weights[it]), "route": dev(routes[it]),
            **St.frontend_inputs(cfg, batch, device)}


def run_lm(args) -> dict:
    """Model-zoo training: token data → movement plan across the data
    shards → ``--steps`` train steps (or FedAvg rounds of ``--lm-tau``
    local steps) → the reference's summary JSON (mode, arch, loss_first,
    loss_last, steps_per_s, moved_frac). Returns it with the loss of
    every step (every round under FedAvg) under ``"losses"`` and the
    device under ``"device"``."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = cfg.with_overrides(num_layers=args.layers)
    world = mesh_lib.world_size()
    shards = min(args.data_shards,
                 world if world > 1 else torch.cuda.device_count() or 1)
    rng = np.random.default_rng(args.seed)
    toks = make_token_dataset(args.steps * args.batch * (args.seq + 1) + 1,
                              cfg.vocab_size, seed=args.seed)
    params = init_params(T.specs(cfg), args.seed, torch.float32, device)
    opt = opt_lib.get_optimizer(args.optimizer, args.lr)
    opt_state = opt.init(params)
    plan, _, routes, weights = lm_movement_inputs(shards, args.batch,
                                                  args.steps, rng)

    def batch_at(it):
        return lm_batch(toks, it, args.batch, args.seq, weights, routes,
                        device, cfg)

    losses = []
    t0 = time.time()
    if args.lm_tau > 1:
        # FedAvg with tau local steps a round (paper eqs. (3)-(4))
        from repro_torch.distributed.fedavg import make_fedavg_round

        group = None
        if world > 1 and shards > 1:
            if shards != world:
                raise SystemExit(f"--data-shards {args.data_shards} gives "
                                 f"{shards} shards on a world of {world} "
                                 "ranks; under torchrun the shard count "
                                 "is 1 or the world size")
            group = mesh_lib.make_data_mesh(device=device).get_group("data")
        rnd = make_fedavg_round(cfg, opt, args.lm_tau, n_shards=shards,
                                group=group)
        for r in range(args.steps // args.lm_tau):
            bs = [St.route_batch(batch_at(r * args.lm_tau + i))
                  for i in range(args.lm_tau)]
            stacked = {k: torch.stack([b[k] for b in bs])
                       for k in bs[0] if k != "route"}
            params, opt_state, loss = rnd(params, opt_state, stacked)
            losses.append(float(loss))
            print(f"round {r:3d} (tau={args.lm_tau}) loss {losses[-1]:.4f}",
                  flush=True)
    else:
        step_fn = St.make_train_step(cfg, opt)
        for it in range(args.steps):
            params, opt_state, m = step_fn(params, opt_state, batch_at(it))
            losses.append(float(m["loss"]))
            if it % max(args.steps // 10, 1) == 0:
                print(f"step {it:4d} loss {losses[-1]:.4f}", flush=True)
    dt = time.time() - t0
    out = {"mode": "lm", "arch": args.arch, "loss_first": losses[0],
           "loss_last": float(np.mean(losses[-5:])),
           "steps_per_s": args.steps / dt,
           "moved_frac": float((plan.s * (1 - np.eye(shards))).sum()  # foglint: disable=dense-materialization -- shard-count square (<= 8), not the device axis
                               / plan.s.shape[0] / shards)}
    _print_summary(out, indent=2)
    return {**out, "losses": losses, "device": str(device)}


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
                    choices=["static", "churn", "flap"],
                    help="network schedule: static, node entry/exit "
                         "churn, or seeded link flaps")
    ap.add_argument("--churn", type=float, default=0.0,
                    help="shorthand: --schedule churn with p_exit = "
                         "p_entry = CHURN")
    ap.add_argument("--p-flap", type=float, default=0.05,
                    help="per-round link failure probability (flap)")
    ap.add_argument("--p-recover", type=float, default=0.5,
                    help="per-round failed-link recovery probability")
    ap.add_argument("--replan", default="oracle",
                    choices=["oracle", "predict", "once"],
                    help="what the planner sees under a dynamic schedule: "
                         "the true schedule, the schedule predicted from "
                         "the observed history, or the base graph; the "
                         "plan is realized against the true schedule")
    ap.add_argument("--plan-once", action="store_true",
                    help="alias for --replan once")
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
    ap.add_argument("--sanitize", action="store_true",
                    help="runtime sanitizer smoke: a sanitized cold "
                         "pass, then a warm one that must compile "
                         "nothing; the summary gains \"sanitize\"")
    # lm
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="the smoke config of --arch (on whatever the "
                         "command line says, as in the reference)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--lm-tau", type=int, default=1,
                    help="FedAvg local steps per aggregation (lm mode)")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-3)
    return ap.parse_args(argv)


def main(argv=None):
    """Parse and run. Under a launcher's world of more than one rank the
    process group is made first, so that ``--engine auto`` sees it; a
    group the run made (that one, or the sharded engine's world of one)
    is destroyed at the end."""
    args = parse_args(argv)
    owned = not dist.is_initialized()
    try:
        if int(os.environ.get("WORLD_SIZE", 1)) > 1:
            mesh_lib.init_process_group(args.device)
        return run_fog(args) if args.mode == "fog" else run_lm(args)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
