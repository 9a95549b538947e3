"""The paper's experiment end to end on the PyTorch/CUDA port, at full
fidelity — CNN over a fog network, testbed-like costs, non-iid
data, capacity constraints and imperfect information (setting E), with
the Table-III cost decomposition.

    PYTHONPATH=src python examples/fog_train_torch.py [--full | --quick] \
        [--device cpu]

The same script as ``examples/fog_train.py``, on ``repro_torch``
(``python -m repro_torch.launch.train --mode fog``), on ``--device``
(``cuda`` by default). ``--full`` restores paper scale (n=10, T=100,
tau=10, 60k images); the default is n=8, T=40, tau=5, 20k images;
``--quick`` is a seconds-long run (n=6, T=8, tau=4, 1,000 images).

Engine knobs
------------
``--engine`` selects the training engine (default "auto"):

* ``scan``    — the whole horizon on one device, every round's padded
  batches staged up front;
* ``sharded`` — the same rounds split over the ranks of a
  ``torch.distributed`` world (``repro_torch.launch.mesh``): each rank
  trains its block of fog devices (n padded with phantom inactive
  devices), eq. (4) is the segment-reduce kernel's row sum on the rank
  followed by an all-reduce. Launched by ``torchrun`` it takes the
  launcher's world; alone it runs on a world of one. ``auto`` picks it
  on a world of more than one rank;
* ``batched`` — the S=1 slice of the sweep engine
  (``repro_torch.core.engine.run_rounds_batched``), bit for bit the
  scan engine; sweeps batch many runs into one program through
  ``repro_torch.launch.tables.run_scenarios``;
* ``legacy``  — the per-round loop (the numerical oracle).

Network dynamics and fault knobs are the training CLI's, as in the
original script: ``--churn``, ``--schedule flap``, ``--replan
oracle|predict|once`` (``--plan-once``), ``--faults KIND --fault-rate
R``, ``--quorum Q`` and ``--unguarded``.
"""
import argparse

from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--full", action="store_true")
    size.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--setting", default="B", choices=list("ABCDE"))
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "scan", "sharded", "batched",
                             "legacy"])
    ap.add_argument("--schedule", default="static",
                    choices=["static", "churn", "flap"])
    ap.add_argument("--churn", type=float, default=0.0)
    ap.add_argument("--replan", default="oracle",
                    choices=["oracle", "predict", "once"])
    ap.add_argument("--plan-once", action="store_true")
    ap.add_argument("--faults", default="none",
                    choices=["none", "straggle", "drop", "crash",
                             "corrupt", "mixed"])
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--quorum", type=float, default=0.0)
    ap.add_argument("--unguarded", action="store_true")
    args = ap.parse_args()
    argv = ["--mode", "fog", "--model", "cnn", "--setting", args.setting,
            "--costs", "testbed", "--engine", args.engine,
            "--schedule", args.schedule, "--replan", args.replan,
            "--faults", args.faults, "--fault-rate", str(args.fault_rate),
            "--quorum", str(args.quorum), "--device", args.device]
    if args.churn:
        argv += ["--churn", str(args.churn)]
    if args.plan_once:
        argv.append("--plan-once")
    if args.unguarded:
        argv.append("--unguarded")
    if args.non_iid:
        argv.append("--non-iid")
    if args.full:
        argv += ["--n", "10", "--T", "100", "--tau", "10",
                 "--n-train", "60000", "--n-test", "10000"]
    elif args.quick:
        argv += ["--n", "6", "--T", "8", "--tau", "4",
                 "--n-train", "1000", "--n-test", "200"]
    else:
        argv += ["--n", "8", "--T", "40", "--tau", "5",
                 "--n-train", "20000", "--n-test", "4000"]
    train_main(argv)
