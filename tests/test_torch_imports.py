"""The port imports neither JAX nor the reference package, nor msgpack
(the machine with the card has none): every module of
``src/repro_torch`` must import in a fresh interpreter in which
``import jax``, ``import repro`` and ``import msgpack`` fail."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (SRC / "repro_torch").rglob("*.py"))

PROBE = """
import importlib, sys
for name in ("jax", "jaxlib", "repro", "msgpack"):
    sys.modules[name] = None            # any import of them now fails
failed = []
for mod in sys.argv[1:]:
    try:
        importlib.import_module(mod)
    except Exception as e:
        failed.append(f"{mod}: {type(e).__name__}: {e}")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")
                and sys.modules[m] is not None)
print("\\n".join(failed + [f"loaded {m}" for m in loaded]))
"""


def test_modules_found():
    assert "repro_torch.core.schedule" in MODULES
    assert "repro_torch.launch.tables" in MODULES
    assert "repro_torch.checkpoint.checkpoint" in MODULES
    assert "repro_torch.core.costmodel" in MODULES
    assert "repro_torch.kernels._grad" in MODULES
    assert "repro_torch.optim.optimizers" in MODULES
    assert "repro_torch.distributed.fedavg" in MODULES
    for mod in ("distributed.sharding", "distributed.collectives",
                "launch.mesh", "launch.roofline", "launch.dryrun"):
        assert f"repro_torch.{mod}" in MODULES
    assert len(MODULES) > 40


def test_every_module_imports_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", PROBE, *MODULES],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=SRC.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


@pytest.mark.parametrize("blocked", ["jax", "repro", "msgpack"])
def test_probe_catches_an_import(blocked, tmp_path):
    """The probe fails a module that imports a blocked package."""
    (tmp_path / "leaky.py").write_text(f"import {blocked}\n")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{SRC}"}
    out = subprocess.run([sys.executable, "-c", PROBE, "leaky"],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert "leaky: ImportError" in out.stdout or \
        "leaky: ModuleNotFoundError" in out.stdout, out.stdout


SPARSE_PROBE = """
import sys
for name in ("jax", "jaxlib", "repro", "msgpack"):
    sys.modules[name] = None
import numpy as np
import torch
from repro_torch.core import costs, hierarchy, movement, topology
from repro_torch.core import federated as F
from repro_torch.data import pipeline as pl
from repro_torch.kernels import ops
n, T = 40, 6
src, dst = topology.random_sparse_edges(n, 4, np.random.default_rng(0))
sched = topology.churn_schedule_edges(n, src, dst, T, 0.1, 0.3,
                                      np.random.default_rng(1), tau=3)
flap = topology.link_flap_schedule_edges(n, src, dst, T,
                                         np.random.default_rng(2))
etr = costs.synthetic_edge_costs(n, T, src, dst, np.random.default_rng(3))
plan = movement.realize_plan(movement.greedy_linear(etr, sched), sched)
tree = hierarchy.TierTree.from_spec("4@3,1@6", n)
tier = hierarchy.solve_tier_movement(tree, etr, flap, D=np.ones((T, n)),
                                     device="cpu")
flat = pl.poisson_streams_flat(n, T, np.arange(200) % 10,
                               rng=np.random.default_rng(4))
D = pl.counts_flat(flat, "cpu")
cost = movement.plan_cost(plan, etr, D)
x = np.random.default_rng(5).random((200, 28, 28)).astype(np.float32)
data = (x, np.arange(200) % 10, x[:20], np.arange(20) % 10)
hist = F.run_network_aware(F.FedConfig(n=n, T=T, tau=3, model="linear"),
                           data, etr, None, plan, streams=flat,
                           schedule=sched, hierarchy=tree, device="cpu")
assert hist["agg_round"] == [5] and cost["total"] > 0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")
                and sys.modules[m] is not None)
print("ok", loaded)
"""


def test_sparse_plane_runs_without_jax_or_repro():
    """The sparse O(E) plane end to end on the CPU (edge-list churn and
    flap, edge costs, the edge planner, the tier restriction with its
    repair, flat streams, ``counts_flat``, a tiered run on them) in an
    interpreter where JAX and the reference cannot be imported."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", SPARSE_PROBE],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=SRC.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok []", out.stdout


LM_PROBE = """
import sys
for name in ("jax", "jaxlib", "repro", "msgpack"):
    sys.modules[name] = None
import torch
from repro_torch.core.costs import effective_link_costs, ici_costs
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.distributed.fedavg import make_fedavg_round
from repro_torch.launch import steps, train
from repro_torch.models.convert import opt_state_from_jax
from repro_torch.optim import optimizers
out = train.main(["--mode", "lm", "--device", "cpu", "--arch", "zamba2-7b",
                  "--steps", "2", "--batch", "2", "--seq", "8",
                  "--lm-tau", "2"])
assert len(out["losses"]) == 1
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")
                and sys.modules[m] is not None)
print("ok", loaded)
"""


def test_lm_training_runs_without_jax_or_repro():
    """The model zoo's training (optimizers, train step, FedAvg round,
    token data, the ICI costs, ``--mode lm``) in an interpreter where
    JAX and the reference cannot be imported."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", LM_PROBE],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=SRC.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok []", out.stdout
