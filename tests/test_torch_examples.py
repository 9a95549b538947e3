"""The port's examples (``examples/*_torch.py``), each run once on the
CPU in a subprocess with its own timeout, at a size that finishes in
seconds: exit 0 and the lines each prints. ``quickstart_torch.py``'s
unit costs equal the reference's ``plan_cost`` of the same seeded
problem (numpy on both sides, so bit for bit). Neither the examples
nor ``chip_smoke.py`` import JAX or the reference package."""
import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro.core import costs as rc
from repro.core import movement as rmv
from repro.core.topology import make_topology
from repro.data import pipeline as rpl
from repro.data.synthetic import make_image_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["quickstart_torch.py", "offload_planning_torch.py",
            "serve_llm_torch.py", "fog_train_torch.py"]


@pytest.mark.parametrize("path", [os.path.join("examples", e)
                                  for e in EXAMPLES] + ["chip_smoke.py"])
def test_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    roots = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert "repro_torch" in roots or path == "chip_smoke.py"
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def _run(name, *args, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, os.path.join(REPO, "examples", name),
                        "--device", "cpu", *args], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout


def test_quickstart_unit_cost_equals_reference():
    out = _run("quickstart_torch.py")
    got = re.search(r"unit cost: (\S+) vs no-movement (\S+) ", out)
    rng = np.random.default_rng(0)
    n, T = 8, 30
    traces = rc.testbed_like_costs(n, T, rng, f_err=0.7)
    adj = make_topology("full", n, rng)
    data = make_image_dataset(n_train=12_000, n_test=2_000, seed=0)
    D = rpl.counts(rpl.poisson_streams(n, T, data[1], iid=True, rng=rng))
    cost = rmv.plan_cost(rmv.greedy_linear(traces, adj), traces, D)
    base = rmv.plan_cost(rmv.no_movement_plan(T, n), traces, D)
    assert (float(got[1]), float(got[2])) == (cost["unit"], base["unit"])
    acc = float(re.search(r"test accuracy: (\S+)", out)[1])
    assert 0.0 <= acc <= 1.0


def test_offload_planning_runs_the_theorem3_rule():
    out = _run("offload_planning_torch.py")
    for plan in ("no_movement", "greedy_thm3", "greedy+capacity_repair",
                 "convex_sqrt"):
        assert re.search(rf"^{re.escape(plan)}\s+\d", out, re.M), plan
    mix = re.search(r"round 0 decision mix: (\{.*\})", out)[1]
    fracs = [float(v) for v in re.findall(r": ([0-9.]+)", mix)]
    assert len(fracs) == 3 and abs(sum(fracs) - 1.0) < 1e-6
    assert "kernel launches: 0" in out          # the plain version on CPU


def test_serve_llm_serves_three_families():
    """Each model serves; the prefill step's next tokens are the first
    tokens greedy serving generates from the same prompts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params

    out = _run("serve_llm_torch.py")
    nxt = [json.loads(m) for m in re.findall(
        r"prefill of the prompts: next tokens (\[.*\])", out)]
    archs = ("qwen3-14b", "mixtral-8x7b", "mamba2-1.3b")
    assert len(nxt) == 3
    for arch, got in zip(archs, nxt):
        assert f"=== {arch} (reduced smoke config) ===" in out
        cfg = get_config(arch, smoke=True)
        params = init_params(T.specs(cfg), seed=0, device="cpu")
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 8)).astype(np.int32)
        toks, _ = greedy_generate(cfg, params, prompts, 1)
        assert got == toks[:, 8].tolist(), arch
    assert out.count("decode_tokens_per_s") == 3
    assert out.count("kernel launches: flash_attention 0, ssd_scan 0") == 3


@pytest.mark.parametrize("engine", ["scan", "sharded", "batched", "legacy"])
def test_fog_train_engines(engine):
    out = _run("fog_train_torch.py", "--quick", "--engine", engine)
    assert f'"engine": "{engine}"' in out
    assert '"final_acc"' in out
