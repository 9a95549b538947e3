"""The port's dry run (``launch/dryrun.py``): DTensors over a fake
process group on the meta device, in subprocesses (a process holds one
default group).

* A data-parallel x tensor-parallel product on a (4, 2) mesh: the
  per-device flops (the flop counter's formulas on the ops DTensor runs
  on rank 0's shards) are the hand count 2·B·S·D·F over the 8 ranks,
  and a column-parallel product followed by a row-parallel one issues
  exactly one all-reduce, of the local (B/4, S, D) float32 partial sum.
  ``flops_by_op`` splits the count by op beside its logical flops: a
  product on replicated operands runs whole on every rank.
* The (4, 2) smoke dry runs of ``tests/test_dryrun_small.py``
  (qwen1.5-4b ``train_4k`` and mamba2-1.3b ``decode_32k`` at B = 8,
  S = 64): flops > 0, collectives > 0, and ``params_total`` /
  ``params_active`` equal to the reference's ``count_params``; with
  ``zero2`` and two microbatches the train step traces too.
* On the fake group the meshes build (``tier_mesh_for`` with the
  extents of ``tier_mesh_axes``), but ``init_process_group`` refuses
  it: a real group is never a fake one.
* ``sharding.gather_dims`` gathers exactly the mesh dims that shard the
  named tensor dims.
* ``accum_shards``: after a microbatch every accumulator leaf carries
  the placements of its ``accum_shardings`` entry (data-sharded where a
  dim divides).
* The CLI: the production (16, 16) qwen3-14b ``train_4k`` row is a PASS
  with the reference's keys and the torch version; an unknown arch
  writes a FAIL row and exits 1; ``--ssm-streaming`` traces
  mamba2-1.3b ``train_4k`` through the streaming scan.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, timeout=300, **env_kw):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", **env_kw)
    args = (["-c", textwrap.dedent(code_or_args)]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, timeout=timeout)


def _last_json(r):
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


SMALL = """
    import dataclasses, json
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro.launch.dryrun import count_params as ref_count
    from repro.configs.registry import get_config as rget
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.models.module import abstract_params
    from repro_torch.optim import optimizers as topt

    torch.set_num_threads(1)
    mesh_lib.init_fake_process_group(8)
    mesh = mesh_lib.make_host_mesh(4, 2, device="cpu")
    out = {}

    # one data x tensor-parallel product pair
    B, S, D, F = 16, 32, 64, 96
    x = distribute_tensor(torch.empty(B, S, D, device="meta"), mesh,
                          [Shard(0), Replicate()])
    w1 = distribute_tensor(torch.empty(D, F, device="meta"), mesh,
                           [Replicate(), Shard(1)])
    w2 = distribute_tensor(torch.empty(F, D, device="meta"), mesh,
                           [Replicate(), Shard(0)])
    _, local = DR.trace(lambda: x @ w1, ())
    out["one_flops"] = local.flops
    _, local = DR.trace(
        lambda: ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()]),
        ())
    out["pair_flops"] = local.flops
    out["pair_by_op"] = local.flops_by_op
    out["pair_colls"] = local.collectives()
    # a product DTensor cannot split: every rank runs it whole
    xr = distribute_tensor(torch.empty(B, S, D, device="meta"), mesh,
                           [Replicate(), Replicate()])
    wr = distribute_tensor(torch.empty(D, F, device="meta"), mesh,
                           [Replicate(), Replicate()])
    _, local = DR.trace(lambda: xr @ wr, ())
    out["replicated_by_op"] = local.flops_by_op

    for arch, shape, variant in [("qwen1.5-4b", "train_4k", None),
                                 ("mamba2-1.3b", "decode_32k", None),
                                 ("qwen1.5-4b", "train_4k",
                                  {"zero1": True, "zero2": True,
                                   "microbatches": 2})]:
        shp = dataclasses.replace(INPUT_SHAPES[shape], global_batch=8,
                                  seq_len=64)
        r = DR.measure(get_config(arch, smoke=True), shp, mesh,
                       variant=variant)
        cfg = St.config_for_shape(rget(arch, smoke=True), shp)
        r["ref_params"] = list(ref_count(cfg))
        out[f"{arch}/{shape}/{bool(variant)}"] = r

    # the accumulator after one microbatch
    cfg = St.config_for_shape(get_config("qwen1.5-4b", smoke=True),
                              INPUT_SHAPES["train_4k"])
    ps = St.param_shardings(cfg, mesh)
    ap = abstract_params(T.specs(cfg))
    acc_sh = St.accum_shardings(ap, ps, mesh)
    grads = DR._distribute(ap, ps)
    acc = St.constrain(topt.tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), grads), acc_sh)
    acc = St.accumulate(acc, grads, acc_sh)
    got = [tuple(a.placements) == s.placements
           for a, s in zip(topt.tree_leaves(acc), topt.tree_leaves(acc_sh))]
    out["accum_ok"] = all(got)
    out["accum_data"] = sum(isinstance(a.placements[0], Shard)
                            for a in topt.tree_leaves(acc))
    out["accum_n"] = len(got)

    # the fake group serves the meshes but is never taken for a real one
    from repro_torch.core.hierarchy import TierTree
    tree = TierTree.balanced(64, (4, 1), (2, 4))
    tm = mesh_lib.tier_mesh_for(tree, device="cpu")
    out["tier_mesh"] = [dict(zip(tm.mesh_dim_names, tm.shape)),
                        mesh_lib.tier_mesh_axes(tree, 8)]
    try:
        mesh_lib.init_process_group("cpu")
        out["real_on_fake"] = "taken"
    except RuntimeError as e:
        out["real_on_fake"] = str(e)

    from repro_torch.distributed.sharding import gather_dims
    t = distribute_tensor(torch.empty(8, 32, 4, device="meta"), mesh,
                          [Shard(0), Shard(1)])
    out["gather"] = [[type(p).__name__ for p in
                      gather_dims(t, dims).placements]
                     for dims in ((1,), (0, 1), (2,))]
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def small():
    return _last_json(_run(SMALL, XLA_FLAGS="--xla_force_host_platform_"
                                            "device_count=8"))


def test_per_device_flops_are_the_hand_count_over_the_ranks(small):
    B, S, D, F = 16, 32, 64, 96
    assert small["one_flops"] == 2 * B * S * D * F // 8
    assert small["pair_flops"] == 2 * (2 * B * S * D * F) // 8


def test_column_then_row_parallel_is_one_all_reduce(small):
    B, S, D = 16, 32, 64
    per_op = small["pair_colls"]["per_op"]
    assert list(per_op) == ["all-reduce"]
    assert per_op["all-reduce"] == {"count": 1,
                                    "result_bytes": (B // 4) * S * D * 4}
    assert small["pair_colls"]["moved_bytes_per_device"] == \
        2.0 * (B // 4) * S * D * 4


def test_flops_by_op_shows_each_ops_replication(small):
    B, S, D, F = 16, 32, 64, 96
    pair = small["pair_by_op"]
    assert sum(d["per_device"] for d in pair.values()) == small["pair_flops"]
    assert sum(d["logical"] for d in pair.values()) == 2 * (2 * B * S * D * F)
    rep = small["replicated_by_op"]
    assert sum(d["per_device"] for d in rep.values()) == 2 * B * S * D * F
    assert sum(d["logical"] for d in rep.values()) == 2 * B * S * D * F


@pytest.mark.parametrize("key", ["qwen1.5-4b/train_4k/False",
                                 "mamba2-1.3b/decode_32k/False",
                                 "qwen1.5-4b/train_4k/True"])
def test_small_mesh_dryrun(small, key):
    r = small[key]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert sum(d["count"] for d in r["collectives"]["per_op"].values()) > 0
    assert [r["params_total"], r["params_active"]] == r["ref_params"]
    assert r["device"] == "meta" and r["chips"] == 8 and r["mesh"] == "4x2"
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["memory"]["argument_size_in_bytes"] > 0


def test_fake_group_serves_meshes_but_not_a_real_group(small):
    got, want = small["tier_mesh"]
    assert got == want == {"pod": 4, "data": 2}
    assert "'fake' process group exists" in small["real_on_fake"]


def test_gather_dims_replicates_only_the_named_dims(small):
    assert small["gather"] == [["Shard", "Replicate"],
                               ["Replicate", "Replicate"],
                               ["Shard", "Shard"]]


def test_accumulator_is_data_sharded_after_a_microbatch(small):
    assert small["accum_ok"]
    assert 0 < small["accum_data"] <= small["accum_n"]


KEYS = {"arch", "shape", "variant", "mesh", "chips", "kind", "device",
        "trace_s", "flops_per_device", "bytes_per_device", "collectives",
        "memory", "params_total", "params_active", "model_flops",
        "useful_flops_ratio", "compute_s", "memory_s", "collective_s",
        "dominant", "torch", "flops_by_op"}


def test_cli_production_row_and_fail_row(tmp_path):
    out = tmp_path / "rows.jsonl"
    r = _run(["-m", "repro_torch.launch.dryrun", "--arch", "qwen3-14b",
              "--shape", "train_4k", "--out", str(out)], timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS qwen3-14b × train_4k × 16x16" in r.stdout
    row = json.loads(out.read_text().splitlines()[-1])
    assert KEYS <= set(row)
    assert row["chips"] == 256 and row["mesh"] == "16x16"
    assert row["params_total"] == 15189048320
    assert 0 < row["useful_flops_ratio"] <= 1.0
    r = _run(["-m", "repro_torch.launch.dryrun", "--arch", "nope",
              "--shape", "train_4k", "--out", str(out)])
    assert r.returncode == 1 and "FAIL nope × train_4k" in r.stdout
    fail = json.loads(out.read_text().splitlines()[-1])
    assert "error" in fail and fail["torch"] == row["torch"]


def test_cli_traces_ssm_streaming(tmp_path):
    """--ssm-streaming, refused while the port had no streaming scan,
    now traces: the reference's variant, a config override."""
    out = tmp_path / "rows.jsonl"
    r = _run(["-m", "repro_torch.launch.dryrun", "--arch", "mamba2-1.3b",
              "--shape", "train_4k", "--ssm-streaming", "--out", str(out)],
             timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS mamba2-1.3b × train_4k × 16x16" in r.stdout
    row = json.loads(out.read_text().splitlines()[-1])
    assert KEYS <= set(row) and row["variant"] == {"ssm_streaming": True}
