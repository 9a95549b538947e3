"""The reference's remaining bench rows (``benchmarks/run.py``) through
the port (``repro_torch.launch.tables``), on the CPU at ``--quick``
sizes, and the Theorem-3 rule's two baselines.

* ``movement.greedy_linear_scalar`` (the pure-Python (t, i, j) loop)
  and ``greedy_linear_loop`` (the per-round numpy loop) are numpy on
  both sides: their plans equal the reference's bit for bit, and the
  port's vectorized ``greedy_linear(backend="numpy")``, on integer
  costs that force ties, on a time-varying (T, n, n) stack and at
  T = 1.
* Each row gives the reference's derived keys (``REF_KEYS``, copied
  from ``benchmarks/run.py``: the reference's bench functions write
  ``results/`` and are not called here) and its exact booleans true.
* ``convex_sweep_costs`` started from the reference's own ``z0`` is
  held to the reference's rows within the convex solver's tolerance
  (``tests/test_torch_convex.py``: rtol 1e-4 on the objective).
* ``dryrun_roofline`` against a hand count on a JSONL written here.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import fog as RF
from repro.core import costs as rc
from repro.core import movement as rmv
from repro_torch.core import costs as pc
from repro_torch.core import movement as pmv
from repro_torch.launch import tables as TT

RTOL_OBJ = 1e-4        # tests/test_torch_convex.py
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The rows' many small ops run on one thread: under the test
    workers' load, intra-op threads only wait for each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tied_costs(T, n, rho, seed, varying):
    """Integer-valued costs (many equal sums, so every tie rule shows)
    on a random graph, static or a (T, n, n) stack; the same arrays as
    the reference's and the port's CostTraces."""
    rng = np.random.default_rng(seed)
    c_node = rng.integers(1, 4, (T, n)).astype(float)
    c_link = rng.integers(0, 3, (T, n, n)).astype(float)
    f_err = rng.integers(1, 5, (T, n)).astype(float)
    shape = (T, n, n) if varying else (n, n)
    adj = rng.random(shape) < rho
    cap = (np.full((T, n), np.inf), np.full((T, n, n), np.inf))
    return ((rc.CostTraces(c_node, c_link, f_err, *cap),
             pc.CostTraces(c_node, c_link, f_err, *cap)), adj)


GREEDY_CASES = [(6, 9, 0.5, 0, False), (5, 12, 1.0, 1, False),
                (4, 10, 0.3, 2, True), (7, 8, 0.7, 3, True),
                (1, 7, 0.6, 4, False), (1, 6, 1.0, 5, True),
                (3, 16, 0.0, 6, False)]


@pytest.mark.parametrize("fn", ["greedy_linear_scalar",
                                "greedy_linear_loop"])
@pytest.mark.parametrize("T,n,rho,seed,varying", GREEDY_CASES)
def test_greedy_baselines_bitwise_reference(fn, T, n, rho, seed, varying):
    (rtr, ptr), adj = _tied_costs(T, n, rho, seed, varying)
    want = getattr(rmv, fn)(rtr, adj)
    got = getattr(pmv, fn)(ptr, adj)
    np.testing.assert_array_equal(got.s, want.s)
    np.testing.assert_array_equal(got.r, want.r)
    assert pmv.plans_equal(got, pmv.greedy_linear(ptr, adj,
                                                  backend="numpy"))
    last = got.s[-1]
    assert np.array_equal(last, np.diag(np.diagonal(last))), \
        "the last round offloads nothing"


# the reference's derived keys (benchmarks/run.py: engine_throughput
# 570-596, kernels_micro 461, solver_scaling 505-509, movement_scale
# 648-669, convex_batched 1583-1588, dryrun_roofline 1608-1617)
REF_KEYS = {
    "engine_throughput": {
        "engine": {"n", "T", "model", "legacy_s", "scan_s",
                   "legacy_rounds_per_s", "scan_rounds_per_s",
                   "acc_curve_gap"},
        "movement": {"n", "T", "python_nested_loop_s",
                     "seed_per_round_loop_s", "vectorized_s",
                     "identical_plan"},
        "headline": {"engine_speedup", "scan_rounds_per_s",
                     "greedy_speedup_vs_python_loop",
                     "greedy_speedup_vs_seed_loop",
                     "greedy_identical_plan"}},
    "kernels_micro": {"headline": {"attention_ref_us", "ssd_ref_us",
                                   "greedy_ref_us"}},
    "solver_scaling": {"rows": {"n", "greedy_s", "kernel_per_round_s",
                                "convex_s"},
                       "headline": {"greedy_512_s", "kernel_512_round_us"}},
    "movement_scale": {
        "rows": {"n", "T", "edges", "sparse_s", "dense_s",
                 "sparse_peak_bytes", "dense_peak_bytes",
                 "dense_s_tensor_bytes", "identical_plan"},
        "ru_maxrss_kb": None,
        "headline": {"n1024_speedup", "n1024_sparse_s", "n1024_peak_ratio",
                     "sparse_below_dense_tensor", "identical_plans"}},
    "convex_batched": {
        "rows": {"f_err", "medium", "process", "transfer", "discard",
                 "total", "unit"},
        "headline": {"n_scenarios", "sequential_s", "batched_s", "speedup",
                     "max_plan_gap"}},
    "dryrun_roofline": {"n_pass": None, "n_total": None,
                        "dominant_hist": None, "worst_useful_flops": None,
                        "headline": {"pass", "dominant_hist"}},
}


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in DRYRUN_ROWS))
    out = TT.main(["--only", ",".join(REF_KEYS), "--quick", "--device",
                   "cpu", "--dryrun", str(path)])
    return out


def _has_keys(got, want):
    for k, sub in want.items():
        assert k in got, k
        if sub is None:
            continue
        v = got[k][0] if isinstance(got[k], list) else got[k]
        assert sub <= set(v), (k, sub - set(v))


@pytest.mark.parametrize("name", list(REF_KEYS))
def test_row_has_the_reference_keys(rows, name):
    _has_keys(rows[name], REF_KEYS[name])


def test_engine_throughput_exact_claims(rows):
    r = rows["engine_throughput"]
    assert r["engine"]["acc_curve_gap"] <= 1e-2     # scan vs legacy
    mov = r["movement"]
    assert mov["identical_plan"] is True
    assert r["headline"]["greedy_identical_plan"] is True
    # the float32 device path: on the CPU its plain version, bit for bit
    # itself, launching nothing; its distance from float64 is a count
    assert mov["device_plain_identical"] is True
    assert mov["device_launches"] == 0
    assert isinstance(mov["device_f32_decisions_differ"], int)
    assert 0 <= mov["device_f32_decisions_differ"] <= 512 * 50


def test_kernels_micro_plain_versions_on_cpu(rows):
    entries = {e["name"]: e for e in rows["kernels_micro"]["kernels"]}
    assert set(entries) == {"flash_attention", "ssd_scan", "offload_greedy",
                            "segment_reduce"}
    for e in entries.values():
        assert e["timer"] == "host clock" and e["ms"] is None
        assert e["launches"] == 0 and e["plain_ms"] > 0
        assert e["bound_ms"] > 0 and e["bound_by"] in ("bytes",
                                                       "operations")
    assert entries["flash_attention"]["library_ms"] > 0
    assert entries["segment_reduce"]["library_ms"] > 0
    assert entries["segment_reduce"]["shape"] == {
        "m": 1000, "P": 1568, "G": 32, "scaled": True}


def test_solver_scaling_rows(rows):
    r = rows["solver_scaling"]["rows"]
    assert [x["n"] for x in r] == [32, 128, 512]
    assert [x["convex_s"] is None for x in r] == [False, False, True]


def test_movement_scale_plans_identical(rows):
    r = rows["movement_scale"]
    assert r["headline"]["identical_plans"] is True
    assert all(x["identical_plan"] for x in r["rows"])
    assert r["headline"]["sparse_below_dense_tensor"] is True
    assert [x["dense_s_tensor_bytes"] for x in r["rows"]] == \
        [8 * n * n * 8 for n in (256, 512, 1024)]


def test_movement_scale_edges_equal_reference(rows):
    """The sparse plans' edge counts are the reference's (its JSON rows,
    numpy on both sides)."""
    want = json.loads((REPO / "results" / "bench_movement.json")
                      .read_text())["rows"]
    got = rows["movement_scale"]["rows"]
    assert [r["edges"] for r in got] == [r["edges"] for r in want]


def test_convex_batched_gap(rows):
    h = rows["convex_batched"]["headline"]
    assert h["n_scenarios"] == 4
    assert h["max_plan_gap"] <= 1e-5     # as tests/test_torch_convex.py
    assert len(rows["convex_batched"]["rows"]) == 4


def test_convex_sweep_costs_match_reference_from_its_z0():
    n, T = 10, 12
    z0 = np.array(0.01 * jax.random.normal(jax.random.PRNGKey(0),
                                           (T, n, n + 1)))
    want = RF.convex_sweep_costs(n, T, iters=100)
    got = TT.convex_sweep_costs(n, T, iters=100, z0=np.stack([z0] * 4),
                                device="cpu")
    assert [(r["f_err"], r["medium"]) for r in got] == \
        [(r["f_err"], r["medium"]) for r in want]
    for g, w in zip(got, want):
        for k in ("total", "unit", "process", "transfer", "discard"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL_OBJ, err_msg=k)
        assert g["data_total"] == w["data_total"]


# a dry-run JSONL: 16x16 and 2x16x16 rows of three kinds, and FAIL rows
DRYRUN_ROWS = [
    {"arch": "a", "shape": "train_4k", "mesh": "16x16", "kind": "train",
     "dominant": "compute_s", "useful_flops_ratio": 0.5},
    {"arch": "b", "shape": "train_4k", "mesh": "16x16", "kind": "train",
     "dominant": "memory_s", "useful_flops_ratio": 0.2},
    {"arch": "c", "shape": "train_4k", "mesh": "16x16", "kind": "train",
     "dominant": "compute_s", "useful_flops_ratio": 0.9},
    {"arch": "d", "shape": "train_4k", "mesh": "16x16", "kind": "train",
     "dominant": "collective_s", "useful_flops_ratio": 0.1},
    {"arch": "a", "shape": "train_4k", "mesh": "2x16x16", "kind": "train",
     "dominant": "compute_s", "useful_flops_ratio": 0.01},
    {"arch": "a", "shape": "prefill_32k", "mesh": "16x16",
     "kind": "prefill", "dominant": "memory_s", "useful_flops_ratio": 0.05},
    {"arch": "e", "shape": "train_4k", "multi_pod": False,
     "error": "RuntimeError: x"},
    {"arch": "e", "shape": "decode_32k", "multi_pod": True,
     "error": "ValueError: y"},
]


def test_dryrun_roofline_hand_count(rows):
    r = rows["dryrun_roofline"]
    assert (r["n_pass"], r["n_total"]) == (6, 8)
    assert r["headline"]["pass"] == "6/8"
    assert r["dominant_hist"] == {"compute_s": 3, "memory_s": 2,
                                  "collective_s": 1}
    assert r["worst_useful_flops"] == [
        {"arch": "d", "shape": "train_4k", "ratio": 0.1},
        {"arch": "b", "shape": "train_4k", "ratio": 0.2},
        {"arch": "a", "shape": "train_4k", "ratio": 0.5}]


def test_dryrun_roofline_without_a_file():
    got = TT.dryrun_roofline(TT.QUICK, "cpu", path=None)
    assert "error" in got["headline"]
