"""fog-lint for the port (``repro_torch.analysis``): a violating, a clean
and a waived fixture for every rule, in torch idiom; the waiver
machinery (a justification is mandatory, file-level waivers, rule names
must match); the port's own tree lints clean through the API and the
CLI, and ``--list-waivers`` shows a justification on every waiver; and
the oracle-pairing backfill the analyzer asked for
(``stage_rounds_flat`` against the reference's and the per-cell
staging)."""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from repro.data import pipeline as rpl
from repro_torch.analysis import all_rules, lint_paths, lint_sources, \
    rules_by_name
from repro_torch.analysis import core as acore
from repro_torch.data import pipeline as tpl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src", "repro_torch")
TESTS = os.path.join(REPO, "tests")


def run_rule(rule_name, sources, tests_sources=None):
    return lint_sources(sources, rules_by_name([rule_name]),
                        tests_sources=tests_sources)


def lines(res):
    return [f.line for f in res.findings]


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


# ---------------------------------------------------------------------------
# rule fixtures: violating / clean / waived for every rule
# ---------------------------------------------------------------------------

DENSE_BAD = """\
import numpy as np
import torch
A = np.zeros((n, n))
B = torch.ones((n, n), dtype=torch.bool)
C = torch.outer(a, b)
D = a[:, None] * b[None, :]
E = sched.adj_at(t)
F = plan.s
"""
DENSE_OK = """\
import numpy as np
import torch
A = np.zeros((n, 3))
B = torch.zeros((T, n))
C = torch.ones((4, 4))
E = sched.edges_at(t)
F = plan.edges()
"""

MASK_BAD = """\
def agg(W, mask, contrib):
    a = W * mask
    b = contrib * grads
    return a, b
"""
MASK_OK = """\
import torch
def agg(W, mask, p_flag, qok):
    a = torch.where(mask > 0, W, 0.0)
    b = p_flag * qok
    return a, b
"""

RECOMPILE_BAD = """\
import functools
import torch
from repro_torch.kernels import _build
def f(names):
    for n in names:
        _build.load(n)
    while True:
        g = torch.compile(h)
@functools.lru_cache
def _prog(shape, opts=[]):
    pass
def _bucket_program(apply_fn, **kw):
    pass
"""
RECOMPILE_OK = """\
import torch
from repro_torch.kernels import _build
def f(names):
    libs = _build.build(names)
    g = torch.compile(h)
    for n in names:
        g(libs[n])
def _bucket_program(apply_fn, eta: float, faults: bool = False):
    pass
"""

HOSTSYNC_BAD = """\
import torch
def run_rounds_scan(x, T):
    for t in range(T):
        v = x[t].item()
        w = float(x.sum())
        torch.cuda.synchronize()
        x.cpu()
    return x
class _BucketProgram:
    def __call__(self, W):
        return W.tolist()
def _scan_body(c):
    def inner(x):
        return x.numpy()
    return inner
"""
HOSTSYNC_OK = """\
import torch
def run_rounds_scan(x, T):
    for t in range(T):
        n = int(x.shape[0])
        y = x[t] * 2.0
    return x.cpu().numpy(), float(x.sum())
def run_rounds_legacy(x, T):
    for t in range(T):
        x[t].item()
def helper(x):
    return x.item()
class _BucketProgram:
    def __init__(self, eta):
        self.eta = float(eta)
"""

RNG_BAD = """\
import numpy as np
import torch
a = np.random.default_rng()
b = np.random.default_rng(0)
c = np.random.rand(3)
torch.manual_seed(1)
g = torch.Generator()
h = torch.Generator().manual_seed(7)
x = torch.randn(3)
y = torch.randperm(5)
"""
RNG_OK = """\
import numpy as np
import torch
a = np.random.default_rng(seed + 7919)
g = torch.Generator().manual_seed(cfg.seed)
x = torch.randn(3, generator=g)
y = torch.randperm(5, generator=g)
"""

ORACLE_SRC = """\
def greedy_linear_edges(x):
    pass
def aggregate_tier(x):
    pass
def run_rounds_hierarchical(x):
    pass
def _private_flat(x):
    pass
"""

# (rule, path, bad source, expected finding lines, clean source)
CASES = {
    "dense-materialization": ("core/newmod.py", DENSE_BAD,
                              [3, 4, 5, 6, 7, 8], DENSE_OK),
    "nan-unsafe-masking": ("core/engine.py", MASK_BAD, [2, 3], MASK_OK),
    "recompile-hazard": ("core/mod.py", RECOMPILE_BAD, [6, 8, 10, 12],
                         RECOMPILE_OK),
    "host-sync-in-hot-path": ("core/engine.py", HOSTSYNC_BAD,
                              [4, 5, 6, 7, 11, 14], HOSTSYNC_OK),
    "rng-stream-discipline": ("core/faults.py", RNG_BAD,
                              [3, 4, 5, 6, 7, 8, 9, 10], RNG_OK),
}


@pytest.mark.parametrize("rule", list(CASES))
def test_rule_flags_violating_fixture(rule):
    path, bad, want, _ = CASES[rule]
    res = run_rule(rule, {path: bad})
    assert lines(res) == want, [f.format() for f in res.findings]
    assert all(f.rule == rule for f in res.findings)


@pytest.mark.parametrize("rule", list(CASES))
def test_rule_passes_clean_fixture(rule):
    path, _, _, ok = CASES[rule]
    res = run_rule(rule, {path: ok})
    assert res.ok, [f.format() for f in res.findings]


@pytest.mark.parametrize("rule", list(CASES))
def test_rule_waived_fixture(rule):
    path, bad, want, _ = CASES[rule]
    src = bad.splitlines()
    for ln in sorted(set(want), reverse=True):
        ind = src[ln - 1][:len(src[ln - 1]) - len(src[ln - 1].lstrip())]
        src.insert(ln - 1, f"{ind}# foglint: disable={rule} -- fixture")
    res = run_rule(rule, {path: "\n".join(src) + "\n"})
    assert res.ok, [f.format() for f in res.findings]
    assert len(res.waived) == len(want)


@pytest.mark.parametrize("path", ["models/layers.py", "kernels/ops.py",
                                  "core/schedule.py"])
def test_dense_designated_module_skipped(path):
    assert run_rule("dense-materialization", {path: DENSE_BAD}).ok


@pytest.mark.parametrize("rule,path", [
    ("nan-unsafe-masking", "launch/tables.py"),
    ("host-sync-in-hot-path", "launch/train.py"),
    ("rng-stream-discipline", "core/engine.py")])
def test_rule_out_of_scope_module_ignored(rule, path):
    assert run_rule(rule, {path: CASES[rule][1]}).ok


def test_oracle_pairing_counts_port_tests_only():
    srcs = {"core/x.py": ORACLE_SRC}
    res = run_rule("oracle-pairing", srcs,
                   {"test_x.py": "greedy_linear_edges aggregate_tier "
                                 "run_rounds_hierarchical"})
    assert lines(res) == [1, 3, 5]           # reference tests don't count
    res = run_rule("oracle-pairing", srcs,
                   {"test_torch_x.py": "greedy_linear_edges(a)\n"
                                       "aggregate_tier(b)\n"})
    assert lines(res) == [5]
    assert run_rule("oracle-pairing", srcs).ok   # no test tree: skipped
    src = ORACLE_SRC.replace(
        "def run_rounds_hierarchical",
        "# foglint: disable=oracle-pairing -- re-export\n"
        "def run_rounds_hierarchical")
    res = run_rule("oracle-pairing", {"core/x.py": src},
                   {"test_torch_x.py": "greedy_linear_edges aggregate_tier"})
    assert res.ok and len(res.waived) == 1


# ---------------------------------------------------------------------------
# waiver machinery
# ---------------------------------------------------------------------------


def test_missing_justification_is_a_finding_and_waives_nothing():
    src = ("import numpy as np\n"
           "A = np.zeros((n, n))  # foglint: disable=dense-materialization\n")
    res = run_rule("dense-materialization", {"core/m.py": src})
    assert sorted(f.rule for f in res.findings) == [
        "dense-materialization", "waiver-justification"]
    assert "waiver-justification" in acore.UNWAIVABLE


def test_file_level_waiver():
    src = ("# foglint: disable-file=dense-materialization -- a dense oracle"
           " module\nimport torch\nA = torch.zeros((n, n))\n"
           "B = torch.empty((m, m))\n")
    res = run_rule("dense-materialization", {"core/m.py": src})
    assert res.ok and len(res.waived) == 2
    assert res.waivers[0].file_level


def test_waiver_names_must_match_rule():
    src = ("import torch\n"
           "A = torch.zeros((n, n))  # foglint: disable=nan-unsafe-masking"
           " -- wrong rule\n")
    res = run_rule("dense-materialization", {"core/m.py": src})
    assert lines(res) == [2]


def test_unknown_rule_selection_raises():
    with pytest.raises(ValueError, match="unknown rule"):
        rules_by_name(["no-such-rule"])


def test_parse_error_is_a_finding():
    res = lint_sources({"core/m.py": "def f(:\n"}, all_rules())
    assert [f.rule for f in res.findings] == ["parse-error"]


# ---------------------------------------------------------------------------
# the port's own tree, through the API and the CLI
# ---------------------------------------------------------------------------


def test_repo_lints_clean():
    res = lint_paths([SRC], all_rules(), tests_dir=TESTS)
    assert res.ok, "\n".join(f.format() for f in res.findings)
    assert res.waivers and all(w.justification for w in res.waivers)
    assert {r.name for r in all_rules()} == {
        "dense-materialization", "nan-unsafe-masking", "recompile-hazard",
        "host-sync-in-hot-path", "rng-stream-discipline", "oracle-pairing"}


def test_cli_exits_zero_on_repo():
    out = _cli()
    assert out.returncode == 0, out.stdout + out.stderr
    assert "fog-lint: 0 finding(s)" in out.stdout


def test_cli_list_waivers():
    out = _cli("--list-waivers")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 missing justification" in out.stdout
    listed = [ln for ln in out.stdout.splitlines() if ") -- " in ln]
    assert listed and not any("MISSING JUSTIFICATION" in ln
                              for ln in listed)


def test_cli_nonzero_on_violation(tmp_path):
    bad = tmp_path / "core"
    bad.mkdir()
    (bad / "newmod.py").write_text(
        "import torch\nA = torch.zeros((n, n))\n")
    out = _cli(str(tmp_path))
    assert out.returncode == 1
    assert "dense-materialization" in out.stdout


def test_port_analysis_imports_nothing_of_the_reference():
    for dirpath, _, files in os.walk(os.path.join(SRC, "analysis")):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert "from repro." not in text and "import repro." \
                    not in text, f


# ---------------------------------------------------------------------------
# oracle-pairing backfill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [3, 8])
def test_stage_rounds_flat_matches_reference_and_cells(P):
    rng = np.random.default_rng(5)
    y = rng.integers(0, 10, 400).astype(np.int32)
    streams = rpl.poisson_streams(9, 5, y, rng=np.random.default_rng(2),
                                  mean_per_round=2.5)
    flat = tpl.flat_from_streams(tpl.poisson_streams(
        9, 5, y, rng=np.random.default_rng(2), mean_per_round=2.5))
    with warnings.catch_warnings():      # P = 3 truncates some cells
        warnings.simplefilter("ignore", UserWarning)
        want = rpl.stage_rounds_flat(rpl.flat_from_streams(streams), y, P)
        got = tpl.stage_rounds_flat(flat, y, P)
        cells = tpl.stage_rounds(tpl.streams_from_flat(flat).collected, y,
                                 P)
    for a, b, c in zip(got, want, cells):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
