"""``chip_smoke.py``'s problems and its convex spread.

The smoke builds each fog problem of ``launch/train.py`` once for each
value of the flags ``build_problem`` reads, and hands every run a deep
copy of that build: the copy is bit for bit a fresh build and shares no
array with the cached one; flags the build does not read hit the cache
and each flag it reads misses; a run through the memo is bit for bit a
run without it; the original ``build_problem`` is back however the
block ends. The card's spread of the convex solve under 1e-7 moves of
z0 comes from one batched descent whose five plans are those of five
sequential solves."""
import contextlib
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--mode", "fog", "--model", "mlp", "--n", "20", "--T", "4",
         "--tau", "2", "--n-train", "300", "--n-test", "60", "--device",
         "cpu"]
# the problems the smoke builds, at a small size
KINDS = {"static": [], "churn": ["--churn", "0.1"],
         "flap": ["--schedule", "flap", "--p-flap", "0.1"],
         "setting E": ["--setting", "E", "--error-model", "sqrt"]}
# flags build_problem does not read
UNREAD = {"setting": ["--setting", "E"], "engine": ["--engine", "batched"],
          "tiers": ["--tiers", "5@2,1@4"],
          "faults": ["--faults", "mixed", "--fault-rate", "0.2"],
          "sanitize": ["--sanitize"], "replan": ["--replan", "predict"]}
# each flag build_problem reads, itself or through schedule_kind
READ = {"seed": ["--seed", "1"], "n_train": ["--n-train", "320"],
        "n_test": ["--n-test", "80"], "n": ["--n", "21"], "T": ["--T", "6"],
        "tau": ["--tau", "4"], "eta": ["--eta", "0.05"],
        "model": ["--model", "linear"], "non_iid": ["--non-iid"],
        "costs": ["--costs", "synthetic"], "f_err": ["--f-err", "0.5"],
        "topology": ["--topology", "scale_free"], "rho": ["--rho", "0.5"],
        "schedule": ["--schedule", "flap"], "p_exit": ["--p-exit", "0.1"],
        "p_entry": ["--p-entry", "0.1"], "churn": ["--churn", "0.1"],
        "p_flap": ["--p-flap", "0.2"], "p_recover": ["--p-recover", "0.3"]}


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
        yield chip_smoke
    finally:
        sys.path.remove(ROOT)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _memo(cs):
    from repro_torch.launch import train

    return cs.ProblemMemo(train, cs.Clock("cpu"))


def _args(argv):
    from repro_torch.launch import train

    return train.parse_args(argv)


def _leaves(obj, path="pb"):
    """(path, leaf) of every array and scalar a bundle holds."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        yield path, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        yield path, type(obj)
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(obj):
        yield path, type(obj)
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif hasattr(obj, "__dict__"):
        yield path, type(obj)
        for k, v in vars(obj).items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, obj


def _bitwise(a, b):
    if isinstance(a, torch.Tensor):
        a, b = a.numpy(), b.numpy()
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_copy_is_bitwise_a_fresh_build(cs, kind):
    memo = _memo(cs)
    args = _args(SMALL + KINDS[kind])
    first, again = memo(args), memo(args)
    assert (memo.builds, memo.hits) == (1, 1)
    fresh = memo.build(args)
    cached = next(iter(memo.cache.values()))[0]
    want = list(_leaves(fresh))
    assert any(isinstance(v, np.ndarray) for _, v in want)
    for got in (first, again):
        have = list(_leaves(got))
        assert [p for p, _ in have] == [p for p, _ in want]
        for (path, g), (_, w) in zip(have, want):
            assert _bitwise(g, w), path
        arrays = [v for _, v in have if isinstance(v, np.ndarray)]
        held = [v for _, v in _leaves(cached) if isinstance(v, np.ndarray)]
        assert not any(np.shares_memory(a, h) for a in arrays for h in held
                       if a.size and h.size)
    # the schedule still reads the bundle's own adjacency
    if kind in ("static", "setting E"):
        assert again["schedule"].static_adj is again["adj"]


@pytest.mark.parametrize("flag", list(UNREAD))
def test_a_flag_the_build_does_not_read_hits(cs, flag):
    memo = _memo(cs)
    memo(_args(SMALL))
    memo(_args(SMALL + UNREAD[flag]))
    assert (memo.builds, memo.hits) == (1, 1)
    assert flag not in memo.flags


@pytest.mark.parametrize("flag", list(READ))
def test_each_flag_the_build_reads_misses(cs, flag):
    memo = _memo(cs)
    memo(_args(SMALL))
    memo(_args(SMALL + READ[flag]))
    assert (memo.builds, memo.hits) == (2, 0)


def test_the_key_is_every_flag_the_build_reads(cs):
    from repro_torch.launch import train

    assert set(cs.problem_flags(train)) == set(READ)


def test_a_source_that_hands_args_on_is_refused(cs):
    class Fake:
        @staticmethod
        def build_problem(args):
            return helper(args.seed)                      # noqa: F821

        @staticmethod
        def schedule_kind(args):
            return hidden(args)                           # noqa: F821

    with pytest.raises(RuntimeError, match="hidden"):
        cs.problem_flags(Fake)


def test_a_run_through_the_memo_is_bitwise_one_without(cs, one_thread,
                                                        capsys):
    """Crash faults make the engine empty crashed devices' streams in
    place: the clean run after a crashed one, a hit on the same problem,
    must start from the build's streams all the same."""
    from repro_torch.core import movement as mv
    from repro_torch.launch import train

    argvs = [SMALL + ["--faults", "crash", "--fault-rate", "0.3"], SMALL]
    want = [train.main(argv) for argv in argvs]
    with cs.ProblemMemo(train, cs.Clock("cpu")) as memo:
        runs = [train.main(argv) for argv in argvs]
    assert (memo.builds, memo.hits) == (1, 1)
    capsys.readouterr()
    for got, w in zip(runs, want):
        assert mv.plans_equal(got["plan"], w["plan"])
        assert got["cost"] == w["cost"]
        assert sorted(got["history"]) == sorted(w["history"])
        for k, v in w["history"].items():
            if isinstance(v, dict):
                assert got["history"][k] == v, k
            else:
                assert np.array_equal(np.asarray(got["history"][k], float),
                                      np.asarray(v, float),
                                      equal_nan=True), k


@pytest.mark.parametrize("ends", ["returns", "raises"])
def test_build_problem_is_restored(cs, ends):
    from repro_torch.launch import train

    real = train.build_problem
    clock = cs.Clock("cpu")
    with pytest.raises(ZeroDivisionError) if ends == "raises" else \
            contextlib.nullcontext():
        with cs.ProblemMemo(train, clock) as memo:
            assert train.build_problem is memo and memo.build is real
            memo(_args(SMALL))
            memo(_args(SMALL))
            if ends == "raises":
                1 / 0
    assert train.build_problem is real
    assert clock.seconds["problem builds"] == 1
    assert clock.seconds["problem copies (hits)"] == 1
    assert "problem hits saved" in clock.seconds


def _setting_b(cs):
    from repro_torch.core import movement as mv

    pb = _memo(cs).build(_args(SMALL))
    T, n = pb["D"].shape
    return pb["traces"], pb["schedule"], pb["D"], mv.convex_z0(T, n, [0])[0]


def test_the_spread_is_one_descent_of_five_sequential_solves(
        cs, one_thread, monkeypatch):
    """On setting-B inputs, where the solve is not chaotic, each of the
    batch's plans is within (n)'s batched tolerance, 1e-5, of the
    sequential solve from the same moved z0."""
    from repro_torch.core import movement as mv

    tr, sched, D, z0 = _setting_b(cs)
    calls = []
    real = mv.solve_convex_batched

    def recorded(*a, **kw):
        calls.append((kw["z0"], real(*a, **kw)))
        return calls[-1][1]

    monkeypatch.setattr(mv, "solve_convex_batched", recorded)
    s_spread, _ = cs._card_spread(mv, tr, sched, D, "sqrt", z0, "cpu")
    monkeypatch.undo()
    (z0s, plans), = calls
    assert len(plans) == len(cs.SPREAD_KS) == 5
    for zk, p in zip(z0s, plans):
        want = mv.solve_convex(tr, sched, D, error_model="sqrt", z0=zk,
                               device="cpu")
        assert max(abs(p.s - want.s).max(), abs(p.r - want.r).max()) <= 1e-5
    base = plans[2]
    assert s_spread == max(max(abs(p.s - base.s).max(),
                               abs(p.r - base.r).max())
                           for i, p in enumerate(plans) if i != 2)


def test_the_spread_passes_five_points_in_order(cs, monkeypatch):
    """z0·(1 + k·1e-7) for k = -2..2, in that order, in one call; the
    spread is taken from the k = 0 plan, the objective's over all five."""
    from repro_torch.core import movement as mv

    tr, sched, D, z0 = _setting_b(cs)
    T, n = D.shape
    calls = []

    def fake(tr_seq, adj_seq, D_seq, **kw):
        calls.append(kw)
        return [mv.MovementPlan(s=np.full((T, n, n), k, float),
                                r=np.full((T, n), -k, float))
                for k in (0.3, 0.1, 0.0, 0.2, 0.4)]

    monkeypatch.setattr(mv, "solve_convex_batched", fake)
    monkeypatch.setattr(cs, "_objective", lambda mv_, p, *a: p.s[0, 0, 0])
    got = cs._card_spread(mv, tr, sched, D, "neg_G", z0, "cpu")
    (kw,), = [calls]
    assert kw["error_model"] == "neg_G" and kw["device"] == "cpu"
    assert cs.SPREAD_KS == (-2, -1, 0, 1, 2)
    assert len(kw["z0"]) == 5
    for k, zk in zip((-2, -1, 0, 1, 2), kw["z0"]):
        assert torch.equal(zk, z0 * (1 + k * 1e-7))
    assert torch.equal(kw["z0"][2], z0)
    assert got == (0.4, 0.4)
