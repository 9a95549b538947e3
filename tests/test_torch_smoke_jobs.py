"""The jobs of ``chip_smoke.py``: the CPU sides of its card-vs-CPU checks
run in a pool of spawned worker processes beside the card's own work.

A job's result is bit for bit the same call made in this process; a job
that raises, exits or does not return fails the phase that collects it
(and so the run); every job is picklable and is collected by a phase that
runs after the one it starts beside; the phase list keeps (a)-(w) and
v3."""
import contextlib
import io
import multiprocessing
import operator
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300            # s for anything multi-process here


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py`` imported by name, so that the spawned workers
    can unpickle its job functions."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
        yield chip_smoke
    finally:
        sys.path.remove(ROOT)


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def _jobs(cs):
    return cs.Jobs(1, 1, cs.Clock("cpu"))


def test_a_job_is_bitwise_the_same_call_here(cs):
    """(o)'s churn run (cnn n=10, T=20, oracle replanning) at its argv
    through a one-thread worker, against the call in this process."""
    from repro_torch.launch import train

    argv = cs.DYN_SHORT[0] + ["--device", "cpu"]
    jobs = _jobs(cs)
    try:
        jobs.start("o churn CPU", train.main, argv)
        got = jobs.collect("o churn CPU", timeout=TIMEOUT)
    finally:
        jobs.close()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _quiet(train.main, argv)
    finally:
        torch.set_num_threads(threads)
    assert got["cost"] == want["cost"]
    assert got["n_events"] == want["n_events"] and got["replan"] == "oracle"
    assert sorted(got["history"]) == sorted(want["history"])
    for k, v in want["history"].items():
        assert np.array_equal(np.asarray(got["history"][k], float),
                              np.asarray(v, float), equal_nan=True), k
    assert cs._compare_histories(np, got, want) == (0.0, 0.0)


@pytest.mark.parametrize("case", ["raises", "exits", "hangs"])
def test_a_failed_job_fails_its_collecting_phase(cs, case, monkeypatch):
    """The phase that collects a job that raises (here a ZeroDivisionError),
    exits (argparse's SystemExit) or never returns (by the jobs' deadline,
    cut here to 5 s, which also ends ``settle``) fails, the phases around
    it run, and closing the pool leaves no worker behind."""
    from repro_torch.launch import train

    monkeypatch.setattr(cs, "JOB_TIMEOUT", 5 if case == "hangs" else TIMEOUT)
    jobs = _jobs(cs)
    calls = {"raises": (operator.truediv, 1, 0),
             "exits": (train.main, ["--mode", "nonesuch"]),
             "hangs": (time.sleep, 3600)}
    ran = []
    try:
        jobs.start("bad", *calls[case])
        t0 = time.perf_counter()
        jobs.settle()
        failed = cs.run_phases(
            [("before", lambda: ran.append("before")),
             ("bad/cpu", lambda: jobs.collect("bad")),
             ("after", lambda: ran.append("after"))], jobs.clock)
        waited = time.perf_counter() - t0
    finally:
        jobs.close()
    assert failed == ["bad/cpu"] and ran == ["before", "after"]
    assert waited < 60, "a job that raised or exited was waited out"
    assert jobs.pool is None
    assert not multiprocessing.active_children()


def test_every_job_is_picklable_and_collected_after_it_starts(cs):
    """Each starter's jobs pickle (function, arguments) and have keys of
    their own; each is collected by a phase of PHASES that runs after
    (r), where they start; the phases keep (a)-(w) and v3 in order."""
    letters = [chr(c) for c in range(ord("a"), ord("w") + 1)]
    assert [p for p in cs.PHASES if p in letters or p == "v3"] == \
        letters[:letters.index("k")] + ["v3"] + letters[letters.index("k"):]
    assert len(set(cs.PHASES)) == len(cs.PHASES)

    class Recorder:
        def __init__(self):
            self.keys = []

        def start(self, key, fn, *args, **kwargs):
            pickle.dumps((fn, args, kwargs))
            self.keys.append(key)

    origins = set()
    all_keys = []
    for starter, collected_in in cs.JOB_PLAN:     # all start in (r)
        assert cs.PHASES.index("r") < cs.PHASES.index(collected_in)
        rec = Recorder()
        starter(rec)
        assert rec.keys, starter.__name__
        all_keys += rec.keys
        origins.add(collected_in.split("/")[0])
    assert len(set(all_keys)) == len(all_keys)
    # the CPU sides of (b), (g), (n), (o), (p) and (s) run as jobs
    assert origins == {"b", "g", "n", "o", "p", "s"}
    assert len([k for k in all_keys if k.startswith("s3 ")]) == \
        len(cs.LM_RUNS) == 16
    # start_jobs starts each once: (s)'s first, in the order (s) collects
    # them, then the rest, which (t) settles, longest first
    late = [k for k in all_keys if not k.startswith("s3 ")]
    assert sorted(cs.JOB_SECONDS) == sorted(late)
    rec = Recorder()
    cs.start_jobs(rec)
    n_s = len(cs.LM_RUNS)
    assert rec.keys[:n_s] == all_keys[:n_s]
    assert sorted(rec.keys[n_s:]) == sorted(late)
    secs = [cs.JOB_SECONDS[k] for k in rec.keys[n_s:]]
    assert secs == sorted(secs, reverse=True)


def test_the_pool_takes_jobs_in_the_order_they_start(cs):
    """start_jobs' order holds in the pool: a worker takes the jobs in
    the order they were started (here one worker, so one after the
    other)."""
    jobs = _jobs(cs)
    try:
        for k in range(4):
            jobs.start(k, time.time)
        started = [jobs.collect(k, timeout=TIMEOUT) for k in range(4)]
    finally:
        jobs.close()
    assert started == sorted(started)


@pytest.mark.parametrize("cpus, want", [(1, (1, 1)), (2, (1, 1)),
                                        (4, (3, 1)), (8, (7, 1)),
                                        (32, (8, 1))])
def test_job_pool_size_leaves_a_cpu_to_the_card_feeder(cs, cpus, want):
    assert cs.job_pool_size(cpus) == want
