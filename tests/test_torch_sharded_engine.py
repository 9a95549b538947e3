"""The sharded fog engine (``core/engine.run_rounds_sharded``), the
``"auto"`` engine rule and the FedAvg round over a process group, on the
CPU (gloo).

* World of one, in this process: ``run_rounds_sharded`` is bit for bit
  ``run_rounds_batched_single``, clean and under faults, with two
  all-reduces a window (numerator, H total) and a third under faults
  (survivor and expected counts); ``--engine sharded`` equals
  ``--engine batched`` through the CLI; the FedAvg round on the group
  is bit for bit the round without one.
* World of two, in a subprocess of two gloo ranks (n = 5: one phantom
  device on rank 1): ``agg_round``, ``H_agg``, ``active``,
  ``processed_counts`` and ``agg_survivors`` / ``agg_quorum_ok`` equal,
  and ``device_loss`` / ``test_loss`` within rtol 2e-3, atol 1e-4 and
  ``test_acc`` within atol 1e-2 (the engines' tolerances), against the
  port's scan engine and against the reference's ``run_rounds_sharded``
  on 2 forced host devices (another subprocess), clean and faulted;
  ``resolve_engine("auto")`` is "scan" before the group and "sharded"
  on it; on a data mesh of rank 0 alone, rank 1 receives rank 0's
  history, bitwise the one-card one. The FedAvg round on the two ranks against the round that runs
  its two shards in turn: eq. (4) sums the same two products in the
  same order, so it is held bit for bit (observed: equal).
"""
import copy
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import engine as reng
from repro_torch.core import engine as teng
from repro_torch.core import faults as tfl
from repro_torch.core import federated as TF
from repro_torch.core import movement as tmv
from repro_torch.core.costs import synthetic_costs
from repro_torch.core.topology import fully_connected
from repro_torch.data import pipeline as tpl
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.distributed import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL, ACC_ATOL = 2e-3, 1e-4, 1e-2
N, T, TAU = 5, 12, 4
EVENTS = [(3, "corrupt", 0, float("nan")), (5, "crash", 2), (7, "drop", 3),
          (11, "drop", 1), (11, "drop", 4)]
EXACT = ("agg_round", "H_agg", "active", "processed_counts")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo world of one in this process, made by the port's own
    ``init_process_group`` and destroyed after the module."""
    owned = not dist.is_initialized()
    mesh_lib.init_process_group("cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    yield
    if owned:
        dist.destroy_process_group()


def _data():
    return make_image_dataset(n_train=1200, n_test=400, seed=0)


def _setup(seed=0):
    cfg = TF.FedConfig(n=N, T=T, tau=TAU, eta=0.05, model="mlp", seed=seed)
    data = _data()
    rng = np.random.default_rng(seed)
    traces = synthetic_costs(N, T, rng)
    streams = tpl.poisson_streams(N, T, data[1], rng=rng)
    plan = tmv.greedy_linear(traces, fully_connected(N))
    return cfg, data, traces, plan, streams


def _faults():
    return tfl.FaultSchedule(T, N, TAU, [tfl.FaultEvent(*e)
                                         for e in EVENTS])


def _params(seed=0):
    jp, _ = reng.make_model("mlp", jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in jp.items()}


def _port(engine, faulted=False, **kw):
    cfg, data, traces, plan, streams = _setup()
    fk = dict(faults=_faults(), guard=True, quorum=0.6) if faulted else {}
    return TF.run_network_aware(cfg, data, traces, None, plan,
                                streams=copy.deepcopy(streams),
                                engine=engine,
                                params=params_from_jax(_params()),
                                device="cpu", **fk, **kw)


def _assert_bitwise(a, b):
    for k in ("device_loss", "H_agg", "test_loss", "test_acc",
              "agg_round", "agg_survivors", "agg_quorum_ok"):
        if k in a or k in b:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


def _assert_close(got, want):
    for k in EXACT:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    for k in ("agg_survivors", "agg_quorum_ok"):
        if k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    for k in ("device_loss", "test_loss"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                               atol=ACC_ATOL)


@pytest.mark.parametrize("faulted", [False, True],
                         ids=["clean", "faulted"])
def test_world_of_one_is_batched_bitwise(world_of_one, faulted):
    want = _port("batched", faulted)
    coll.reset_counts()
    got = _port("sharded", faulted)
    _assert_bitwise(got, want)
    assert coll.all_reduces == (3 if faulted else 2) * (T // TAU)


def test_cli_sharded_equals_batched(world_of_one, capsys):
    args = ["--device", "cpu", "--model", "mlp", "--n", "6", "--T", "8",
            "--tau", "4", "--n-train", "600", "--n-test", "200"]
    want = ttrain.main(args + ["--engine", "batched"])
    got = ttrain.main(args + ["--engine", "sharded"])
    capsys.readouterr()
    assert got["engine"] == "sharded" and got["cost"] == want["cost"]
    _assert_bitwise(got["history"], want["history"])
    assert dist.is_initialized()        # the fixture's group is kept


def test_resolve_engine_cases(world_of_one):
    for name in ("scan", "batched", "sharded", "legacy", "hierarchical"):
        assert teng.resolve_engine(name) == name
    assert teng.resolve_engine("auto") == "scan"        # a world of one


def test_mesh_refusals(world_of_one, monkeypatch):
    with pytest.raises(ValueError, match="DeviceMesh"):
        _port("sharded", mesh=mesh_lib.make_host_mesh(1, 1, device="cpu"))
    cfg, data, traces, plan, streams = _setup()
    with pytest.raises(ValueError, match="ragged"):
        TF.run_network_aware_batched(
            [cfg], data, [plan], streams=[streams], staging="ragged",
            mesh=mesh_lib.make_data_mesh(device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh_lib.make_data_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="process group exists"):
        mesh_lib.init_fake_process_group(4)
    # a group of another backend is never taken in place of the one the
    # device needs
    monkeypatch.setattr(mesh_lib, "backend_for", lambda device: "nccl")
    with pytest.raises(RuntimeError, match="'gloo' process group exists"):
        mesh_lib.init_process_group("cpu")


@pytest.mark.parametrize("n, groups, taus, world, axes", [
    (64, (4, 1), (2, 4), 8, {"pod": 4, "data": 2}),
    (64, (1,), (2,), 8, {"data": 8}),
    (16, (4, 1), (2, 4), 1, {"data": 1}),
    (6, (1,), (2,), 8, {"data": 6})])
def test_tier_mesh_axes(n, groups, taus, world, axes):
    """The extents ``hier_scale`` stamps, as the reference's
    ``tier_mesh_for`` gives them (``tests/test_hierarchy.py``): never
    more pods than gateways, never wider than the widest bucket."""
    from repro_torch.core.hierarchy import TierTree

    tree = TierTree.balanced(n, groups, taus)
    assert mesh_lib.tier_mesh_axes(tree, world) == axes


def _lm_setup():
    from repro_torch.configs import registry
    from repro_torch.models import transformer as MT
    from repro_torch.models.module import init_params

    cfg = registry.get_config("qwen3-14b", smoke=True)
    rng = np.random.default_rng(0)
    tau, B, S = 2, 4, 8
    w = rng.uniform(0.2, 1.5, (tau, B)).astype(np.float32)
    w[0, 1] = 0.0
    batches = {"tokens": torch.from_numpy(rng.integers(
                   0, cfg.vocab_size, (tau, B, S)).astype(np.int32)),
               "labels": torch.from_numpy(rng.integers(
                   0, cfg.vocab_size, (tau, B, S)).astype(np.int32)),
               "weights": torch.from_numpy(w)}
    return cfg, init_params(MT.specs(cfg), 0, torch.float32, "cpu"), \
        batches, tau


def test_fedavg_world_of_one_is_bitwise(world_of_one):
    from repro_torch.distributed.fedavg import make_fedavg_round
    from repro_torch.optim import optimizers as topt

    cfg, params, batches, tau = _lm_setup()
    outs = []
    for group in (None, dist.group.WORLD):
        opt = topt.adamw(3e-3)
        p = topt.tree_map(lambda t: t.clone(), params)
        rnd = make_fedavg_round(cfg, opt, tau, n_shards=1, group=group)
        coll.reset_counts()
        outs.append(rnd(p, opt.init(p), batches))
    # eq. (4) on the group: the H total, then every leaf in one buffer
    assert coll.all_reduces == 2
    (p0, s0, l0), (p1, s1, l1) = outs
    assert torch.equal(l0, l1)
    for a, b in zip(topt.tree_leaves(p0) + topt.tree_leaves(s0),
                    topt.tree_leaves(p1) + topt.tree_leaves(s1)):
        assert torch.equal(a, b)


def test_all_reduce_flat_keeps_shapes_and_refuses_mixed_dtypes(
        world_of_one):
    xs = [torch.arange(6.0).reshape(2, 3), torch.ones(4)]
    got = coll.all_reduce_flat(xs, dist.group.WORLD)
    assert [g.shape for g in got] == [x.shape for x in xs]
    assert all(torch.equal(g, x) for g, x in zip(got, xs))
    with pytest.raises(TypeError, match="one dtype"):
        coll.all_reduce_flat([torch.ones(2), torch.ones(2, dtype=torch.int32)],
                             dist.group.WORLD)


WORKER = r'''
import copy, json, os, sys
import numpy as np
import torch
import torch.multiprocessing as mp


def work(rank, port, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.core import engine as teng
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.fedavg import make_fedavg_round
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import optimizers as topt
    from setups import port_run, lm_setup

    res = {"auto_before": teng.resolve_engine("auto")}
    mesh_lib.init_process_group("cpu")
    res["auto_after"] = teng.resolve_engine("auto")
    for faulted in (False, True):
        coll.reset_counts()
        h = port_run("auto", faulted)
        res[f"all_reduces_{faulted}"] = coll.all_reduces
        if rank == 0:
            np.savez(os.path.join(out_dir, f"port2_{faulted}.npz"),
                     **{k: np.asarray(v) for k, v in h.items()
                        if k in KEYS})
    # a mesh of rank 0 alone: rank 1 is no member and receives the
    # history from rank 0
    h1 = port_run("sharded", False,
                  mesh=mesh_lib.make_data_mesh(1, device="cpu"))
    got = [None, None]
    dist.all_gather_object(got, np.asarray(h1["device_loss"]).tolist())
    res["narrow_mesh_same_on_both"] = got[0] == got[1]
    if rank == 0:
        np.savez(os.path.join(out_dir, "narrow.npz"),
                 **{k: np.asarray(v) for k, v in h1.items() if k in KEYS})
    cfg, params, batches, tau = lm_setup()
    opt = topt.adamw(3e-3)
    group = mesh_lib.make_data_mesh(device="cpu").get_group("data")
    p = topt.tree_map(lambda t: t.clone(), params)
    coll.reset_counts()
    pg, sg, lg = make_fedavg_round(cfg, opt, tau, group=group)(
        p, opt.init(p), batches)
    res["fedavg_all_reduces"] = coll.all_reduces
    if rank == 0:
        p = topt.tree_map(lambda t: t.clone(), params)
        pt, st, lt = make_fedavg_round(cfg, opt, tau, n_shards=2)(
            p, opt.init(p), batches)
        diffs = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                 for a, b in zip(topt.tree_leaves(pg) + topt.tree_leaves(sg),
                                 topt.tree_leaves(pt) + topt.tree_leaves(st))
                 if b.is_floating_point()]
        res["fedavg_max_rel"] = max(diffs)
        res["fedavg_loss"] = [float(lg), float(lt)]
        res["fedavg_equal"] = all(
            torch.equal(a, b) for a, b in zip(
                topt.tree_leaves(pg) + topt.tree_leaves(sg) + [lg],
                topt.tree_leaves(pt) + topt.tree_leaves(st) + [lt]))
        with open(os.path.join(out_dir, "res.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


KEYS = {KEYS}

if __name__ == "__main__":
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(work, args=(port, sys.argv[1]), nprocs=2)
'''

SETUPS = r'''
import copy
from math import nan
import numpy as np
import torch
from repro_torch.core import faults as tfl
from repro_torch.core import federated as TF
from repro_torch.core import movement as tmv
from repro_torch.core.costs import synthetic_costs
from repro_torch.core.topology import fully_connected
from repro_torch.data import pipeline as tpl
from repro_torch.data.synthetic import make_image_dataset

N, T, TAU, EVENTS, PARAMS = {N}, {T}, {TAU}, {EVENTS}, {PARAMS!r}


def port_run(engine, faulted, **kw):
    cfg = TF.FedConfig(n=N, T=T, tau=TAU, eta=0.05, model="mlp", seed=0)
    data = make_image_dataset(n_train=1200, n_test=400, seed=0)
    rng = np.random.default_rng(0)
    traces = synthetic_costs(N, T, rng)
    streams = tpl.poisson_streams(N, T, data[1], rng=rng)
    plan = tmv.greedy_linear(traces, fully_connected(N))
    fk = {{}}
    if faulted:
        fk = dict(faults=tfl.FaultSchedule(
            T, N, TAU, [tfl.FaultEvent(*e) for e in EVENTS]),
            guard=True, quorum=0.6)
    p = dict(np.load(PARAMS))
    return TF.run_network_aware(cfg, data, traces, None, plan,
                                streams=streams, engine=engine,
                                params={{k: torch.from_numpy(v)
                                         for k, v in p.items()}},
                                device="cpu", **fk, **kw)


def lm_setup():
    from repro_torch.configs import registry
    from repro_torch.models import transformer as MT
    from repro_torch.models.module import init_params

    cfg = registry.get_config("qwen3-14b", smoke=True)
    rng = np.random.default_rng(0)
    tau, B, S = 2, 4, 8
    w = rng.uniform(0.2, 1.5, (tau, B)).astype(np.float32)
    w[0, 1] = 0.0
    batches = {{"tokens": torch.from_numpy(rng.integers(
                   0, cfg.vocab_size, (tau, B, S)).astype(np.int32)),
               "labels": torch.from_numpy(rng.integers(
                   0, cfg.vocab_size, (tau, B, S)).astype(np.int32)),
               "weights": torch.from_numpy(w)}}
    return cfg, init_params(MT.specs(cfg), 0, torch.float32, "cpu"), \
        batches, tau
'''

REFERENCE = """
    import sys
    from math import nan
    import numpy as np
    import jax
    from repro.core import faults as rfl
    from repro.core import federated as RF
    from repro.core import movement as rmv
    from repro.core.costs import synthetic_costs
    from repro.core.topology import fully_connected
    from repro.data import pipeline as rpl
    from repro.data.synthetic import make_image_dataset
    from repro.launch.mesh import make_data_mesh

    assert jax.device_count() == 2
    N, T, TAU, EVENTS = {N}, {T}, {TAU}, {EVENTS}
    for faulted in (False, True):
        cfg = RF.FedConfig(n=N, T=T, tau=TAU, eta=0.05, model="mlp", seed=0)
        data = make_image_dataset(n_train=1200, n_test=400, seed=0)
        rng = np.random.default_rng(0)
        traces = synthetic_costs(N, T, rng)
        streams = rpl.poisson_streams(N, T, data[1], rng=rng)
        plan = rmv.greedy_linear(traces, fully_connected(N))
        fk = {{}}
        if faulted:
            fk = dict(faults=rfl.FaultSchedule(
                T, N, TAU, [rfl.FaultEvent(*e) for e in EVENTS]),
                guard=True, quorum=0.6)
        h = RF.run_network_aware(cfg, data, traces, None, plan,
                                 streams=streams, engine="sharded",
                                 mesh=make_data_mesh(2), **fk)
        np.savez(sys.argv[1] + f"/ref2_{{faulted}}.npz",
                 **{{k: np.asarray(v) for k, v in h.items()
                    if k in {KEYS}}})
"""

KEYS = {"device_loss", "test_loss", "test_acc", "agg_round", "H_agg",
        "active", "processed_counts", "agg_survivors", "agg_quorum_ok"}


@pytest.fixture(scope="module")
def world_of_two(tmp_path_factory):
    out = tmp_path_factory.mktemp("world2")
    params = out / "params.npz"
    np.savez(params, **{k: v.numpy()
                        for k, v in params_from_jax(_params()).items()})
    fmt = dict(N=N, T=T, TAU=TAU, EVENTS=repr(EVENTS), KEYS=repr(KEYS))
    work = out / "work" / "worker.py"
    work.parent.mkdir()
    (out / "work" / "setups.py").write_text(
        SETUPS.format(PARAMS=str(params), **fmt))
    work.write_text(WORKER.replace("{KEYS}", repr(KEYS)))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, str(work), str(work.parent)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env),
        subprocess.Popen([sys.executable, "-c",
                          textwrap.dedent(REFERENCE.format(**fmt)),
                          str(out)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=dict(
                             env, JAX_PLATFORMS="cpu",
                             XLA_FLAGS="--xla_force_host_platform_"
                                       "device_count=2"))]
    for p in procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, f"stdout:\n{so}\nstderr:\n{se}"
    res = json.loads((work.parent / "res.json").read_text())

    def hist(path):
        return dict(np.load(path))

    return {"res": res,
            "narrow": hist(work.parent / "narrow.npz"),
            "port2": {f: hist(work.parent / f"port2_{f}.npz")
                      for f in (False, True)},
            "ref2": {f: hist(out / f"ref2_{f}.npz") for f in (False, True)}}


def test_world_of_two_resolves_sharded(world_of_two):
    res = world_of_two["res"]
    assert (res["auto_before"], res["auto_after"]) == ("scan", "sharded")
    assert res["all_reduces_False"] == 2 * (T // TAU)
    assert res["all_reduces_True"] == 3 * (T // TAU)


@pytest.mark.parametrize("faulted", [False, True],
                         ids=["clean", "faulted"])
def test_world_of_two_matches_scan_and_reference(world_of_two, faulted):
    got = world_of_two["port2"][faulted]
    scan = _port("scan", faulted)
    _assert_close(got, {k: np.asarray(v) for k, v in scan.items()
                        if k in KEYS})
    _assert_close(got, world_of_two["ref2"][faulted])


def test_narrow_mesh_shares_its_history(world_of_two):
    """A data mesh of one rank on a world of two: rank 1 takes no part
    and receives rank 0's history, which is the one-card history."""
    assert world_of_two["res"]["narrow_mesh_same_on_both"]
    want = _port("batched")
    for k in ("device_loss", "H_agg", "test_loss", "test_acc"):
        np.testing.assert_array_equal(world_of_two["narrow"][k],
                                      np.asarray(want[k]), err_msg=k)


def test_fedavg_world_of_two_is_the_in_turn_round(world_of_two):
    res = world_of_two["res"]
    assert res["fedavg_equal"], res["fedavg_max_rel"]
    assert res["fedavg_all_reduces"] == 2
    assert res["fedavg_loss"][0] == res["fedavg_loss"][1]
