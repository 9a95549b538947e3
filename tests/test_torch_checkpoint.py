"""Checkpoints through the port (``repro_torch.checkpoint``, the scan
engine's window-boundary checkpoint and resume, serve's
``--checkpoint/--resume``) against the reference's contract.

* The checkpoint module: provenance metadata, every mismatched leaf in
  one error (the reference's message), an atomic save, bfloat16 bitwise.
* The scan engine: a checkpointed run equals the whole-horizon run bit
  for bit, and a run resumed mid-horizon equals the uninterrupted one
  bit for bit, clean and under faults; a snapshot of another run
  config names the key that differs; other engines refuse the keywords.
* A port run resumed from a reference snapshot (msgpack, carried across
  by ``models.convert.scan_state_from_jax``) matches the reference's
  uninterrupted run within the engine tolerances (rtol 2e-3, atol 1e-4
  on losses, 1e-2 on accuracy; exact on H and the fault fields).
"""
import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rckpt
from repro.core import engine as reng
from repro.core import faults as rfl
from repro.core import federated as RF
from repro.core import movement as rmv
from repro.core.costs import synthetic_costs
from repro.core.topology import fully_connected
from repro.data import pipeline as rpl
from repro.data.synthetic import make_image_dataset
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import faults as tfl
from repro_torch.core import federated as TF
from repro_torch.core import movement as tmv
from repro_torch.data import pipeline as tpl
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax, scan_state_from_jax
from test_torch_engine import assert_histories_match

N, T, TAU = 6, 12, 4
DATA = make_image_dataset(n_train=1200, n_test=400, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the checkpoint module
# ---------------------------------------------------------------------------


def test_metadata_provenance_stamp(tmp_path):
    path = str(tmp_path / "ck.pt")
    tree = {"a": torch.zeros(2)}
    ckpt.save(path, tree, {"step": 3})
    _, meta = ckpt.restore(path, tree)
    assert meta["step"] == 3
    assert meta["torch_version"] == str(torch.__version__)
    assert isinstance(meta["git_sha"], str) and meta["git_sha"]
    assert "saved_at" in meta and "jax_version" not in meta
    ckpt.save(path, tree, {"git_sha": "pinned"})     # caller keys win
    _, meta = ckpt.restore(path, tree)
    assert meta["git_sha"] == "pinned"


def test_restore_reports_every_mismatched_leaf(tmp_path):
    path = str(tmp_path / "ck.pt")
    ckpt.save(path, {"a": torch.zeros(2), "b": torch.zeros(3),
                     "gone": torch.zeros(1)})
    template = {"a": torch.zeros(4),                     # shape
                "b": torch.zeros(3, dtype=torch.int32),  # dtype
                "new": torch.zeros(1)}                   # missing
    with pytest.raises(ValueError) as ei:
        ckpt.restore(path, template)
    msg = str(ei.value)
    assert "4 mismatched leaf path(s)" in msg
    assert "['a']: shape (2,) != template (4,)" in msg
    assert "['b']: dtype" in msg
    assert "['new']: missing from checkpoint" in msg
    assert "['gone']: in checkpoint but not in template" in msg


def test_leaf_paths_are_the_reference_spelling(tmp_path):
    """Nested dicts, lists and tuples keyed as jax's ``keystr`` spells
    them, so a mismatch reads as the reference's would."""
    tree = {"carry": {"W": {"w1": torch.zeros(2)}}, "xs": [torch.zeros(1),
                                                           (torch.ones(1),)]}
    keys = [k for k, _ in ckpt._flatten(tree)]
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, tree))
    assert keys == [jax.tree_util.keystr(p) for p, _ in flat]
    path = str(tmp_path / "ck.pt")
    ckpt.save(path, tree)
    out, _ = ckpt.restore(path, tree)
    assert isinstance(out["xs"][1], tuple)
    assert torch.equal(out["xs"][1][0], torch.ones(1))


def test_save_is_atomic_on_failure(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.pt")
    ckpt.save(path, {"a": torch.arange(3.0)})
    before = open(path, "rb").read()

    def boom(*a, **kw):
        raise RuntimeError("disk full")

    monkeypatch.setattr(torch, "save", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        ckpt.save(path, {"a": torch.arange(5.0)})
    assert open(path, "rb").read() == before
    assert not os.path.exists(path + ".tmp")
    assert os.listdir(tmp_path) == ["ck.pt"]


def test_bfloat16_and_numpy_leaves_roundtrip_bitwise(tmp_path):
    path = str(tmp_path / "ck.pt")
    w = torch.from_numpy(np.random.default_rng(0).normal(size=17)
                         .astype(np.float32)).to(torch.bfloat16)
    tree = {"w": w, "round": np.asarray(5, np.int64),
            "h": np.arange(4, dtype=np.float32)[1:]}
    ckpt.save(path, tree)
    out, _ = ckpt.restore(path, tree)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), w.view(torch.int16))
    assert isinstance(out["h"], np.ndarray) and int(out["round"]) == 5
    np.testing.assert_array_equal(out["h"], tree["h"])


# ---------------------------------------------------------------------------
# the scan engine
# ---------------------------------------------------------------------------


def _problem(mod_pl):
    rng = np.random.default_rng(0)
    traces = synthetic_costs(N, T, rng)
    adj = fully_connected(N)
    streams = mod_pl.poisson_streams(N, T, DATA[1], rng=rng)
    return traces, adj, streams


def _jax_params():
    jp, _ = reng.make_model("mlp", jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in jp.items()}


def _run(engine="scan", eta=0.05, **kw):
    traces, adj, streams = _problem(tpl)
    plan = tmv.greedy_linear(traces, adj, backend="numpy")
    cfg = TF.FedConfig(n=N, T=T, tau=TAU, eta=eta, model="mlp", seed=0)
    return TF.run_network_aware(cfg, DATA, traces, adj, plan,
                                streams=streams, engine=engine,
                                params=params_from_jax(_jax_params()),
                                device="cpu", **kw)


def _assert_bitwise(a, b):
    assert a["agg_round"] == b["agg_round"]
    assert a["test_acc"] == b["test_acc"]
    assert a["test_loss"] == b["test_loss"]
    assert len(a["device_loss"]) == len(b["device_loss"])
    for x, y in zip(a["device_loss"], b["device_loss"]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.asarray(a["H_agg"]),
                                  np.asarray(b["H_agg"]))
    assert a.get("agg_survivors") == b.get("agg_survivors")
    assert a.get("agg_quorum_ok") == b.get("agg_quorum_ok")


FAULTS = [tfl.FaultEvent(3, "corrupt", 0, float("nan")),
          tfl.FaultEvent(7, "drop", 1), tfl.FaultEvent(5, "crash", 2)]


@pytest.mark.parametrize("every", [1, 2, 5])
def test_chunked_checkpoint_matches_monolithic_bitwise(tmp_path, every):
    mono = _run()
    ck = str(tmp_path / "ck.pt")
    chunked = _run(checkpoint_path=ck, checkpoint_every=every)
    _assert_bitwise(mono, chunked)
    assert "stopped_at" not in chunked and os.path.exists(ck)
    resumed = _run(resume=ck)        # a finished snapshot: nothing to run
    _assert_bitwise(mono, resumed)


@pytest.mark.parametrize("stop", [1, 4, 8])
def test_resume_mid_horizon_bitwise(tmp_path, stop):
    full = _run()
    ck = str(tmp_path / "ck.pt")
    part = _run(checkpoint_path=ck, stop_after=stop)
    boundary = -(-stop // TAU) * TAU
    assert part["stopped_at"] == boundary
    assert len(part["test_acc"]) == boundary // TAU
    assert len(part["device_loss"]) == boundary
    _assert_bitwise(full, _run(resume=ck))


@pytest.mark.parametrize("guard", [True, False])
def test_resume_faulted_run_bitwise(tmp_path, guard):
    fs = tfl.FaultSchedule(T, N, TAU, FAULTS)
    kw = dict(faults=fs, guard=guard, quorum=0.2)
    full = _run(**kw)
    ck = str(tmp_path / "ck.pt")
    _run(checkpoint_path=ck, stop_after=4, **kw)
    resumed = _run(resume=ck, **kw)
    if guard:
        _assert_bitwise(full, resumed)
    else:                  # NaN from the first window on, in the same places
        for x, y in zip(full["device_loss"], resumed["device_loss"]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(full["test_loss"],
                                      resumed["test_loss"])
        assert np.isnan(resumed["test_loss"][-1])


@pytest.mark.parametrize("kw,key", [
    (dict(eta=0.01), "eta"), (dict(guard=False), "guard"),
    (dict(quorum=0.5), "quorum"),
])
def test_resume_rejects_mismatched_run_config(tmp_path, kw, key):
    ck = str(tmp_path / "ck.pt")
    base = dict(faults=tfl.FaultSchedule(T, N, TAU, FAULTS), guard=True,
                quorum=0.2)
    _run(checkpoint_path=ck, stop_after=4, **base)
    with pytest.raises(ValueError, match=f"with {key}=") as ei:
        _run(resume=ck, **{**base, **kw})
    assert "this run has" in str(ei.value)


def test_resume_rejects_a_faulted_snapshot_in_a_clean_run(tmp_path):
    """A faulted run's history has the survivor and quorum rows a clean
    run's lacks: the restore names both leaves."""
    ck = str(tmp_path / "ck.pt")
    _run(checkpoint_path=ck, stop_after=4,
         faults=tfl.FaultSchedule(T, N, TAU, FAULTS))
    with pytest.raises(ValueError, match="2 mismatched") as ei:
        _run(resume=ck)
    assert "['hist']['surv']: in checkpoint but not in template" in \
        str(ei.value)


def test_resume_rejects_another_model(tmp_path):
    ck = str(tmp_path / "ck.pt")
    _run(checkpoint_path=ck, stop_after=4)
    traces, adj, streams = _problem(tpl)
    plan = tmv.greedy_linear(traces, adj, backend="numpy")
    cfg = TF.FedConfig(n=N, T=T, tau=TAU, eta=0.05, model="linear", seed=0)
    with pytest.raises(ValueError, match="mismatched leaf path"):
        TF.run_network_aware(cfg, DATA, traces, adj, plan, streams=streams,
                             device="cpu", resume=ck)


@pytest.mark.parametrize("engine,extra", [
    ("legacy", {}), ("scan", {"hierarchy": True}),
])
@pytest.mark.parametrize("kw", [dict(checkpoint_path="x"),
                                dict(resume="x"), dict(stop_after=4)])
def test_checkpoint_keywords_are_scan_only(engine, extra, kw):
    if extra:
        from repro_torch.core.hierarchy import TierTree
        extra = {"hierarchy": TierTree.from_spec("3@4,1@12", N)}
    with pytest.raises(ValueError, match="checkpoint/resume is a "
                                         "scan-engine feature"):
        _run(engine=engine, **extra, **kw)


def test_port_resumes_a_reference_snapshot(tmp_path):
    """The reference checkpoints mid-horizon (msgpack); the state is
    carried across and the port finishes the run."""
    fs_r = rfl.FaultSchedule(T, N, TAU, [
        rfl.FaultEvent(3, "corrupt", 0, float("nan")),
        rfl.FaultEvent(7, "drop", 1), rfl.FaultEvent(5, "crash", 2)])
    kw = dict(guard=True, quorum=0.2)
    traces, adj, streams = _problem(rpl)
    plan = rmv.greedy_linear(traces, adj, backend="numpy")
    cfg = RF.FedConfig(n=N, T=T, tau=TAU, eta=0.05, model="mlp", seed=0)

    def ref(**k):
        return RF.run_network_aware(cfg, DATA, traces, adj, plan,
                                    streams=streams, engine="scan",
                                    faults=fs_r, **kw, **k)

    full = ref()
    rck = str(tmp_path / "ref.msgpack")
    ref(checkpoint_path=rck, stop_after=4)
    jp = _jax_params()
    like = {"carry": {"W": reng._stack(jp, N), "wg": jp,
                      "H": np.zeros(N, np.float32),
                      "waiting": np.zeros(N, np.float32)},
            "hist": {"losses": np.zeros((T, N), np.float32),
                     "tl": np.zeros(T, np.float32),
                     "ta": np.zeros(T, np.float32),
                     "H_at": np.zeros((T, N), np.float32),
                     "surv": np.zeros(T, np.float32),
                     "qok": np.ones(T, np.float32)},
            "round": np.asarray(0, np.int64)}
    state, meta = rckpt.restore(rck, like)
    assert int(state["round"]) == 4
    pck = str(tmp_path / "port.pt")
    ckpt.save(pck, scan_state_from_jax(jax.tree_util.tree_map(
        np.asarray, state)), metadata={k: meta[k] for k in (
            "kind", "T", "n", "tau", "eta", "faults", "guard", "quorum")})
    got = _run(faults=tfl.FaultSchedule(T, N, TAU, FAULTS), resume=pck,
               **kw)
    # the first window is the reference's own history, bit for bit
    np.testing.assert_array_equal(got["device_loss"][:4],
                                  full["device_loss"][:4])
    assert got["test_acc"][0] == full["test_acc"][0]
    assert got["agg_survivors"] == full["agg_survivors"]
    assert got["agg_quorum_ok"] == full["agg_quorum_ok"]
    assert got["fault_summary"] == full["fault_summary"]
    assert_histories_match(got, full)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def _serve(*flags):
    with contextlib.redirect_stdout(io.StringIO()):
        return serve.main(["--device", "cpu", "--arch", "zamba2-7b",
                           "--gen", "6", "--batch", "2", *flags])


def test_serve_checkpoint_then_resume_gives_the_same_tokens(tmp_path):
    ck = str(tmp_path / "serve.pt")
    first = _serve("--checkpoint", ck)
    _, meta = ckpt.restore(ck, serve.init_params(
        serve.T.specs(serve.get_config("zamba2-7b", smoke=True)), seed=0,
        device="cpu"))
    assert meta["arch"] == "zamba2-7b" and meta["config"] == "smoke"
    again = _serve("--resume", ck, "--seed", "0")
    assert again["resumed"] and not first["resumed"]
    assert again["sample"] == first["sample"]
    assert not again["interrupted"]


def test_serve_resume_restores_the_snapshot_not_the_seed(tmp_path):
    """A snapshot drawn from seed 0, resumed by a run with seed 3 (its
    prompts drawn from seed 3): the tokens are seed 0's weights on seed
    3's prompts."""
    ck = str(tmp_path / "serve.pt")
    _serve("--checkpoint", ck)
    resumed = _serve("--resume", ck, "--seed", "3")
    cfg = serve.get_config("zamba2-7b", smoke=True)
    params = serve.init_params(serve.T.specs(cfg), seed=0, device="cpu")
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    toks, _ = serve.greedy_generate(cfg, params, prompts, 6)
    assert resumed["sample"] == toks[0, -10:].tolist()


def test_serve_resume_checks_the_arch(tmp_path):
    ck = str(tmp_path / "serve.pt")
    cfg = serve.get_config("zamba2-7b", smoke=True)
    params = serve.init_params(serve.T.specs(cfg), seed=0, device="cpu")
    ckpt.save(ck, params, {"arch": "qwen3-14b"})
    with pytest.raises(SystemExit, match="saved for arch 'qwen3-14b'"):
        _serve("--resume", ck)


def test_serve_first_sigint_flushes_and_exits_cleanly(tmp_path,
                                                      monkeypatch):
    """A SIGINT during decoding: the token in flight finishes, the loop
    stops, the snapshot is flushed with ``interrupted`` and the partial
    generation is reported."""
    import signal

    ck = str(tmp_path / "serve.pt")
    real = serve.greedy_generate
    calls = {"n": 0}

    def stop_after_two(*a, should_stop, **kw):
        def poll():
            calls["n"] += 1
            if calls["n"] == 2:
                signal.raise_signal(signal.SIGINT)
            return should_stop()
        return real(*a, should_stop=poll, **kw)

    monkeypatch.setattr(serve, "greedy_generate", stop_after_two)
    out = _serve("--checkpoint", ck)
    assert out["interrupted"]
    assert out["generated_shape"] == [2, 16 + 2]
    _, meta = ckpt.restore(ck, serve.init_params(
        serve.T.specs(serve.get_config("zamba2-7b", smoke=True)), seed=0,
        device="cpu"))
    assert meta["interrupted"] is True
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler
