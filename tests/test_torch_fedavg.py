"""The port's FedAvg round (``repro_torch.distributed.fedavg``) on the
CPU.

* At n_shards = 4, τ = 2, sgd 0.05, the round equals its own manual
  H-weighted mean (eq. (4)) of four one-shard rounds on the shards'
  slices, within 1e-6 of each leaf's largest |p|;
* it equals the reference's ``make_fedavg_round`` run under
  ``shard_map`` on 4 forced host devices (in a subprocess, as
  ``tests/test_distributed.py`` runs its meshes), from the same
  parameters and batches, within 1e-5 of each leaf's largest |p|;
* with adamw, the moments are averaged with the same weights and
  ``count`` is kept; a shard with no weight takes no part.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.distributed.fedavg import make_fedavg_round
from repro_torch.models import transformer as T
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.models.module import init_params
from repro_torch.optim import optimizers as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-14b"
TAU, NS, B, S = 2, 4, 8, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(cfg, seed=0, zero_shard=None):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.2, 1.5, (TAU, B)).astype(np.float32)
    w[0, 3] = 0.0
    if zero_shard is not None:
        per = B // NS
        w[:, zero_shard * per:(zero_shard + 1) * per] = 0.0
    return {"tokens": rng.integers(0, cfg.vocab_size, (TAU, B, S)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (TAU, B, S)).astype(
                np.int32),
            "weights": w}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _params(cfg):
    return init_params(T.specs(cfg), 0, torch.float32, "cpu")


def _manual_round(cfg, opt, params, state, batches):
    """Four one-shard rounds on the shards' slices, then Σ w_i · x_i."""
    one = make_fedavg_round(cfg, opt, TAU, n_shards=1)
    per = B // NS
    H = [float(batches["weights"][:, i * per:(i + 1) * per].sum())
         for i in range(NS)]
    tot = max(sum(H), 1e-9)
    outs = [one(params, state, {k: v[:, i * per:(i + 1) * per]
                                for k, v in batches.items()})
            for i in range(NS)]
    avg = topt.tree_map(lambda *xs: sum(x * (h / tot) for x, h in
                                        zip(xs, H)), *[o[0] for o in outs])
    return avg, [o[1] for o in outs], H


def _close(got, want, tol):
    for g, w in zip(topt.tree_leaves(got), topt.tree_leaves(want)):
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=tol * float(np.abs(w).max()))


def test_round_equals_manual_weighted_mean_of_one_shard_rounds():
    cfg = registry.get_config(ARCH, smoke=True)
    opt = topt.sgd(0.05)
    params = _params(cfg)
    state = opt.init(params)
    batches = _t(_batches(cfg))
    p, s, loss = make_fedavg_round(cfg, opt, TAU, n_shards=NS)(
        params, state, batches)
    want, _, _ = _manual_round(cfg, opt, params, state, batches)
    _close(p, want, 1e-6)
    assert int(s["count"]) == TAU and torch.isfinite(loss)


def test_adamw_moments_are_averaged_and_count_kept():
    cfg = registry.get_config(ARCH, smoke=True)
    opt = topt.adamw(3e-3)
    params = _params(cfg)
    state = opt.init(params)
    batches = _t(_batches(cfg, seed=1, zero_shard=2))
    p, s, _ = make_fedavg_round(cfg, opt, TAU, n_shards=NS)(
        params, state, batches)
    want, states, H = _manual_round(cfg, opt, params, state, batches)
    assert H[2] == 0.0
    _close(p, want, 1e-6)
    tot = sum(H)
    for k in ("m", "v"):
        avg = topt.tree_map(lambda *xs: sum(x * (h / tot) for x, h in
                                            zip(xs, H)),
                            *[st[k] for st in states])
        _close(s[k], avg, 1e-6)
    assert s["count"].dtype == torch.int32 and int(s["count"]) == TAU


REF_ROUND = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.distributed.fedavg import make_fedavg_round
from repro.models import transformer as T
from repro.models.module import init_params
from repro.optim import optimizers as opt_lib

out = sys.argv[1]
d = np.load(out + "/batches.npz")
cfg = get_config("%s", smoke=True)
params = init_params(T.specs(cfg), jax.random.PRNGKey(0), jnp.float32)
opt = opt_lib.sgd(0.05)
mesh = jax.make_mesh((%d,), ("data",))
rnd = make_fedavg_round(cfg, opt, %d, mesh)
p, s, loss = rnd(params, opt.init(params),
                 {k: jnp.asarray(d[k]) for k in d.files})
flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
        jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(out + "/init.npz", **flat)
flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
        jax.tree_util.tree_flatten_with_path(p)[0]}
np.savez(out + "/round.npz", **flat)
print(json.dumps({"loss": float(loss), "count": int(s["count"]),
                  "devices": jax.device_count()}))
""" % (ARCH, NS, TAU)


def _unflat(flat, like):
    """numpy leaves keyed by jax keystr paths -> a tree shaped like
    ``like`` (the port's spec tree of the same config)."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}['{k}']") for k, v in node.items()}
        return flat[prefix]
    return build(like, "")


def test_round_equals_reference_shard_map_on_four_devices(tmp_path):
    cfg = registry.get_config(ARCH, smoke=True)
    b = _batches(cfg, seed=2)
    np.savez(tmp_path / "batches.npz", **b)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NS}",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_ROUND),
                        str(tmp_path)], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stderr
    meta = json.loads(r.stdout.strip().splitlines()[-1])
    assert meta["devices"] == NS and meta["count"] == TAU
    specs = T.specs(cfg)
    init = np.load(tmp_path / "init.npz")
    params = lm_params_from_jax(_unflat({k: init[k] for k in init.files},
                                        specs))
    want = np.load(tmp_path / "round.npz")
    want = _unflat({k: want[k] for k in want.files}, specs)
    opt = topt.sgd(0.05)
    p, s, loss = make_fedavg_round(cfg, opt, TAU, n_shards=NS)(
        params, opt.init(params), _t(b))
    _close(p, lm_params_from_jax(want), 1e-5)
    assert int(s["count"]) == TAU
    # the reference's shard_map (out_specs P(), unchecked) returns shard
    # 0's mean loss; the port returns the mean over every shard's steps
    _, _, loss0 = make_fedavg_round(cfg, opt, TAU, n_shards=1)(
        params, opt.init(params), {k: v[:, :B // NS] for k, v in
                                   _t(b).items()})
    assert meta["loss"] == pytest.approx(float(loss0), rel=1e-5)
    assert float(loss) != float(loss0)


def test_one_shard_round_is_tau_plain_steps():
    """At n_shards = 1 (one card) the round is τ local steps with the
    weight 1: the parameters of τ clipped sgd steps on the gradient of
    the loss itself (not of loss · Σ weights, as the train step takes
    it), exactly."""
    cfg = registry.get_config(ARCH, smoke=True)
    opt = topt.sgd(0.05)
    params = _params(cfg)
    b = _t(_batches(cfg, seed=3))
    p, s, loss = make_fedavg_round(cfg, opt, TAU, n_shards=1)(
        params, opt.init(params), b)
    q, st, losses = params, opt.init(params), []
    for t in range(TAU):
        mb = {k: v[t] for k, v in b.items()}
        (loss_t, _), g = topt.value_and_grad(
            lambda x: T.loss_fn(x, mb, cfg), q)
        g, _ = topt.clip_by_global_norm(g, 1.0)
        ups, st = opt.update(g, st, q)
        q = topt.apply_updates(q, ups)
        losses.append(float(loss_t.detach()))
    for a, c in zip(topt.tree_leaves(p), topt.tree_leaves(q)):
        assert torch.equal(a, c)
    assert float(loss) == pytest.approx(np.mean(losses), rel=1e-6)
