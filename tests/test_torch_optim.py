"""The port's optimizers held to the reference's (``repro.optim.
optimizers``): sgd, momentum and adamw (with weight decay, and with a
``cosine_schedule`` learning rate) take the same numpy parameters and
gradients in both packages for 5 steps; updates, parameters and every
state leaf agree within 1e-6 of the leaf's largest |value| (float32 on
the CPU; the tolerance covers XLA fusing a product and an add where
torch rounds each). ``global_norm`` and ``clip_by_global_norm`` are held
the same way, and the reference's quadratic convergence case runs on
the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as ropt
from repro_torch.models.convert import opt_state_from_jax
from repro_torch.optim import optimizers as topt

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "blocks": {"b": (scale * rng.standard_normal(5)).astype(
                np.float32),
                       "s": np.float32(scale * rng.standard_normal())}}


def _to_torch(tree):
    return topt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves_close(got, want, tol=TOL):
    gl, wl = topt.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(
            g, w, rtol=0, atol=tol * max(float(np.abs(w).max()), 1e-30))


def _pair(name):
    sched_r = ropt.cosine_schedule(0.05, warmup=2, total=5)
    sched_t = topt.cosine_schedule(0.05, warmup=2, total=5)
    return {
        "sgd": (ropt.sgd(0.1), topt.sgd(0.1)),
        "sgd_cosine": (ropt.sgd(sched_r), topt.sgd(sched_t)),
        "momentum": (ropt.momentum(0.05), topt.momentum(0.05)),
        "adamw": (ropt.adamw(3e-3), topt.adamw(3e-3)),
        "adamw_wd": (ropt.adamw(1e-2, weight_decay=0.1),
                     topt.adamw(1e-2, weight_decay=0.1)),
        "adamw_cosine": (ropt.adamw(sched_r, weight_decay=0.01),
                         topt.adamw(sched_t, weight_decay=0.01)),
    }[name]


@pytest.mark.parametrize("name", ["sgd", "sgd_cosine", "momentum", "adamw",
                                  "adamw_wd", "adamw_cosine"])
def test_five_steps_match_reference(name):
    rng = np.random.default_rng(0)
    ro, to = _pair(name)
    rp = jax.tree_util.tree_map(jnp.asarray, _tree(rng))
    tp = _to_torch(jax.tree_util.tree_map(np.asarray, rp))
    rs, ts = ro.init(rp), to.init(tp)
    for _ in range(5):
        g = _tree(rng, scale=0.5)
        rups, rs = ro.update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
        tups, ts = to.update(_to_torch(g), ts, tp)
        _leaves_close(tups, rups)
        rp = ropt.apply_updates(rp, rups)
        tp = topt.apply_updates(tp, tups)
        _leaves_close(tp, rp)
        for k in rs:
            if k == "count":
                assert int(ts[k]) == int(rs[k])
                assert ts[k].dtype == torch.int32 and ts[k].dim() == 0
            else:
                _leaves_close(ts[k], rs[k])


def test_state_from_the_reference_continues_alike():
    """A reference adamw state carried across mid-run
    (``opt_state_from_jax``) gives the reference's next step."""
    rng = np.random.default_rng(1)
    ro, to = _pair("adamw_wd")
    rp = jax.tree_util.tree_map(jnp.asarray, _tree(rng))
    rs = ro.init(rp)
    for _ in range(3):
        ups, rs = ro.update(jax.tree_util.tree_map(jnp.asarray,
                                                   _tree(rng)), rs, rp)
        rp = ropt.apply_updates(rp, ups)
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, rs))
    assert int(ts["count"]) == 3 and ts["m"]["w"].dtype == torch.float32
    tp = _to_torch(jax.tree_util.tree_map(np.asarray, rp))
    g = _tree(rng)
    rups, rs = ro.update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
    tups, ts = to.update(_to_torch(g), ts, tp)
    _leaves_close(tups, rups)
    _leaves_close(ts["v"], rs["v"])
    with pytest.raises(ValueError, match="not an optimizer state"):
        opt_state_from_jax({"count": 0, "nu": {}})


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_and_global_norm_match_reference(scale):
    g = _tree(np.random.default_rng(2), scale=scale)
    rc, rn = ropt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                      1.0)
    tc, tn = topt.clip_by_global_norm(_to_torch(g), 1.0)
    assert float(tn) == pytest.approx(float(rn), rel=TOL)
    assert float(topt.global_norm(_to_torch(g))) == pytest.approx(
        float(ropt.global_norm(g)), rel=TOL)
    _leaves_close(tc, rc)
    if scale > 1:
        assert float(topt.global_norm(tc)) == pytest.approx(1.0, rel=1e-5)
    else:                   # under the limit: untouched
        for a, b in zip(topt.tree_leaves(tc), topt.tree_leaves(
                _to_torch(g))):
            assert torch.equal(a, b)


def test_cosine_schedule_matches_reference():
    rf = ropt.cosine_schedule(1.0, warmup=10, total=100)
    tf = topt.cosine_schedule(1.0, warmup=10, total=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert float(tf(torch.tensor(step, dtype=torch.int32))) == \
            pytest.approx(float(rf(jnp.array(step))), rel=1e-6, abs=1e-7)
    assert float(tf(torch.tensor(100))) == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("name,lr", [("sgd", 0.1), ("momentum", 0.05),
                                     ("adamw", 0.1)])
def test_optimizer_converges_on_quadratic(name, lr):
    """The reference's case (``tests/test_substrates.py``) on the port."""
    opt = topt.get_optimizer(name, lr)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(5.0)}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    for _ in range(300):
        _, g = topt.value_and_grad(lambda p: (loss(p),), params)
        ups, state = opt.update(g, state, params)
        params = topt.apply_updates(params, ups)
    assert float(loss(params)) < 1e-3


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        topt.get_optimizer("lion", 1e-3)
