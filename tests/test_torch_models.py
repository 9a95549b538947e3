"""The port's models on the reference's weights: with parameters carried
across by ``params_from_jax`` (HWIO→OIHW kernels, the CNN's ``w1`` rows
from (h, w, c) to (c, h, w) order), logits agree within atol 1e-5 and
the gradients of one device step within rtol 1e-4 (atol 1e-6 for the
entries that are zero up to rounding). Both run float32 on the CPU; the
tolerances cover summation order in the convolutions and products."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.models import mnist as rmm
from repro_torch.core import engine as teng
from repro_torch.models import mnist as tmm
from repro_torch.models.convert import params_from_jax

MODELS = ["mlp", "cnn", "linear"]


def _setup(model, seed=0, B=24):
    jp, _ = reng.make_model(model, jax.random.PRNGKey(seed))
    jp = {k: np.asarray(v) for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, B).astype(np.int32)
    w = (rng.random(B) < 0.8).astype(np.float32)
    return jp, x, y, w


@pytest.mark.parametrize("model", MODELS)
def test_logits_match_reference(model):
    jp, x, y, _ = _setup(model)
    want = np.asarray(rmm.MODELS[model][1](
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x)))
    got = tmm.MODELS[model][1](params_from_jax(jp), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    lw = float(rmm.ce_loss(jnp.asarray(want), jnp.asarray(y)))
    lt = float(tmm.ce_loss(got, torch.from_numpy(y).long()))
    np.testing.assert_allclose(lt, lw, rtol=1e-5)
    assert float(tmm.accuracy(got, torch.from_numpy(y).long())) == \
        float(rmm.accuracy(jnp.asarray(want), jnp.asarray(y)))


@pytest.mark.parametrize("model", MODELS)
def test_device_step_gradients_match_reference(model):
    jp, x, y, w = _setup(model, seed=1)
    apply_j = rmm.MODELS[model][1]

    def lf(p):
        return rmm.ce_loss(apply_j(p, jnp.asarray(x)), jnp.asarray(y),
                           jnp.asarray(w))

    gj = jax.grad(lf)({k: jnp.asarray(v) for k, v in jp.items()})
    want = params_from_jax({k: np.asarray(v) for k, v in gj.items()})
    apply_t = tmm.MODELS[model][1]
    gt = torch.func.grad(lambda p: tmm.ce_loss(
        apply_t(p, torch.from_numpy(x)), torch.from_numpy(y).long(),
        torch.from_numpy(w)))(params_from_jax(jp))
    for k in want:
        np.testing.assert_allclose(gt[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("model", MODELS)
def test_vmapped_step_matches_reference_step(model):
    """The engine's per-device step over a device axis, with one idle
    and one empty device: updated params and losses match the
    reference's vmapped step."""
    n, P, eta = 3, 16, 0.1
    jp, _, _, _ = _setup(model, seed=2)
    rng = np.random.default_rng(3)
    xb = rng.standard_normal((n, P, 28, 28)).astype(np.float32)
    yb = rng.integers(0, 10, (n, P)).astype(np.int32)
    wb = np.ones((n, P), np.float32)
    wb[2] = 0.0                                   # device 2 holds no data
    active = np.array([1.0, 0.0, 1.0], np.float32)  # device 1 is idle
    W = {k: np.stack([v] * n) for k, v in jp.items()}
    j_new, j_loss = reng.make_device_step(rmm.MODELS[model][1], eta)(
        {k: jnp.asarray(v) for k, v in W.items()}, jnp.asarray(xb),
        jnp.asarray(yb), jnp.asarray(wb), jnp.asarray(active))
    t_new, t_loss = teng.make_device_step(tmm.MODELS[model][1], eta)(
        teng._stack(params_from_jax(jp), n), torch.from_numpy(xb),
        torch.from_numpy(yb).long(), torch.from_numpy(wb),
        torch.from_numpy(active))
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(j_loss),
                               rtol=1e-5, atol=1e-6)
    for d in range(n):
        want = params_from_jax({k: np.asarray(v[d])
                                for k, v in j_new.items()})
        for k in want:
            np.testing.assert_allclose(t_new[k][d].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-6)
    base = params_from_jax(jp)
    for k in base:     # idle and empty devices took no step
        assert torch.equal(t_new[k][1], base[k])
        assert torch.equal(t_new[k][2], base[k])


def test_init_params_laws():
    g = torch.Generator().manual_seed(0)
    p = tmm.init_params(tmm.cnn_specs(), g)
    assert {k: tuple(v.shape) for k, v in p.items()} == tmm.cnn_specs()
    assert all(float(p[b].abs().sum()) == 0 for b in ("cb1", "b1", "b2"))
    np.testing.assert_allclose(float(p["w1"].std()), 1 / np.sqrt(1568),
                               rtol=0.05)
    np.testing.assert_allclose(float(p["c2"].std()), 1 / np.sqrt(400),
                               rtol=0.05)
    again = tmm.init_params(tmm.cnn_specs(), torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)
