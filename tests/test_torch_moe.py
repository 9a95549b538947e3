"""The port's MoE layer (``repro_torch.models.moe``) held to the
reference's ``repro.models.moe`` on the same numpy-seeded inputs, on the
CPU, at the olmoe smoke config's widths (4 experts, top-2) and variants:

* capacity factors 0.25 and 1.25 (tokens dropped) and 8 (none dropped),
  ``moe_groups`` 1, 2 and 4 and a group count that does not divide the
  tokens (the reference falls back to one group), 8 padded experts;
* the routing (expert ids, position in expert, kept) exactly equal to
  the reference's (its lines restated in JAX here, as its module keeps
  them inside ``moe_apply``), the output within 2e-5 of max|out| and the
  aux loss within 1e-6;
* gradients of a fixed cotangent's inner product with the output, plus
  the aux loss, for x, router, w_gate, w_up and w_down within 1e-5 of
  each leaf's max|g| of ``jax.grad``'s; the padded experts' exactly 0;
* ``expert_capacity`` equal over a grid;
* a uniform router (every probability tied) picks the lowest expert ids,
  as ``jax.lax.top_k`` does, at 64 experts top-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import moe as RM
from repro.models import module as ref_module
from repro_torch.configs import registry
from repro_torch.models import moe as M
from repro_torch.models.convert import lm_params_from_jax

OUT_TOL = 2e-5          # of max|out|
AUX_TOL = 1e-6
GRAD_TOL = 1e-5         # of each leaf's max|g|


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both(**overrides):
    rc = ref_registry.get_config("olmoe-1b-7b", smoke=True)
    tc = registry.get_config("olmoe-1b-7b", smoke=True)
    if overrides:
        rc, tc = rc.with_overrides(**overrides), tc.with_overrides(**overrides)
    jp = ref_module.init_params(RM.moe_specs(rc), jax.random.PRNGKey(0),
                                jnp.float32)
    return rc, tc, jp, lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))


def _x(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _ref_routing(x, p, cfg):
    """(eids, pos, keep) as ``repro.models.moe.moe_apply`` computes them."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    G = max(int(cfg.moe_groups or 1), 1)
    if T % G != 0:
        G = 1
    Tg = T // G
    C = RM.expert_capacity(Tg, cfg)
    xt = jnp.asarray(x).reshape(G, Tg, D)
    logits = jnp.einsum("gtd,de->gte", xt, p["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, eids = jax.lax.top_k(probs, k)
    flat_e = eids.reshape(G, Tg * k)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - 1,
                              flat_e[..., None], axis=2)[..., 0]
    return np.asarray(eids), np.asarray(pos), np.asarray(pos < C), G, C


def _port_routing(x, p, cfg, G, C):
    B, S, D = x.shape
    _, _, eids, pos, keep = M.route(torch.from_numpy(x).reshape(G, -1, D),
                                    p["router"], cfg, C)
    return eids.numpy(), pos.numpy(), keep.numpy()


CASES = [
    dict(capacity_factor=0.25), dict(capacity_factor=1.25),
    dict(capacity_factor=8.0),
    dict(capacity_factor=1.25, moe_groups=2),
    dict(capacity_factor=0.25, moe_groups=4),
    dict(capacity_factor=8.0, moe_groups=4),
    dict(capacity_factor=1.25, moe_groups=3),        # 48 % 3 == 0
    dict(capacity_factor=1.25, moe_groups=5),        # 48 % 5: one group
    dict(capacity_factor=1.25, moe_pad_experts=8),
    dict(capacity_factor=0.25, moe_groups=2, moe_pad_experts=8),
]


@pytest.mark.parametrize("overrides", CASES)
def test_moe_apply_matches_reference(overrides):
    rc, tc, jp, tp = _both(**overrides)
    x = _x(tc, 3, 16, seed=1)
    want, want_aux = RM.moe_apply(jnp.asarray(x), jp, rc)
    got, aux = M.moe_apply(torch.from_numpy(x), tp, tc)
    eids, pos, keep, G, C = _ref_routing(x, jp, rc)
    g_eids, g_pos, g_keep = _port_routing(x, tp, tc, G, C)
    np.testing.assert_array_equal(g_eids, eids)
    np.testing.assert_array_equal(g_pos, pos)
    np.testing.assert_array_equal(g_keep, keep)
    if overrides["capacity_factor"] < 1:
        assert not keep.all()                    # the case drops tokens
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=OUT_TOL * float(np.abs(want).max()))
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


@pytest.mark.parametrize("overrides", [
    dict(capacity_factor=0.25), dict(capacity_factor=8.0),
    dict(capacity_factor=1.25, moe_groups=2, moe_pad_experts=8)])
def test_moe_gradients_match_jax_grad(overrides):
    rc, tc, jp, tp = _both(**overrides)
    x = _x(tc, 2, 16, seed=2)
    cot = np.random.default_rng(3).standard_normal(x.shape).astype(
        np.float32)

    def ref_loss(xx, p):
        out, aux = RM.moe_apply(xx, p, rc)
        return jnp.sum(out * cot) + aux

    gx, gp = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    out, aux = M.moe_apply(tx, leaves, tc)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    pairs = [("x", tx.grad, gx)] + [(k, leaves[k].grad, gp[k])
                                     for k in sorted(leaves)]
    for name, got, want in pairs:
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()),
                                   err_msg=name)
    E = tc.num_experts
    if overrides.get("moe_pad_experts"):
        for name in ("w_gate", "w_up", "w_down"):
            assert leaves[name].grad.shape[0] == 8
            assert not leaves[name].grad[E:].any(), name
            assert leaves[name].grad[:E].abs().max() > 0, name


def test_expert_capacity_equals_reference():
    base = registry.get_config("olmoe-1b-7b")
    ref = ref_registry.get_config("olmoe-1b-7b")
    for E, k in ((64, 8), (8, 2), (4, 2), (3, 1)):
        for cf in (0.1, 0.25, 1.0, 1.25, 2.0, 8.0):
            tc = base.with_overrides(num_experts=E, experts_per_token=k,
                                     capacity_factor=cf)
            rc = ref.with_overrides(num_experts=E, experts_per_token=k,
                                    capacity_factor=cf)
            for tokens in (1, 2, 7, 64, 1000, 4096, 8192):
                assert M.expert_capacity(tokens, tc) == \
                    RM.expert_capacity(tokens, rc), (E, k, cf, tokens)
    # the full configs' prefill shapes: olmoe B2 x 4096, mixtral B1 x 8192
    assert M.expert_capacity(8192, base) == 1280
    assert M.expert_capacity(8192, registry.get_config("mixtral-8x7b")) \
        == 2560


def test_uniform_router_ties_pick_the_lowest_experts():
    """Every probability tied: the k lowest expert ids, the reference's
    choice; torch.topk makes no such promise."""
    kw = dict(num_experts=64, experts_per_token=8, d_model=64, d_ff=32,
              num_heads=4, capacity_factor=8.0)
    rc, tc, jp, tp = _both(**kw)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(tc, 2, 8, seed=4)
    eids, pos, keep, G, C = _ref_routing(x, jp, rc)
    g_eids, g_pos, g_keep = _port_routing(x, tp, tc, G, C)
    assert (eids == np.arange(8)).all()
    np.testing.assert_array_equal(g_eids, eids)
    np.testing.assert_array_equal(g_pos, pos)
    np.testing.assert_array_equal(g_keep, keep)
    want, want_aux = RM.moe_apply(jnp.asarray(x), jp, rc)
    got, aux = M.moe_apply(torch.from_numpy(x), tp, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OUT_TOL * float(np.abs(want).max()))
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL
    assert M.top_k(torch.full((3, 64), 1 / 64), 8)[1].tolist() == \
        [list(range(8))] * 3
