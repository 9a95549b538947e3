"""Gradients through the attention and SSD-scan wrappers, on the CPU.

``ops.attention`` and ``ops.ssd`` are autograd Functions whose backward
recomputes the kernels' plain versions. Their gradients are held to
``jax.grad`` of the functions the reference trains through,
``layers.full_attention`` (with its head map) and ``ssm.ssd_chunked``,
on the same seeded inputs and output cotangent: MHA, GQA and MQA,
causal or not, windows, and rows that no key can see, within 1e-5 of the
largest |gradient| (float32; the tolerance covers summation order). The
reference gives a row with no visible key NaN (its softmax of all
-inf), the port 0 with a zero gradient: there the reference runs on the
rows that see a key, and the port's gradient of the others must be
finite and zero. A float64 ``gradcheck`` holds the plain versions'
backward to finite differences, and ``segment_max`` still refuses grad.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.models import ssm as RS
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 default_kv_map)
from repro_torch.kernels.ssd_scan import ssd_scan_plain

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _attn_inputs(seed, B, H, KH, Sq, Sk, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KH, Sk, hd)).astype(np.float32)
    v = rng.standard_normal((B, KH, Sk, hd)).astype(np.float32)
    g = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    return q, k, v, g


def _visible(Sq, Sk, causal, window):
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return ok.any(1)


def _port_attention_grads(q, k, v, g, kv_map, causal, window):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    y = ops.attention(*ts, causal=causal, window=window,
                      kv_map=torch.from_numpy(kv_map))
    return y, torch.autograd.grad(y, ts, torch.from_numpy(g))


def _ref_attention_grads(q, k, v, g, kv_map, causal, window, rows):
    """jax.grad of full_attention on the query rows ``rows`` (which all
    see a key), in the reference's (B, S, H, hd) layout, returned in the
    kernel's."""
    qr = jnp.asarray(q.transpose(0, 2, 1, 3)[:, rows])
    kr = jnp.asarray(k.transpose(0, 2, 1, 3))
    vr = jnp.asarray(v.transpose(0, 2, 1, 3))
    gr = jnp.asarray(g.transpose(0, 2, 1, 3)[:, rows])

    def f(q_, k_, v_):
        out = RL.full_attention(q_, k_, v_, jnp.asarray(kv_map),
                                causal=causal, window=window,
                                q_pos=jnp.asarray(rows))
        return jnp.sum(out * gr)

    dq, dk, dv = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(qr, kr, vr)
    return [np.asarray(a).transpose(0, 2, 1, 3) for a in (dq, dk, dv)]


@pytest.mark.parametrize("B,H,KH,Sq,Sk,hd,causal,window", [
    (2, 4, 4, 16, 16, 8, True, None),      # MHA, causal
    (2, 4, 2, 16, 16, 8, True, None),      # GQA 2:1
    (1, 4, 1, 16, 16, 16, True, None),     # MQA
    (2, 4, 2, 16, 16, 8, False, None),     # not causal
    (1, 6, 3, 16, 16, 8, True, 4),         # causal window
    (1, 4, 2, 12, 20, 8, False, 5),        # window, Sq != Sk
    (1, 4, 2, 16, 4, 8, False, 3),         # rows 6.. see no key
    (1, 2, 1, 9, 3, 4, True, 2),           # causal window: rows 4.. blind
])
def test_attention_grads_match_reference(B, H, KH, Sq, Sk, hd, causal,
                                         window):
    q, k, v, g = _attn_inputs(B * 100 + H * 10 + Sq, B, H, KH, Sq, Sk, hd)
    kv_map = default_kv_map(H, KH).numpy()
    y, (dq, dk, dv) = _port_attention_grads(q, k, v, g, kv_map, causal,
                                            window)
    seen = _visible(Sq, Sk, causal, window)
    rows = np.nonzero(seen)[0]
    want_dq, want_dk, want_dv = _ref_attention_grads(q, k, v, g, kv_map,
                                                     causal, window, rows)
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()
    _close(dq[:, :, rows], want_dq)
    _close(dk, want_dk)
    _close(dv, want_dv)
    blind = np.nonzero(~seen)[0]
    if len(blind):
        assert torch.equal(dq[:, :, blind], torch.zeros_like(dq[:, :, blind]))
        assert torch.equal(y[:, :, blind], torch.zeros_like(y[:, :, blind]))


def test_attention_grads_reach_kv_through_a_padded_head_map():
    """Padded q heads (map entries past H) read K/V head 0, as
    ``layers.kv_head_map`` builds them: their gradient adds into head 0."""
    q, k, v, g = _attn_inputs(7, 1, 6, 2, 10, 10, 8)
    kv_map = np.array([0, 0, 1, 1, 0, 0], np.int32)
    _, (dq, dk, dv) = _port_attention_grads(q, k, v, g, kv_map, True, None)
    rows = np.arange(10)
    want = _ref_attention_grads(q, k, v, g, kv_map, True, None, rows)
    for got, w in zip((dq, dk, dv), want):
        _close(got, w)


def _ssd_inputs(seed, B, H, S, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, S, P)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((B, H, S))) * 0.3).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, N)).astype(np.float32)
    g = rng.standard_normal((B, H, S, P)).astype(np.float32)
    return x, a, bm, cm, g


@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (2, 3, 16, 4, 5, 4), (1, 2, 16, 8, 4, 8), (2, 2, 8, 4, 3, 8),
    (1, 4, 24, 2, 6, 6)])
def test_ssd_grads_match_reference(B, H, S, P, N, chunk):
    x, a, bm, cm, g = _ssd_inputs(S * 10 + H, B, H, S, P, N)
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (x, a, bm, cm)]
    y = ops.ssd(*ts, chunk=chunk)
    got = torch.autograd.grad(y, ts, torch.from_numpy(g))

    def f(x_, a_, b_, c_):
        out = RS.ssd_chunked(x_, a_, b_, c_, chunk)
        return jnp.sum(out * jnp.asarray(g.transpose(0, 2, 1, 3)))

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(
        jnp.asarray(x.transpose(0, 2, 1, 3)),
        jnp.asarray(a.transpose(0, 2, 1)), jnp.asarray(bm), jnp.asarray(cm))
    want = [np.asarray(want[0]).transpose(0, 2, 1, 3),
            np.asarray(want[1]).transpose(0, 2, 1), want[2], want[3]]
    for t, w in zip(got, want):
        assert torch.isfinite(t).all()
        _close(t, w)


def test_plain_versions_pass_gradcheck_in_float64():
    rng = np.random.default_rng(3)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()

    km = default_kv_map(4, 2)
    q, k, v = t((1, 4, 7, 4)), t((1, 2, 5, 4)), t((1, 2, 5, 4))
    for causal, window in ((True, None), (False, 2), (True, 3)):
        assert torch.autograd.gradcheck(
            lambda q_, k_, v_: flash_attention_plain(
                q_, k_, v_, km, causal=causal, window=window), (q, k, v))
    x, bm, cm = t((1, 2, 8, 3)), t((1, 8, 2)), t((1, 8, 2))
    a = (-torch.rand(1, 2, 8, dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *z: ssd_scan_plain(*z, chunk=4), (x, a, bm, cm))


def test_function_backward_equals_plain_autograd_bitwise():
    """On the CPU the forward is the plain version too, so the Function's
    gradients are autograd's through the plain version, bit for bit."""
    q, k, v, g = _attn_inputs(11, 1, 4, 2, 12, 12, 8)
    km = default_kv_map(4, 2)
    a1 = [torch.from_numpy(z).requires_grad_() for z in (q, k, v)]
    a2 = [torch.from_numpy(z).requires_grad_() for z in (q, k, v)]
    y1 = ops.attention(*a1, causal=True, window=5, kv_map=km)
    y2 = flash_attention_plain(*a2, km, causal=True, window=5)
    for x1, x2 in zip(torch.autograd.grad(y1, a1, torch.from_numpy(g)),
                      torch.autograd.grad(y2, a2, torch.from_numpy(g))):
        assert torch.equal(x1, x2)
    x, a, bm, cm, g = _ssd_inputs(12, 1, 2, 16, 4, 3)
    s1 = [torch.from_numpy(z).requires_grad_() for z in (x, a, bm, cm)]
    s2 = [torch.from_numpy(z).requires_grad_() for z in (x, a, bm, cm)]
    y1, y2 = ops.ssd(*s1, chunk=8), ssd_scan_plain(*s2, chunk=8)
    for x1, x2 in zip(torch.autograd.grad(y1, s1, torch.from_numpy(g)),
                      torch.autograd.grad(y2, s2, torch.from_numpy(g))):
        assert torch.equal(x1, x2)


def test_bf16_grads_take_the_input_type():
    q, k, v, g = _attn_inputs(13, 1, 2, 1, 8, 8, 8)
    ts = [torch.from_numpy(z).bfloat16().requires_grad_() for z in (q, k, v)]
    y = ops.attention(*ts)
    assert y.dtype == torch.bfloat16
    for d in torch.autograd.grad(y, ts, torch.from_numpy(g).bfloat16()):
        assert d.dtype == torch.bfloat16 and torch.isfinite(d).all()
    x, a, bm, cm, g = _ssd_inputs(14, 1, 2, 8, 4, 3)
    ins = [torch.from_numpy(x).bfloat16(), torch.from_numpy(a),
           torch.from_numpy(bm).bfloat16(), torch.from_numpy(cm).bfloat16()]
    ins = [z.requires_grad_() for z in ins]
    y = ops.ssd(*ins, chunk=4)
    assert y.dtype == torch.float32
    grads = torch.autograd.grad(y, ins, torch.from_numpy(g))
    assert [d.dtype for d in grads] == [torch.bfloat16, torch.float32,
                                        torch.bfloat16, torch.bfloat16]


def test_only_the_inputs_that_need_it_get_a_gradient():
    q, k, v, g = _attn_inputs(15, 1, 2, 2, 6, 6, 4)
    qt = torch.from_numpy(q).requires_grad_()
    y = ops.attention(qt, torch.from_numpy(k), torch.from_numpy(v))
    dq, = torch.autograd.grad(y, [qt], torch.from_numpy(g))
    assert dq.shape == qt.shape
    x, a, bm, cm, g = _ssd_inputs(16, 1, 2, 8, 4, 3)
    at = torch.from_numpy(a).requires_grad_()
    y = ops.ssd(torch.from_numpy(x), at, torch.from_numpy(bm),
                torch.from_numpy(cm), chunk=4)
    da, = torch.autograd.grad(y, [at], torch.from_numpy(g))
    assert da.shape == at.shape and torch.isfinite(da).all()


def test_segment_max_still_refuses_grad():
    with pytest.raises(RuntimeError, match="segment_max has no backward"):
        ops.segment_max(torch.randn(5, requires_grad=True),
                        torch.zeros(5, dtype=torch.int32), num_segments=1)
    with torch.no_grad():
        out = ops.segment_max(torch.ones(3, requires_grad=True),
                              torch.zeros(3, dtype=torch.int32),
                              num_segments=1)
    assert out.item() == 1.0
