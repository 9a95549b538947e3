"""Gradients through the kernel wrappers, on the CPU.

``segment_sum`` and ``segment_sum_rows`` are autograd Functions whose
backward is the transpose of the sum (a gather): held bit for bit to
autograd through their plain versions, and to ``jax.grad`` of the
reference's ``jax.ops.segment_sum`` (the gradient of the data exactly;
the gradient of the row weights, a sum over the row, within rtol 1e-6,
since XLA may sum a row in another order). ``segment_max`` has no
backward and refuses inputs that require grad; flash attention and the
SSD scan have one (``tests/test_torch_kernel_grad.py``). The ragged round's row gather (its backward a row sum
that drops the trash id) equals the reference's transpose of
``jnp.take(mode="clip")`` bit for bit on a bucket whose phantom rows
carry the zero gradients that their zero weights give; eq. (4)'s
bucket sums equal a sequential float32 replay bit for bit (the
reference's ``fori_loop`` form of them, traced alone, lets XLA fuse
the product and the add on the CPU: within rtol 1e-6 of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import engine as teng
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as sr


def _case(seed, m=30, P=7, G=5, oob=True):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((m, P)).astype(np.float32)
    ids = rng.integers(0, G, m).astype(np.int32)
    if oob:
        ids[::7] = G + 1            # out of range: adds nothing
        ids[3] = -1
    ids[ids == 2] = 1               # an empty segment
    scale = rng.random(m).astype(np.float32)
    g = rng.standard_normal((G, P)).astype(np.float32)
    return data, ids, G, scale, g


def _grads(fn, data, scale, g, with_scale):
    d = torch.from_numpy(data).requires_grad_(True)
    s = torch.from_numpy(scale).requires_grad_(True) if with_scale else None
    out = fn(d, s)
    inputs = (d, s) if with_scale else (d,)
    return [x.numpy() for x in torch.autograd.grad(out, inputs,
                                                   torch.from_numpy(g))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_scale", [False, True])
def test_segment_sum_rows_grad_equals_plain_and_jax(seed, with_scale):
    data, ids, G, scale, g = _case(seed)
    tid = torch.from_numpy(ids)
    got = _grads(lambda d, s: ops.segment_sum_rows(
        d, tid, num_segments=G, scale=s), data, scale, g, with_scale)
    plain = _grads(lambda d, s: sr.segment_sum_rows_plain(
        d, tid, G, scale=s), data, scale, g, with_scale)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)

    def ref(d, s):
        x = d * s[:, None] if with_scale else d
        return jax.ops.segment_sum(x, jnp.asarray(ids), num_segments=G)

    _, vjp = jax.vjp(ref, jnp.asarray(data), jnp.asarray(scale))
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    np.testing.assert_array_equal(got[0], want[0])
    if with_scale:
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_grad_equals_plain_and_jax(seed):
    data, ids, G, _, g = _case(seed, P=1)
    data, g = data[:, 0].copy(), g[:, 0].copy()
    tid = torch.from_numpy(ids)
    d = torch.from_numpy(data).requires_grad_(True)
    got, = torch.autograd.grad(ops.segment_sum(d, tid, num_segments=G), d,
                               torch.from_numpy(g))
    d2 = torch.from_numpy(data).requires_grad_(True)
    plain, = torch.autograd.grad(sr.segment_sum_plain(d2, tid, G), d2,
                                 torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    want = jax.grad(lambda x: jnp.vdot(jax.ops.segment_sum(
        x, jnp.asarray(ids), num_segments=G), jnp.asarray(g)))(
        jnp.asarray(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_grads_of_empty_shapes():
    d = torch.zeros((0, 3), requires_grad=True)
    ids = torch.zeros(0, dtype=torch.int32)
    out = ops.segment_sum_rows(d, ids, num_segments=2)
    g, = torch.autograd.grad(out.sum(), d)
    assert g.shape == (0, 3)
    d = torch.ones(4, requires_grad=True)
    out = ops.segment_sum(d, torch.zeros(4, dtype=torch.int32),
                          num_segments=0)
    g, = torch.autograd.grad(out.sum(), d, allow_unused=True)
    assert g is None or torch.equal(g, torch.zeros(4))


def test_kernels_without_a_backward_refuse_grad():
    """``segment_max`` is the one kernel wrapper without a backward: it
    refuses inputs that require grad. Attention and the SSD scan, which
    refused them before they had a backward, now give gradients."""
    from repro_torch.kernels.flash_attention import default_kv_map

    with pytest.raises(RuntimeError, match="segment_max has no backward"):
        ops.segment_max(torch.randn(5, requires_grad=True),
                        torch.zeros(5, dtype=torch.int32), num_segments=1)
    x = torch.randn(1, 2, 4, 8, requires_grad=True)
    a = torch.randn(1, 2, 4)
    bm = torch.randn(1, 4, 3)
    g, = torch.autograd.grad(ops.attention(x, x, x).sum(), x)
    assert g.shape == x.shape and torch.isfinite(g).all()
    g, = torch.autograd.grad(ops.ssd(x, a, bm, bm, chunk=4).sum(), x)
    assert g.shape == x.shape and torch.isfinite(g).all()
    # without grad they run as before
    with torch.no_grad():
        y = ops.attention(x, x, x, kv_map=default_kv_map(2, 2))
        assert y.shape == x.shape
        assert ops.ssd(x, a, bm, bm, chunk=4).shape == x.shape
    assert ops.segment_max(torch.ones(3), torch.zeros(3, dtype=torch.int32),
                           num_segments=1).item() == 1.0


def test_row_gather_backward_equals_reference_transpose():
    """A bucket of M = 6 devices, 11 rows of which 3 are phantom (trash
    id M): forward reads row M - 1 for them, as ``mode="clip"``; the
    backward of cotangents that are signed zeros on the phantom rows
    (what zero sample weights give) equals the reference's scatter
    transpose, which adds them into row M - 1, bit for bit."""
    rng = np.random.default_rng(3)
    M, R = 6, 11
    W = rng.standard_normal((M, 4, 3)).astype(np.float32)
    cell = np.array([0, 0, 1, 3, 3, 3, 5, 5, M, M, M], np.int32)
    G = rng.standard_normal((R, 4, 3)).astype(np.float32)
    G[cell == M] = np.where(rng.random((3, 4, 3)) < 0.5, 0.0, -0.0)
    tc = torch.from_numpy(cell)
    safe = torch.clamp(tc, max=M - 1).long()
    Wt = torch.from_numpy(W).requires_grad_(True)
    rows = teng._RowGather.apply(Wt, tc, safe, None)
    got, = torch.autograd.grad(rows, Wt, torch.from_numpy(G))
    take = lambda w: jnp.take(w, jnp.asarray(cell), axis=0, mode="clip")
    fwd, vjp = jax.vjp(take, jnp.asarray(W))
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(fwd))
    want, = vjp(jnp.asarray(G))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[2].any() and not got[4].any()   # devices with no rows


def test_bucket_sums_are_the_fixed_order_sums():
    """Eq. (4)'s bucket numerator and denominator (one row-sum call per
    leaf into S segments, H·contributing as the scale) against a
    sequential float32 replay (one rounded product and add an entry,
    devices in order from 0), and the reference's ``fori_loop`` form
    within rtol 1e-6."""
    rng = np.random.default_rng(5)
    S, n = 3, 5
    W = {"w": rng.standard_normal((S * n, 4, 2)).astype(np.float32),
         "b": rng.standard_normal((S * n, 2)).astype(np.float32)}
    H = (rng.integers(0, 9, (S, n)) * 1.0).astype(np.float32)
    c = (rng.random((S, n)) < 0.7).astype(np.float32)
    ids = torch.arange(S, dtype=torch.int32).repeat_interleave(n)
    prog = teng._BucketProgram(None, 0.1, True, False, False, 0.0, "dense")
    num, tot = prog.agg_sums({k: torch.from_numpy(v) for k, v in W.items()},
                             torch.from_numpy(H), torch.from_numpy(c),
                             (ids, None))
    hc = H * c
    for k, a in W.items():
        a = a.reshape((S, n) + a.shape[1:])
        rep = np.zeros((S,) + a.shape[2:], np.float32)
        for i in range(n):
            rep = rep + a[:, i] * hc[:, i].reshape((S,) + (1,) * (a.ndim - 2))
        np.testing.assert_array_equal(num[k].numpy(), rep)

        def fori(a, hc):
            def step(i, s):
                return s + a[:, i] * hc[:, i].reshape(
                    (-1,) + (1,) * (a.ndim - 2))
            return jax.lax.fori_loop(0, n, step,
                                     jnp.zeros((S,) + a.shape[2:]))
        np.testing.assert_allclose(num[k].numpy(),
                                   np.asarray(fori(jnp.asarray(a),
                                                   jnp.asarray(hc))),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tot.numpy(), hc.sum(1))
