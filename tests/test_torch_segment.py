"""The segment-reduce kernel's plain PyTorch versions against the
reference: ``jax.ops.segment_sum`` / ``segment_max`` and the Pallas
kernel (``segment_sum_pallas`` / ``segment_max_pallas``) in interpret
mode, on the same numpy-seeded inputs. Plus the kernel's CSR layout
(walked in ascending order it must give the plain sum bit for bit, as
the CUDA kernel does), the wrapper's CPU dispatch and its argument
checks. The CUDA kernel itself is held to these in
``test_torch_gpu.py``.

Tolerances: against ``jax.ops`` the sum is exact (on the CPU both add in
element order) and so is the max. Against the Pallas kernel the max is
exact, and the sum is within rtol 1e-6, atol 1e-5: the one-hot matmul
sums each 128-element chunk first, another order of float32 adds. The
NaN case is held against ``jax.ops`` only: the Pallas kernel spreads a
NaN to every segment of its tile (0 · NaN = NaN).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import ops as jops

from repro.kernels import ops as rops
from repro.kernels.segment_reduce import (segment_max_pallas,
                                          segment_sum_pallas)
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as sr


def _case(kind, seed):
    """(data f32, ids int32, num_segments) for one edge case."""
    rng = np.random.default_rng(seed)
    if kind == "unsorted":
        E, S = 300, 37
        ids = rng.integers(0, S, E)
    elif kind == "empty_segments":         # most segments named by nobody
        E, S = 200, 500
        ids = rng.choice(np.arange(0, S, 7), E)
    elif kind == "out_of_range":           # negative and too-large ids
        E, S = 257, 19
        ids = rng.integers(-5, S + 6, E)
    elif kind == "no_elements":
        E, S = 0, 6
        ids = np.zeros(0, np.int64)
    elif kind == "one_wide_segment":
        E, S = 1000, 3
        ids = np.ones(E, np.int64)
    elif kind == "ragged":                 # S a multiple of nothing
        E, S = 389, 131
        ids = rng.integers(0, S, E)
    else:
        raise ValueError(kind)
    data = rng.standard_normal(E).astype(np.float32)
    return data, ids.astype(np.int32), S


KINDS = ["unsorted", "empty_segments", "out_of_range", "no_elements",
         "one_wide_segment", "ragged"]


def _torch(data, ids):
    return torch.from_numpy(data), torch.from_numpy(ids)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_sum_equals_jax_ops_and_pallas(kind):
    data, ids, S = _case(kind, 1)
    got = sr.segment_sum_plain(*_torch(data, ids), S).numpy()
    want = np.asarray(jops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                       num_segments=S))
    assert got.shape == (S,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(segment_sum_pallas(jnp.asarray(data),
                                           jnp.asarray(ids), S,
                                           interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_max_equals_jax_ops_and_pallas(kind):
    data, ids, S = _case(kind, 2)
    got = sr.segment_max_plain(*_torch(data, ids), S).numpy()
    want = np.asarray(jops.segment_max(jnp.asarray(data), jnp.asarray(ids),
                                       num_segments=S))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(segment_max_pallas(jnp.asarray(data),
                                           jnp.asarray(ids), S,
                                           interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_zero_segments():
    data, ids = _torch(np.ones(4, np.float32), np.arange(4, dtype=np.int32))
    for fn in (sr.segment_sum, sr.segment_max):
        assert fn(data, ids, 0).shape == (0,)
    assert sr.segment_layout(ids, 0).offsets.tolist() == [0]


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_non_finite_stays_in_its_segment(value):
    data = np.array([1, value, 3, 4, 5, -2], np.float32)
    ids = np.array([0, 0, 1, -1, 7, 2], np.int32)
    for plain, ref in ((sr.segment_sum_plain, jops.segment_sum),
                       (sr.segment_max_plain, jops.segment_max)):
        got = plain(*_torch(data, ids), 3).numpy()
        want = np.asarray(ref(jnp.asarray(data), jnp.asarray(ids),
                              num_segments=3))
        np.testing.assert_array_equal(got, want)
        assert np.isfinite(got[1:]).all()


def _layout_walk(data, layout, op):
    """The CUDA kernel's arithmetic in numpy: each segment walks its
    layout list in order with one float32 add (or max) per element."""
    offsets = layout.offsets.numpy()
    perm = layout.perm.numpy()
    S = layout.num_segments
    out = np.full(S, 0.0 if op == "sum" else -np.inf, np.float32)
    for s in range(S):
        for i in perm[offsets[s]:offsets[s + 1]]:
            out[s] = (np.float32(out[s] + data[i]) if op == "sum"
                      else max(out[s], data[i]))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_layout_lists_each_segment_in_ascending_order(kind):
    data, ids, S = _case(kind, 3)
    layout = sr.segment_layout(torch.from_numpy(ids), S)
    assert layout.offsets.dtype == layout.perm.dtype == torch.int32
    offsets, perm = layout.offsets.numpy(), layout.perm.numpy()
    valid = (ids >= 0) & (ids < S)
    assert offsets[0] == 0 and offsets[-1] == valid.sum()
    for s in range(S):
        np.testing.assert_array_equal(perm[offsets[s]:offsets[s + 1]],
                                      np.nonzero(ids == s)[0])
    for op, plain in (("sum", sr.segment_sum_plain),
                      ("max", sr.segment_max_plain)):
        want = plain(*_torch(data, ids), S).numpy()
        np.testing.assert_array_equal(
            _layout_walk(data, layout, op).view(np.int32),
            want.view(np.int32))


def test_cpu_tensors_never_launch():
    data, ids, S = _case("out_of_range", 4)
    t_data, t_ids = _torch(data, ids)
    before = sr.launches
    for fn, plain in ((sr.segment_sum, sr.segment_sum_plain),
                      (sr.segment_max, sr.segment_max_plain)):
        assert torch.equal(fn(t_data, t_ids, S), plain(t_data, t_ids, S))
        layout = sr.segment_layout(t_ids, S)
        assert torch.equal(fn(t_data, t_ids, S, layout=layout),
                           plain(t_data, t_ids, S))
    assert sr.launches == before
    sr.reset_launches()
    assert sr.launches == 0


def test_ops_wrappers_match_reference_ops():
    data, ids, S = _case("unsorted", 5)
    t = _torch(data, ids)
    j = (jnp.asarray(data), jnp.asarray(ids))
    np.testing.assert_array_equal(
        ops.segment_sum(*t, num_segments=S).numpy(),
        np.asarray(rops.segment_sum(*j, num_segments=S, use_pallas=False)))
    np.testing.assert_array_equal(
        ops.segment_max(*t, num_segments=S).numpy(),
        np.asarray(rops.segment_max(*j, num_segments=S, use_pallas=False)))


@pytest.mark.parametrize("bad", ["data_dtype", "ids_dtype", "shape",
                                 "device", "layout", "negative_segments"])
def test_wrapper_rejects_bad_arguments(bad):
    data, ids = _torch(np.ones(8, np.float32), np.arange(8, dtype=np.int32))
    kw, S, err = {}, 8, ValueError
    if bad == "data_dtype":
        data, err = data.double(), TypeError
    elif bad == "ids_dtype":
        ids, err = ids.long(), TypeError
    elif bad == "shape":
        data = data[:5]
    elif bad == "device":
        data = data.to("meta")
    elif bad == "layout":
        kw["layout"] = sr.segment_layout(ids, 4)
    else:
        S = -1
    with pytest.raises(err):
        sr.segment_sum(data, ids, S, **kw)
