"""The Theorem-3 kernel's plain PyTorch version against the reference's
oracle (``ref.offload_greedy_ref``) and its Pallas kernel in interpret
mode: choice, best_j and best_cost must be exactly equal (one float32
add per entry and an order-free min in all three). Plus the wrapper's
CPU dispatch, its argument checks and the build keying. The CUDA kernel
itself is held to the plain version in ``test_torch_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref
from repro.kernels.offload_greedy import offload_greedy
from repro_torch.kernels import _build
from repro_torch.kernels import offload_greedy as og
from repro_torch.kernels import ops


def _inputs(n, density, seed, *, ties=False, isolated=0, T=None):
    rng = np.random.default_rng(seed)
    lead = () if T is None else (T,)
    if ties:       # integer-valued costs: many equal sums and 3-way ties
        c_link = rng.integers(0, 3, lead + (n, n)).astype(np.float32)
        vec = [rng.integers(0, 3, lead + (n,)).astype(np.float32)
               for _ in range(3)]
    else:
        c_link = rng.random(lead + (n, n), np.float32)
        vec = [rng.random(lead + (n,), np.float32) for _ in range(3)]
    adj = rng.random(lead + (n, n)) < density
    if isolated:
        adj[..., :isolated, :] = False        # rows with no candidate
    return (c_link, *vec, adj)


CASES = [(n, d, False, 0) for n in (128, 256) for d in (0.1, 0.5, 1.0)] \
    + [(128, 0.5, True, 0), (256, 1.0, True, 0), (128, 0.3, False, 5),
       (256, 0.0, False, 0)]


@pytest.mark.parametrize("n,density,ties,isolated", CASES)
def test_plain_equals_ref_and_pallas(n, density, ties, isolated):
    args = _inputs(n, density, n + int(10 * density), ties=ties,
                   isolated=isolated)
    got = og.offload_greedy_plain(*(torch.from_numpy(a[None])
                                    for a in args))
    got = [g[0].numpy() for g in got]
    jargs = [jnp.asarray(a) for a in args]
    want = ref.offload_greedy_ref(*jargs)
    pallas = offload_greedy(*jargs, interpret=True)
    for w in (want, pallas):
        np.testing.assert_array_equal(got[0], np.asarray(w[0]))
        np.testing.assert_array_equal(got[1], np.asarray(w[1]))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    if isolated:
        assert not (got[0][:isolated] == 1).any()
        np.testing.assert_array_equal(got[1][:isolated], 0)


@pytest.mark.parametrize("T,n", [(1, 1), (3, 7), (4, 129), (5, 64)])
def test_batched_plain_equals_vmapped_ref(T, n):
    args = _inputs(n, 0.4, T * n, T=T, ties=n % 2 == 1)
    got = og.offload_greedy_plain(*(torch.from_numpy(a) for a in args))
    want = jax.vmap(ref.offload_greedy_ref)(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapper_uses_plain_version_on_cpu_without_launching():
    args = [torch.from_numpy(a) for a in _inputs(64, 0.5, 1, T=3)]
    before = og.launches
    got = og.offload_greedy_batched(*args)
    assert og.launches == before
    for g, w in zip(got, og.offload_greedy_plain(*args)):
        assert torch.equal(g, w)


def test_edges_and_decisions_match_reference_ops():
    args = _inputs(96, 0.3, 5, T=4)
    got = ops.greedy_edges_batched(*(torch.from_numpy(a) for a in args))
    want = rops.greedy_edges_batched(*(jnp.asarray(a) for a in args),
                                     use_pallas=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = ops.greedy_decision(*(torch.from_numpy(a[1]) for a in args))
    batched = ops.greedy_decision_batched(*(torch.from_numpy(a)
                                            for a in args))
    for g, b in zip(one, batched):
        assert torch.equal(g, b[1])


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrapper_rejects_bad_arguments(bad):
    args = [torch.from_numpy(a) for a in _inputs(16, 0.5, 2, T=2)]
    if bad == "dtype":
        args[0] = args[0].double()
        err = TypeError
    elif bad == "shape":
        args[1] = args[1][:, :8]
        err = ValueError
    else:
        args[4] = args[4].to("meta")
        err = ValueError
    with pytest.raises(err):
        og.offload_greedy_batched(*args)


def test_build_is_keyed_on_source_and_stays_in_repo(monkeypatch):
    path = _build.library_path("offload_greedy")
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parent == _build.CSRC.parents[3]
    assert path == _build.library_path("offload_greedy")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("offload_greedy") != path
    with pytest.raises(FileNotFoundError):
        _build.source_path("no_such_kernel")
