"""The CUDA kernels on the card, held to their plain PyTorch versions.

Every test here needs a CUDA card: it carries the ``gpu`` marker and
skips with a reason where there is none. The file imports no JAX, so it
collects on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import costs, movement, topology
from repro_torch.kernels import offload_greedy as og

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _inputs(T, n, density, seed, device, *, ties=False, isolated=0):
    g = torch.Generator().manual_seed(seed)
    if ties:
        c_link = torch.randint(0, 3, (T, n, n), generator=g).float()
        vec = [torch.randint(0, 3, (T, n), generator=g).float()
               for _ in range(3)]
    else:
        c_link = torch.rand((T, n, n), generator=g)
        vec = [torch.rand((T, n), generator=g) for _ in range(3)]
    adj = torch.rand((T, n, n), generator=g) < density
    adj[:, :isolated] = False
    return [a.to(device) for a in (c_link, *vec, adj)]


@pytest.mark.parametrize("T,n,density,ties,isolated", [
    (1, 1, 1.0, False, 0), (3, 7, 0.5, False, 0), (4, 129, 0.3, False, 0),
    (2, 256, 0.1, False, 0), (20, 1000, 0.1, False, 0),
    (100, 1024, 1.0, False, 0), (6, 300, 0.7, True, 0),
    (5, 200, 0.4, False, 17),
])
def test_kernel_equals_plain_version_bitwise(cuda, T, n, density, ties,
                                             isolated):
    args = _inputs(T, n, density, T * 7919 + n, cuda, ties=ties,
                   isolated=isolated)
    before = og.launches
    got = og.offload_greedy_batched(*args)
    assert og.launches == before + 1
    want = og.offload_greedy_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


def test_kernel_rejects_noncontiguous_and_wrong_dtype(cuda):
    args = _inputs(2, 64, 0.5, 0, cuda)
    bad = list(args)
    bad[0] = args[0].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        og.offload_greedy_batched(*bad)
    bad = list(args)
    bad[4] = args[4].to(torch.uint8)
    with pytest.raises(TypeError):
        og.offload_greedy_batched(*bad)


def test_device_plan_equals_plain_plan_on_card(cuda):
    rng = np.random.default_rng(0)
    T, n = 6, 300
    tr = costs.testbed_like_costs(n, T, rng)
    adj = topology.make_topology("random", n, rng, rho=0.2)
    before = og.launches
    plan = movement.greedy_linear(tr, adj, device=cuda)    # auto: kernel
    assert og.launches == before + 1
    choice, best_j, _ = og.offload_greedy_plain(
        *movement.device_inputs(tr, adj, cuda))
    want = movement._plan_from_choice(choice.cpu().numpy(),
                                      best_j.cpu().numpy())
    assert movement.plans_equal(plan, want)
