"""The CUDA kernels on the card, held to their plain PyTorch versions
(and the segment sum to a sequential ascending-order float32 sum;
flash attention at 2e-5, the SSD scan at 1e-4 of max|y|: the
reference's float32 tolerances; the scan's output is float32 on
bfloat16 inputs too, and a bfloat16 attention output lies within one
bfloat16 rounding of the plain version's float32 result, plus 2e-5).

Every test here needs a CUDA card: it carries the ``gpu`` marker and
skips with a reason where there is none. The file imports no JAX, so it
collects on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import costs, movement, topology
from repro_torch.core import engine as eng
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import offload_greedy as og
from repro_torch.kernels import segment_reduce as sr
from repro_torch.kernels import ssd_scan as sd

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


# ---------------------------------------------------------------------------
# segment reduce
# ---------------------------------------------------------------------------


def _segment_case(E, S, seed, *, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(E).astype(np.float32)
    ids = rng.integers(lo, S if hi is None else hi, E).astype(np.int32)
    return data, ids


def _sequential_sum(data, ids, S):
    """float32 sums in ascending element order, one add at a time."""
    out = np.zeros(S, np.float32)
    for x, s in zip(data, ids):
        if 0 <= s < S:
            out[s] = np.float32(out[s] + x)
    return out


@pytest.mark.parametrize("E,S,lo,hi", [
    (0, 5, 0, None), (1, 1, 0, None), (1000, 37, 0, None),
    (3000, 2000, 0, None), (2048, 64, -9, 80), (5000, 1, 0, None)])
def test_segment_sum_is_the_sequential_sum_bitwise(cuda, E, S, lo, hi):
    data, ids = _segment_case(E, S, E + S, lo=lo, hi=hi)
    before = sr.launches
    got = sr.segment_sum(torch.from_numpy(data).to(cuda),
                         torch.from_numpy(ids).to(cuda), S)
    assert sr.launches == before + 1
    want = _sequential_sum(data, ids, S)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  want.view(np.int32))


def test_segment_sum_repeats_bitwise_and_max_equals_plain(cuda):
    data, ids = _segment_case(1 << 21, 40_000, 7, lo=-100, hi=40_100)
    d, i = torch.from_numpy(data).to(cuda), torch.from_numpy(ids).to(cuda)
    layout = sr.segment_layout(i, 40_000)
    first = sr.segment_sum(d, i, 40_000)
    for _ in range(3):
        again = sr.segment_sum(d, i, 40_000, layout=layout)
        assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    got = sr.segment_max(d, i, 40_000, layout=layout)
    assert torch.equal(got, sr.segment_max_plain(d, i, 40_000))
    torch.cuda.synchronize()


def test_segment_kernel_keeps_non_finite_in_its_segment(cuda):
    data = torch.tensor([1, float("nan"), 3, 4, 5, float("inf")],
                        device=cuda)
    ids = torch.tensor([0, 0, 1, -1, 7, 2], dtype=torch.int32, device=cuda)
    s = sr.segment_sum(data, ids, 3).cpu()
    m = sr.segment_max(data, ids, 3).cpu()
    assert s[0].isnan() and s[1] == 3 and s[2] == float("inf")
    assert m[0].isnan() and m[1] == 3 and m[2] == float("inf")


def test_segment_kernel_rejects_bad_arguments(cuda):
    d = torch.ones(64, device=cuda)
    i = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sr.segment_sum(d.double(), i, 4)
    with pytest.raises(TypeError):
        sr.segment_sum(d, i.long(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        sr.segment_sum(torch.ones(128, device=cuda)[::2], i, 4)
    with pytest.raises(ValueError):
        sr.segment_sum(d, i.cpu(), 4)
    with pytest.raises(ValueError):
        sr.segment_sum(d, i, 4, layout=sr.segment_layout(i.cpu(), 4))


def test_aggregate_tier_row_is_aggregate_edges_bitwise_on_card(cuda):
    rng = np.random.default_rng(0)
    m, G = 300, 7
    W = {"w": torch.from_numpy(rng.standard_normal((m, 50, 9))
                               .astype(np.float32)).to(cuda),
         "b": torch.from_numpy(rng.standard_normal((m,))
                               .astype(np.float32)).to(cuda)}
    H = torch.from_numpy(rng.integers(0, 9, m).astype(np.float32)).to(cuda)
    gids = rng.integers(0, G, m)
    Wg, Hg = eng.aggregate_tier(W, H, gids, G)
    for g in range(G):
        members = np.nonzero(gids == g)[0]
        ref = eng.aggregate_edges(W, H, members, None)
        for k in W:
            assert torch.equal(Wg[k][g], ref[k])


def _randn(shape, seed, device, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(device)


@pytest.mark.parametrize("B,H,KH,Sq,Sk,hd,causal,window", [
    (1, 2, 2, 128, 128, 64, True, None), (2, 4, 2, 256, 256, 64, False, None),
    (1, 8, 1, 256, 256, 32, True, None), (2, 2, 2, 384, 384, 16, True, None),
    (1, 2, 2, 100, 77, 112, True, None), (1, 4, 2, 77, 100, 128, False, None),
    (1, 2, 2, 300, 300, 112, True, 200), (1, 2, 2, 256, 256, 64, True, 32),
    (1, 2, 1, 200, 64, 112, True, 16), (1, 2, 2, 200, 200, 100, True, None),
    (1, 2, 2, 130, 130, 37, False, 50),
])
def test_flash_attention_equals_plain(cuda, B, H, KH, Sq, Sk, hd, causal,
                                      window):
    q = _randn((B, H, Sq, hd), 1, cuda)
    k, v = _randn((B, KH, Sk, hd), 2, cuda), _randn((B, KH, Sk, hd), 3, cuda)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, fa.default_kv_map(H, KH),
                                    causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_flash_attention_padded_head_map_on_card(cuda):
    q = _randn((2, 8, 64, 64), 4, cuda)
    k, v = _randn((2, 2, 64, 64), 5, cuda), _randn((2, 2, 64, 64), 6, cuda)
    kv_map = [0, 0, 0, 1, 1, 1, 0, 0]            # H=6 padded to 8
    got = fa.flash_attention(q, k, v, kv_map, causal=True)
    want = fa.flash_attention_plain(q, k, v, torch.tensor(kv_map,
                                                          dtype=torch.int32))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (1, 2, 128, 32, 16, 32), (2, 4, 256, 64, 64, 128),
    (1, 1, 64, 16, 128, 64), (2, 3, 64, 32, 16, 8), (1, 2, 512, 64, 64, 128),
])
def test_ssd_scan_equals_plain(cuda, B, H, S, P, N, chunk):
    xdt = _randn((B, H, S, P), 7, cuda, 0.3)
    a = -_randn((B, H, S), 8, cuda, 0.3).abs()
    Bm, Cm = _randn((B, S, N), 9, cuda, 0.3), _randn((B, S, N), 10, cuda, 0.3)
    before = sd.launches
    got = sd.ssd_scan(xdt, a, Bm, Cm, chunk=chunk)
    assert sd.launches == before + 1
    want = sd.ssd_scan_plain(xdt, a, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


def _ssd_inputs(B, H, S, P, N, cuda, dtype=torch.float32):
    xdt = _randn((B, H, S, P), 7, cuda, 0.3).to(dtype)
    a = -_randn((B, H, S), 8, cuda, 0.3).abs()
    Bm = _randn((B, S, N), 9, cuda, 0.3).to(dtype)
    Cm = _randn((B, S, N), 10, cuda, 0.3).to(dtype)
    return xdt, a, Bm, Cm


def test_ssd_scan_runs_mamba2_1_3b_chunk(cuda):
    """mamba2-1.3b's full SSD shape (N = 128 at l = 128, 64 heads)."""
    args = _ssd_inputs(1, 64, 1024, 64, 128, cuda)
    got = sd.ssd_scan(*args, chunk=128)
    want = sd.ssd_scan_plain(*args, chunk=128)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("B,H,KH,Sq,hd,causal,window", [
    (1, 4, 2, 256, 64, True, None), (2, 2, 2, 300, 112, False, None),
    (1, 4, 4, 200, 100, True, 64),
])
def test_flash_attention_bf16_equals_plain(cuda, B, H, KH, Sq, hd, causal,
                                           window):
    q = _randn((B, H, Sq, hd), 11, cuda).bfloat16()
    k = _randn((B, KH, Sq, hd), 12, cuda).bfloat16()
    v = _randn((B, KH, Sq, hd), 13, cuda).bfloat16()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    fa.default_kv_map(H, KH),
                                    causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    # one rounding to bfloat16 (half a step) of the float32 result, whose
    # own tolerance is 2e-5
    got = got.float()
    room = 2.0 ** -8 * torch.maximum(got.abs(), want.abs()) + 2e-5
    assert bool(((got - want).abs() <= room).all())


@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (2, 4, 256, 64, 64, 128), (1, 2, 128, 32, 16, 32),
    (1, 4, 256, 64, 128, 128),
])
def test_ssd_scan_bf16_equals_plain(cuda, B, H, S, P, N, chunk):
    args = _ssd_inputs(B, H, S, P, N, cuda, torch.bfloat16)
    got = sd.ssd_scan(*args, chunk=chunk)
    want = sd.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_launch_counters_count_kernel_calls_only(cuda):
    q = _randn((1, 2, 64, 64), 14, cuda)
    args = _ssd_inputs(1, 2, 128, 32, 16, cuda)
    fa.reset_launches()
    sd.reset_launches()
    fa.flash_attention_plain(q, q, q, fa.default_kv_map(2, 2))
    sd.ssd_scan_plain(*args, chunk=32)
    fa.flash_attention(q.cpu(), q.cpu(), q.cpu())
    assert (fa.launches, sd.launches) == (0, 0)
    for n in (1, 2):
        fa.flash_attention(q, q, q)
        sd.ssd_scan(*args, chunk=32)
        assert (fa.launches, sd.launches) == (n, n)
    torch.cuda.synchronize()


def test_flash_attention_takes_a_head_map_on_the_card(cuda):
    q = _randn((1, 4, 96, 64), 15, cuda)
    kv = _randn((1, 2, 96, 64), 16, cuda)
    host = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    got = fa.flash_attention(q, kv, kv, host.to(cuda))
    want = fa.flash_attention(q, kv, kv, host)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_new_kernels_reject_what_they_cannot_take(cuda):
    q = torch.zeros(1, 2, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3), q, q)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    x = torch.zeros(1, 1, 128, 64, device=cuda)
    a = torch.zeros(1, 1, 128, device=cuda)
    Bm = torch.zeros(1, 128, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sd.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), a,
                    Bm, Bm)
    with pytest.raises(ValueError, match="up to 128"):
        sd.ssd_scan(x, a, torch.zeros(1, 128, 129, device=cuda),
                    torch.zeros(1, 128, 129, device=cuda))
    with pytest.raises(TypeError):
        sd.ssd_scan(x.bfloat16(), a, Bm, Bm)
