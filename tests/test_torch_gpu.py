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


def _inputs(T, n, density, seed, device, *, ties=False, isolated=0,
            last=0):
    """Seeded kernel inputs; ``ties``: integer-valued costs (many equal
    sums); the first ``isolated`` rows have no link; the first ``last``
    rows have only column n-1."""
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
    if last:
        adj[:, :last] = False
        adj[:, :last, n - 1] = True
    return [a.to(device) for a in (c_link, *vec, adj)]


# n = 1003 and 4097 leave most rows unaligned for the kernel's 16-byte
# loads (head and tail peeled); n = 12000 reads c_next unstaged
@pytest.mark.parametrize("T,n,density,ties,isolated,last", [
    (1, 1, 1.0, False, 0, 0), (3, 7, 0.5, False, 0, 0),
    (4, 129, 0.3, False, 0, 0), (2, 256, 0.1, False, 0, 0),
    (20, 1000, 0.1, False, 0, 0), (100, 1024, 1.0, False, 0, 0),
    (6, 300, 0.7, True, 0, 0), (5, 200, 0.4, False, 17, 0),
    (3, 1003, 0.1, False, 0, 0), (2, 4097, 0.05, False, 0, 0),
    (4, 1003, 0.0, False, 0, 0), (5, 1003, 0.3, False, 0, 40),
    (3, 4097, 0.02, False, 0, 300), (4, 1000, 0.5, True, 0, 0),
    (1, 12000, 0.01, False, 5, 7),
])
def test_kernel_equals_plain_version_bitwise(cuda, T, n, density, ties,
                                             isolated, last):
    args = _inputs(T, n, density, T * 7919 + n, cuda, ties=ties,
                   isolated=isolated, last=last)
    before = og.launches
    got = og.offload_greedy_batched(*args)
    assert og.launches == before + 1
    want = og.offload_greedy_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("adj_off,link_off", [(3, 0), (0, 1), (5, 2)])
def test_kernel_on_unaligned_bases_equals_plain(cuda, adj_off, link_off):
    """Contiguous views that start off a 16-byte boundary: the head peel
    follows adj's address, and the wrapper copies a view whose c_link
    runs would not be 16-byte aligned with adj's."""
    T, n = 3, 517
    c_link, c_next, c_node, f_err, adj = _inputs(T, n, 0.2, 11, cuda)
    a = torch.zeros(T * n * n + adj_off, dtype=torch.bool, device=cuda)
    a[adj_off:] = adj.reshape(-1)
    c = torch.zeros(T * n * n + link_off, device=cuda)
    c[link_off:] = c_link.reshape(-1)
    args = [c[link_off:].view(T, n, n), c_next, c_node, f_err,
            a[adj_off:].view(T, n, n)]
    got = og.offload_greedy_batched(*args)
    want = og.offload_greedy_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_entry_refuses_bases_that_disagree(cuda):
    """The C entry point called with a c_link view one float into its
    storage (its runs off 16 bytes from adj's) returns
    cudaErrorMisalignedAddress and launches nothing."""
    import ctypes

    from repro_torch.kernels import _build

    T, n = 2, 64
    c_link, c_next, c_node, f_err, adj = _inputs(T, n, 0.5, 3, cuda)
    shifted = torch.zeros(T * n * n + 1, device=cuda)
    outs = [torch.full((T, n), -1, dtype=dt, device=cuda)
            for dt in (torch.int32, torch.int32, torch.float32)]
    fn = _build.load("offload_greedy").offload_greedy_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(shifted[1:].data_ptr(), c_next.data_ptr(), c_node.data_ptr(),
             f_err.data_ptr(), adj.data_ptr(),
             *(o.data_ptr() for o in outs), T, n,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 716                   # cudaErrorMisalignedAddress
    assert all(bool((o == -1).all()) for o in outs)


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


def _convex_problem(n, T, rho, seed):
    """Setting-B inputs at fog density (no capacities: there the descent
    is well posed, see tests/test_torch_convex.py)."""
    rng = np.random.default_rng(seed)
    tr = costs.testbed_like_costs(n, T, rng)
    adj = topology.make_topology("random", n, rng, rho=rho)
    D = rng.poisson(15, (T, n)).astype(float)
    return tr, adj, D


@pytest.mark.parametrize("em", ["sqrt", "neg_G"])
def test_convex_solve_on_card_matches_cpu(cuda, em):
    """n = 200, T = 20, rho = 0.1, the same z0 on both devices: plans
    within 1e-3, objectives within rtol 1e-4."""
    tr, adj, D = _convex_problem(200, 20, 0.1, 0)
    z0 = movement.convex_z0(20, 200, [0])[0]
    got = movement.solve_convex(tr, adj, D, error_model=em, z0=z0,
                                device=cuda)
    want = movement.solve_convex(tr, adj, D, error_model=em, z0=z0,
                                 device="cpu")
    np.testing.assert_allclose(got.s, want.s, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.r, want.r, rtol=0, atol=1e-3)
    cost = [movement.plan_cost(p, tr, D, error_model=em)["total"]
            for p in (got, want)]
    np.testing.assert_allclose(cost[0], cost[1], rtol=1e-4)


def test_convex_batched_equals_sequential_on_card(cuda):
    probs = [_convex_problem(120, 10, 0.2, sd) for sd in (1, 2, 3)]
    trs, adjs, Ds = zip(*probs)
    batched = movement.solve_convex_batched(list(trs), list(adjs), list(Ds),
                                            seeds=[0, 1, 2], device=cuda)
    for (tr, adj, D), sd, got in zip(probs, (0, 1, 2), batched):
        want = movement.solve_convex(tr, adj, D, seed=sd, device=cuda)
        np.testing.assert_allclose(got.s, want.s, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.r, want.r, rtol=0, atol=1e-5)


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


def _nan_bits(a):
    """float32 bits, every NaN one pattern."""
    a = np.array(a, np.float32)
    a[np.isnan(a)] = np.nan
    return a.view(np.int32)


def _sequential_rows(data, ids, G, scale):
    """float32 row sums in ascending row order from +0, each entry one
    product and one add."""
    out = np.zeros((G, data.shape[1]), np.float32)
    for i, g in enumerate(ids):
        if 0 <= g < G:
            out[g] = out[g] + (data[i] if scale is None
                               else data[i] * scale[i])
    return out


# P % 4 in 0..3, bases off a 16-B boundary (a view `off` floats into its
# storage), a group of 600 rows (staged chunks, unrolled tails), P = 1,
# no rows, no groups, an empty group, out-of-range ids, NaN and inf rows
@pytest.mark.parametrize("m,P,G,off,scaled,kind", [
    (40, 12, 5, 0, True, "random"), (40, 13, 5, 0, True, "random"),
    (40, 14, 5, 1, True, "random"), (40, 15, 5, 0, False, "random"),
    (40, 16, 5, 3, False, "random"), (40, 16, 5, 2, True, "random"),
    (650, 1031, 3, 2, True, "random"), (30, 156_800, 2, 0, True, "random"),
    (25, 1, 5, 0, True, "random"), (0, 8, 4, 0, True, "random"),
    (40, 8, 0, 0, True, "random"), (60, 20, 6, 0, True, "empty_group"),
    (60, 20, 6, 0, True, "out_of_range"), (60, 20, 6, 0, True, "non_finite")])
def test_segment_rows_kernel_is_the_sequential_sum_bitwise(cuda, m, P, G,
                                                           off, scaled,
                                                           kind):
    rng = np.random.default_rng(m + P + off)
    ids = rng.integers(-2, G + 2, m) if kind == "out_of_range" else \
        rng.integers(0, max(G, 1), m)
    if kind == "empty_group":
        ids[ids == 2] = 4
    data = rng.standard_normal((m, P)).astype(np.float32)
    if kind == "non_finite":
        data[np.nonzero(ids == 1)[0][0]] = np.nan
        data[np.nonzero(ids == 3)[0][0], 5] = np.inf
    scale = rng.integers(0, 7, m).astype(np.float32) if scaled else None
    store = torch.empty(off + m * P, device=cuda)
    store[off:] = torch.from_numpy(data.reshape(-1)).to(cuda)
    d = store[off:].view(m, P)
    i = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    h = None if scale is None else torch.from_numpy(scale).to(cuda)
    before = sr.launches
    got = sr.segment_sum_rows(d, i, G, scale=h)
    again = sr.segment_sum_rows(d, i, G, scale=h,
                                layout=sr.segment_layout(i, G))
    assert sr.launches == before + (2 if G and P else 0)
    want = _sequential_rows(data, ids, G, scale)
    assert got.shape == (G, P)
    np.testing.assert_array_equal(_nan_bits(got.cpu().numpy()),
                                  _nan_bits(want))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    if kind == "empty_group":
        assert not got[2].any()


def _segment_lengths_case(kind, rng):
    if kind == "one_element":               # per-cell counts, K > 1
        S = 600_000
        ids = np.repeat(np.arange(S), rng.poisson(1.0, S))
    elif kind == "wide":                    # around the wide threshold
        lens = [5, 2100, 0, 3, 2049, 2048, 700, 4100, 1, 70_000, 2047]
        S = len(lens) + 3
        ids = np.repeat(np.arange(len(lens)), lens)
        rng.shuffle(ids)
    elif kind == "huge":                    # one segment of 2**20
        S = 5
        ids = np.full(1 << 20, 3)
    else:
        S = 3001
        ids = rng.integers(-50, S + 50, 200_000)
    data = rng.standard_normal(ids.shape[0]).astype(np.float32)
    if kind == "mixed":
        data[rng.integers(0, data.shape[0], 4)] = [np.nan, np.inf, -np.inf,
                                                   np.nan]
    return data, ids.astype(np.int32), S


@pytest.mark.parametrize("kind", ["one_element", "wide", "huge", "mixed"])
def test_segment_kernel_short_and_wide_segments_bitwise(cuda, kind):
    data, ids, S = _segment_lengths_case(kind, np.random.default_rng(9))
    d, i = torch.from_numpy(data).to(cuda), torch.from_numpy(ids).to(cuda)
    got = sr.segment_sum(d, i, S).cpu().numpy()
    np.testing.assert_array_equal(_nan_bits(got),
                                  _nan_bits(_sequential_sum(data, ids, S)))
    mx = sr.segment_max(d, i, S).cpu().numpy()
    want = sr.segment_max_plain(torch.from_numpy(data),
                                torch.from_numpy(ids), S).numpy()
    np.testing.assert_array_equal(_nan_bits(mx), _nan_bits(want))


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


# ---------------------------------------------------------------------------
# faults and recovery on the card
# ---------------------------------------------------------------------------


def _fog_run(device, tmp=None, **kw):
    """mlp, n=6, T=12, τ=4 on ``device``, from seed 0's weights."""
    from repro_torch.core import federated as F
    from repro_torch.data import pipeline as pl
    from repro_torch.data.synthetic import make_image_dataset

    n, T = 6, 12
    data = make_image_dataset(n_train=1200, n_test=400, seed=0)
    rng = np.random.default_rng(0)
    traces = costs.synthetic_costs(n, T, rng)
    adj = topology.fully_connected(n)
    streams = pl.poisson_streams(n, T, data[1], rng=rng)
    plan = movement.greedy_linear(traces, adj, backend="numpy")
    cfg = F.FedConfig(n=n, T=T, tau=4, eta=0.05, model="mlp", seed=0)
    return F.run_network_aware(cfg, data, traces, adj, plan,
                               streams=streams, device=device, **kw)


def _fault_schedule(kind="mixed", rate=0.4, corrupt="nan"):
    from repro_torch.core import faults as fl

    return fl.make_faults(kind, 12, 6, 4, rate=rate, seed=3,
                          corrupt=corrupt)


def _bitwise(a, b):
    for k in ("device_loss", "test_loss", "test_acc", "H_agg"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k]),
                              equal_nan=True), k
    assert a.get("agg_quorum_ok") == b.get("agg_quorum_ok")
    assert a.get("agg_survivors") == b.get("agg_survivors")


def test_guarded_uploads_on_card_equal_cpu(cuda):
    g = torch.Generator().manual_seed(5)
    W = {"w": torch.randn(5, 7, 3, generator=g),
         "b": torch.randn(5, 3, generator=g)}
    W["w"][1, 2, 0] = float("nan")
    contrib = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0])
    upl = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0])
    for payload in (float("nan"), float("inf"), -10.0):
        cor = torch.tensor([1.0, 1.0, 1.0, 1.0, payload])
        for guard in (True, False):
            want = eng._guarded_uploads(W, contrib, upl, cor, guard)
            got = eng._guarded_uploads(
                {k: v.to(cuda) for k, v in W.items()}, contrib.to(cuda),
                upl.to(cuda), cor.to(cuda), guard)
            assert torch.equal(got[1].cpu(), want[1])
            for k in W:
                assert torch.equal(got[0][k].cpu().nan_to_num(7.0),
                                   want[0][k].nan_to_num(7.0))
                assert torch.equal(got[0][k].cpu().isnan(),
                                   want[0][k].isnan())


@pytest.mark.parametrize("engine", ["scan", "legacy"])
def test_quorum_and_guard_on_card_match_cpu(cuda, engine):
    fs = _fault_schedule()
    got = _fog_run(cuda, engine=engine, faults=fs, quorum=0.5)
    want = _fog_run("cpu", engine=engine, faults=fs, quorum=0.5)
    assert got["agg_quorum_ok"] == want["agg_quorum_ok"]
    assert got["agg_survivors"] == want["agg_survivors"]
    np.testing.assert_array_equal(np.stack(got["H_agg"]),
                                  np.stack(want["H_agg"]))
    np.testing.assert_allclose(np.stack(got["device_loss"]),
                               np.stack(want["device_loss"]),
                               rtol=2e-3, atol=1e-4)


def test_unguarded_nan_on_card_in_the_cpu_places(cuda):
    fs = _fault_schedule("corrupt", 0.3)
    got = _fog_run(cuda, faults=fs, guard=False)
    want = _fog_run("cpu", faults=fs, guard=False)
    for k in ("device_loss", "test_loss"):
        assert np.array_equal(np.isnan(np.asarray(got[k], float)),
                              np.isnan(np.asarray(want[k], float))), k
    assert np.isnan(got["test_loss"][-1])


def test_clean_noop_bitwise_on_card(cuda):
    from repro_torch.core import faults as fl

    clean = _fog_run(cuda)
    noop = _fog_run(cuda, faults=fl.FaultSchedule(12, 6, 4), quorum=0.5)
    _bitwise(clean, {**noop, "agg_quorum_ok": None,
                     "agg_survivors": None})


@pytest.mark.parametrize("faulted", [False, True])
def test_chunked_and_resumed_runs_bitwise_on_card(cuda, tmp_path, faulted):
    kw = dict(faults=_fault_schedule(), quorum=0.25) if faulted else {}
    full = _fog_run(cuda, **kw)
    ck = str(tmp_path / "ck.pt")
    _bitwise(full, _fog_run(cuda, checkpoint_path=ck, **kw))
    part = _fog_run(cuda, checkpoint_path=ck, stop_after=4, **kw)
    assert part["stopped_at"] == 4
    _bitwise(full, _fog_run(cuda, resume=ck, **kw))


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import checkpoint as ckpt

    tree = {"a": torch.arange(6.0, device=cuda).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.bfloat16, device=cuda)],
            "c": torch.zeros(2)}
    path = str(tmp_path / "ck.pt")
    ckpt.save(path, tree, {"k": 1})
    out, meta = ckpt.restore(path, tree)
    assert out["a"].device == tree["a"].device and out["c"].device.type \
        == "cpu"
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"][0].view(torch.int16),
                       tree["b"][0].view(torch.int16))
    assert meta["k"] == 1


def _flat_problem(n, T, seed=0, mean=2.0):
    """A seeded edge-list churn problem on flat streams: (data, config
    pieces, costs, plan, flat streams, schedule)."""
    from repro_torch.core import federated as F
    from repro_torch.core.costs import synthetic_edge_costs
    from repro_torch.data import pipeline as pl

    rng = np.random.default_rng(seed)
    data = (rng.random((600, 28, 28)).astype(np.float32),
            rng.integers(0, 10, 600),
            rng.random((100, 28, 28)).astype(np.float32),
            rng.integers(0, 10, 100))
    src, dst = topology.random_sparse_edges(n, 4, rng)
    sched = topology.churn_schedule_edges(n, src, dst, T, 0.1, 0.3,
                                          np.random.default_rng(7), tau=4)
    etr = synthetic_edge_costs(n, T, src, dst, np.random.default_rng(1))
    plan = movement.realize_plan(movement.greedy_linear(etr, sched), sched)
    flat = pl.poisson_streams_flat(n, T, data[1],
                                   rng=np.random.default_rng(3),
                                   mean_per_round=mean)
    cfg = F.FedConfig(n=n, T=T, tau=4, eta=0.1, model="linear", seed=0)
    return data, cfg, etr, plan, flat, sched


@pytest.mark.parametrize("n,T,mean", [(64, 8, 2.0), (3000, 20, 1.0)])
def test_counts_flat_through_the_kernel(cuda, n, T, mean):
    from repro_torch.data import pipeline as pl

    flat = _flat_problem(n, T, mean=mean)[4]
    sr.reset_launches()
    got = pl.counts_flat(flat)
    assert sr.launches == 1
    key = flat.cell_key()
    plain = sr.segment_sum_plain(
        torch.ones(key.shape[0], device=cuda),
        torch.from_numpy(key.astype(np.int32)).to(cuda), T * n)
    assert got.dtype == np.float64 and got.shape == (T, n)
    np.testing.assert_array_equal(got, plain.cpu().numpy().reshape(T, n))
    np.testing.assert_array_equal(
        got, np.bincount(key, minlength=T * n).reshape(T, n))
    np.testing.assert_array_equal(got, pl.counts_flat(flat, "cpu"))


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_ties_on_card_equal_cpu(cuda, seed):
    """Integer costs make many equal sums: the card must order them as
    the CPU does (lowest j first), dense and CSR."""
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(seed)
    T, n, k = 3, 300, 6
    c_link = torch.randint(0, 3, (T, n, n), generator=g).float()
    c_next = torch.randint(0, 3, (T, n), generator=g).float()
    adj = torch.rand((T, n, n), generator=g) < 0.1
    want = ops.topk_neighbors(c_link, c_next, adj, k=k)
    got = ops.topk_neighbors(c_link.to(cuda), c_next.to(cuda),
                             adj.to(cuda), k=k)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    src, dst = np.nonzero(adj[0].numpy() | adj[1].numpy())
    keys = src * n + dst
    indptr = np.searchsorted(src, np.arange(n + 1))
    ce = c_link[:, src, dst]
    live = torch.from_numpy(adj[:, src, dst].numpy() & (src != dst))
    want = ops.topk_neighbors_csr(ce, c_next, indptr, dst, live, k=k)
    got = ops.topk_neighbors_csr(ce.to(cuda), c_next.to(cuda), indptr, dst,
                                 live.to(cuda), k=k)
    assert keys.size and np.all(np.diff(keys) > 0)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_tiered_flat_l1_is_flat_scan_bitwise_on_card(cuda):
    from repro_torch.core import federated as F
    from repro_torch.core import hierarchy as hr

    data, cfg, etr, plan, flat, sched = _flat_problem(64, 16)
    kw = dict(streams=flat, schedule=sched, device=cuda)
    h1 = F.run_network_aware(cfg, data, etr, None, plan,
                             hierarchy=hr.TierTree.balanced(64, (1,), (4,)),
                             **kw)
    h0 = F.run_network_aware(cfg, data, etr, None, plan, **kw)
    assert h1["agg_round"] == h0["agg_round"]
    for k in ("device_loss", "test_loss", "test_acc", "H_agg"):
        assert np.array_equal(np.asarray(h1[k]), np.asarray(h0[k])), k


# ---------------------------------------------------------------------------
# gradients through kernel 2 and the sweep engine on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_scale", [False, True])
def test_segment_sum_grads_on_card_equal_plain(cuda, with_scale):
    """Autograd through the kernels (backward: a gather) against autograd
    through their plain versions on the same card, bit for bit."""
    g = torch.Generator().manual_seed(11)
    m, P, G = 300, 37, 9
    data = torch.randn(m, P, generator=g)
    ids = torch.randint(-1, G + 1, (m,), generator=g).to(torch.int32)
    scale = torch.rand(m, generator=g)
    cot = torch.randn(G, P, generator=g).to(cuda)

    def grads(fn):
        d = data.to(cuda).requires_grad_(True)
        s = scale.to(cuda).requires_grad_(True) if with_scale else None
        out = fn(d, ids.to(cuda), s)
        return torch.autograd.grad(out, (d, s) if with_scale else (d,), cot)

    got = grads(lambda d, i, s: sr.segment_sum_rows(d, i, G, scale=s))
    want = grads(lambda d, i, s: sr.segment_sum_rows_plain(d, i, G,
                                                           scale=s))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    d = data[:, 0].contiguous().to(cuda).requires_grad_(True)
    got, = torch.autograd.grad(sr.segment_sum(d, ids.to(cuda), G), d,
                               cot[:, 0].contiguous())
    d2 = data[:, 0].contiguous().to(cuda).requires_grad_(True)
    want, = torch.autograd.grad(sr.segment_sum_plain(d2, ids.to(cuda), G),
                                d2, cot[:, 0].contiguous())
    assert torch.equal(got, want)


def test_row_gather_backward_on_card_equals_cpu(cuda):
    """The ragged round's gather: its backward on the card (the row
    kernel, each device's rows in ascending order, the trash id adding
    nothing) equals the CPU's sequential row sum bit for bit."""
    g = torch.Generator().manual_seed(12)
    M, R = 40, 300
    W = torch.randn(M, 13, 5, generator=g)
    cell = torch.randint(0, M + 1, (R,), generator=g).to(torch.int32)
    cot = torch.randn(R, 13, 5, generator=g)
    out = []
    for dev in ("cpu", cuda):
        c = cell.to(dev)
        Wt = W.to(dev).requires_grad_(True)
        rows = eng._RowGather.apply(Wt, c, torch.clamp(c, max=M - 1).long(),
                                    eng._layout(c, M))
        out.append(torch.autograd.grad(rows, Wt, cot.to(dev))[0].cpu())
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("staging", ["dense", "ragged"])
def test_small_bucket_on_card_matches_cpu(cuda, staging):
    from repro_torch.core import federated as F
    from repro_torch.data import pipeline as pl
    from repro_torch.data.synthetic import make_image_dataset

    data = make_image_dataset(n_train=1200, n_test=400, seed=0)
    cfgs, plans, streams = [], [], []
    for n, seed in ((4, 0), (6, 1), (6, 2)):
        rng = np.random.default_rng(seed)
        traces = costs.synthetic_costs(n, 12, rng)
        streams.append(pl.poisson_streams(n, 12, data[1], rng=rng))
        plans.append(movement.greedy_linear(
            traces, topology.fully_connected(n), backend="numpy"))
        cfgs.append(F.FedConfig(n=n, T=12, tau=4, eta=0.05, model="mlp",
                                seed=seed))
    fs = [None, _fault_schedule(), None]
    runs = [F.run_network_aware_batched(
        cfgs, data, plans, streams=streams, staging=staging, faults=fs,
        quorum=0.3, device=dev) for dev in (cuda, "cpu")]
    for got, want in zip(*runs):
        assert got["agg_round"] == want["agg_round"]
        assert got["agg_quorum_ok"] == want["agg_quorum_ok"]
        assert got["agg_survivors"] == want["agg_survivors"]
        np.testing.assert_array_equal(np.stack(got["H_agg"]),
                                      np.stack(want["H_agg"]))
        np.testing.assert_allclose(np.stack(got["device_loss"]),
                                   np.stack(want["device_loss"]),
                                   rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                                   rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                                   atol=1e-2)


def _grads(y, ins, g):
    return torch.autograd.grad(y, ins, g)


# (s1) of chip_smoke.py: the Functions' backward is the plain version
# recomputed, so on the same inputs and cotangent their gradients equal
# all-plain autograd bit for bit; a row no key sees gets 0
@pytest.mark.parametrize("B,H,KH,Sq,Sk,hd,causal,window,dtype", [
    (1, 4, 4, 128, 128, 64, True, None, torch.float32),
    (2, 4, 2, 96, 96, 112, True, 32, torch.float32),
    (1, 4, 1, 64, 80, 64, False, None, torch.float32),
    (1, 2, 1, 64, 16, 32, False, 8, torch.float32),       # rows 23.. blind
    (1, 4, 2, 128, 128, 64, True, None, torch.bfloat16),
])
def test_attention_grads_on_card_equal_plain_autograd(
        cuda, B, H, KH, Sq, Sk, hd, causal, window, dtype):
    q = _randn((B, H, Sq, hd), 21, cuda).to(dtype)
    k = _randn((B, KH, Sk, hd), 22, cuda).to(dtype)
    v = _randn((B, KH, Sk, hd), 23, cuda).to(dtype)
    g = _randn((B, H, Sq, hd), 24, cuda).to(dtype)
    km = fa.default_kv_map(H, KH).to(cuda)
    a1 = [t.clone().requires_grad_() for t in (q, k, v)]
    a2 = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.launches
    y1 = fa.flash_attention(*a1, km, causal=causal, window=window)
    got = _grads(y1, a1, g)
    assert fa.launches == before + 1                 # none from the backward
    y2 = fa.flash_attention_plain(*a2, km, causal=causal, window=window)
    want = _grads(y2, a2, g)
    for x1, x2 in zip(got, want):
        assert x1.dtype == dtype and bool(torch.isfinite(x1).all())
        assert torch.equal(x1, x2)


@pytest.mark.parametrize("B,H,S,P,N,chunk,dtype", [
    (2, 4, 256, 64, 64, 128, torch.float32),
    (1, 3, 64, 32, 16, 8, torch.float32),
    (1, 2, 128, 32, 16, 32, torch.bfloat16),
])
def test_ssd_grads_on_card_equal_plain_autograd(cuda, B, H, S, P, N, chunk,
                                                dtype):
    ins = _ssd_inputs(B, H, S, P, N, cuda, dtype)
    g = _randn((B, H, S, P), 25, cuda)
    a1 = [t.clone().requires_grad_() for t in ins]
    a2 = [t.clone().requires_grad_() for t in ins]
    before = sd.launches
    got = _grads(sd.ssd_scan(*a1, chunk=chunk), a1, g)
    assert sd.launches == before + 1
    want = _grads(sd.ssd_scan_plain(*a2, chunk=chunk), a2, g)
    for x1, x2, t in zip(got, want, ins):
        assert x1.dtype == t.dtype and bool(torch.isfinite(x1).all())
        assert torch.equal(x1, x2)


def _attention_launches(cfg):
    """Flash-attention launches of one forward: one a decoder layer, one
    a hybrid group; an enc-dec arch adds its encoder and cross layers."""
    if cfg.attn_every:
        return cfg.num_layers // cfg.attn_every
    if cfg.ssm_state:
        return 0
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b", "zamba2-7b",
                                  "olmoe-1b-7b", "whisper-large-v3"])
def test_smoke_train_step_on_card_matches_cpu(cuda, arch):
    """One ``make_train_step`` of a smoke config on the card (the
    kernels forward, their plain versions backward) against the CPU,
    from the same parameters: loss and gradient norm within rtol 1e-4,
    the parameters after an sgd step within 1e-4 of each leaf's largest
    |p| (AdamW's first step is about ±lr on every entry whatever its
    gradient's size, so rounding flips the sign of near-zero ones); a
    key bias (whisper), whose gradient is 0 in exact arithmetic, moved
    by no more than 1e-6·lr on either device."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params
    from repro_torch.optim import optimizers as topt

    cfg = registry.get_config(arch, smoke=True)
    params = init_params(T.specs(cfg), 0, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (4, 64)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (4, 64)).astype(np.int32)),
             "weights": torch.tensor([1.0, 0.0, 0.5, 1.0]),
             "route": torch.tensor([2, 0, 3, 1], dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    lr = 0.05
    opt = topt.sgd(lr)
    step = St.make_train_step(cfg, opt)
    before = dict(_named_leaves(topt.tree_map(lambda t: t.clone(), params)))
    out = {}
    for dev in (cuda, "cpu"):
        p = topt.tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        fa.reset_launches()
        sd.reset_launches()
        out[str(dev)] = step(p, opt.init(p), b)
        if dev == cuda:
            torch.cuda.synchronize()
            assert fa.launches == _attention_launches(cfg)
            assert sd.launches == (cfg.num_layers if cfg.ssm_state else 0)
    (pc, _, mc), (pp, _, mp) = out["cuda"], out["cpu"]
    for k in ("loss", "grad_norm"):
        assert float(mc[k]) == pytest.approx(float(mp[k]), rel=1e-4)
    for (name, a), (_, b) in zip(_named_leaves(pc), _named_leaves(pp)):
        if name.endswith("/bk"):
            # a bias added to every key shifts a query's scores by one
            # constant, which the softmax ignores: its gradient is 0 in
            # exact arithmetic and rounding noise on either device
            for x in (a.cpu(), b):
                assert float((x - before[name]).abs().max()) <= 1e-6 * lr
            continue
        assert float((a.cpu() - b).abs().max()) <= \
            1e-4 * float(b.abs().max())


def _named_leaves(tree, path=""):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


# the MoE layer (plain torch) on the card against the CPU: the routing
# exactly (ties to the lowest expert, as jax.lax.top_k), the output
# within 2e-5 of max|out|, the aux loss within 1e-6
@pytest.mark.parametrize("case", ["tie", "padded", "drops"])
def test_moe_apply_on_card_matches_cpu(cuda, case):
    from repro_torch.configs import registry
    from repro_torch.models import moe as M
    from repro_torch.models.module import init_params

    kw = {"tie": dict(num_experts=64, experts_per_token=8, d_model=64,
                      d_ff=32, num_heads=4, capacity_factor=8.0),
          "padded": dict(moe_pad_experts=8, moe_groups=2),
          "drops": dict(capacity_factor=0.25)}[case]
    cfg = registry.get_config("olmoe-1b-7b", smoke=True).with_overrides(**kw)
    p = init_params(M.moe_specs(cfg), 0, torch.float32, "cpu")
    if case == "tie":
        p["router"].zero_()
    x = _randn((2, 48, cfg.d_model), 31, "cpu")
    C = M.expert_capacity(96, cfg)
    G = cfg.moe_groups
    routes, outs = [], []
    for dev in (cuda, "cpu"):
        pd = {k: v.to(dev) for k, v in p.items()}
        xd = x.to(dev)
        routes.append([t.cpu() for t in M.route(
            xd.reshape(G, -1, cfg.d_model), pd["router"], cfg, C)[2:]])
        outs.append([t.cpu() for t in M.moe_apply(xd, pd, cfg)])
    for a, b in zip(*routes):
        assert torch.equal(a, b)
    if case == "tie":
        assert (routes[0][0] == torch.arange(8)).all()
    (oc, ac), (oh, ah) = outs
    assert float((oc - oh).abs().max()) <= 2e-5 * float(oh.abs().max())
    assert abs(float(ac) - float(ah)) <= 1e-6
    if case == "padded":
        pd = {k: v.to(cuda).requires_grad_() for k, v in p.items()}
        M.moe_apply(x.to(cuda), pd, cfg)[0].sum().backward()
        E = cfg.num_experts
        for name in ("w_gate", "w_up", "w_down"):
            assert not pd[name].grad[E:].any()
            assert bool(pd[name].grad[:E].abs().max() > 0)


def test_cross_decode_attention_on_card_matches_cpu(cuda):
    """Whisper's decode-time cross attention (plain torch, padded q heads
    dropped) on the card against the CPU, within 2e-5 of max|out|."""
    from repro_torch.configs import registry
    from repro_torch.models import layers as L
    from repro_torch.models.module import init_params

    cfg = registry.get_config("whisper-large-v3", smoke=True).with_overrides(
        num_heads=6, num_kv_heads=2, tp_pad=8)
    p = init_params(L.attention_specs(cfg), 0, torch.float32, "cpu")
    x = _randn((3, 1, cfg.d_model), 41, "cpu")
    enc = _randn((3, cfg.encoder_seq, cfg.d_model), 42, "cpu")
    out = []
    for dev in (cuda, "cpu"):
        pd = {k: v.to(dev) for k, v in p.items()}
        k, v = L.cross_kv(enc.to(dev), pd, cfg)
        out.append(L.cross_decode_attention(x.to(dev), pd, cfg, k, v).cpu())
    assert out[0].shape == (3, 1, cfg.d_model)
    assert float((out[0] - out[1]).abs().max()) <= \
        2e-5 * float(out[1].abs().max())


@pytest.fixture
def nccl_world_of_one(cuda):
    """An NCCL world of one made by ``launch/mesh.init_process_group``,
    destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    if dist.is_initialized():
        pytest.fail("a process group exists before the test")
    mesh_lib.init_process_group(cuda)
    assert (dist.get_backend(), dist.get_world_size()) == ("nccl", 1)
    yield dist
    dist.destroy_process_group()


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
def test_sharded_engine_on_nccl_world_of_one_is_batched(nccl_world_of_one,
                                                        cuda, faulted):
    """``engine="sharded"`` on the card's world of one: bit for bit
    ``engine="batched"``, kernel 2 launched as often, two all-reduces a
    window (three under faults)."""
    import copy

    from repro_torch.core import federated as F
    from repro_torch.core import faults as fl
    from repro_torch.data import pipeline as pl
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.distributed import collectives as coll

    data = make_image_dataset(n_train=1200, n_test=400, seed=0)
    n, T, tau = 5, 12, 4
    rng = np.random.default_rng(0)
    traces = costs.synthetic_costs(n, T, rng)
    streams = pl.poisson_streams(n, T, data[1], rng=rng)
    plan = movement.greedy_linear(traces, topology.fully_connected(n),
                                  backend="numpy")
    cfg = F.FedConfig(n=n, T=T, tau=tau, eta=0.05, model="mlp", seed=0)
    kw = {}
    if faulted:
        kw = dict(faults=fl.FaultSchedule(T, n, tau, [
            fl.FaultEvent(3, "corrupt", 0, float("nan")),
            fl.FaultEvent(5, "crash", 2), fl.FaultEvent(11, "drop", 4)]),
            quorum=0.5)
    runs = {}
    for engine in ("batched", "sharded"):
        before, coll.all_reduces = sr.launches, 0
        h = F.run_network_aware(cfg, data, traces, None, plan,
                                streams=copy.deepcopy(streams),
                                engine=engine, device=cuda, **kw)
        runs[engine] = (h, sr.launches - before, coll.all_reduces)
    (got, l_s, ar_s), (want, l_b, ar_b) = runs["sharded"], runs["batched"]
    assert l_s == l_b > 0 and ar_b == 0
    assert ar_s == (3 if faulted else 2) * (T // tau)
    for k in ("device_loss", "H_agg", "test_loss", "test_acc",
              "agg_round", "agg_survivors", "agg_quorum_ok"):
        if k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_fedavg_round_on_nccl_world_of_one_is_the_one_card_round(
        nccl_world_of_one, cuda):
    from repro_torch.configs import registry
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.fedavg import make_fedavg_round
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params
    from repro_torch.optim import optimizers as topt

    dist = nccl_world_of_one
    cfg = registry.get_config("qwen3-14b", smoke=True)
    g = torch.Generator().manual_seed(0)
    tau, B, S = 2, 4, 16
    batches = {"tokens": torch.randint(0, cfg.vocab_size, (tau, B, S),
                                       generator=g, dtype=torch.int32),
               "labels": torch.randint(0, cfg.vocab_size, (tau, B, S),
                                       generator=g, dtype=torch.int32),
               "weights": torch.rand((tau, B), generator=g)}
    batches = {k: v.to(cuda) for k, v in batches.items()}
    outs = []
    for group in (None, dist.group.WORLD):
        opt = topt.adamw(3e-3)
        p = init_params(T.specs(cfg), 0, torch.float32, cuda)
        coll.reset_counts()
        outs.append(make_fedavg_round(cfg, opt, tau, group=group)(
            p, opt.init(p), batches))
    assert coll.all_reduces == 2        # the H total, one flat buffer
    (p0, s0, l0), (p1, s1, l1) = outs
    assert torch.equal(l0, l1)
    for a, b in zip(topt.tree_leaves(p0) + topt.tree_leaves(s0),
                    topt.tree_leaves(p1) + topt.tree_leaves(s1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the sanitizer's guard on the card, and the streaming scan flag
# ---------------------------------------------------------------------------


def test_sanitize_guard_sets_and_restores_sync_debug_mode(cuda):
    from repro_torch.core import sanitize as sz

    x = torch.arange(1.0, 9.0, device=cuda)
    for before in (0, 1):                    # "default", then "warn"
        torch.cuda.set_sync_debug_mode(before)
        try:
            with sz.sanitized(True):
                with sz.hot_loop_guard():
                    assert torch.cuda.get_sync_debug_mode() == 2
                    y = x * 2.0                  # no sync: allowed
                assert torch.cuda.get_sync_debug_mode() == before
                with pytest.raises(RuntimeError):
                    with sz.hot_loop_guard():
                        x.sum().item()
                assert torch.cuda.get_sync_debug_mode() == before
            assert torch.cuda.get_sync_debug_mode() == before
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert float(y.sum()) == 72.0


def test_sanitize_sync_debug_catches_syncs_inside_ops(cuda):
    """A boolean mask index syncs inside the op (its output size is read
    on the host): the dispatch mode sees only aten.index, the sync debug
    mode raises; copies between the host and the card raise too."""
    from repro_torch.core import sanitize as sz

    x = torch.arange(-4.0, 4.0, device=cuda)
    with sz.sanitized(True):
        for op in (lambda: x[x > 0], lambda: x.cpu(),
                   lambda: torch.ones(3).to(cuda)):
            with pytest.raises(RuntimeError):
                with sz.hot_loop_guard():
                    op()
        with sz.hot_loop_guard() as outs:    # card to card: allowed
            outs.append(x.clone().to(cuda))
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.parametrize("loop", ["scan", "checkpointed", "hierarchical",
                                  "batched"])
def test_sanitized_engine_on_card_is_bitwise_and_guarded(cuda, loop,
                                                         tmp_path):
    """Each guarded round loop on the card under the sanitizer, cold and
    warm (no build, no new program key): bit for bit the unsanitized
    run, with guarded corrupt uploads in the window of round 3."""
    from repro_torch.core import faults as fl
    from repro_torch.core import federated as F
    from repro_torch.core import sanitize as sz
    from repro_torch.core.hierarchy import TierTree
    from repro_torch.data.synthetic import make_image_dataset

    data = make_image_dataset(n_train=600, n_test=200, seed=0)
    cfg = F.FedConfig(n=6, T=8, tau=2, eta=0.05, model="mlp", seed=3)
    traces = costs.synthetic_costs(cfg.n, cfg.T, np.random.default_rng(1))
    plan = movement.no_movement_plan(cfg.T, cfg.n)
    kw = dict(faults=fl.FaultSchedule(cfg.T, cfg.n, cfg.tau, [
        fl.FaultEvent(3, "corrupt", 0, float("nan"))]), engine=loop)
    if loop == "checkpointed":
        kw.update(engine="scan", checkpoint_path=str(tmp_path / "c"))
    elif loop == "hierarchical":
        kw.update(engine="scan", hierarchy=TierTree.from_spec("3@2,1@4", 6))
    warm = sz.SanitizeConfig(expect_warm=True)
    runs = [F.run_network_aware(cfg, data, traces, None, plan, sanitize=s,
                                device=cuda, **kw)
            for s in (False, True, warm)]
    assert warm.last_compiles == 0
    for h in runs[1:]:
        assert h["test_acc"] == runs[0]["test_acc"]
        assert h["agg_survivors"] == runs[0]["agg_survivors"]
        np.testing.assert_array_equal(np.stack(h["device_loss"]),
                                      np.stack(runs[0]["device_loss"]))


def test_sanitized_sharded_engine_on_nccl_world_of_one(nccl_world_of_one,
                                                       cuda):
    from repro_torch.core import federated as F
    from repro_torch.data.synthetic import make_image_dataset

    data = make_image_dataset(n_train=600, n_test=200, seed=0)
    cfg = F.FedConfig(n=5, T=8, tau=2, eta=0.05, model="mlp", seed=3)
    traces = costs.synthetic_costs(cfg.n, cfg.T, np.random.default_rng(1))
    plan = movement.no_movement_plan(cfg.T, cfg.n)
    h0, h1 = (F.run_network_aware(cfg, data, traces, None, plan,
                                  engine="sharded", sanitize=s, device=cuda)
              for s in (False, True))
    assert h1["test_acc"] == h0["test_acc"]
    np.testing.assert_array_equal(np.stack(h1["device_loss"]),
                                  np.stack(h0["device_loss"]))


def test_streaming_flag_runs_kernel_four(cuda):
    """ops.ssd(streaming=True) on the card is the kernel (one launch),
    bitwise the default setting's, and within 1e-4 of max|y| of the
    streaming plain version."""
    from repro_torch.kernels import ops

    args = _ssd_inputs(2, 4, 256, 64, 64, cuda)
    sd.reset_launches()
    got = ops.ssd(*args, chunk=64, streaming=True)
    default = ops.ssd(*args, chunk=64)
    want = sd.ssd_scan_streaming_plain(*args, chunk=64)
    torch.cuda.synchronize()
    assert sd.launches == 2
    assert torch.equal(got, default)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
