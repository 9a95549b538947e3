"""The arithmetic of the tensor-core kernels, emulated on the CPU.

The flash-attention and SSD-scan CUDA kernels (``src/repro_torch/kernels/
csrc``) run their products on TF32 tensor cores by 3xTF32: each
float32 operand x is split into hi = rna(x) and lo =
rna(x − hi), where rna is ``cvt.rna.tf32.f32`` (round to nearest, ties
away from zero, keep 10 mantissa bits), and a product issues hi·lo,
lo·hi and hi·hi. Here that rounding is emulated in torch, and the two
kernels' decompositions are run with it in plain torch against the JAX
reference:

- at zamba2's head_dim 112, one TF32 product misses attention's
  float32 tolerance (2e-5) and the 3xTF32 sum meets it;
- the attention tile walk of the kernel (128-row q tiles of 16-row warps,
  64-key tiles, tiles skipped outside the band, masks only on edge
  tiles, the online softmax in log2 units, P fed to P·V through the
  kernel's register mapping, with the keys of each 8-key group
  relabelled, and the small terms of S and of O summed apart from their
  hi·hi terms) against ``ref.flash_attention_ref`` at 2e-5;
- the scan's chunk-parallel decomposition (C·Bᵀ per batch and chunk, the
  chunk states, the sequential pass over them, the outputs) against
  ``ref.ssd_scan_ref`` at 1e-4 of max|y|.

So a decomposition or permutation error shows here before the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref

ATTN_TOL = 2e-5   # tests/test_kernels.py, float32
SSD_TOL = 1e-4    # of max|y|
LOG2E = 1.4426950408889634


def rna_tf32(x):
    """cvt.rna.tf32.f32: add half of the last kept bit, clear the 13 low
    bits of the float32 pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm1(a, b):
    """One TF32 product, float32 accumulation."""
    return rna_tf32(a) @ rna_tf32(b)


def mm3(a, b):
    """3xTF32: the small terms first, then hi·hi, into float32."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bl + al @ bh + ah @ bh


def mm3_sep(a, b):
    """3xTF32 as (hi·hi, the small terms), to be summed apart."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh, ah @ bl + al @ bh


def test_rna_keeps_ten_mantissa_bits_and_hi_lo_restore_float32():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000)
                         .astype(np.float32))
    hi, lo = split(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert (lo.view(torch.int32) & 0x1FFF == 0).all()
    assert float((hi - x).abs().max() / x.abs().max()) <= 2.0 ** -11
    # hi + lo is x to 2^-22 of |x|, below float32's own 2^-24 spacing x 4
    assert float(((hi + lo) - x).abs().div(x.abs()).max()) <= 2.0 ** -21
    # ties go away from zero: 1 + 2^-11 (half of the last kept bit) -> up
    t = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert rna_tf32(t).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


def _qkv(B, H, KH, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, hd)).astype(np.float32),
            rng.standard_normal((B, KH, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, KH, Sk, hd)).astype(np.float32))


def _ref_attention(q, k, v, causal, window):
    return np.asarray(ref.flash_attention_ref(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window))


def _dense_attention(q, k, v, mm):
    """Causal softmax attention with both products through ``mm``."""
    hd, S = q.shape[-1], q.shape[2]
    s = mm(q, k.transpose(-1, -2)) / np.sqrt(hd)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                      float("-inf"))
    return mm(torch.softmax(s, dim=-1), v)


def test_one_tf32_product_misses_and_three_meet_at_head_dim_112():
    q, k, v = _qkv(1, 2, 2, 256, 256, 112, seed=112)
    want = _ref_attention(q, k, v, True, None)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    err1 = np.abs(_dense_attention(tq, tk, tv, mm1).numpy() - want).max()
    err3 = np.abs(_dense_attention(tq, tk, tv, mm3).numpy() - want).max()
    assert err1 > ATTN_TOL > err3, (err1, err3)


# -- the attention kernel's tile walk ---------------------------------------

BQ, BK, WARP_ROWS = 128, 64, 16


def _pv_fragment_keys():
    """Which key of an 8-key group feeds A column c of P·V, and which
    key row of V feeds B row c, from the lanes' registers as the kernel
    assigns them: a0..a3 = c0, c2, c1, c3 of the score accumulator, and
    b0, b1 = V rows 2t, 2t + 1."""
    a_key, b_key = [None] * 8, [None] * 8
    for lane in range(32):
        g, t = divmod(lane, 4)
        acc = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]
        frag = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
        for (row, col), e in zip(frag, (0, 2, 1, 3)):
            src_row, key = acc[e]
            assert src_row == row            # a lane keeps its rows
            assert a_key[col] in (None, key)
            a_key[col] = key
        for k_row, key in ((t, 2 * t), (t + 4, 2 * t + 1)):
            assert b_key[k_row] in (None, key)
            b_key[k_row] = key
    return a_key, b_key


def _tile_walk(q, k, v, causal, window, keys=None):
    """The kernel's walk for every (b, h) at once; q (B,H,Sq,hd), k/v
    already expanded to H heads. ``keys``: (a_key, b_key), default the
    kernel's register mapping."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    scale_log2 = LOG2E / np.sqrt(hd)
    a_key, b_key = keys or _pv_fragment_keys()
    out = torch.zeros_like(q)
    for q0 in range(0, Sq, BQ):
        last_key = min(Sk - 1, q0 + BQ - 1) if causal else Sk - 1
        first_key = max(q0 - (window - 1), 0) if window else 0
        tiles = range(first_key // BK, last_key // BK + 1) \
            if first_key <= last_key else range(0)
        for r0 in range(q0, min(q0 + BQ, Sq), WARP_ROWS):
            rows = torch.arange(r0, r0 + WARP_ROWS)
            qw = q[:, :, r0:r0 + WARP_ROWS]
            if qw.shape[2] < WARP_ROWS:               # rows past Sq: zero
                qw = torch.nn.functional.pad(
                    qw, (0, 0, 0, WARP_ROWS - qw.shape[2]))
            m = torch.full((B, H, WARP_ROWS), -1e30)
            l = torch.zeros(B, H, WARP_ROWS)
            o = torch.zeros(B, H, WARP_ROWS, hd)
            o_lo = torch.zeros(B, H, WARP_ROWS, hd)     # O's small terms
            for kt in tiles:
                k0 = kt * BK
                if (causal and k0 > r0 + 15) or \
                        (window and k0 + BK - 1 <= r0 - window):
                    continue                     # the warp skips the tile
                full = ((not causal or k0 + BK - 1 <= r0)
                        and (not window or k0 > r0 + 15 - window)
                        and k0 + BK <= Sk)
                kk = torch.nn.functional.pad(k[:, :, k0:k0 + BK],
                                             (0, 0, 0, max(0, k0 + BK - Sk)))
                vv = torch.nn.functional.pad(v[:, :, k0:k0 + BK],
                                             (0, 0, 0, max(0, k0 + BK - Sk)))
                big, small = mm3_sep(qw, kk.transpose(-1, -2))
                s = (big + small) * scale_log2
                if not full:
                    j = torch.arange(k0, k0 + BK)[None, :]
                    ok = j < Sk
                    if causal:
                        ok = ok & (j <= rows[:, None])
                    if window:
                        ok = ok & (j > rows[:, None] - window)
                    s = s.masked_fill(~ok, float("-inf"))
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)
                o = o * alpha[..., None]
                o_lo = o_lo * alpha[..., None]
                for kg in range(0, BK, 8):
                    a = p[..., kg:kg + 8][..., a_key]
                    b = vv[:, :, kg:kg + 8][:, :, b_key]
                    big, small = mm3_sep(a, b)
                    o = o + big
                    o_lo = o_lo + small
                m = m_new
            o = (o + o_lo) / torch.clamp(l, min=1e-30)[..., None]
            n = min(WARP_ROWS, Sq - r0)
            out[:, :, r0:r0 + n] = o[:, :, :n]
    return out


def test_pv_relabelling_pairs_each_a_column_with_its_v_row():
    a_key, b_key = _pv_fragment_keys()
    assert a_key == b_key == [0, 2, 4, 6, 1, 3, 5, 7]


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (256, 256, True, None),     # zamba2's case: causal, full tiles inside
    (200, 200, True, 70),       # window edges inside tiles
    (100, 77, False, None),     # ragged ends
    (200, 64, True, 16),        # rows that see no key: 0
])
def test_tile_walk_matches_reference(Sq, Sk, causal, window):
    q, k, v = _qkv(1, 2, 2, Sq, Sk, 112, seed=Sq + Sk)
    got = _tile_walk(*map(torch.from_numpy, (q, k, v)), causal, window)
    want = _ref_attention(q, k, v, causal, window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL,
                               rtol=ATTN_TOL)


def test_a_wrong_relabelling_shows():
    """P fed with the natural key order while V keeps the relabelled rows:
    the walk no longer computes attention."""
    q, k, v = _qkv(1, 1, 1, 64, 64, 16, seed=1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = _ref_attention(q, k, v, True, None)
    good = _tile_walk(tq, tk, tv, True, None)
    bad = _tile_walk(tq, tk, tv, True, None,
                     keys=(list(range(8)), _pv_fragment_keys()[1]))
    assert np.abs(good.numpy() - want).max() <= ATTN_TOL
    assert np.abs(bad.numpy() - want).max() > 1e-2


# -- the SSD scan's chunk-parallel decomposition ----------------------------


def _chunk_parallel_scan(xdt, a, Bm, Cm, l):
    """The four CUDA kernels of csrc/ssd_scan.cu, in plain torch, every
    product by emulated 3xTF32."""
    B, H, S, P = xdt.shape
    N, nc = Bm.shape[-1], S // l
    x = xdt.reshape(B, H, nc, l, P)
    Bc, Cc = Bm.reshape(B, nc, l, N), Cm.reshape(B, nc, l, N)
    cs = torch.cumsum(a.reshape(B, H, nc, l), dim=-1)
    lower = torch.ones(l, l, dtype=torch.bool).tril()
    # 1. C·Bᵀ once per (b, chunk)
    cb = mm3(Cc, Bc.transpose(-1, -2))                       # (B,nc,l,l)
    # 2. each chunk's own state and exp(cs_last)
    w = torch.exp(cs[..., -1:] - cs)
    own = mm3((x * w[..., None]).transpose(-1, -2), Bc[:, None])
    decay = torch.exp(cs[..., -1])                           # (B,H,nc)
    # 3. the states entering each chunk, sequentially, in float32
    states, run = [], torch.zeros(B, H, P, N)
    for c in range(nc):
        states.append(run)
        run = decay[..., c, None, None] * run + own[:, :, c]
    entering = torch.stack(states, dim=2)                    # (B,H,nc,P,N)
    # 4. outputs: L only on j <= i
    diff = (cs[..., :, None] - cs[..., None, :]).masked_fill(~lower, 0.0)
    L = torch.where(lower, torch.exp(diff), torch.zeros(()))
    y = torch.exp(cs)[..., None] * mm3(Cc[:, None],
                                       entering.transpose(-1, -2))
    y = y + mm3(cb[:, None] * L, x)
    return y.reshape(B, H, S, P)


@pytest.mark.parametrize("B,H,S,P,N,l", [
    (2, 4, 512, 64, 64, 128),    # zamba2's head: P = N = 64, l = 128
    (1, 2, 256, 64, 128, 128),   # mamba2-1.3b's N = 128
    (1, 3, 96, 32, 16, 32),
])
def test_chunk_parallel_scan_matches_reference(B, H, S, P, N, l):
    rng = np.random.default_rng(S + N)
    xdt = rng.standard_normal((B, H, S, P)).astype(np.float32) * 0.3
    a = -np.abs(rng.standard_normal((B, H, S))).astype(np.float32) * 0.3
    Bm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.3
    Cm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.3
    got = _chunk_parallel_scan(*map(torch.from_numpy, (xdt, a, Bm, Cm)), l)
    want = np.asarray(ref.ssd_scan_ref(*map(jnp.asarray, (xdt, a, Bm, Cm))))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy() / scale, want / scale,
                               atol=SSD_TOL)
