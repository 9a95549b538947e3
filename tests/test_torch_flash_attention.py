"""The flash-attention kernel's plain PyTorch version against the
reference's oracle (``ref.flash_attention_ref``) and its Pallas kernel
in interpret mode, over the reference's own grid (shapes, GQA and MQA,
causal or not, sliding windows, block shapes), at the reference's
float32 tolerance of 2e-5. Plus the explicit head map against the
reference model's ``full_attention`` with padded heads, fully masked
rows, and the wrapper's CPU dispatch and argument checks. bfloat16
inputs (rounded from the same float32 numbers on both sides) against
the Pallas kernel and ``ref`` at the reference's bfloat16 tolerance of
2e-2. The CUDA
kernel itself is held to the plain version in ``test_torch_gpu.py``
and ``chip_smoke.py`` phase (i)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as RL
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

TOL = 2e-5      # the reference's float32 tolerance (tests/test_kernels.py)
BF16_TOL = 2e-2  # and its bfloat16 tolerance


def _qkv(B, H, KH, Sq, hd, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.standard_normal((B, H, Sq, hd)).astype(np.float32),
            rng.standard_normal((B, KH, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, KH, Sk, hd)).astype(np.float32))


def _port(q, k, v, **kw):
    before = fa.launches
    out = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert fa.launches == before           # a CPU tensor never launches
    return out.numpy()


@pytest.mark.parametrize("B,H,KH,S,hd", [
    (1, 2, 2, 128, 64),
    (2, 4, 2, 256, 64),     # GQA 2:1
    (1, 8, 1, 256, 32),     # MQA
    (2, 2, 2, 384, 16),     # 3 blocks, odd head_dim
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_ref_and_pallas(B, H, KH, S, hd, causal):
    q, k, v = _qkv(B, H, KH, S, hd, seed=B * 100 + H * 10 + hd)
    got = _port(q, k, v, causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = ref.flash_attention_ref(jq, jk, jv, causal=causal)
    pallas = pallas_flash(jq, jk, jv, causal=causal, interpret=True)
    for w in (want, pallas):
        np.testing.assert_allclose(got, np.asarray(w), atol=TOL, rtol=TOL)


def bf16_pair(x):
    """float32 numpy -> (torch bfloat16, jax bfloat16), each rounded on
    its own side; their bits must agree."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    j = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(j).view(np.int16))
    return t, j


@pytest.mark.parametrize("B,H,KH,S,hd", [
    (1, 2, 2, 128, 64),
    (2, 4, 2, 256, 64),     # GQA 2:1
    (1, 8, 1, 256, 32),     # MQA
    (2, 2, 2, 384, 16),     # 3 blocks, odd head_dim
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_matches_ref_and_pallas(B, H, KH, S, hd, causal):
    pairs = [bf16_pair(x) for x in _qkv(B, H, KH, S, hd, seed=B + H + hd)]
    (tq, jq), (tk, jk), (tv, jv) = pairs
    before = fa.launches
    got = ops.attention(tq, tk, tv, causal=causal)
    assert fa.launches == before and got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = ref.flash_attention_ref(jq, jk, jv, causal=causal)
    pallas = pallas_flash(jq, jk, jv, causal=causal, interpret=True)
    for w in (want, pallas):
        np.testing.assert_allclose(got, np.asarray(w, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("window", [32, 128, 200])
def test_plain_sliding_window(window):
    q, k, v = _qkv(1, 2, 2, 256, 64, seed=window)
    got = _port(q, k, v, causal=True, window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = ref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    pallas = pallas_flash(jq, jk, jv, causal=True, window=window,
                          interpret=True, bq=64, bk=64)
    for w in (want, pallas):
        np.testing.assert_allclose(got, np.asarray(w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bq,bk", [(64, 128), (128, 64), (256, 256)])
def test_plain_matches_pallas_block_shapes(bq, bk):
    q, k, v = _qkv(1, 1, 1, 512, 64, seed=bq + bk)
    got = _port(q, k, v, causal=True)
    pallas = pallas_flash(*map(jnp.asarray, (q, k, v)), causal=True, bq=bq,
                          bk=bk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (100, 77, True, None),      # neither a multiple of a tile
    (77, 100, False, None),
    (200, 64, True, 16),        # rows 79.. see no key: 0, not NaN
    (130, 50, False, 8),
])
def test_plain_ragged_and_fully_masked_rows(Sq, Sk, causal, window):
    q, k, v = _qkv(1, 4, 2, Sq, 112, seed=Sq + Sk, Sk=Sk)
    got = _port(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    assert np.isfinite(got).all()
    if window is not None:
        dead = np.arange(Sq) >= Sk + window - 1
        assert dead.any()
        assert (got[:, :, dead] == 0).all()


@pytest.mark.parametrize("H,KH,tp_pad,window", [
    (6, 2, 8, None),            # Hp = 8 > H: padded heads read KV head 0
    (5, 5, 8, 8),
    (4, 1, 1, None),
])
def test_kv_map_matches_reference_full_attention(H, KH, tp_pad, window):
    from repro_torch.configs.registry import get_config

    cfg = get_config("qwen3-14b", smoke=True).with_overrides(
        num_heads=H, num_kv_heads=KH, tp_pad=tp_pad)
    Hp, hd, S = cfg.num_heads_padded, cfg.head_dim, 48
    rng = np.random.default_rng(H * 10 + KH)
    q = rng.standard_normal((2, S, Hp, hd)).astype(np.float32)
    k = rng.standard_normal((2, S, KH, hd)).astype(np.float32)
    v = rng.standard_normal((2, S, KH, hd)).astype(np.float32)
    kv_map = RL.kv_head_map(cfg)
    want = RL.full_attention(*map(jnp.asarray, (q, k, v)),
                             jnp.asarray(kv_map), causal=True, window=window)
    got = _port(q.transpose(0, 2, 1, 3).copy(), k.transpose(0, 2, 1, 3).copy(),
                v.transpose(0, 2, 1, 3).copy(), causal=True, window=window,
                kv_map=kv_map)
    np.testing.assert_allclose(got.transpose(0, 2, 1, 3), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_default_map_is_the_pallas_map():
    np.testing.assert_array_equal(fa.default_kv_map(8, 2).numpy(),
                                  np.arange(8) // 4)
    with pytest.raises(ValueError, match="multiple"):
        ops.attention(torch.zeros(1, 3, 4, 8), torch.zeros(1, 2, 4, 8),
                      torch.zeros(1, 2, 4, 8))


@pytest.mark.parametrize("bad,err,match", [
    (dict(dtype=torch.float16), TypeError, "float32"),
    (dict(dtype=torch.float64), TypeError, "bfloat16"),
    (dict(k_dtype=torch.bfloat16), TypeError, "all torch.bfloat16"),
    (dict(hd=129), ValueError, "head_dim"),
    (dict(kv_map=[0, 2]), ValueError, r"\[0, 2\)"),
    (dict(kv_map=[0]), ValueError, "kv_map"),
    (dict(kv_map=[0.0, 1.0]), TypeError, "integers"),
    (dict(window=0), ValueError, "window"),
    (dict(k_shape=(1, 2, 8, 16)), ValueError, "k and v"),
    (dict(device="meta"), ValueError, "no kernel"),
])
def test_wrapper_rejects_bad_arguments(bad, err, match):
    hd = bad.get("hd", 8)
    dt = bad.get("dtype", torch.float32)
    dev = bad.get("device", "cpu")
    q = torch.zeros(1, 2, 8, hd, dtype=dt, device=dev)
    k = torch.zeros(bad.get("k_shape", (1, 2, 8, hd)),
                    dtype=bad.get("k_dtype", dt), device=dev)
    with pytest.raises(err, match=match):
        ops.attention(q, k, torch.zeros_like(k), causal=True,
                      window=bad.get("window"), kv_map=bad.get("kv_map"))
