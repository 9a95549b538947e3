"""The SSD-scan kernel's plain PyTorch version against the reference's
sequential oracle (``ref.ssd_scan_ref``), its Pallas kernel in
interpret mode, and the model's own chunked paths (``ssm.ssd_chunked``
and ``ssd_chunked_streaming``), over the reference's grid, at the
reference's tolerance of 1e-4 scaled by max|y|. Plus the state carried
across many chunks, the ragged-S error, a whole Mamba2 block against
the reference's ``ssm_apply``, and the wrapper's CPU dispatch and
checks. bfloat16 xdt, Bm and Cm (rounded from the same float32 numbers
on both sides) at the reference's bfloat16 tolerance of 4e-2 of
max|y|, and mamba2-1.3b's widths (N = 128 at l = 128). The CUDA
kernel itself is held to the plain version in ``test_torch_gpu.py``
and ``chip_smoke.py`` phase (i)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import ssm as RS
from repro.models.module import init_params as ref_init
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as sd
from repro_torch.models import ssm as TS
from repro_torch.models.convert import lm_params_from_jax

TOL = 1e-4      # the reference's float32 tolerance, scaled by max|y|
BF16_TOL = 4e-2  # and its bfloat16 tolerance

GRID = [(1, 2, 128, 32, 16, 32), (2, 4, 256, 64, 64, 128),
        (1, 1, 64, 16, 128, 64)]


def _inputs(B, H, S, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, P)).astype(np.float32) * 0.3,
            -np.abs(rng.standard_normal((B, H, S))).astype(np.float32) * 0.3,
            rng.standard_normal((B, S, N)).astype(np.float32) * 0.3,
            rng.standard_normal((B, S, N)).astype(np.float32) * 0.3)


def _port(args, chunk):
    before = sd.launches
    out = ops.ssd(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert sd.launches == before           # a CPU tensor never launches
    assert out.dtype == torch.float32
    return out.numpy()


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.parametrize("B,H,S,P,N,chunk", GRID)
def test_plain_matches_ref_and_pallas(B, H, S, P, N, chunk):
    args = _inputs(B, H, S, P, N, seed=S + P + N)
    got = _port(args, chunk)
    jargs = [jnp.asarray(a) for a in args]
    _close(got, ref.ssd_scan_ref(*jargs))
    _close(got, pallas_ssd(*jargs, chunk=chunk, interpret=True))


@pytest.mark.parametrize("B,H,S,P,N,chunk", GRID)
def test_plain_bf16_matches_ref_and_pallas(B, H, S, P, N, chunk):
    xdt, a, Bm, Cm = _inputs(B, H, S, P, N, seed=S + P + N + 1)
    t_args, j_args = [], []
    for x in (xdt, Bm, Cm):
        t = torch.from_numpy(x).to(torch.bfloat16)
        j = jnp.asarray(x, jnp.bfloat16)
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))
        t_args.append(t)
        j_args.append(j)
    before = sd.launches
    got = ops.ssd(t_args[0], torch.from_numpy(a), t_args[1], t_args[2],
                  chunk=chunk)
    assert sd.launches == before and got.dtype == torch.float32
    ja = jnp.asarray(a)
    for want in (ref.ssd_scan_ref(j_args[0], ja, j_args[1], j_args[2]),
                 pallas_ssd(j_args[0], ja, j_args[1], j_args[2], chunk=chunk,
                            interpret=True)):
        _close(got.numpy(), want, BF16_TOL)


@pytest.mark.parametrize("B,H,S,chunk", [(1, 2, 256, 128), (2, 1, 384, 128)])
def test_plain_at_mamba2_1_3b_widths(B, H, S, chunk):
    """P = 64, N = 128 at l = 128: mamba2-1.3b's full SSD shape, short."""
    args = _inputs(B, H, S, 64, 128, seed=S + H)
    got = _port(args, chunk)
    jargs = [jnp.asarray(a) for a in args]
    _close(got, ref.ssd_scan_ref(*jargs))
    _close(got, pallas_ssd(*jargs, chunk=chunk, interpret=True))


@pytest.mark.parametrize("B,H,S,P,N,chunk", GRID + [(2, 3, 64, 32, 16, 8)])
@pytest.mark.parametrize("streaming", [False, True])
def test_plain_matches_model_chunked_paths(B, H, S, P, N, chunk, streaming):
    xdt, a, Bm, Cm = _inputs(B, H, S, P, N, seed=7 * S + chunk)
    got = _port((xdt, a, Bm, Cm), chunk)
    fn = RS.ssd_chunked_streaming if streaming else RS.ssd_chunked
    want = fn(jnp.asarray(xdt.transpose(0, 2, 1, 3)),
              jnp.asarray(a.transpose(0, 2, 1)), jnp.asarray(Bm),
              jnp.asarray(Cm), chunk)
    _close(got, np.asarray(want).transpose(0, 2, 1, 3))


def test_state_carry_across_many_chunks():
    """An early impulse must reach the last output (tests/test_kernels.py
    state-carry case)."""
    B, H, S, P, N = 1, 1, 256, 8, 8
    xdt = np.zeros((B, H, S, P), np.float32)
    xdt[0, 0, 3] = 1.0
    a = np.full((B, H, S), -0.01, np.float32)
    Bm = np.full((B, S, N), 0.5, np.float32)
    Cm = np.full((B, S, N), 0.5, np.float32)
    got = _port((xdt, a, Bm, Cm), 64)
    want = ref.ssd_scan_ref(*map(jnp.asarray, (xdt, a, Bm, Cm)))
    assert np.abs(got[0, 0, -1]).max() > 1e-3
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_chunk_longer_than_sequence_is_the_sequence():
    args = _inputs(1, 2, 48, 16, 8, seed=3)
    got = _port(args, 128)
    _close(got, ref.ssd_scan_ref(*map(jnp.asarray, args)))


@pytest.mark.parametrize("S,chunk", [(130, 128), (96, 64), (10, 4)])
def test_ragged_sequence_raises(S, chunk):
    args = [torch.from_numpy(x) for x in _inputs(1, 1, S, 8, 8, seed=0)]
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd(*args, chunk=chunk)


@pytest.mark.parametrize("which,bad,err", [
    (0, lambda t: t.to(torch.float16), TypeError),
    (0, lambda t: t.to(torch.float64), TypeError),
    (0, lambda t: t.to(torch.bfloat16), TypeError),   # Bm, Cm stay float32
    (1, lambda t: t.to(torch.bfloat16), TypeError),   # a is float32 only
    (1, lambda t: t[..., :-1], ValueError),
    (2, lambda t: t[:, :, :-1], ValueError),
    (3, lambda t: t.to("meta"), ValueError),
])
def test_wrapper_rejects_bad_arguments(which, bad, err):
    args = [torch.from_numpy(x) for x in _inputs(1, 2, 16, 8, 8, seed=1)]
    args[which] = bad(args[which])
    with pytest.raises(err):
        ops.ssd(*args, chunk=8)


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-1.3b"])
def test_ssm_block_matches_reference(arch):
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = ref_init(RS.ssm_specs(rcfg), jax.random.PRNGKey(3), jnp.float32)
    # give the zero- and one-initialised leaves values that matter
    rng = np.random.default_rng(4)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    for k in ("conv_b", "A_log", "dt_bias", "D_skip"):
        jp[k] = (rng.standard_normal(jp[k].shape) * 0.5).astype(np.float32)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want = RS.ssm_apply(jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in jp.items()}, rcfg)
    got = TS.ssm_apply(torch.from_numpy(x), lm_params_from_jax(jp), cfg)
    _close(got.numpy(), want)


def _sequential_float64(xdt, a, Bm, Cm):
    """h_t = exp(a_t)·h_{t-1} + B_t ⊗ x_t, y_t = C_t·h_t in float64."""
    x, a, Bm, Cm = (np.asarray(v, np.float64) for v in (xdt, a, Bm, Cm))
    B, H, S, P = x.shape
    h = np.zeros((B, H, P, Bm.shape[-1]))
    y = np.empty((B, H, S, P))
    for t in range(S):
        h = h * np.exp(a[:, :, t])[:, :, None, None] \
            + x[:, :, t, :, None] * Bm[:, t][:, None, None, :]
        y[:, :, t] = np.einsum("bhpn,bn->bhp", h, Cm[:, t])
    return y


def test_plain_f32_no_further_from_float64_than_reference_kernel():
    """One zamba2-7b layer's SSD shape (H 112, P 64, N 64, S 256, chunk
    128): the port's chunked float32 scan lies no further from a float64
    sequential scan than the reference's own chunked Pallas kernel
    (about 5.7e-7 against 1.5e-6 of max|y|), so the f32 prefill's
    distance from float64 is the chunked algorithm's, not the port's."""
    args = _inputs(1, 112, 256, 64, 64, seed=0)
    want = _sequential_float64(*args)
    scale = float(np.abs(want).max())
    port = _port(args, 128)
    pallas = np.asarray(pallas_ssd(*(jnp.asarray(v) for v in args),
                                   chunk=128, interpret=True))
    port_err = float(np.abs(port - want).max()) / scale
    pallas_err = float(np.abs(pallas - want).max()) / scale
    assert port_err <= pallas_err, (port_err, pallas_err)
