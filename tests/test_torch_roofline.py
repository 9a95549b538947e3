"""The port's analytic roofline (``launch/roofline.py``) against the
reference's, and its properties under the H100's constants.

At ``param_bytes=2`` (the reference's bfloat16) every count equals the
reference's within rtol 1e-12 for the 10 archs x 4 input shapes x both
production meshes; the time terms are the counts over the port's
constants. The reference's property tests are ported; the one that
depends on the constants ("decode is memory-bound") is re-derived here:
at 67 TFLOP/s over 3.35 TB/s a step is compute-bound only above 20
FLOP a byte. A decode step of B = 128 tokens on 256 chips does 2·N·B /
256 = N FLOP a chip while each chip reads its 1/16 of the N parameters,
N/4 bytes in float32: 4 FLOP a byte (8 in bfloat16), so decode stays
memory-bound on the H100 too.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs.base import INPUT_SHAPES as RSH
from repro.configs.registry import get_config as rget
from repro.launch import roofline as RR
from repro.launch import steps as RSt
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as St
from repro_torch.launch.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                         analytic_roofline, dominant_term,
                                         params_total_active)
from repro_torch.models import transformer as T
from repro_torch.models.module import param_count

MESH = (16, 16)
COUNTS = ("flops_useful", "flops_hw", "bytes_hbm_dev", "bytes_coll_dev",
          "params_total", "params_active")


def test_constants_are_the_h100s():
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (67e12, 3.35e12, 450e9)


@pytest.mark.parametrize("mesh", [(16, 16), (2, 16, 16)],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", all_archs())
def test_counts_match_reference_at_bf16(arch, shape, mesh):
    got = analytic_roofline(St.config_for_shape(get_config(arch),
                                                INPUT_SHAPES[shape]),
                            INPUT_SHAPES[shape], mesh, param_bytes=2)
    want = RR.analytic_roofline(RSt.config_for_shape(rget(arch), RSH[shape]),
                                RSH[shape], mesh)
    for k in COUNTS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0,
                                   err_msg=k)
    chips = int(np.prod(mesh))
    assert got["compute_s"] == got["flops_hw"] / (chips * PEAK_FLOPS)
    assert got["compute_useful_s"] == got["flops_useful"] / (chips
                                                              * PEAK_FLOPS)
    assert got["memory_s"] == got["bytes_hbm_dev"] / HBM_BW
    assert got["collective_s"] == got["bytes_coll_dev"] / LINK_BW
    assert got["mfu_bound"] == want["mfu_bound"]


@pytest.mark.parametrize("arch", all_archs())
def test_param_bytes_scales_only_the_stored_widths(arch):
    """float32 storage doubles the parameter, activation and cache bytes
    and leaves the flops alone."""
    for shape in INPUT_SHAPES.values():
        cfg = St.config_for_shape(get_config(arch), shape)
        r2 = analytic_roofline(cfg, shape, MESH, param_bytes=2)
        r4 = analytic_roofline(cfg, shape, MESH)
        assert r4["flops_hw"] == r2["flops_hw"]
        assert r4["bytes_hbm_dev"] > r2["bytes_hbm_dev"]
        assert r4["bytes_coll_dev"] >= r2["bytes_coll_dev"]
        assert r4["bytes_hbm_dev"] <= 2 * r2["bytes_hbm_dev"]


@pytest.mark.parametrize("arch", all_archs())
def test_analytic_param_count_matches_spec_tree(arch):
    cfg = get_config(arch)
    total, active = params_total_active(cfg)
    assert total == pytest.approx(param_count(T.specs(cfg)), rel=0.02)
    assert active <= total + 1
    assert DR.count_params(cfg)[0] == param_count(T.specs(cfg))


@pytest.mark.parametrize("arch", all_archs())
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_roofline_terms_positive_and_finite(arch, shape):
    cfg = St.config_for_shape(get_config(arch), INPUT_SHAPES[shape])
    r = analytic_roofline(cfg, INPUT_SHAPES[shape], MESH)
    for k in ("compute_s", "memory_s", "collective_s", "flops_useful",
              "flops_hw", "bytes_hbm_dev", "bytes_coll_dev"):
        assert np.isfinite(r[k]) and r[k] >= 0, (k, r[k])
    assert 0 < r["mfu_bound"] <= 1.0 + 1e-9
    assert dominant_term(r) in ("compute_s", "memory_s", "collective_s")


def test_decode_is_memory_bound_on_the_h100():
    """Re-derived for the H100 (see the module docstring): every decode
    combo's memory term exceeds its compute term, at float32 and at
    bfloat16 storage."""
    for arch in all_archs():
        for shape in ("decode_32k", "long_500k"):
            cfg = St.config_for_shape(get_config(arch), INPUT_SHAPES[shape])
            for b in (4, 2):
                r = analytic_roofline(cfg, INPUT_SHAPES[shape], MESH,
                                      param_bytes=b)
                assert dominant_term(r) == "memory_s", (arch, shape, b)


def test_train_and_prefill_are_compute_bound_on_the_h100():
    """At 20 FLOP a byte the GEMMs of a 4096-token train step and of a
    32k prefill outweigh their bytes on every arch."""
    for arch in all_archs():
        for shape in ("train_4k", "prefill_32k"):
            cfg = St.config_for_shape(get_config(arch), INPUT_SHAPES[shape])
            r = analytic_roofline(cfg, INPUT_SHAPES[shape], MESH)
            assert dominant_term(r) == "compute_s", (arch, shape)


def test_train_flops_3x_prefill_plus_remat():
    cfg = St.config_for_shape(get_config("phi4-mini-3.8b"),
                              INPUT_SHAPES["train_4k"])
    r_train = analytic_roofline(cfg, INPUT_SHAPES["train_4k"], MESH)
    pf = dataclasses.replace(INPUT_SHAPES["train_4k"], kind="prefill")
    r_fwd = analytic_roofline(cfg.with_overrides(remat="none"), pf, MESH)
    assert 3.9 <= r_train["flops_hw"] / r_fwd["flops_hw"] <= 4.1


def test_swa_caps_decode_context():
    cfg = get_config("mixtral-8x7b")
    r = analytic_roofline(cfg, INPUT_SHAPES["long_500k"], MESH)
    big = St.config_for_shape(cfg.with_overrides(sliding_window=None),
                              INPUT_SHAPES["long_500k"])
    r_big = analytic_roofline(big, INPUT_SHAPES["long_500k"], MESH)
    assert r["flops_hw"] <= r_big["flops_hw"] + 1


def test_ssm_decode_state_constant_in_context():
    cfg = get_config("mamba2-1.3b")
    r32 = analytic_roofline(cfg, INPUT_SHAPES["decode_32k"], MESH)
    r500 = analytic_roofline(cfg, INPUT_SHAPES["long_500k"], MESH)
    per_32 = r32["flops_hw"] / INPUT_SHAPES["decode_32k"].global_batch
    per_500 = r500["flops_hw"] / INPUT_SHAPES["long_500k"].global_batch
    assert per_500 == pytest.approx(per_32, rel=0.01)


def test_config_for_shape_rules():
    cfg = St.config_for_shape(get_config("qwen3-14b"),
                              INPUT_SHAPES["long_500k"])
    assert cfg.sliding_window == 4096
    for arch in ("mamba2-1.3b", "zamba2-7b"):
        c = St.config_for_shape(get_config(arch), INPUT_SHAPES["long_500k"])
        assert not c.sliding_window
    c = St.config_for_shape(get_config("mixtral-8x7b"),
                            INPUT_SHAPES["long_500k"])
    assert c.sliding_window == 4096
    c = St.config_for_shape(get_config("qwen3-14b"), INPUT_SHAPES["train_4k"])
    assert c.remat == "full"


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_encdec_useful_flops_charge_the_encoder_its_frames():
    """``chip_smoke.py`` (u3) reads whisper's mfu with the encoder at its
    frames: equal to the roofline's decoder-token formula when the
    frames are the tokens, and within 1% of a count over the port's
    ``T.specs`` (biases and norms, which the roofline leaves out)."""
    from repro_torch.launch import roofline as R
    from repro_torch.models.module import leaves

    cs = _chip_smoke()
    cfg = get_config("whisper-large-v3")
    B, S = 2, cfg.max_positions
    same = dataclasses.replace(cfg, encoder_seq=S)
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=S,
                                global_batch=B)
    assert cs._encdec_useful_flops(R, same, B, S) == \
        analytic_roofline(same, shape, (1, 1))["flops_useful"]
    frames = rest = 0
    for path, s in leaves(T.specs(cfg)):
        n = int(np.prod(s.shape))
        if path.startswith("['enc']") or any(
                f"['xattn']['{w}']" in path for w in ("wk", "wv")):
            frames += n
        else:
            rest += n
    want = 2.0 * (frames * B * cfg.encoder_seq + rest * B * S)
    got = cs._encdec_useful_flops(R, cfg, B, S)
    assert got == pytest.approx(want, rel=1e-2)
    assert got > 2 * analytic_roofline(cfg, shape, (1, 1))["flops_useful"]
