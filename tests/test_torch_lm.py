"""The port's model zoo and serving path held to the reference.

* configs: every field of every architecture, full and smoke, equals
  the reference's; so does every spec tree and parameter count;
* ``lm_params_from_jax`` carries the reference's parameters across
  unchanged;
* with those parameters, the port's ``forward`` (prefill through the
  kernels' plain versions), ``decode_step`` over 8 tokens and
  ``greedy_generate`` agree with the reference's for the smoke configs
  of zamba2-7b (hybrid), mamba2-1.3b (ssm), qwen3-14b and
  phi4-mini-3.8b (dense), olmoe-1b-7b and mixtral-8x7b (MoE),
  whisper-large-v3 (enc-dec, the decode's cross K/V from ``encode``)
  and phi-3-vision-4.2b (VLM, seeded patch embeddings). Logits within
  1e-4 of the largest |logit| (both float32 on the CPU; the tolerance
  covers summation order in the products and the scans), the MoE aux
  loss within 1e-6; greedy tokens exactly;
* the port's own decode matches its forward (the reference's contract,
  ``tests/test_models_smoke.py``, atol/rtol 2e-3, MoE at capacity
  factor 8 so that no token drops), also with padded heads, a
  sliding-window ring cache, learned positions (whisper) and the VLM's
  text-only decoder;
* every registry arch runs forward, its cache and a decode step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.models import module as ref_module
from repro.models import transformer as RT
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as sd
from repro_torch.launch import serve, steps
from repro_torch.launch import train as ttrain
from repro_torch.models import module
from repro_torch.models import transformer as T
from repro_torch.models.convert import lm_params_from_jax

ARCHS = registry.all_archs()
SERVED = ["zamba2-7b", "mamba2-1.3b", "qwen3-14b", "phi4-mini-3.8b",
          "olmoe-1b-7b", "mixtral-8x7b", "whisper-large-v3",
          "phi-3-vision-4.2b"]
# the families the model zoo's last slice ported
LATE = ["mixtral-8x7b", "olmoe-1b-7b", "whisper-large-v3",
        "phi-3-vision-4.2b"]
REL_TOL = 1e-4
AUX_TOL = 1e-6


def _both(arch, **overrides):
    rc = ref_registry.get_config(arch, smoke=True)
    tc = registry.get_config(arch, smoke=True)
    if overrides:
        rc, tc = rc.with_overrides(**overrides), tc.with_overrides(**overrides)
    jp = ref_module.init_params(RT.specs(rc), jax.random.PRNGKey(0),
                                jnp.float32)
    return rc, tc, jp, lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                 jp))


def _close(got, want, rel=REL_TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _inputs(cfg, B, S, seed):
    """Seeded tokens, with seeded ``frames`` (enc-dec) or ``patch_embeds``
    (VLM), as numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.vision_patches:
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, smoke):
    want = dataclasses.asdict(ref_registry.get_config(arch, smoke=smoke))
    got = dataclasses.asdict(registry.get_config(arch, smoke=smoke))
    assert got == want


def _ref_leaves(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, ref_module.Spec))
    return [(jax.tree_util.keystr(p), s.shape, s.axes, s.init, s.scale,
             None if s.dtype is None else np.dtype(s.dtype).name)
            for p, s in flat]


def _port_leaves(specs):
    return [(p, s.shape, s.axes, s.init, s.scale,
             None if s.dtype is None else str(s.dtype).split(".")[-1])
            for p, s in module.leaves(specs)]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_and_param_count_equal_reference(arch, smoke):
    rc = ref_registry.get_config(arch, smoke=smoke)
    tc = registry.get_config(arch, smoke=smoke)
    assert _port_leaves(T.specs(tc)) == _ref_leaves(RT.specs(rc))
    assert module.param_count(T.specs(tc)) == \
        ref_module.param_count(RT.specs(rc))


def test_zamba2_7b_full_size():
    cfg = registry.get_config("zamba2-7b")
    assert module.param_count(T.specs(cfg)) == 6_751_078_992
    assert (cfg.ssm_heads, cfg.ssm_inner, cfg.head_dim) == (112, 7168, 112)
    assert T.hybrid_shape(cfg) == (9, 9)


@pytest.mark.parametrize("arch", ["zamba2-7b", "qwen3-14b"])
def test_cache_specs_equal_reference(arch):
    rc = ref_registry.get_config(arch, smoke=True)
    tc = registry.get_config(arch, smoke=True)
    assert _port_leaves(T.init_cache_specs(tc, 3, 40)) == \
        _ref_leaves(RT.init_cache_specs(rc, 3, 40))


def test_lm_params_from_jax_round_trip():
    rc = ref_registry.get_config("zamba2-7b", smoke=True)
    jp = ref_module.init_params(RT.specs(rc), jax.random.PRNGKey(1),
                                jnp.float32)
    jc = ref_module.init_params(RT.init_cache_specs(rc, 2, 8),
                                jax.random.PRNGKey(1), jnp.float32)
    for tree in (jp, jc):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        port = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        for path, leaf in flat:
            got = port
            for key in path:
                got = got[key.key]
            want = np.asarray(leaf)
            assert got.shape == want.shape
            assert got.dtype == (torch.float32 if want.dtype.kind == "f"
                                 else torch.int32)
            np.testing.assert_array_equal(got.numpy(), want)


def _same_tree(port, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        got = port
        for key in path:
            got = got[key.key]
        want = np.asarray(leaf)
        assert got.shape == want.shape
        assert got.dtype == (torch.float32 if want.dtype.kind == "f"
                             else torch.int32)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,overrides", [
    ("olmoe-1b-7b", {"moe_pad_experts": 8}), ("mixtral-8x7b", {}),
    ("whisper-large-v3", {}), ("phi-3-vision-4.2b", {})])
def test_lm_params_from_jax_carries_moe_encdec_vlm_trees(arch, overrides):
    """Parameters (padded experts too), caches (cross K/V) and an AdamW
    state of the MoE, enc-dec and VLM trees come across leaf for leaf."""
    from repro.optim import optimizers as ropt
    from repro_torch.models.convert import opt_state_from_jax

    rc = ref_registry.get_config(arch, smoke=True)
    if overrides:
        rc = rc.with_overrides(**overrides)
    jp = ref_module.init_params(RT.specs(rc), jax.random.PRNGKey(2),
                                jnp.float32)
    jc = ref_module.init_params(RT.init_cache_specs(rc, 2, 8),
                                jax.random.PRNGKey(2), jnp.float32)
    for tree in (jp, jc):
        _same_tree(lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             tree)), tree)
    state = ropt.adamw(1e-3).init(jp)
    state = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.5, state)
    ported = opt_state_from_jax(state)
    for k in ("m", "v"):
        _same_tree(ported[k], state[k])
    assert int(ported["count"]) == int(state["count"])
    if overrides:
        assert ported["m"]["blocks"]["moe"]["w_gate"].shape[1] == 8


def test_init_params_laws_and_seeding():
    cfg = registry.get_config("zamba2-7b", smoke=True)
    a = module.init_params(T.specs(cfg), seed=5)
    b = module.init_params(T.specs(cfg), seed=5)
    c = module.init_params(T.specs(cfg), seed=6)
    w = a["blocks"]["ssm"]["w_x"]                       # (layers, D, DI)
    assert torch.equal(w, b["blocks"]["ssm"]["w_x"])
    assert not torch.equal(w, c["blocks"]["ssm"]["w_x"])
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1) < 0.02
    assert abs(float(a["embed"]["tok"].std()) - 0.02) < 1e-3
    assert abs(float(a["blocks"]["ssm"]["conv_w"].std()) - 0.02) < 2e-3
    assert torch.equal(a["blocks"]["ssm"]["D_skip"],
                       torch.ones_like(a["blocks"]["ssm"]["D_skip"]))
    assert not a["blocks"]["ssm"]["A_log"].any()
    cache = module.init_params(T.init_cache_specs(cfg, 2, 8))
    assert cache["attn"]["slot_pos"].dtype == torch.int32
    assert (cache["attn"]["slot_pos"] == -1).all()
    # a leaf's values do not depend on the rest of the tree
    alone = module.init_params({"blocks": {"ssm": {"w_x": T.specs(cfg)[
        "blocks"]["ssm"]["w_x"]}}}, seed=5)
    assert torch.equal(alone["blocks"]["ssm"]["w_x"], w)


@pytest.mark.parametrize("arch", SERVED)
def test_forward_matches_reference(arch):
    rc, tc, jp, tp = _both(arch)
    b = _inputs(rc, 2, 32, seed=1)
    want, want_aux = RT.forward(jp, _j(b), rc)
    got, aux = T.forward(tp, _t(b), tc)
    assert got.shape == (2, 32, tc.vocab_padded)
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL
    assert (float(aux) > 0) == bool(tc.num_experts)
    _close(got, want)


def test_forward_matches_reference_with_padded_heads():
    """H=6 q heads padded to 8: padded heads read KV head 0 through the
    explicit map, as the reference's full_attention does."""
    rc, tc, jp, tp = _both("qwen3-14b", num_heads=6, num_kv_heads=2,
                           tp_pad=8)
    assert tc.num_heads_padded == 8
    toks = _tokens(rc, 2, 24, seed=2)
    want, _ = RT.forward(jp, {"tokens": jnp.asarray(toks)}, rc)
    got, _ = T.forward(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(got, want)


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_step_matches_reference(arch):
    rc, tc, jp, tp = _both(arch)
    b = _inputs(rc, 2, 16, seed=3)
    want = ref_steps.make_prefill_step(rc)(jp, _j(b))
    got = steps.make_prefill_step(tc)(tp, _t(b))
    assert got.shape == (2, tc.vocab_padded)
    _close(got, want)


@pytest.mark.parametrize("arch", SERVED)
def test_decode_step_matches_reference(arch):
    rc, tc, jp, tp = _both(arch)
    toks = _tokens(rc, 2, 8, seed=4)
    jcache = ref_module.init_params(RT.init_cache_specs(rc, 2, 16),
                                    jax.random.PRNGKey(0), jnp.float32)
    tcache = module.init_params(T.init_cache_specs(tc, 2, 16))
    if rc.family == "encdec":        # cross K/V of the same seeded frames
        frames = _inputs(rc, 2, 1, seed=8)["frames"]
        _, jcache["cross_k"], jcache["cross_v"] = RT.encode(
            jp, jnp.asarray(frames), rc)
        _, tcache["cross_k"], tcache["cross_v"] = T.encode(
            tp, torch.from_numpy(frames), tc)
        _close(tcache["cross_k"], jcache["cross_k"])
    rstep = jax.jit(lambda p, c, t, i: RT.decode_step(p, c, {"tokens": t},
                                                      i, rc))
    tstep = steps.make_decode_step(tc)
    for i in range(8):
        want, jcache = rstep(jp, jcache, jnp.asarray(toks[:, i:i + 1]), i)
        got, tcache = tstep(tp, tcache, {"tokens": torch.from_numpy(
            toks[:, i:i + 1])}, i)
        _close(got, want)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        got = tcache
        for key in path:
            got = got[key.key]
        _close(got, leaf)


@pytest.mark.parametrize("arch", SERVED)
def test_greedy_generate_matches_reference(arch):
    rc, tc, jp, tp = _both(arch)
    prompts = _tokens(rc, 4, 16, seed=5)
    want, _ = ref_serve.greedy_generate(rc, jp, prompts, 8)
    got, tps = serve.greedy_generate(tc, tp, prompts, 8)
    np.testing.assert_array_equal(got, want)
    assert tps > 0


@pytest.mark.parametrize("arch,overrides", [
    ("zamba2-7b", {}), ("mamba2-1.3b", {}), ("qwen3-14b", {}),
    ("phi4-mini-3.8b", {}), ("qwen1.5-4b", {}), ("minitron-4b", {}),
    ("qwen3-14b", {"num_heads": 6, "num_kv_heads": 2, "tp_pad": 8}),
    ("olmoe-1b-7b", {"capacity_factor": 8.0}),
    ("mixtral-8x7b", {"capacity_factor": 8.0}),
    ("whisper-large-v3", {}),
    ("whisper-large-v3", {"num_heads": 6, "num_kv_heads": 2, "tp_pad": 8}),
    ("phi-3-vision-4.2b", {}),
])
def test_decode_matches_forward(arch, overrides):
    """Teacher-forced decode reproduces the prefill logits (the
    reference's own contract, tests/test_models_smoke.py; MoE at
    capacity factor 8, so that no token drops in either). Whisper's
    decode takes its cross K/V from ``encode`` of the forward's frames
    and its learned position from ``pos``. A VLM decodes text only, as
    in the reference: it is held to its forward without the patch
    prefix."""
    cfg = registry.get_config(arch, smoke=True)
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    params = module.init_params(T.specs(cfg), seed=1)
    if cfg.num_heads_padded > cfg.num_heads:
        # decode drops the padded heads; prefill runs them. They agree
        # only when the padded wo rows are zero, as the reference's
        # layers.py docstring assumes (its init_params does not zero them)
        for name in ("attn", "xattn"):
            if name in params["blocks"]:
                params["blocks"][name]["wo"][
                    :, cfg.num_heads * cfg.head_dim:] = 0
    b = _t(_inputs(cfg, 1, 16, seed=6))
    toks = b["tokens"]
    fwd_cfg = cfg.with_overrides(vision_patches=0)  # VLM: the text decoder
    full, _ = T.forward(params, b, fwd_cfg)
    cache = module.init_params(T.init_cache_specs(cfg, 1, 16))
    if cfg.family == "encdec":
        _, cache["cross_k"], cache["cross_v"] = T.encode(params, b["frames"],
                                                         cfg)
    outs = []
    for i in range(16):
        lg, cache = T.decode_step(params, cache, {"tokens": toks[:, i:i + 1]},
                                  i, cfg)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-1.3b", "qwen3-14b"])
def test_float64_decode_matches_forward_to_rounding(arch, monkeypatch):
    """In float64, with the kernels' plain versions standing in for them,
    teacher-forced decode gives the prefill's logits to float64 rounding:
    no op of either path drops to float32 (a check at full depth on the
    card leans on this)."""
    monkeypatch.setattr(ops, "attention", lambda q, k, v, *, causal=True,
                        window=None, kv_map=None: fa.flash_attention_plain(
                            q, k, v, fa.default_kv_map(q.shape[1], k.shape[1])
                            if kv_map is None else torch.as_tensor(kv_map),
                            causal=causal, window=window))
    monkeypatch.setattr(ops, "ssd", lambda xdt, a, Bm, Cm, *, chunk=128:
                        sd.ssd_scan_plain(xdt, a, Bm, Cm, chunk=chunk))
    cfg = registry.get_config(arch, smoke=True)
    params = module.init_params(T.specs(cfg), seed=1, dtype=torch.float64)
    if cfg.num_heads_padded > cfg.num_heads:      # as in the test above
        params["blocks"]["attn"]["wo"][:, cfg.num_heads * cfg.head_dim:] = 0
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=6))
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    assert full.dtype == torch.float64
    cache = module.init_params(T.init_cache_specs(cfg, 2, 16),
                               dtype=torch.float64)
    if "h" in cache:                              # its spec says float32
        cache["h"] = cache["h"].double()
    outs = []
    for i in range(16):
        lg, cache = T.decode_step(params, cache, {"tokens": toks[:, i:i + 1]},
                                  i, cfg)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    assert dec.dtype == torch.float64
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=0,
                               atol=1e-10 * float(full.abs().max()))


def test_sliding_window_ring_decode_matches_forward():
    """A window of 8 through the prefill path (the kernel's window mask)
    and through an 8-slot ring cache give the same logits."""
    cfg = registry.get_config("qwen3-14b", smoke=True).with_overrides(
        sliding_window=8)
    assert T.cache_len_for(cfg, 20) == 8
    params = module.init_params(T.specs(cfg), seed=2)
    toks = torch.from_numpy(_tokens(cfg, 1, 20, seed=7))
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    ring = module.init_params(T.init_cache_specs(cfg, 1, 20))
    assert ring["k"].shape[3] == 8
    outs = []
    for i in range(20):
        lg, ring = T.decode_step(params, ring, {"tokens": toks[:, i:i + 1]},
                                 i, cfg)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", LATE)
def test_late_families_run_forward_cache_and_decode(arch):
    """The MoE, enc-dec and VLM archs, once refused, run: forward with
    the stubbed frontends' zero inputs (finite logits and aux), a cache
    whose spec tree is the reference's, and a decode step."""
    cfg = registry.get_config(arch, smoke=True)
    params = module.init_params(T.specs(cfg), seed=3)
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             **steps.frontend_inputs(cfg, 1, "cpu")}
    logits, aux = T.forward(params, batch, cfg)
    assert logits.shape == (1, 4, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    specs = T.init_cache_specs(cfg, 1, 8)
    assert _port_leaves(specs) == _ref_leaves(RT.init_cache_specs(
        ref_registry.get_config(arch, smoke=True), 1, 8))
    cache = module.init_params(specs)
    lg, cache = T.decode_step(params, cache, {"tokens": batch["tokens"][
        :, :1]}, 0, cfg)
    assert lg.shape == (1, 1, cfg.vocab_padded)
    assert bool(torch.isfinite(lg).all())
    assert int(cache["slot_pos"][0, 0]) == 0


def test_serve_cli_on_cpu(capsys, tmp_path):
    out = serve.main(["--device", "cpu", "--arch", "zamba2-7b", "--gen",
                      "4", "--batch", "2"])
    assert out["config"] == "smoke" and out["device"] == "cpu"
    assert out["generated_shape"] == [2, 20]
    assert '"decode_tokens_per_s"' in capsys.readouterr().out
    assert serve.parse_args(["--full"]).full
    ck = str(tmp_path / "serve.pt")
    first = serve.main(["--device", "cpu", "--arch", "zamba2-7b", "--gen",
                        "4", "--batch", "2", "--checkpoint", ck])
    again = serve.main(["--device", "cpu", "--arch", "zamba2-7b", "--gen",
                        "4", "--batch", "2", "--resume", ck])
    assert again["resumed"] and again["sample"] == first["sample"] \
        == out["sample"]


def test_train_lm_mode_takes_every_arch():
    """``--mode lm`` refuses no registry arch; one small step runs for an
    MoE and the enc-dec arch."""
    for arch in ARCHS:
        ttrain._check_ported(ttrain.parse_args(["--mode", "lm", "--arch",
                                                arch]))
    for arch in ("mixtral-8x7b", "whisper-large-v3"):
        out = ttrain.main(["--mode", "lm", "--device", "cpu", "--arch", arch,
                           "--steps", "1", "--batch", "2", "--seq", "8"])
        assert np.isfinite(out["losses"]).all() and out["arch"] == arch


def test_breakdown_profiles_the_prefill_step():
    from repro_torch.launch import breakdown

    res = breakdown.run(["--prefill", "zamba2-7b", "--smoke", "--device",
                         "cpu", "--seq", "32", "--reps", "1"])
    assert (res["config"], res["batch"], res["seq"]) == ("smoke", 2, 32)
    assert res["cold_s"] > 0 and len(res["warm_s"]) == 1
    assert res["prefill_tokens_per_s_warm"][0] > 0
    assert res["device_idle_share"] is None          # no device time on CPU
