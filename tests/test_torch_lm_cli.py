"""``python -m repro_torch.launch.train --mode lm`` held to the
reference's ``--mode lm`` on the CPU.

* ``make_token_dataset``, ``ici_costs``, ``effective_link_costs`` and
  ``lm_movement_inputs`` (n_shards 1, 4 and 8: plan, routes, weights,
  traces) are bitwise the reference's;
* the CLI on the same small arguments, its ``init_params`` patched to
  return the reference's initial parameters carried across: loss_first
  within rtol 1e-5, loss_last within rtol 1e-4, moved_frac equal, the
  reference's output keys, at ``--lm-tau`` 1 and 2;
* the same for the MoE (olmoe with ``--data-shards 4 --lm-tau 2``),
  enc-dec and VLM archs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.core import costs as rcosts
from repro.data import synthetic as rsyn
from repro.launch import train as rtrain
from repro.models import module as ref_module
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.core import costs as tcosts
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import lm_params_from_jax

KEYS = {"mode", "arch", "loss_first", "loss_last", "steps_per_s",
        "moved_frac"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("n,vocab,seed", [(1000, 512, 0), (4097, 32000, 3),
                                          (1, 7, 1)])
def test_token_dataset_bitwise(n, vocab, seed):
    got = tsyn.make_token_dataset(n, vocab, seed=seed)
    want = rsyn.make_token_dataset(n, vocab, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_ici_costs_and_effective_link_costs_bitwise():
    sf = np.array([1.0, 0.5, 2.0, 0.2])
    kw = dict(bytes_per_point=8192.0, flops_per_point=5e9,
              speed_factors=sf, f_err=1e9)
    got, want = tcosts.ici_costs(4, 3, **kw), rcosts.ici_costs(4, 3, **kw)
    for k in ("c_node", "c_link", "f_err", "cap_node", "cap_link"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    d = tcosts.ici_costs(5, 2, bytes_per_point=1.0)
    assert np.array_equal(d.c_link, rcosts.ici_costs(
        5, 2, bytes_per_point=1.0).c_link)
    tr = rcosts.synthetic_costs(4, 5, np.random.default_rng(0))
    for shift in (False, True):
        assert np.array_equal(tcosts.effective_link_costs(tr, shift),
                              rcosts.effective_link_costs(tr, shift))


@pytest.mark.parametrize("n_shards,batch,seed", [(1, 8, 0), (4, 16, 1),
                                                 (8, 32, 2), (4, 8, 5)])
def test_lm_movement_inputs_bitwise(n_shards, batch, seed):
    T_ = 6
    gp, gt, gr, gw = ttrain.lm_movement_inputs(
        n_shards, batch, T_, np.random.default_rng(seed))
    wp, wt, wr, ww = rtrain.lm_movement_inputs(
        n_shards, batch, T_, np.random.default_rng(seed))
    assert np.array_equal(gp.s, wp.s) and np.array_equal(gp.r, wp.r)
    assert np.array_equal(gt.c_node, wt.c_node)
    assert np.array_equal(gt.c_link, wt.c_link)
    for a, b in zip(gr + gw, wr + ww):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _ref_params(arch, layers):
    def init(specs, seed, dtype, device):
        cfg = ref_registry.get_config(arch, smoke=True)
        if layers:
            cfg = cfg.with_overrides(num_layers=layers)
        jp = ref_module.init_params(RT.specs(cfg), jax.random.PRNGKey(seed),
                                    jnp.float32)
        return lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  device=device)
    return init


def _matches_reference_cli(monkeypatch, capsys, arch, extra):
    argv = ["--mode", "lm", "--arch", arch, "--steps", "4", "--batch", "4",
            "--seq", "16", "--seed", "1"] + extra
    want = rtrain.main(argv)
    monkeypatch.setattr(ttrain, "init_params",
                        _ref_params(arch, int(dict(zip(extra, extra[1:]))
                                              .get("--layers", 0))))
    got = ttrain.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert set(want) == KEYS and KEYS <= set(got)
    assert got["mode"] == "lm" and got["arch"] == arch
    assert got["loss_first"] == pytest.approx(want["loss_first"], rel=1e-5)
    assert got["loss_last"] == pytest.approx(want["loss_last"], rel=1e-4)
    assert got["moved_frac"] == want["moved_frac"]
    n_losses = 2 if "--lm-tau" in extra else 4
    assert len(got["losses"]) == n_losses and got["device"] == "cpu"
    assert '"steps_per_s"' in out


@pytest.mark.parametrize("arch,extra", [
    ("qwen3-14b", []), ("qwen3-14b", ["--lm-tau", "2"]),
    ("mamba2-1.3b", ["--layers", "1", "--optimizer", "sgd", "--lr",
                     "0.05"]),
])
def test_cli_matches_reference_cli(monkeypatch, capsys, arch, extra):
    _matches_reference_cli(monkeypatch, capsys, arch, extra)


def test_cli_defaults_and_moved_fraction():
    """The lm flags' defaults are the reference's; over 4 shards the
    plan moves some shards' samples and not all."""
    args = ttrain.parse_args(["--mode", "lm"])
    assert (args.arch, args.steps, args.batch, args.seq, args.data_shards,
            args.lm_tau, args.optimizer, args.lr, args.smoke) == \
        ("qwen3-14b", 40, 8, 128, 1, 1, "adamw", 3e-3, True)
    plan, _, _, _ = ttrain.lm_movement_inputs(4, 16, 10,
                                              np.random.default_rng(0))
    moved = (plan.s * (1 - np.eye(4))).sum() / plan.s.shape[0] / 4
    assert 0.0 < moved < 1.0


@pytest.mark.parametrize("arch,extra", [
    ("mixtral-8x7b", []),
    ("olmoe-1b-7b", ["--data-shards", "4", "--lm-tau", "2"]),
    ("whisper-large-v3", []), ("phi-3-vision-4.2b", [])])
def test_moe_encdec_vlm_archs_match_reference_cli(monkeypatch, capsys, arch,
                                                 extra):
    """The archs the model zoo's last slice ported: the MoE aux loss in
    the loss, zero frames and patch embeddings in the batches. The
    reference's MoE sharding constraint (``moe._maybe_shard``) is made
    the identity it is on one device: under this jax its
    ``with_sharding_constraint`` refuses the Manual axis of the FedAvg
    round's ``shard_map``."""
    monkeypatch.setattr(RM, "_maybe_shard", lambda x, *axes: x)
    _matches_reference_cli(monkeypatch, capsys, arch, extra)
