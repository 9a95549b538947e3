"""The training loss keeps the logits vocab-sharded on DTensors.

``T.token_loss``, the tail of ``loss_fn``, picks the labels' log-
probabilities with ``nll_loss`` and runs on DTensors through
``sharding.on_vocab_shards`` under the ``loss_parallel()`` that
``steps.grads_of`` enters:

* (a) on plain tensors the tail and ``loss_fn`` are bit for bit the
  former ``torch.gather`` form, in the loss and in the logits' and every
  leaf's gradient, for one smoke config of each family (the bfloat16
  logits and the unweighted tail too);
* (b) on two gloo ranks, a (1, 2) mesh, the tail on logits placed
  (Shard(0), Shard(2)) and (Shard(0), Partial()) equals the plain tail
  on the same seeded inputs: the loss within 1e-6 relative, the logits'
  gradient within 1e-6 of its largest entry;
* (c) a smoke ``train_4k`` step traced on the (4, 2) fake mesh of
  ``tests/test_torch_dryrun.py`` allocates no storage of the global
  (B, S, V_pad) float32 logits' bytes, and its log-softmax reduces the
  local (B/4, S, V_pad/2) shards only (the max over the vocab that
  loss parallelism all-reduces). Before the repair DTensor gathered the
  vocab for the log-softmax and the gather's backward made the global
  logits on every rank.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.models.module import init_params
from repro_torch.optim import optimizers as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one smoke config of each family: dense, moe, ssm, hybrid, encdec, vlm
ARCHS = ["qwen3-14b", "olmoe-1b-7b", "mamba2-1.3b", "zamba2-7b",
         "whisper-large-v3", "phi-3-vision-4.2b"]
B, S = 3, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _gather_tail(logits, labels, weights=None):
    """The tail of ``loss_fn`` as it was: the pick by ``torch.gather``."""
    labels = labels.long()
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    w = weights
    if w is None:
        w = torch.ones(labels.shape[:1], dtype=torch.float32,
                       device=ll.device)
    tok_w = w[:, None] * torch.ones_like(ll)
    return -(ll * tok_w).sum() / torch.clamp(tok_w.sum(), min=1.0)


def _gather_loss_fn(params, batch, cfg):
    logits, aux = T.forward(params, batch, cfg)
    loss = _gather_tail(logits, batch["labels"], batch.get("weights"))
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.2, 1.5, B).astype(np.float32)
    w[1] = 0.0                               # a discarded sample
    s_text = S - (cfg.vision_patches or 0)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, s_text)),
         "labels": rng.integers(0, cfg.vocab_size, (B, s_text)),
         "weights": w}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
    if cfg.vision_patches:
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.vision_patches, cfg.d_model))
    return {k: torch.from_numpy(v.astype(np.int32) if v.dtype == np.int64
                                else v.astype(np.float32))
            for k, v in b.items()}


def _same_bits(a, b):
    """Equal dtypes, shapes and bits (a signed zero or a NaN included)."""
    def bits(t):
        t = t.detach().contiguous()
        return t.view({torch.float32: torch.int32,
                       torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_is_the_gather_form_bitwise(arch):
    cfg = registry.get_config(arch, smoke=True)
    params = init_params(T.specs(cfg), seed=3)
    batch = _batch(cfg, 11)
    (got, gm), gg = topt.value_and_grad(
        lambda p: T.loss_fn(p, batch, cfg), params)
    (want, wm), wg = topt.value_and_grad(
        lambda p: _gather_loss_fn(p, batch, cfg), params)
    assert _same_bits(got, want) and _same_bits(gm["ce"], wm["ce"])
    leaves = list(zip(topt.tree_leaves(gg), topt.tree_leaves(wg)))
    assert leaves and all(_same_bits(a, b) for a, b in leaves)


@pytest.mark.parametrize("dtype,weighted", [(torch.float32, True),
                                            (torch.float32, False),
                                            (torch.bfloat16, True)])
def test_token_loss_is_the_gather_form_bitwise(dtype, weighted):
    rng = np.random.default_rng(5)
    V = 1001
    x = torch.from_numpy(rng.standard_normal((B, 17, V)).astype(
        np.float32) * 4).to(dtype)
    labels = torch.from_numpy(rng.integers(0, V, (B, 17)).astype(np.int32))
    w = (torch.tensor([0.7, 0.0, 1.3]) if weighted else None)
    out = []
    for tail in (T.token_loss, _gather_tail):
        xl = x.clone().requires_grad_(True)
        loss = tail(xl, labels, w)
        (g,) = torch.autograd.grad(loss, xl)
        out.append((loss.detach(), g))
    (gl, gg), (wl, wg) = out
    assert _same_bits(gl, wl)
    # bit for bit but for the sign of a zero: at a zero-weight sample's
    # labels nll_loss's backward writes -0.0 where gather's added +0.0
    nz = wg != 0
    assert gg.dtype == dtype and torch.equal(gg, wg)
    assert _same_bits(gg[nz], wg[nz])


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, env=env, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


GLOO = r'''
import json, os, socket, sys
import numpy as np
import torch
import torch.multiprocessing as mp

B, S, V = 4, 6, 10


def work(rank, port, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from torch.distributed.tensor.parallel import loss_parallel
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T

    mesh = mesh_lib.make_host_mesh(1, 2, device="cpu")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((B, S, V)).astype(np.float32)
                         * 3)
    labels = torch.from_numpy(rng.integers(0, V, (B, S)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0.2, 1.5, B).astype(np.float32))
    w[2] = 0.0
    xp = x.clone().requires_grad_(True)
    want = T.token_loss(xp, labels, w)
    (want_g,) = torch.autograd.grad(want, xp)
    want = want.detach()
    res = {}
    for case, lab_place in (("vocab", [Shard(0), Replicate()]),
                            ("partial", [Shard(0), Shard(1)])):
        if case == "vocab":
            dx = distribute_tensor(x, mesh, [Shard(0), Shard(2)])
        else:                       # rank 1's addend is zero
            dx = DTensor.from_local(x if rank == 0 else torch.zeros_like(x),
                                    mesh, [Shard(0), Partial()],
                                    run_check=False)
        dx = dx.detach().requires_grad_(True)
        dl = distribute_tensor(labels, mesh, lab_place)
        dw = distribute_tensor(w, mesh, [Shard(0), Replicate()])
        with loss_parallel():
            got = T.token_loss(dx, dl, dw)
            (got_g,) = torch.autograd.grad(got, dx)
        got, got_g = got.full_tensor().detach(), got_g.full_tensor()
        res[case] = {
            "loss_rel": float((got - want).abs() / want.abs()),
            "grad_rel": float((got_g - want_g).abs().max()
                              / want_g.abs().max()),
            "finite": bool(torch.isfinite(got_g).all()),
            "shape": list(got_g.shape)}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "res.json")
    mp.spawn(work, args=(port, out), nprocs=2)
    print(open(out).read())
'''


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    script = tmp_path_factory.mktemp("gloo") / "work.py"
    script.write_text(GLOO)       # spawned workers import it by path
    return _run([str(script)], timeout=300)


@pytest.mark.parametrize("case", ["vocab", "partial"])
def test_dtensor_tail_on_two_gloo_ranks(gloo, case):
    r = gloo[case]
    assert r["loss_rel"] <= 1e-6
    assert r["grad_rel"] <= 1e-6
    assert r["finite"] and r["shape"] == [4, 6, 10]


TRACE = r'''
import dataclasses, json
import torch
from torch.distributed.tensor import DTensor
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from torch.distributed.tensor.experimental import implicit_replication

torch.set_num_threads(1)
mesh_lib.init_fake_process_group(8)
mesh = mesh_lib.make_host_mesh(4, 2, device="cpu")


class Seen(DR.LocalTraffic):
    """LocalTraffic that also keeps each local op's input shapes, and
    the shape and storage bytes of each of its outputs."""

    def __init__(self):
        super().__init__()
        self.ops, self.allocs = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is NotImplemented or self.inferring
                or any(issubclass(t, DTensor) for t in types)):
            return out
        name = func._overloadpacket.__name__
        self.ops.append([name, [list(t.shape) for t in
                                DR._tensors((args, kwargs or {}))]])
        self.allocs += [[name, list(t.shape), t.untyped_storage().nbytes()]
                        for t in DR._tensors(out)]
        return out


res = {}
for arch in ("qwen1.5-4b", "phi-3-vision-4.2b"):
    shp = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=8,
                              seq_len=64)
    # a vocabulary (790, padded to 800) unlike the smoke config's other
    # widths, so that no weight or activation has the logits' bytes
    cfg0 = get_config(arch, smoke=True).with_overrides(vocab_size=790)
    step, args, cfg = DR.build_step(cfg0, shp, mesh)
    seen = Seen()
    with DR._uncounted_shape_inference(seen), seen, implicit_replication():
        step(*args)
    (b, s), v = args[2]["labels"].shape, T.specs(cfg)["embed"]["tok"].shape[0]
    res[arch] = {"v_pad": v, "labels": [b, s],
                 "global_logits": [a for a in seen.allocs
                                   if a[2] == b * s * v * 4],
                 "vocab_reductions": [shapes[0] for op, shapes in seen.ops
                                      if op in ("_log_softmax", "amax",
                                                "logsumexp")]}
print(json.dumps(res))
'''


@pytest.fixture(scope="module")
def traced():
    return _run(["-c", TRACE], timeout=300)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "phi-3-vision-4.2b"])
def test_train_trace_keeps_the_logits_vocab_sharded(traced, arch):
    r = traced[arch]
    (b, s), v = r["labels"], r["v_pad"]
    assert v == 800 and r["global_logits"] == []
    assert r["vocab_reductions"]
    assert all(sh == [b // 4, s, v // 2] for sh in r["vocab_reductions"])
