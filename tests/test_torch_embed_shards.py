"""The token lookup on its vocab shards.

``layers.embed_tokens`` on a DTensor table whose rows (the vocab) the
model axis shards runs ``sharding.vocab_lookup``: each rank looks up the
ids in its own rows and writes zeros for the others, and that partial
sum goes straight to the residual stream's placement (the sequence
shards, a reduce-scatter; a decode step's one token whole on the model
axis, an all-reduce). The backward is the embedding backward of the
local ids into the local rows. Before, the table was gathered for the
lookup, and the backward made its dense global gradient on every rank.

* (a) on plain tensors ``embed_tokens`` (with learned positions too)
  and ``loss_fn`` are bit for bit the former code (copied below), the
  output, the loss and every leaf's gradient, for one smoke config of
  each family;
* (d) on a (2, 2) gloo world (data, model), a table of 500 ids padded to
  512 rows, ids on both sides of the shard edge (255, 256), at 0, 511
  and in the padded rows (500, 511), 6 positions and 1 (decode), tied
  and untied: the output is bit for bit the plain lookup (one nonzero
  addend a sum) at (Shard(0), Shard(1)) for 6 positions and
  (Shard(0), Replicate()) for one; each rank's rows of the lookup's
  gradient, the data ranks' partial sums added, are bit for bit the sum
  of the plain gradients of the two data shards' rows, and within 1e-6
  of max|g| of the plain gradient of the whole batch (observed at most
  6.5e-8, repeated ids across the data shards summing in another
  order); with the tied or untied head's logits in the loss, every
  leaf's gradient within 1e-6 of its max|g| (observed at most 2.2e-7);
* (e) a smoke ``train_4k`` step (global batch 8, 64 tokens) traced on
  the (4, 2) fake mesh of ``tests/test_torch_dryrun.py`` with the
  vocabulary at 790 (padded to 800): no storage the step allocates and
  no collective result has the global (800, 256) float32 table's bytes,
  which the former gather and the dense gradient of its backward had.
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
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.module import init_params
from repro_torch.optim import optimizers as topt
from test_torch_moe_sharded import _same_bits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one smoke config of each family: dense, moe, ssm, hybrid, encdec
# (learned positions), vlm, and a tied table
FAMILIES = ["qwen3-14b", "olmoe-1b-7b", "mamba2-1.3b", "zamba2-7b",
            "whisper-large-v3", "phi-3-vision-4.2b", "phi4-mini-3.8b"]
B, S = 3, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _former_embed_tokens(tokens, p, cfg, positions=None):
    x = F.embedding(tokens.long(), p["tok"])
    if cfg.pos_embed == "learned":
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = x + F.embedding(positions, p["pos"])
    return x


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    s_text = S - (cfg.vision_patches or 0)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, s_text)),
         "labels": rng.integers(0, cfg.vocab_size, (B, s_text)),
         "weights": rng.uniform(0.2, 1.5, B)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
    if cfg.vision_patches:
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.vision_patches, cfg.d_model))
    return {k: torch.from_numpy(v.astype(np.int32) if v.dtype == np.int64
                                else v.astype(np.float32))
            for k, v in b.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_plain_embed_tokens_is_the_former_form_bitwise(arch):
    cfg = registry.get_config(arch, smoke=True)
    p = init_params(L.embed_specs(cfg), seed=4)
    tokens = _batch(cfg, 5)["tokens"]
    cot = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (*tokens.shape, cfg.d_model)).astype(np.float32))
    out = []
    for fn in (L.embed_tokens, _former_embed_tokens):
        pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        x = fn(tokens, pp, cfg)
        grads = torch.autograd.grad((x * cot).sum(), list(pp.values()),
                                    allow_unused=True)
        out.append((x.detach(), grads))
    (gx, gg), (wx, wg) = out
    assert _same_bits(gx, wx)
    assert all((a is None and b is None) or _same_bits(a, b)
               for a, b in zip(gg, wg))


@pytest.mark.parametrize("arch", FAMILIES)
def test_plain_loss_fn_is_the_former_form_bitwise(arch, monkeypatch):
    cfg = registry.get_config(arch, smoke=True)
    params = init_params(T.specs(cfg), seed=3)
    batch = _batch(cfg, 11)
    (got, gm), gg = topt.value_and_grad(
        lambda p: T.loss_fn(p, batch, cfg), params)
    monkeypatch.setattr(L, "embed_tokens", _former_embed_tokens)
    (want, wm), wg = topt.value_and_grad(
        lambda p: T.loss_fn(p, batch, cfg), params)
    assert _same_bits(got, want) and _same_bits(gm["ce"], wm["ce"])
    leaves = list(zip(topt.tree_leaves(gg), topt.tree_leaves(wg)))
    assert leaves and all(_same_bits(a, b) for a, b in leaves)


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, env=env, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


# (arch, positions): minitron-4b's head is untied, phi4-mini-3.8b's tied
GLOO_CASES = [(a, s) for a in ("minitron-4b", "phi4-mini-3.8b")
              for s in (6, 1)]

GLOO = r'''
import json, os, socket, sys
import numpy as np
import torch
import torch.multiprocessing as mp

B = 4
CASES = %s


def work(rank, port, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers as L
    from repro_torch.models.module import init_params, logical_axes

    mesh = mesh_lib.make_host_mesh(2, 2, device="cpu")

    def grads(p, ids, cfg, cx, cl):
        """The leaves' gradients of sum(x·cx) (+ sum(logits·cl))."""
        pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        x = L.embed_tokens(ids, pp, cfg)
        loss = (x * cx).sum()
        if cl is not None:
            loss = loss + (L.lm_logits(x, pp, cfg) * cl).sum()
        loss.backward()
        return x.detach(), {k: v.grad for k, v in pp.items()}

    res = {}
    for arch, S in CASES:
        cfg = registry.get_config(arch, smoke=True).with_overrides(
            vocab_size=500)
        specs = L.embed_specs(cfg)
        p = init_params(specs, seed=3)
        V = cfg.vocab_padded
        rng = np.random.default_rng(S)
        ids = rng.integers(0, V, (B, S))
        edge = [V // 2 - 1, V // 2, cfg.vocab_size, V - 1, 0, V // 2]
        if S > 1:              # ids on the shard edge repeated on both halves
            ids[:, 3:] = rng.integers(V // 2 - 2, V // 2 + 2, (B, S - 3))
            ids[:2, :3] = np.reshape(edge, (2, 3))
        else:
            ids[:, 0] = edge[:B]
        ids = torch.from_numpy(ids.astype(np.int32))
        cx = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
        cl = torch.from_numpy(rng.standard_normal((B, S, V)).astype(
            np.float32))
        shards = sh.tree_shardings(logical_axes(specs), p, mesh)
        dids = distribute_tensor(ids, mesh, [Shard(0), Replicate()])
        r = {"edges_in_ids": [e for e in (V // 2 - 1, V // 2, cfg.vocab_size,
                                          V - 1, 0) if e in ids]}
        for head in (False, True):
            dp = {k: distribute_tensor(v, mesh, shards[k].placements)
                  .detach().requires_grad_(True) for k, v in p.items()}
            dx = L.embed_tokens(dids, dp, cfg)
            loss = (dx * distribute_tensor(cx, mesh, dx.placements)).sum()
            if head:
                dlg = L.lm_logits(dx, dp, cfg)
                loss = loss + (dlg * distribute_tensor(
                    cl, mesh, dlg.placements)).sum()
            loss.backward()
            x, want = grads(p, ids, cfg, cx, cl if head else None)
            keys = list(p) if head else ["tok"]
            got = {k: dp[k].grad.redistribute(mesh, dp[k].placements)
                   .to_local() for k in keys}
            rows = {}
            for k in keys:
                d = 0 if k == "tok" else 1
                lo, n = sh._local_range(dp[k], d)
                rows[k] = want[k].narrow(d, lo, n)
            rel = {k: float((got[k] - rows[k]).abs().max()
                            / want[k].abs().max()) for k in keys}
            if not head:
                # the data ranks' partial sums: the two halves' gradients
                half = [grads(p, ids[h:h + B // 2], cfg, cx[h:h + B // 2],
                              None)[1]["tok"] for h in (0, B // 2)]
                lo, n = sh._local_range(dp["tok"], 0)
                r["lookup"] = {
                    "forward": bool(torch.equal(dx.full_tensor(), x)),
                    "placements": [str(q) for q in dx.placements],
                    "halves": bool(torch.equal(
                        got["tok"], (half[0] + half[1])[lo:lo + n])),
                    "rel": rel["tok"]}
            else:
                r["head"] = rel
        res[f"{arch}:{S}"] = r
    allr = [None] * 4
    dist.all_gather_object(allr, res)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(allr, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "res.json")
    mp.spawn(work, args=(port, out), nprocs=4)
    print(open(out).read())
'''


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    script = tmp_path_factory.mktemp("gloo") / "work.py"
    script.write_text(GLOO % repr(GLOO_CASES))
    return _run([str(script)], timeout=300)


@pytest.mark.parametrize("arch,positions", GLOO_CASES)
def test_lookup_on_the_vocab_shards_of_a_gloo_world(gloo, arch, positions):
    for res in gloo:
        r = res[f"{arch}:{positions}"]
        lk = r["lookup"]
        assert lk["forward"]
        assert lk["placements"] == ["S(0)", "S(1)" if positions > 1 else "R"]
        assert lk["halves"] and lk["rel"] <= 1e-6
        assert sorted(r["head"]) == (["tok"] if arch == "phi4-mini-3.8b"
                                     else ["lm_head", "tok"])
        assert all(v <= 1e-6 for v in r["head"].values()), r["head"]
    edges = gloo[0][f"{arch}:{positions}"]["edges_in_ids"]
    assert edges == [255, 256, 500, 511] + ([0] if positions > 1 else [])


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
ARCHS = %r


class Seen(DR.LocalTraffic):
    """LocalTraffic that also keeps the bytes of every storage a local op
    creates, and the result bytes of each collective."""

    def __init__(self):
        super().__init__()
        self.allocs, self.results = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is NotImplemented or self.inferring
                or any(issubclass(t, DTensor) for t in types)):
            return out
        name = func._overloadpacket.__name__
        old = {t.untyped_storage()._cdata
               for t in DR._tensors((args, kwargs or {}))}
        sizes = [t.untyped_storage().nbytes() for t in DR._tensors(out)
                 if t.untyped_storage()._cdata not in old]
        self.allocs += [[name, n] for n in sizes]
        if name in DR._COLLECTIVES:
            self.results += [[name, n] for n in sizes]
        return out


res = {}
for arch in ARCHS:
    shp = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=8,
                              seq_len=64)
    cfg0 = get_config(arch, smoke=True).with_overrides(vocab_size=790)
    step, args, cfg = DR.build_step(cfg0, shp, mesh)
    seen = Seen()
    with DR._uncounted_shape_inference(seen), seen, implicit_replication():
        step(*args)
    v, d = T.specs(cfg)["embed"]["tok"].shape
    res[arch] = {"table": v * d * 4, "allocs": seen.allocs,
                 "results": seen.results}
print(json.dumps(res))
'''
TRACE_ARCHS = ["minitron-4b", "phi4-mini-3.8b", "phi-3-vision-4.2b",
               "whisper-large-v3", "mamba2-1.3b", "olmoe-1b-7b"]


@pytest.fixture(scope="module")
def traced():
    return _run(["-c", TRACE % TRACE_ARCHS], timeout=300)


@pytest.mark.parametrize("arch", TRACE_ARCHS)
def test_train_trace_holds_no_global_table(traced, arch):
    r = traced[arch]
    assert r["table"] == 800 * 256 * 4
    assert r["results"] and r["allocs"]
    assert [a for a in r["allocs"] if a[1] == r["table"]] == []
    assert [a for a in r["results"] if a[1] == r["table"]] == []
