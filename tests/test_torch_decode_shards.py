"""Decode attention on the KV cache's sequence shards.

The cache is (B, KH, S_cache, hd) with its slots on the model axis (the
rule ``"cache_seq"``), as in the reference. On a DTensor cache
``layers.decode_attention`` writes the new K/V only on the rank whose
local slots hold the step's slot, scores the local slots, takes the
softmax across the slot shards by small all-reduces (the max, the sum of
exp, p·v) and multiplies ``wo``'s local rows (``layers._attend_on_shards``,
``sharding.rows_product``); ``cross_decode_attention`` runs the same
core on the encoder's K/V. Before, DTensor gathered every layer's whole
cache for the in-place write, the scores, the output and ``wo``.

* (a) on plain tensors ``decode_step`` (and so ``decode_attention``,
  ``cross_decode_attention`` and ``embed_tokens``) is bit for bit the
  former code (copied below; its ``gather_dims`` calls were the identity
  on plain tensors and are left out), its logits and every cache leaf
  after every token, for one smoke config of each family: dense, GQA
  with padded q heads (one of them with a model rank holding padded
  rows only), a sliding window on an 8-slot ring, hybrid, enc-dec with
  learned positions, VLM and MoE;
* (b) on a (2, 2) gloo world (data, model), the same configs decode 8
  tokens from a cache that the plain path prefilled with 6 prompt
  tokens, with parameters, cache and tokens placed by the sharding
  rules, beside the plain decode on the same inputs. The 14-slot caches
  put the first decoded slots on both sides of the shard boundary
  (slots 6 and 7); the ring of 8 wraps at the third token and writes
  both sides of its boundary (slots 3 and 4); a 13-slot cache, which
  does not divide the model axis, is whole on every rank (every rank
  writes). At every token: the tokens are equal, ``slot_pos`` is
  bitwise, the first layer's K and V are bitwise (their input, the
  token's embedding, is exact: one nonzero addend a sum), the cache
  returned is the one passed in, and in float64 the logits and every
  cache leaf are within 1e-12 of their max|.| (observed at most 6.1e-15),
  so the sharded softmax and products are the plain ones to rounding.
  In float32 the logits are within 2e-6 of max|logit| (zamba2-7b:
  1e-5) and the later layers' K/V within 1e-5 of the cache's max|.|:
  the row-parallel products of the MLP and of ``wo`` sum over the model
  ranks in another order than one product does. Observed: logits at
  most 1.2e-6 (zamba2-7b 3.0e-6), caches at most 1.1e-6 (2.3e-6). The
  former DTensor decode read 9.6e-7 (4.4e-6) where the cache was
  whole on every rank (13 slots), from the same sums; on a
  sequence-sharded cache its in-place write through DTensor was lost:
  logits 0.8-1.3 of max|logit| off, the tokens and ``slot_pos`` wrong;
* (c) the float32 decode of (b) on DTensors against the reference's
  ``decode_step`` (jax, CPU) from the same parameters and prompt, fed
  the same tokens: the logits within 1e-4 of max|logit|
  (``tests/test_torch_lm.py``'s tolerance), its greedy tokens equal;
* (e) a smoke decode step (global batch 8, 40 cache slots; mixtral's
  window 32) traced on the (4, 2) fake mesh of
  ``tests/test_torch_dryrun.py`` with the vocabulary at 790 (padded to
  800): no collective result and no storage the step allocates is as
  large as one layer's global K cache, one layer's global SSM state
  (B·H·P·N·4; mamba2 and zamba2) or the global token table. The former
  code's trace gathered the cache and the table. Every block boundary
  leaves the stream on its batch shards, whole on the model axis
  (``residual_placements`` pinned ``S(0),R``), and none arrives
  ``Partial``.
"""
import json
import math
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
from test_torch_moe_sharded import _same_bits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, config overrides, prompt tokens, decode tokens)
CASES = [
    ("minitron-4b", {}, 6, 8),                              # dense
    ("minitron-4b", {}, 5, 8),                              # 13 slots
    ("qwen3-14b", {"num_heads": 6, "num_kv_heads": 2, "tp_pad": 8}, 6, 8),
    ("qwen1.5-4b", {"num_heads": 2, "num_kv_heads": 2, "tp_pad": 8}, 6, 8),
    ("mixtral-8x7b", {"sliding_window": 8}, 6, 8),          # ring, MoE
    ("zamba2-7b", {}, 6, 8),                                # hybrid
    ("whisper-large-v3", {}, 6, 8),                         # enc-dec
    ("phi-3-vision-4.2b", {}, 6, 8),                        # VLM
    ("olmoe-1b-7b", {}, 6, 8),                              # MoE
]
B = 4


def _key(arch, kw, P, N):
    return f"{arch}:{json.dumps(kw, sort_keys=True)}:{P}:{N}"


def _ids(case):
    return _key(*case)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the former code, on plain tensors ----------------------------------------

def _former_decode_attention(x, p, cfg, cache, pos, *, window=None):
    B = x.shape[0]
    hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q, k_new, v_new = L._project_qkv(x, p, cfg)
    q = q[:, :, :H, :]
    if cfg.rope:
        cos, sin = L.rope_cos_sin(torch.full((1,), pos, device=x.device), hd,
                                  cfg.rope_theta)
        q = L.apply_rope(q, cos, sin)
        k_new = L.apply_rope(k_new, cos, sin)
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    slot = pos % k.shape[2]
    k[:, :, slot] = k_new[:, 0]
    v[:, :, slot] = v_new[:, 0]
    slot_pos[slot] = pos
    qg = q.reshape(B, KH, H // KH, hd)
    s = L.upcast(torch.einsum("bgrh,bgsh->bgrs", qg, k)) / math.sqrt(hd)
    valid = slot_pos >= 0
    if window is not None:
        valid &= slot_pos > pos - window
    valid |= slot_pos == pos
    s = s.masked_fill(~valid, float("-inf"))
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    og = torch.einsum("bgrs,bgsh->bgrh", pr, v)
    out = og.reshape(B, 1, H * hd) @ p["wo"][:H * hd]
    return out, cache


def _former_cross_decode_attention(x, p, cfg, k, v):
    B = x.shape[0]
    hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, 1, cfg.num_heads_padded, hd)[:, :, :H, :]
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"])
    qg = q.reshape(B, KH, H // KH, hd)
    s = L.upcast(torch.einsum("bgrh,bgsh->bgrs", qg, k)) / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    og = torch.einsum("bgrs,bgsh->bgrh", pr, v)
    return og.reshape(B, 1, H * hd) @ p["wo"][:H * hd]


def _former_embed_tokens(tokens, p, cfg, positions=None):
    x = F.embedding(tokens.long(), p["tok"])
    if cfg.pos_embed == "learned":
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = x + F.embedding(positions, p["pos"])
    return x


def _decode_run(cfg, P, N, seed=2):
    """Greedy decode of P prompt tokens and N more from a zero cache:
    the logits of every step and the cache after each."""
    params = init_params(T.specs(cfg), seed=1)
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P)).astype(
        np.int32))
    cache = init_params(T.init_cache_specs(cfg, B, P + N))
    if cfg.family == "encdec":
        frames = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        _, cache["cross_k"], cache["cross_v"] = T.encode(params, frames, cfg)
    logits, caches = [], []
    nxt = tok[:, :1]
    for i in range(P + N):
        nxt = tok[:, i:i + 1] if i < P else nxt
        lg, cache = T.decode_step(params, cache, {"tokens": nxt}, i, cfg)
        logits.append(lg)
        caches.append({k: v.clone() for k, v in _flat(cache).items()})
        nxt = lg[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
    return logits, caches


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_decode_is_the_former_form_bitwise(case, monkeypatch):
    arch, kw, P, N = case
    cfg = registry.get_config(arch, smoke=True).with_overrides(**kw)
    got = _decode_run(cfg, P, N)
    monkeypatch.setattr(L, "decode_attention", _former_decode_attention)
    monkeypatch.setattr(L, "cross_decode_attention",
                        _former_cross_decode_attention)
    monkeypatch.setattr(L, "embed_tokens", _former_embed_tokens)
    want = _decode_run(cfg, P, N)
    for (gl, gc), (wl, wc) in zip(zip(*got), zip(*want)):
        assert _same_bits(gl, wl)
        assert gc.keys() == wc.keys()
        assert all(_same_bits(gc[k], wc[k]) for k in gc), [
            k for k in gc if not _same_bits(gc[k], wc[k])]


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

B = %d
CASES = %s


def work(rank, port, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params
    from repro_torch.optim import optimizers as topt

    mesh = mesh_lib.make_host_mesh(2, 2, device="cpu")

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, pre + k + "/"))
            else:
                out[pre + k] = v
        return out

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    res, arrays = {}, {}
    for arch, kw, P, N in CASES:
        key = f"{arch}:{json.dumps(kw, sort_keys=True)}:{P}:{N}"
        cfg = registry.get_config(arch, smoke=True).with_overrides(**kw)
        for dtype in (torch.float32, torch.float64):
            params = init_params(T.specs(cfg), seed=1, dtype=dtype)
            rng = np.random.default_rng(2)
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, P)).astype(np.int32))
            cache = init_params(T.init_cache_specs(cfg, B, P + N),
                                dtype=dtype)
            if "h" in cache:                   # its spec says float32
                cache["h"] = cache["h"].to(dtype)
            frames = None
            if cfg.family == "encdec":
                # encoded in float32: the prefill attention's plain
                # version takes float32 or bfloat16 only
                frames = torch.from_numpy(rng.standard_normal(
                    (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
                _, ck, cv = T.encode(init_params(T.specs(cfg), seed=1),
                                     frames, cfg)
                cache["cross_k"], cache["cross_v"] = ck.to(dtype), cv.to(dtype)
            for i in range(P):                 # the plain path prefills
                lg, cache = T.decode_step(params, cache,
                                          {"tokens": prompt[:, i:i + 1]}, i,
                                          cfg)
            tok = lg[:, -1, :cfg.vocab_size].argmax(-1).to(
                torch.int32)[:, None]
            dparams = topt.tree_map(
                lambda t, s: distribute_tensor(t, mesh, s.placements),
                params, St.param_shardings(cfg, mesh))
            cshard = St.cache_shardings(cfg, B, P + N, mesh)
            dcache = topt.tree_map(
                lambda t, s: distribute_tensor(t.clone(), mesh,
                                               s.placements), cache, cshard)
            place = St.batch_shardings({"tokens": tok}, mesh)["tokens"]
            attn = cshard["attn"] if "attn" in cshard else cshard
            r = {"logits": [], "toks": [], "slot_pos": [], "first": [],
                 "cache": [], "same": [],
                 "slots_sharded": attn["k"].spec[3] is not None}
            tok0 = tok
            dlogits, dtoks = [], []
            for j in range(N):
                pos = P + j
                lg, cache = T.decode_step(params, cache, {"tokens": tok}, pos,
                                          cfg)
                with implicit_replication():    # whisper's position row
                    dlg, back = T.decode_step(
                        dparams, dcache, {"tokens": distribute_tensor(
                            tok, mesh, place.placements)}, pos, cfg)
                r["same"].append(all(
                    a is b for a, b in zip(topt.tree_leaves(back),
                                           topt.tree_leaves(dcache))))
                dlg = dlg.full_tensor()
                r["logits"].append(rel(dlg, lg))
                want = lg[:, -1, :cfg.vocab_size].argmax(-1)
                got = dlg[:, -1, :cfg.vocab_size].argmax(-1)
                r["toks"].append(bool(torch.equal(want, got)))
                dlogits.append(dlg)
                dtoks.append(got)
                full = {k: v.full_tensor() for k, v in flat(dcache).items()}
                plain = flat(cache)
                r["slot_pos"].append(all(
                    torch.equal(full[k], plain[k]) for k in full
                    if k.endswith("slot_pos")))
                r["first"].append(all(
                    torch.equal(full[k][0], plain[k][0])
                    for k in ("k", "v") if k in full))
                r["cache"].append(max(rel(full[k], plain[k]) for k in full
                                      if not k.endswith("slot_pos")))
                tok = want.to(torch.int32)[:, None]
            res[key + ":" + str(dtype)[6:]] = r
            if dtype == torch.float32:
                arrays[key] = {"params": params, "prompt": prompt,
                               "frames": frames, "tok0": tok0,
                               "logits": torch.stack(dlogits, 1)[:, :, 0],
                               "toks": torch.stack(dtoks, 1)}
    allr = [None] * 4
    dist.all_gather_object(allr, res)
    if rank == 0:
        torch.save(arrays, out + ".pt")
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
    print(json.dumps({"path": out, "res": json.load(open(out))}))
'''


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    script = tmp_path_factory.mktemp("gloo") / "work.py"
    script.write_text(GLOO % (B, repr(CASES)))
    return _run([str(script)], timeout=300)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_decode_on_the_cache_shards_of_a_gloo_world(gloo, case, dtype):
    arch, kw, P, N = case
    for r in (g[_key(*case) + ":" + dtype] for g in gloo["res"]):
        assert len(r["toks"]) == N and all(r["toks"])
        assert all(r["slot_pos"]) and all(r["same"])
        # 14 slots and the ring of 8 divide the model axis; 13 do not
        assert r["slots_sharded"] == ((P + N) % 2 == 0)
        if arch != "zamba2-7b":      # its first attention follows SSMs
            assert all(r["first"])
        if dtype == "float64":
            assert max(r["logits"]) <= 1e-12 and max(r["cache"]) <= 1e-12
        else:
            tol = 1e-5 if arch == "zamba2-7b" else 2e-6
            assert max(r["logits"]) <= tol, r["logits"]
            assert max(r["cache"]) <= 1e-5, r["cache"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_decode_on_shards_matches_the_reference(gloo, case):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import registry as ref_registry
    from repro.models import module as ref_module
    from repro.models import transformer as RT

    arch, kw, P, N = case
    a = torch.load(gloo["path"] + ".pt")[_key(*case)]
    rc = ref_registry.get_config(arch, smoke=True).with_overrides(**kw)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                a["params"])
    cache = ref_module.init_params(RT.init_cache_specs(rc, B, P + N),
                                   jax.random.PRNGKey(0), jnp.float32)
    if rc.family == "encdec":
        _, cache["cross_k"], cache["cross_v"] = RT.encode(
            jp, jnp.asarray(a["frames"].numpy()), rc)
    step = jax.jit(lambda p, c, t, i: RT.decode_step(p, c, {"tokens": t}, i,
                                                     rc))
    prompt = a["prompt"].numpy()
    for i in range(P):
        lg, cache = step(jp, cache, jnp.asarray(prompt[:, i:i + 1]), i)
    tok = a["tok0"].numpy()
    for j in range(N):
        # the plain path's prefill picked the first token; after that the
        # port's own picks on DTensors
        np.testing.assert_array_equal(
            np.asarray(lg)[:, -1, :rc.vocab_size].argmax(-1), tok[:, 0])
        lg, cache = step(jp, cache, jnp.asarray(tok), P + j)
        want = np.asarray(lg)[:, -1]
        np.testing.assert_allclose(a["logits"][:, j].numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
        tok = a["toks"][:, j:j + 1].numpy().astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(lg)[:, -1, :rc.vocab_size].argmax(-1), tok[:, 0])


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
KIND = %r
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
        # new storages only: a view's or an in-place op's is an input's
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
    shp = dataclasses.replace(INPUT_SHAPES[KIND], global_batch=8,
                              seq_len=64 if KIND == "train_4k" else 40)
    cfg0 = get_config(arch, smoke=True).with_overrides(vocab_size=790)
    step, args, cfg = DR.build_step(cfg0, shp, mesh)
    seen = Seen()
    with DR._uncounted_shape_inference(seen), seen, implicit_replication(), \
            DR._residual_placements(seen.residuals):
        step(*args)
    v, d = T.specs(cfg)["embed"]["tok"].shape
    layer = state = None
    if shp.kind == "decode":
        c = T.init_cache_specs(cfg, shp.global_batch, shp.seq_len)
        k = (c["attn"] if "attn" in c else c).get("k")
        layer = 4 * int(torch.tensor(k.shape[1:]).prod()) if k else None
        h = c.get("h")
        state = 4 * int(torch.tensor(h.shape[1:]).prod()) if h else None
    res[arch] = {"table": v * d * 4, "layer": layer, "state": state,
                 "allocs": seen.allocs, "results": seen.results,
                 "residuals": seen.residuals}
print(json.dumps(res))
'''
DECODE_ARCHS = ["minitron-4b", "mixtral-8x7b", "zamba2-7b",
                "whisper-large-v3", "phi-3-vision-4.2b", "olmoe-1b-7b",
                "mamba2-1.3b"]


@pytest.fixture(scope="module")
def traced():
    return _run(["-c", TRACE % ("decode_32k", DECODE_ARCHS)], timeout=300)


def _largest(entries):
    return max((n for _, n in entries), default=0)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_trace_gathers_no_cache_and_no_table(traced, arch):
    r = traced[arch]
    assert r["table"] == 800 * 256 * 4
    bound = min(b for b in (r["table"], r["layer"], r["state"]) if b)
    if arch != "mamba2-1.3b":
        assert r["layer"] == 8 * 2 * (32 if arch == "mixtral-8x7b"
                                      else 40) * 64 * 4
    if arch in ("mamba2-1.3b", "zamba2-7b"):     # one layer's SSM state
        assert r["state"] == 8 * 16 * 32 * 16 * 4
    assert r["results"], "no collective: not a sharded trace"
    assert _largest(r["results"]) < bound, sorted(
        r["results"], key=lambda e: -e[1])[:4]
    assert _largest(r["allocs"]) < bound, sorted(
        r["allocs"], key=lambda e: -e[1])[:4]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_trace_pins_the_stream(traced, arch):
    """At every block boundary the decode stream leaves on its batch
    shards, whole on the model axis, and none arrives ``Partial``."""
    r = traced[arch]["residuals"]
    assert set(r["pinned"]) == {"S(0),R"}, r
    assert not any("P(" in k for k in r["arrived"]), r
