"""The SSM decode on its head shards, and the decode stream pinned.

On DTensors ``ssm.ssm_decode`` runs on each model rank's own heads and
the inner columns of those heads (``ssm._decode_on_shards``): z, xs and
dt from the local columns of their weights, B and C whole, the state
update and the readout on the local heads of h, the gated RMSNorm's sum
of squares and ``w_out``'s partial sum all-reduced, h and conv written
in place into the rank's local storage of the stacked cache
(``sharding.layer_view``). ``transformer.decode_step`` passes the stream
through ``seq_shards`` at every block boundary, and the products of a
decode step (S below the model extent) run on local tensors
(``sharding.stream_product``).

* (a) on plain tensors ``ssm_decode`` and ``decode_step`` are bit for
  bit the former code (copied below; its ``even_shards`` and
  ``gather_dims`` calls were the identity on plain tensors and are left
  out): the output and the cache of one step, and the logits and every
  cache leaf after every token of a greedy decode, for mamba2, zamba2,
  one dense smoke config and mamba2 with 3 SSD heads;
* (b) on a (2, 2) gloo world (data, model), mamba2's smoke config, and
  the same with 3 heads (``d_model`` 96, ``ssm_headdim`` 64: 3 heads do
  not divide the model axis, so the heads and h are whole on every rank
  and the 192 inner columns sharded), decode 8 tokens from a cache that
  the plain path prefilled with 6 prompt tokens, beside the plain decode
  on the same inputs, in float64 and float32. At every token the tokens
  are equal, the cache returned is the one passed in, its local
  storages are the ones it had (the in-place writes land there), and h
  and conv are the plain path's: in float64 within 1e-12 of their
  max|.| (observed at most 2.0e-15), the logits too (1.7e-15); in
  float32 the logits within 2e-6 of max|logit| (observed at most
  8.5e-7) and h and conv within 1e-5 (observed at most 6.9e-7). The
  former decode (DTensor's own ops around ``even_shards`` and
  ``gather_dims``, and ``cache["h"][i].copy_(h)`` through DTensor)
  passes (b) as well: its values held (float32 logits 1.4e-6, state
  1.1e-6, float64 2.0e-15), and its plan differed between torch
  versions only;
* (c) the float32 decode of (b) on DTensors against the reference's
  ``decode_step`` (jax, CPU) from the same parameters and prompt, fed
  the same tokens: the logits within 1e-4 of max|logit|, its greedy
  tokens equal.

The decode traces on a fake mesh (the SSM state bound, the stream
pinned) are in ``tests/test_torch_decode_shards.py``.
"""
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.module import init_params
from test_torch_decode_shards import _flat, _run
from test_torch_moe_sharded import _same_bits

# (arch, config overrides)
PLAIN = [("mamba2-1.3b", {}), ("zamba2-7b", {}), ("minitron-4b", {}),
         ("mamba2-1.3b", {"d_model": 96, "ssm_headdim": 64})]
SSM = [c for c in PLAIN if c[0] != "minitron-4b"]
GLOO_CASES = [{}, {"d_model": 96, "ssm_headdim": 64}]
B, P, N = 4, 6, 8


def _ids(case):
    return f"{case[0]}:{json.dumps(case[1], sort_keys=True)}"


def _key(kw):
    return json.dumps(kw, sort_keys=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the former code, on plain tensors ----------------------------------------

def _former_ssm_decode(x, p, cfg, cache):
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    xt = x[:, 0]
    z = xt @ p["w_z"]
    xs = xt @ p["w_x"]
    Bm = L.upcast(xt @ p["w_B"])
    Cm = L.upcast(xt @ p["w_C"])
    dt = xt @ p["w_dt"]
    hist = torch.cat([cache["conv"], xs[:, None, :]], dim=1)
    xs = torch.einsum("bki,ik->bi", hist, p["conv_w"]) + p["conv_b"]
    xs = F.silu(L.upcast(xs)).to(x.dtype)
    dt = F.softplus(L.upcast(dt) + p["dt_bias"])
    A = -torch.exp(L.upcast(p["A_log"]))
    decay = torch.exp(dt * A)
    xh = L.upcast(xs.reshape(B, H, P))
    h = (cache["h"] * decay[:, :, None, None]
         + (dt[:, :, None] * xh)[..., None] * Bm[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, Cm)
    y = y + p["D_skip"][None, :, None] * xh
    y = y.reshape(B, H * P).to(x.dtype)
    y = L.rmsnorm(y * F.silu(L.upcast(z)).to(y.dtype), p["norm"])
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:, :])
    return (y @ p["w_out"])[:, None, :], cache


def _former_ssm_decode_block(x, params, cache, i, cfg):
    lp = T._layer(params["blocks"], i)
    h, _ = _former_ssm_decode(T._norm(x, lp["ln"], cfg), lp["ssm"], cfg,
                              {"h": cache["h"][i], "conv": cache["conv"][i]})
    return x + h


def _former_attn_mlp_decode(x, lp, cfg, cache, pos, window):
    h, _ = L.decode_attention(T._norm(x, lp["ln1"], cfg), lp["attn"], cfg,
                              cache, pos, window=window)
    x = x + h
    if cfg.num_experts:
        h, _ = T.M.moe_apply(T._norm(x, lp["ln2"], cfg), lp["moe"], cfg)
    else:
        h = L.mlp_apply(T._norm(x, lp["ln2"], cfg), lp["mlp"], cfg)
    return x + h


def _former_decode_step(params, cache, batch, pos, cfg):
    window = cfg.sliding_window
    x = L.embed_tokens(batch["tokens"], params["embed"], cfg)
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _former_ssm_decode_block(x, params, cache, i, cfg)
    elif cfg.family == "hybrid":
        g, per = T.hybrid_shape(cfg)
        for gi in range(g):
            for j in range(per):
                x = _former_ssm_decode_block(x, params, cache, gi * per + j,
                                             cfg)
            x = _former_attn_mlp_decode(x, params["shared"], cfg,
                                        T._layer(cache["attn"], gi), pos,
                                        window)
    else:
        for i in range(cfg.num_layers):
            x = _former_attn_mlp_decode(x, T._layer(params["blocks"], i),
                                        cfg, T._layer(cache, i), pos, window)
    x = T._norm(x, params["ln_f"], cfg)
    return L.lm_logits(x, params["embed"], cfg), cache


def _config(case):
    arch, kw = case
    return registry.get_config(arch, smoke=True).with_overrides(**kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("case", SSM, ids=_ids)
def test_plain_ssm_decode_is_the_former_form_bitwise(case, dtype):
    cfg = _config(case)
    p = init_params(S.ssm_specs(cfg), seed=3, dtype=dtype)
    rng = np.random.default_rng(4)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)

    x = draw(B, 1, cfg.d_model)
    cache = {"h": draw(B, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
             "conv": draw(B, S.KCONV - 1, cfg.ssm_inner)}
    twin = {k: v.clone() for k, v in cache.items()}
    got, back = S.ssm_decode(x, p, cfg, cache)
    want, _ = _former_ssm_decode(x, p, cfg, twin)
    assert back is cache
    assert _same_bits(got, want)
    assert all(_same_bits(cache[k], twin[k]) for k in cache)


def _decode_run(cfg, step):
    """Greedy decode of P prompt tokens and N more from a zero cache by
    ``step``: the logits of every step and the cache after each."""
    params = init_params(T.specs(cfg), seed=1)
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P)).astype(
        np.int32))
    cache = init_params(T.init_cache_specs(cfg, B, P + N))
    logits, caches = [], []
    nxt = tok[:, :1]
    for i in range(P + N):
        nxt = tok[:, i:i + 1] if i < P else nxt
        lg, cache = step(params, cache, {"tokens": nxt}, i, cfg)
        logits.append(lg)
        caches.append({k: v.clone() for k, v in _flat(cache).items()})
        nxt = lg[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
    return logits, caches


@pytest.mark.parametrize("case", PLAIN, ids=_ids)
def test_plain_decode_step_is_the_former_form_bitwise(case):
    cfg = _config(case)
    got = _decode_run(cfg, T.decode_step)
    want = _decode_run(cfg, _former_decode_step)
    for (gl, gc), (wl, wc) in zip(zip(*got), zip(*want)):
        assert _same_bits(gl, wl)
        assert gc.keys() == wc.keys()
        assert all(_same_bits(gc[k], wc[k]) for k in gc), [
            k for k in gc if not _same_bits(gc[k], wc[k])]


GLOO = r'''
import json, os, socket
import numpy as np
import torch
import torch.multiprocessing as mp

B, P, N = %d, %d, %d
CASES = %s


def work(rank, port, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params
    from repro_torch.optim import optimizers as topt

    mesh = mesh_lib.make_host_mesh(2, 2, device="cpu")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    res, arrays = {}, {}
    for kw in CASES:
        key = json.dumps(kw, sort_keys=True)
        cfg = registry.get_config("mamba2-1.3b", smoke=True).with_overrides(
            **kw)
        for dtype in (torch.float32, torch.float64):
            params = init_params(T.specs(cfg), seed=1, dtype=dtype)
            rng = np.random.default_rng(2)
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, P)).astype(np.int32))
            cache = init_params(T.init_cache_specs(cfg, B, P + N),
                                dtype=dtype)
            cache["h"] = cache["h"].to(dtype)      # its spec says float32
            for i in range(P):                     # the plain path prefills
                lg, cache = T.decode_step(params, cache,
                                          {"tokens": prompt[:, i:i + 1]}, i,
                                          cfg)
            tok = lg[:, -1, :cfg.vocab_size].argmax(-1).to(
                torch.int32)[:, None]
            dparams = topt.tree_map(
                lambda t, s: distribute_tensor(t, mesh, s.placements),
                params, St.param_shardings(cfg, mesh))
            dcache = topt.tree_map(
                lambda t, s: distribute_tensor(t.clone(), mesh,
                                               s.placements), cache,
                St.cache_shardings(cfg, B, P + N, mesh))
            ptrs = {k: v.to_local().data_ptr() for k, v in dcache.items()}
            place = St.batch_shardings({"tokens": tok}, mesh)["tokens"]
            r = {"logits": [], "toks": [], "h": [], "conv": [], "same": [],
                 "storage": [],
                 "heads_sharded": any(isinstance(q, Shard) and q.dim == 2
                                      for q in dcache["h"].placements),
                 "inner_sharded": any(isinstance(q, Shard) and q.dim == 3
                                      for q in dcache["conv"].placements)}
            tok0 = tok
            dlogits, dtoks = [], []
            for j in range(N):
                pos = P + j
                lg, cache = T.decode_step(params, cache, {"tokens": tok}, pos,
                                          cfg)
                dlg, back = T.decode_step(
                    dparams, dcache, {"tokens": distribute_tensor(
                        tok, mesh, place.placements)}, pos, cfg)
                r["same"].append(back is dcache and all(
                    back[k] is dcache[k] for k in dcache))
                r["storage"].append(all(
                    dcache[k].to_local().data_ptr() == ptrs[k]
                    for k in dcache))
                dlg = dlg.full_tensor()
                r["logits"].append(rel(dlg, lg))
                want = lg[:, -1, :cfg.vocab_size].argmax(-1)
                got = dlg[:, -1, :cfg.vocab_size].argmax(-1)
                r["toks"].append(bool(torch.equal(want, got)))
                for k in ("h", "conv"):
                    r[k].append(rel(dcache[k].full_tensor(), cache[k]))
                dlogits.append(dlg)
                dtoks.append(got)
                tok = want.to(torch.int32)[:, None]
            res[key + ":" + str(dtype)[6:]] = r
            if dtype == torch.float32:
                arrays[key] = {"params": params, "prompt": prompt,
                               "tok0": tok0,
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
    script.write_text(GLOO % (B, P, N, repr(GLOO_CASES)))
    return _run([str(script)], timeout=300)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kw", GLOO_CASES, ids=_key)
def test_ssm_decode_on_head_shards_of_a_gloo_world(gloo, kw, dtype):
    for r in (g[_key(kw) + ":" + dtype] for g in gloo["res"]):
        assert len(r["toks"]) == N and all(r["toks"])
        assert all(r["same"]) and all(r["storage"])
        # 16 heads divide the model axis; 3 do not, their 192 columns do
        assert r["heads_sharded"] == (kw == {}) and r["inner_sharded"]
        if dtype == "float64":
            assert max(r["logits"] + r["h"] + r["conv"]) <= 1e-12, r
        else:
            assert max(r["logits"]) <= 2e-6, r["logits"]
            assert max(r["h"] + r["conv"]) <= 1e-5, (r["h"], r["conv"])


@pytest.mark.parametrize("kw", GLOO_CASES, ids=_key)
def test_ssm_decode_on_shards_matches_the_reference(gloo, kw):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import registry as ref_registry
    from repro.models import module as ref_module
    from repro.models import transformer as RT

    a = torch.load(gloo["path"] + ".pt")[_key(kw)]
    rc = ref_registry.get_config("mamba2-1.3b", smoke=True).with_overrides(
        **kw)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                a["params"])
    cache = ref_module.init_params(RT.init_cache_specs(rc, B, P + N),
                                   jax.random.PRNGKey(0), jnp.float32)
    step = jax.jit(lambda p, c, t, i: RT.decode_step(p, c, {"tokens": t}, i,
                                                     rc))
    prompt = a["prompt"].numpy()
    for i in range(P):
        lg, cache = step(jp, cache, jnp.asarray(prompt[:, i:i + 1]), i)
    tok = a["tok0"].numpy()
    for j in range(N):
        np.testing.assert_array_equal(
            np.asarray(lg)[:, -1, :rc.vocab_size].argmax(-1), tok[:, 0])
        lg, cache = step(jp, cache, jnp.asarray(tok), P + j)
        want = np.asarray(lg)[:, -1]
        np.testing.assert_allclose(a["logits"][:, j].numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
        tok = a["toks"][:, j:j + 1].numpy().astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(lg)[:, -1, :rc.vocab_size].argmax(-1), tok[:, 0])
