"""The MoE dispatch on its group and expert shards.

``moe.moe_apply`` on a DTensor runs ``moe._on_shards``: the router on
the tokens' own shards, the (G, Tg, D) groups on the batch axes as far
as G divides, the experts (olmoe) or the expert hidden dim (mixtral) on
the model axis, the capacity slots on every other mesh dim, each rank's
dispatch, products and combine on its local tensors, the output
``Partial`` on every dim but the groups'. On plain tensors it is the
former code.

* (a) on plain tensors the output, the aux loss and every leaf's
  gradient are bit for bit the former form (copied below as
  ``_former_moe_apply``; its ``pin`` and ``gather_dims`` calls were the
  identity on plain tensors and are left out), over the cases of
  ``tests/test_torch_moe.py``: G in {1, 2, 3, 4, 5}, padded experts,
  capacity drops;
* (b) on a (2, 2) gloo world (data, model), the olmoe and mixtral smoke
  layers at G in {1, 2, 4}, with capacity drops and padded experts too,
  on x placed as the residual stream (Shard(0), Shard(1)) and weights
  placed by the sharding rules, against the plain layer on the whole
  inputs: each rank's expert ids, positions and kept flags equal to its
  groups' rows of the plain routing, the output within 1e-6 of max|out|,
  the aux loss within 1e-6, the input's and every weight's gradient
  within 1e-6 of the leaf's max|g|. Observed: output 0 (olmoe) and at
  most 8.3e-8 (mixtral), aux at most 1.2e-7, gradients at most 5.2e-7
  (x's and the router's, their sums split over the ranks);
* (c) a smoke ``train_4k`` step (global batch 8, 64 tokens) traced on
  the (4, 2) fake mesh of ``tests/test_torch_dryrun.py`` with
  ``moe_groups`` in {1, 4, 8}: every case traces (G = 8 failed before:
  a view of the (G, Tg) split), no rank allocates a storage of the
  global dispatch buffer's bytes (G·E·C·D·4, or one more row), and each
  rank allocates its local (G_l·E_l·C_l, D) buffer: a quarter of the
  global groups or capacity times half the experts (olmoe), or the
  experts whole on their hidden shards (mixtral). d_ff is 384, so that
  no expert product has the buffer's bytes (at the smoke config's 512,
  olmoe's (2, 320, 512) product did at G = 1);
* (d) the gathered outputs and gradients of (b) against the reference's
  ``moe_apply`` on the same inputs, within ``tests/test_torch_moe.py``'s
  tolerances (output 2e-5 of max|out|, aux 1e-6, gradients 1e-5 of each
  leaf's max|g|).
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
from repro_torch.models import moe as M
from repro_torch.models.layers import upcast
from repro_torch.models.module import init_params
from repro_torch.optim import optimizers as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _former_moe_apply(x, p, cfg):
    """``moe_apply`` as it was, on plain tensors."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    Ep = M._padded_experts(cfg)
    T = B * S
    G = max(int(getattr(cfg, "moe_groups", 1) or 1), 1)
    if T % G:
        G = 1
    Tg = T // G
    C = M.expert_capacity(Tg, cfg)
    xt = x.reshape(G, Tg, D)
    probs = torch.softmax(upcast(xt) @ upcast(p["router"]), dim=-1)
    gate, eids = M.top_k(probs, k)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    flat_e = eids.reshape(G, Tg * k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1,
                       2, flat_e[..., None])[..., 0]
    keep = pos < C
    pos_c = torch.where(keep, pos, 0)
    e_c = torch.where(keep, flat_e, 0)
    g_off = torch.arange(G, device=x.device)[:, None] * Ep
    slot = (g_off + e_c) * C + pos_c
    dest = torch.where(keep, slot, G * Ep * C).reshape(-1)
    x_rep = xt.repeat_interleave(k, dim=1).reshape(G * Tg * k, D)
    rows = x.new_zeros((G * Ep * C + 1, D)).index_put((dest,), x_rep)
    buf = rows[:-1].view(G, Ep, C, D)
    g = torch.einsum("gecd,edf->gecf", buf, p["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    h = F.silu(upcast(g)).to(x.dtype) * u
    out_e = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    flat_out = out_e.reshape(G * Ep * C, D)
    out_tk = flat_out[slot.reshape(-1)].view(G, Tg * k, D)
    out_tk = out_tk * (keep[..., None]
                       * gate.reshape(G, Tg * k)[..., None]).to(x.dtype)
    out = out_tk.view(G, Tg, k, D).sum(dim=2)
    frac_tokens = F.one_hot(eids, E).sum(dim=2).reshape(T, E) \
        .to(probs.dtype).mean(dim=0) / k
    frac_probs = probs.reshape(T, E).mean(dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return out.reshape(B, S, D), aux


def _same_bits(a, b):
    """Equal dtypes, shapes and bits (a signed zero included)."""
    def bits(t):
        t = t.detach().contiguous()
        return t.view({torch.float32: torch.int32,
                       torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(bits(a), bits(b))


PLAIN = [
    dict(capacity_factor=0.25), dict(capacity_factor=1.25),
    dict(capacity_factor=8.0),
    dict(capacity_factor=1.25, moe_groups=2),
    dict(capacity_factor=0.25, moe_groups=4),
    dict(capacity_factor=1.25, moe_groups=3),
    dict(capacity_factor=1.25, moe_groups=5),        # 48 % 5: one group
    dict(capacity_factor=1.25, moe_pad_experts=8),
    dict(capacity_factor=0.25, moe_groups=2, moe_pad_experts=8),
]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
@pytest.mark.parametrize("overrides", PLAIN)
def test_plain_moe_apply_is_the_former_form_bitwise(arch, overrides):
    cfg = registry.get_config(arch, smoke=True).with_overrides(**overrides)
    p = init_params(M.moe_specs(cfg), seed=2)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 16, cfg.d_model)).astype(
        np.float32))
    cot = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    res = []
    for fn in (M.moe_apply, _former_moe_apply):
        leaves = {"x": x.clone().requires_grad_(True),
                  **{k: v.clone().requires_grad_(True) for k, v in p.items()}}

        def f(lv):
            out, aux = fn(lv["x"], {k: v for k, v in lv.items() if k != "x"},
                          cfg)
            return torch.sum(out * cot) + aux, (out.detach(), aux.detach())
        (_, (out, aux)), grads = topt.value_and_grad(f, leaves)
        res.append((out, aux, grads))
    (out, aux, grads), (w_out, w_aux, w_grads) = res
    assert _same_bits(out, w_out) and _same_bits(aux, w_aux)
    assert sorted(grads) == sorted(w_grads) == sorted(["x", *p])
    assert all(_same_bits(grads[k], w_grads[k]) for k in grads), \
        [k for k in grads if not _same_bits(grads[k], w_grads[k])]
    if overrides["capacity_factor"] < 1:
        C = M.expert_capacity(48 // (overrides.get("moe_groups") or 1), cfg)
        _, _, _, _, keep = M.route(
            x.reshape(overrides.get("moe_groups") or 1, -1, cfg.d_model),
            p["router"], cfg, C)
        assert not keep.all()                    # the case drops tokens


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, env=env, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


# (arch, moe_groups, config overrides) of the gloo cases
GLOO_CASES = [(a, g, {}) for a in ("olmoe-1b-7b", "mixtral-8x7b")
              for g in (1, 2, 4)] + [
    ("olmoe-1b-7b", 2, {"capacity_factor": 0.5}),
    ("mixtral-8x7b", 1, {"capacity_factor": 0.5}),
    ("olmoe-1b-7b", 4, {"moe_pad_experts": 8}),
]
B, S = 4, 16

GLOO = r'''
import json, os, socket, sys
import numpy as np
import torch
import torch.multiprocessing as mp

B, S = %d, %d
CASES = %s


def work(rank, port, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe as M
    from repro_torch.models.module import init_params, logical_axes

    mesh = mesh_lib.make_host_mesh(2, 2, device="cpu")
    d = mesh.get_local_rank("data")
    res, arrays = {}, {}
    for arch, G, kw in CASES:
        key = f"{arch}:{G}:{json.dumps(kw, sort_keys=True)}"
        cfg = registry.get_config(arch, smoke=True).with_overrides(
            moe_groups=G, **kw)
        specs = M.moe_specs(cfg)
        p = init_params(specs, seed=5)
        rng = np.random.default_rng(G)
        x = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
        cot = torch.from_numpy(rng.standard_normal(x.shape).astype(
            np.float32))
        # the plain layer on the whole inputs
        xp = x.clone().requires_grad_(True)
        pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        want, want_aux = M.moe_apply(xp, pp, cfg)
        (torch.sum(want * cot) + want_aux).backward()
        C = M.expert_capacity(B * S // G, cfg)
        _, _, w_eids, w_pos, w_keep = M.route(
            x.reshape(G, -1, cfg.d_model), p["router"], cfg, C)
        w_eids = w_eids.reshape(G, -1)
        # on shards: x as the residual stream, the weights by the rules
        shards = sh.tree_shardings(logical_axes(specs), p, mesh)
        dp = {k: distribute_tensor(v, mesh, shards[k].placements)
              .detach().requires_grad_(True) for k, v in p.items()}
        dx = distribute_tensor(x, mesh, [Shard(0), Shard(1)]) \
            .detach().requires_grad_(True)
        seen, real = [], M._positions

        def spy(flat_e, *a):
            r = real(flat_e, *a)
            seen.append((flat_e, *r))
            return r
        M._positions = spy
        try:
            got, aux = M.moe_apply(dx, dp, cfg)
        finally:
            M._positions = real
        dcot = distribute_tensor(cot, mesh, [Shard(0), Shard(1)])
        (torch.sum(got * dcot) + aux).backward()
        (eids, pos, keep), = seen
        out_placements = [type(q).__name__ for q in got.placements]
        gl = eids.shape[0]
        g0 = d * gl if gl < G else 0
        same = (torch.equal(eids, w_eids[g0:g0 + gl])
                and torch.equal(pos, w_pos[g0:g0 + gl])
                and torch.equal(keep, w_keep[g0:g0 + gl]))
        got = got.full_tensor().detach()
        aux = aux.full_tensor().detach()
        grads = {"x": (dx.grad.full_tensor(), xp.grad)}
        grads.update({k: (dp[k].grad.full_tensor(), pp[k].grad) for k in p})
        res[key] = {
            "route": bool(same), "groups_local": gl,
            "dropped": int((~w_keep).sum()),
            "placements": [type(q).__name__ for q in dx.grad.placements],
            "out_placements": out_placements,
            "out": float((got - want).abs().max() / want.abs().max()),
            "aux": float((aux - want_aux).abs()),
            "grads": {k: float((a - b).abs().max() / b.abs().max())
                      for k, (a, b) in grads.items()},
            "zero_pad": [bool(not a[cfg.num_experts:].any())
                         for n, (a, _) in grads.items() if n.startswith("w_")
                         and kw.get("moe_pad_experts")]}
        arrays[key] = {"x": x, "cot": cot, "out": got, "aux": aux,
                       **{"g_" + k: a for k, (a, _) in grads.items()},
                       **{"p_" + k: v for k, v in p.items()}}
    allr = [None] * 4
    dist.all_gather_object(allr, res)
    if rank == 0:
        for key in res:
            res[key]["route"] = all(r[key]["route"] for r in allr)
        torch.save(arrays, out + ".pt")
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
    mp.spawn(work, args=(port, out), nprocs=4)
    print(json.dumps({"path": out, "res": json.load(open(out))}))
'''


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    script = tmp_path_factory.mktemp("gloo") / "work.py"
    script.write_text(GLOO % (B, S, repr(GLOO_CASES)))
    return _run([str(script)], timeout=300)


def _key(arch, G, kw):
    return f"{arch}:{G}:{json.dumps(kw, sort_keys=True)}"


@pytest.mark.parametrize("arch,G,kw", GLOO_CASES)
def test_dispatch_on_shards_of_a_gloo_world(gloo, arch, G, kw):
    r = gloo["res"][_key(arch, G, kw)]
    assert r["route"]
    # G whole groups per data rank where 2 divides G, else all of them
    assert r["groups_local"] == (G // 2 if G % 2 == 0 else G)
    assert r["out_placements"] == (["Shard", "Partial"] if G % 2 == 0
                                   else ["Partial", "Partial"])
    assert r["placements"] == ["Shard", "Shard"]
    assert r["out"] <= 1e-6 and r["aux"] <= 1e-6
    assert sorted(r["grads"]) == ["router", "w_down", "w_gate", "w_up", "x"]
    assert all(v <= 1e-6 for v in r["grads"].values()), r["grads"]
    if kw.get("capacity_factor", 1.25) < 1:
        assert r["dropped"] > 0
    if kw.get("moe_pad_experts"):
        assert r["zero_pad"] == [True] * 3


@pytest.mark.parametrize("arch,G,kw", GLOO_CASES)
def test_dispatch_on_shards_matches_the_reference(gloo, arch, G, kw):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import registry as ref_registry
    from repro.models import moe as RM

    a = torch.load(gloo["path"] + ".pt")[_key(arch, G, kw)]
    rc = ref_registry.get_config(arch, smoke=True).with_overrides(
        moe_groups=G, **kw)
    jp = {k[2:]: jnp.asarray(v.numpy()) for k, v in a.items()
          if k.startswith("p_")}
    x, cot = jnp.asarray(a["x"].numpy()), a["cot"].numpy()

    def ref_loss(xx, p):
        out, aux = RM.moe_apply(xx, p, rc)
        return jnp.sum(out * cot) + aux, (out, aux)

    (gx, gp), (want, want_aux) = jax.jit(jax.grad(
        ref_loss, argnums=(0, 1), has_aux=True))(x, jp)
    want = np.asarray(want)
    np.testing.assert_allclose(a["out"].numpy(), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))
    assert abs(float(a["aux"]) - float(want_aux)) <= 1e-6
    for name, ref in [("x", gx)] + sorted(gp.items()):
        ref = np.asarray(ref)
        np.testing.assert_allclose(a["g_" + name].numpy(), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()),
                                   err_msg=name)


TRACE = r'''
import dataclasses, json, math
import torch
from torch.distributed.tensor import DTensor
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe as M
from torch.distributed.tensor.experimental import implicit_replication

torch.set_num_threads(1)
mesh_lib.init_fake_process_group(8)
mesh = mesh_lib.make_host_mesh(4, 2, device="cpu")


class Seen(DR.LocalTraffic):
    """LocalTraffic that also keeps each local op's outputs: name, shape
    and storage bytes."""

    def __init__(self):
        super().__init__()
        self.allocs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is NotImplemented or self.inferring
                or any(issubclass(t, DTensor) for t in types)):
            return out
        self.allocs += [[func._overloadpacket.__name__, list(t.shape),
                         t.untyped_storage().nbytes()]
                        for t in DR._tensors(out)]
        return out


shp = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=8,
                          seq_len=64)
res = {}
for arch in ("olmoe-1b-7b", "mixtral-8x7b"):
    for G in (1, 4, 8):
        cfg0 = get_config(arch, smoke=True).with_overrides(d_ff=384)
        key = f"{arch}:{G}"
        try:
            step, args, cfg = DR.build_step(cfg0, shp, mesh,
                                            variant={"moe_groups": G})
            seen = Seen()
            with DR._uncounted_shape_inference(seen), seen, \
                    implicit_replication():
                step(*args)
        except Exception as e:
            res[key] = {"error": f"{type(e).__name__}: {e}"}
            continue
        E, D = cfg.num_experts, cfg.d_model
        C = M.expert_capacity(shp.global_batch * shp.seq_len // G, cfg)
        res[key] = {"G": G, "E": E, "C": C, "D": D,
                    "sizes": sorted({a[2] for a in seen.allocs}),
                    "index": [a[1] for a in seen.allocs
                              if a[0] == "index" and a[1][-1:] == [D]]}
print(json.dumps(res))
'''


@pytest.fixture(scope="module")
def traced():
    return _run(["-c", TRACE], timeout=300)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_train_trace_keeps_the_dispatch_on_shards(traced, arch, G):
    r = traced[f"{arch}:{G}"]
    assert "error" not in r, r
    E, C, D = r["E"], r["C"], r["D"]
    assert G * C == 320                  # the global buffer: 320·E rows
    glob = {G * E * C * D * 4, (G * E * C + 1) * D * 4}
    assert not glob & set(r["sizes"])
    # the local buffer: groups on the 4 data ranks where 4 divides G,
    # else the capacity slots; olmoe's experts on the 2 model ranks
    Gl = max(G // 4, 1)
    Cl = C if G % 4 == 0 else math.ceil(C / 4)
    El = E // 2 if arch == "olmoe-1b-7b" else E
    assert [Gl * El * Cl, D] in r["index"]
    # spread over all 8 ranks, or the 4 data ranks in ffn mode
    assert Gl * El * Cl * (8 if El < E else 4) == G * E * C
