"""The port's sharding rules (``distributed/sharding.py``) and step
shardings (``launch/steps.py``) held to the reference's, on the CPU.

* ``spec_for_axes`` / ``tree_pspecs`` equal the reference's for every
  registry arch's full-size parameter and cache specs on the (16, 16),
  (2, 16, 16), (4, 2) and (1, 1) meshes (both take a mesh by its axis
  names and extents, so plain stand-ins serve);
* ``param``, ``cache``, ``opt_state`` (with and without ``zero1``),
  ``accum`` and ``batch`` shardings equal the reference's
  ``NamedSharding`` specs entry for entry, the reference's computed on
  512 forced host devices in a subprocess;
* ``placements`` unit cases;
* in one subprocess with 8 forced host devices and a fake torch group of
  8 ranks, every parameter leaf's local shard shape on a (4, 2) mesh
  equals the reference's ``NamedSharding.shard_shape``.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as ref_registry
from repro.configs.base import INPUT_SHAPES as RSH
from repro.distributed import sharding as rsh
from repro.launch import steps as RSt
from repro.models import transformer as RT
from repro.models.module import logical_axes as ref_axes
from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES as TSH
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps as St
from repro_torch.models import transformer as T
from repro_torch.models.module import abstract_params, logical_axes
from repro_torch.optim import optimizers as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
ARCHS = registry.all_archs()


def _tmesh(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


def _rmesh(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=types.SimpleNamespace(shape=shape))


def _as_lists(tree):
    """A tree of specs (tuples, PartitionSpecs or NamedShardings) as
    JSON-like nested lists, entries None, a name or a list of names."""
    if isinstance(tree, dict):
        return {k: _as_lists(v) for k, v in tree.items()}
    spec = getattr(tree, "spec", tree)
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def test_arch_lists_match():
    assert ARCHS == ref_registry.all_archs()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_pspecs_match_reference(arch, mesh):
    tc, rc = registry.get_config(arch), ref_registry.get_config(arch)
    ts, rs = T.specs(tc), RT.specs(rc)
    got = sh.tree_pspecs(logical_axes(ts), ts, _tmesh(mesh))
    want = rsh.tree_pspecs(ref_axes(rs), rs, _rmesh(mesh))
    assert _as_lists(got) == _as_lists(want)
    for shape_name in ("decode_32k", "long_500k"):
        B, S = RSH[shape_name].global_batch, RSH[shape_name].seq_len
        tcs = T.init_cache_specs(St.config_for_shape(tc, TSH[shape_name]),
                                 B, S)
        rcs = RT.init_cache_specs(RSt.config_for_shape(rc, RSH[shape_name]),
                                  B, S)
        assert _as_lists(sh.tree_pspecs(logical_axes(tcs), tcs,
                                        _tmesh(mesh))) == \
            _as_lists(rsh.tree_pspecs(ref_axes(rcs), rcs, _rmesh(mesh)))


def test_spec_for_axes_cases():
    m = _tmesh("2x16x16")
    assert sh.spec_for_axes(("batch", None), (64, 3), m) == \
        (("pod", "data"), None)
    assert sh.spec_for_axes(("batch",), (48,), m) == (None,)  # 48 % 32
    assert sh.spec_for_axes(("vocab", "embed"), (32, 8), m) == ("model",
                                                               None)
    assert sh.spec_for_axes(("nope", None), (16, 16), m) == (None, None)
    assert sh.batch_spec(m) == (("pod", "data"),)
    assert sh.batch_spec(_tmesh("4x2")) == ("data",)
    assert sh.data_axis_size(m) == 32 and sh.data_axis_size(
        types.SimpleNamespace(mesh_dim_names=("model",), shape=(4,))) == 1


def test_placements_cases():
    m2 = _tmesh("4x2")
    assert sh.placements(("data", None), m2) == (Shard(0), Replicate())
    assert sh.placements((None, "model"), m2) == (Replicate(), Shard(1))
    assert sh.placements(("data", "model"), m2) == (Shard(0), Shard(1))
    assert sh.placements((), m2) == (Replicate(), Replicate())
    assert sh.placements((None, None, None), m2) == (Replicate(),
                                                     Replicate())
    m3 = _tmesh("2x16x16")
    assert sh.placements((("pod", "data"), "model"), m3) == \
        (Shard(0), Shard(0), Shard(1))
    assert sh.placements((None, ("pod", "data")), m3) == \
        (Shard(1), Shard(1), Replicate())
    with pytest.raises(ValueError, match="shards two dims"):
        sh.placements(("data", "data"), m2)
    with pytest.raises(ValueError, match="lacks"):
        sh.placements(("pod",), m2)
    ns = sh.NamedSharding(m2, ("data", None))
    assert ns.placements == (Shard(0), Replicate())


def _run(code: str, devices: int) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout.strip().splitlines()[-1]


REF_SHARDINGS = """
    import json
    import jax
    from repro.configs.base import INPUT_SHAPES
    from repro.configs.registry import all_archs, get_config
    from repro.launch import steps as St
    from repro.models import transformer as T
    from repro.models.module import abstract_params
    from repro.optim import optimizers as opt_lib

    MESHES = {MESHES}

    def lists(tree):
        return jax.tree_util.tree_map(
            lambda s: [list(e) if isinstance(e, tuple) else e
                       for e in tuple(s.spec)], tree,
            is_leaf=lambda x: hasattr(x, "spec"))

    out = {{}}
    for mname, (shape, names) in MESHES.items():
        mesh = jax.make_mesh(shape, names)
        for arch in all_archs():
            cfg0 = get_config(arch)
            row = out.setdefault(mname, {{}}).setdefault(arch, {{}})
            cfg = St.config_for_shape(cfg0, INPUT_SHAPES["train_4k"])
            ps = St.param_shardings(cfg, mesh)
            ap = abstract_params(T.specs(cfg))
            aopt = jax.eval_shape(opt_lib.get_optimizer("adamw", 1e-4).init,
                                  ap)
            row["param"] = lists(ps)
            row["opt"] = lists(St.opt_state_shardings(aopt, ps, mesh))
            row["opt_zero1"] = lists(St.opt_state_shardings(
                aopt, ps, mesh, zero1=True))
            row["accum"] = lists(St.accum_shardings(ap, ps, mesh))
            for sname, shp in INPUT_SHAPES.items():
                c = St.config_for_shape(cfg0, shp)
                ios = St.input_specs(c, shp)
                if shp.kind == "decode":
                    row["batch_" + sname] = lists(St.batch_shardings(
                        ios["batch"], mesh))
                    row["cache_" + sname] = lists(St.cache_shardings(
                        c, shp.global_batch, shp.seq_len, mesh))
                else:
                    row["batch_" + sname] = lists(St.batch_shardings(ios,
                                                                     mesh))
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_shardings():
    code = REF_SHARDINGS.format(MESHES=repr(MESHES))
    return json.loads(_run(code, 512))


def _port_shardings(mesh_name, arch):
    mesh = _tmesh(mesh_name)
    cfg0 = registry.get_config(arch)
    cfg = St.config_for_shape(cfg0, TSH["train_4k"])
    ps = St.param_shardings(cfg, mesh)
    ap = abstract_params(T.specs(cfg))
    aopt = topt.get_optimizer("adamw", 1e-4).init(ap)
    row = {"param": ps, "opt": St.opt_state_shardings(aopt, ps, mesh),
           "opt_zero1": St.opt_state_shardings(aopt, ps, mesh, zero1=True),
           "accum": St.accum_shardings(ap, ps, mesh)}
    for sname, shp in TSH.items():
        c = St.config_for_shape(cfg0, shp)
        ios = St.input_specs(c, shp)
        if shp.kind == "decode":
            row["batch_" + sname] = St.batch_shardings(ios["batch"], mesh)
            row["cache_" + sname] = St.cache_shardings(
                c, shp.global_batch, shp.seq_len, mesh)
        else:
            row["batch_" + sname] = St.batch_shardings(ios, mesh)
    return {k: _as_lists(v) for k, v in row.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_shardings_match_reference(ref_shardings, arch, mesh):
    got = _port_shardings(mesh, arch)
    want = ref_shardings[mesh][arch]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def test_input_specs_match_reference():
    """Shapes equal the reference's ``ShapeDtypeStruct``s; dtypes are the
    port's (float32 activations, int32 tokens, labels and route)."""
    import jax

    for arch in ARCHS:
        for sname in TSH:
            tc = registry.get_config(arch)
            rc = ref_registry.get_config(arch)
            got = St.input_specs(tc, TSH[sname])
            want = RSt.input_specs(rc, RSH[sname])
            gl = topt.tree_leaves(got)
            wl = jax.tree_util.tree_leaves(want)
            assert [tuple(t.shape) for t in gl] == \
                [tuple(w.shape) for w in wl], (arch, sname)
            assert all(t.device.type == "meta" for t in gl)
            for t, w in zip(gl, wl):
                if str(w.dtype) == "int32":
                    assert t.dtype == torch.int32


SHARD_SHAPES = """
    import json, math
    import jax
    import torch
    from jax.sharding import NamedSharding
    from torch.distributed.tensor import distribute_tensor
    from repro.configs.registry import get_config as rget
    from repro.launch import steps as RSt
    from repro_torch.configs.registry import all_archs, get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.models.module import abstract_params, leaves
    from repro_torch.optim import optimizers as topt

    mesh_lib.init_fake_process_group(8)
    tmesh = mesh_lib.make_host_mesh(4, 2, device="cpu")
    rmesh = jax.make_mesh((4, 2), ("data", "model"))
    bad, n = [], 0
    for arch in all_archs():
        for smoke in (False, True):
            tc, rc = get_config(arch, smoke=smoke), rget(arch, smoke=smoke)
            tsh = topt.tree_leaves(St.param_shardings(tc, tmesh))
            rsh = jax.tree_util.tree_leaves(
                RSt.param_shardings(rc, rmesh),
                is_leaf=lambda x: isinstance(x, NamedSharding))
            for (path, spec), ts, rs in zip(leaves(T.specs(tc)), tsh, rsh):
                t = torch.empty(spec.shape, device="meta")
                local = tuple(distribute_tensor(t, tmesh, ts.placements)
                              .to_local().shape)
                want = tuple(rs.shard_shape(spec.shape))
                n += 1
                if local != want:
                    bad.append([arch, smoke, path, local, want])
    print(json.dumps({"n": n, "bad": bad}))
"""


def test_local_shard_shapes_match_reference():
    out = json.loads(_run(SHARD_SHAPES, 8))
    assert out["n"] > 200
    assert out["bad"] == []
