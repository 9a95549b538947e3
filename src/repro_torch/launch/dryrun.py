"""Production dry run: trace every (arch × input shape × mesh) step on
DTensors over a fake process group, on the meta device, and report its
per-device roofline terms.

The torch counterpart of :mod:`repro.launch.dryrun`, which lowers and
compiles each step for 512 placeholder CPU devices. Torch has no HLO to
lower, so here one process makes a fake default group of the mesh's size
(``mesh.init_fake_process_group``: collectives return at once), builds
the production ``DeviceMesh`` on it, distributes meta parameters,
optimizer state, batch and cache by the slice's shardings
(``launch/steps.py``), and runs the step once on them. Nothing touches a
device and nothing is timed but the trace. Sharding mismatches and ops
that DTensor cannot shard surface as errors.

What a row reports, per device:

* ``flops_per_device``: the flops of every aten op DTensor runs on the
  local shards (rank 0's), by ``FlopCounterMode``'s formulas
  (``torch.utils.flop_counter.flop_registry``): what one device
  computes, replicated work included (the reference reads XLA's
  per-device count);
* ``flops_by_op``: that count by aten op (``per_device``), beside the
  op's flops on the global shapes where DTensor ran it (``logical``):
  ``per_device`` · chips / ``logical`` is the op's replication, 1 where
  DTensor split its work over every rank. Ops the port runs on local
  shards itself (attention, the SSD scan) have no ``logical`` share;
* ``bytes_per_device``: every aten op's input and output bytes on the
  local shards, views and allocations left out;
* ``collectives``: the collectives DTensor issued on the local shards
  (``per_op`` counts and result bytes, ``moved_bytes_per_device`` with
  the reference's ring multipliers);
* ``memory``: the local shard bytes of the step's arguments and outputs
  (``argument_size_in_bytes``, ``output_size_in_bytes``), the peak of
  live bytes the step allocated on the local shards
  (``temp_size_in_bytes``), and the argument bytes an output shares,
  such as a decode cache or parameters updated in place
  (``alias_size_in_bytes``, 0 where no output shares one). The peak
  counts every storage an op creates (views and in-place results share
  an input's, and add nothing) from its creation until it dies, the
  step's new outputs and the tensors autograd saves included: an eager
  upper bound, not XLA's fused and rematerialised temporaries, which
  the reference reads from ``compiled.memory_analysis()``. Its
  ``generated_code_size_in_bytes`` has no counterpart here;
* ``compute_s``, ``memory_s``, ``collective_s`` at the H100 constants of
  ``launch/roofline.py``, and the dominant term;
* ``torch``: the torch version that traced it. DTensor's plan changes
  between versions (what it replicates, where it redistributes), so
  rows of different versions are different plans;
* ``residual_placements``: the placements the residual stream arrived
  in at each block boundary (``arrived``) and left in (``pinned``), by
  count, at every call of ``sharding.seq_shards`` (``"S(0),S(1)"``:
  batch shards on the data axis, sequence shards on the model axis):
  where two versions' plans differ, this is where it shows first.

DTensor's shape inference, which runs each new op once on tensors of
the global shapes, counts in none of these.

The plan is DTensor's own sharding propagation, op by op, from the
slice's input shardings, with the port's explicit layouts where DTensor
has no rule or picks differently between torch 2.11 and 2.13: the
residual stream on its batch and sequence shards at every block
boundary (``sharding.seq_shards``), the products that read or write it
as sequence parallelism on local shards (``sharding.stream_product``),
attention and the SSD scan on each rank's batch rows and heads
(``kernels/ops.py``), the MoE dispatch on its groups, experts and
capacity slots (``models/moe.py``), the loss on the vocab shards, the
token lookup on the table's vocab shards (``sharding.vocab_lookup``),
decode attention on the KV cache's sequence shards
(``layers._attend_on_shards``), and buffers gathered and pinned before
a view splits or merges a sharded dim (``distributed/sharding.py``).
The (2, 16, 16) mesh is traced on its (32, 16) flattening
(:func:`check_pod_flattening`).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out build/dryrun.jsonl
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --multi-pod
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import sys
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as St
from repro_torch.models import transformer as T
from repro_torch.models.module import abstract_params, leaves
from repro_torch.optim import optimizers as opt_lib

# collectives by the reference's names, and its bytes-moved-per-device
# multipliers on the result (ring algorithms)
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}
_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "broadcast": 1.0}
# ops that move no bytes: allocations, and bookkeeping of collectives
_NO_TRAFFIC = ("empty", "empty_strided", "_unsafe_view", "wait_tensor",
               "_wrap_tensor_autograd", "detach", "alias", "lift_fresh")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)
    elif isinstance(x, dict):
        for e in x.values():
            yield from _tensors(e)


def _local_bytes(tree) -> int:
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def _storage_sizes(tree) -> dict:
    """Storage key -> bytes of the local tensors of ``tree``, each
    storage once."""
    return {s._cdata: s.nbytes() for s in
            (_local(t).untyped_storage() for t in _tensors(tree))}


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


class LocalTraffic(TorchDispatchMode):
    """The ops DTensor runs on the local shards: their flops (the flop
    counter's formulas), their input and output bytes (views and
    allocations left out), the collectives with their result bytes, and
    the peak of live bytes the ops allocated (``peak_bytes``). An op on
    DTensors has its flops on the global shapes counted as ``logical``
    and is passed on (NotImplemented), so that this mode sees what
    DTensor turns it into.

    Live bytes are kept by storage, not by tensor: a view keeps its
    base's storage alive after the base tensor is gone. An output whose
    storage is an input's (a view, an in-place op) or already counted
    adds nothing; a new storage counts from its op until Python frees
    it (a weak reference's finalizer)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.per_op: dict[str, dict] = {}
        self.flops_by_op: dict[str, dict] = {}
        self._live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.inferring = 0          # > 0 inside DTensor's shape inference
        self.residuals: dict[str, dict] = {}

    def _drop(self, key) -> None:
        self.live_bytes -= self._live.pop(key)

    def _track(self, args, kwargs, out) -> None:
        """Count ``out``'s new storages as live until they die."""
        seen = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            seen.add(key)
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._drop, key).atexit = False

    def _op_flops(self, name) -> dict:
        return self.flops_by_op.setdefault(name, {"per_device": 0,
                                                  "logical": 0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        if any(issubclass(t, DTensor) for t in types):
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                # the products' formulas read the operands' (global)
                # shapes only; the output is not known yet
                self._op_flops(name)["logical"] += count(*args, **kwargs,
                                                         out_val=None)
            return NotImplemented
        out = func(*args, **kwargs)
        if self.inferring or any(isinstance(t, FakeTensor)
                                 for t in _tensors((args, kwargs))):
            return out      # DTensor's shape inference on global shapes
        self._track(args, kwargs, out)
        if name in _COLLECTIVES:
            d = self.per_op.setdefault(_COLLECTIVES[name],
                                       {"count": 0, "result_bytes": 0})
            d["count"] += 1
            d["result_bytes"] += sum(_nbytes(t) for t in _tensors(out))
        elif not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                n = count(*args, **kwargs, out_val=out)
                self.flops += n
                self._op_flops(name)["per_device"] += n
        return out

    def collectives(self) -> dict:
        moved = sum(_MULT[op] * d["result_bytes"]
                    for op, d in self.per_op.items())
        return {"per_op": self.per_op, "moved_bytes_per_device": moved}


def count_params(cfg) -> tuple[int, int]:
    """(total, active): active discounts MoE experts by topk/E."""
    total = active = 0
    for path, s in leaves(T.specs(cfg)):
        n = math.prod(s.shape)
        total += n
        if "moe" in path and "router" not in path and cfg.num_experts:
            active += n * cfg.experts_per_token // cfg.num_experts
        else:
            active += n
    return total, active


def _distribute(tree, shards):
    return opt_lib.tree_map(
        lambda t, s: distribute_tensor(t, s.mesh, s.placements), tree,
        shards)


def build_step(cfg0, shape, mesh, optimizer="adamw",
               variant: dict | None = None):
    """(step, args, cfg): the step of ``shape``'s kind for config
    ``cfg0`` and its arguments as DTensors on ``mesh``. ``variant`` —
    the reference's perf knobs: moe_groups, ssm_streaming,
    moe_pad_experts (config overrides); microbatches, zero1, zero2 (step
    and sharding options)."""
    variant = variant or {}
    cfg = St.config_for_shape(cfg0, shape)
    overrides = {k: variant[k]
                 for k in ("moe_groups", "ssm_streaming", "moe_pad_experts")
                 if k in variant}
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    pshard = St.param_shardings(cfg, mesh)
    aparams = abstract_params(T.specs(cfg))
    params = _distribute(aparams, pshard)
    if shape.kind == "train":
        opt = opt_lib.get_optimizer(optimizer, 1e-4)
        aopt = opt.init(aparams)
        oshard = St.opt_state_shardings(aopt, pshard, mesh,
                                        zero1=variant.get("zero1", False))
        binput = St.input_specs(cfg, shape)
        acc = (St.accum_shardings(aparams, pshard, mesh)
               if variant.get("zero2") else None)
        step = St.make_train_step(
            cfg, opt, microbatches=variant.get("microbatches", 1),
            accum_shards=acc)
        return step, (params, _distribute(aopt, oshard), _distribute(
            binput, St.batch_shardings(binput, mesh))), cfg
    if shape.kind == "prefill":
        binput = St.input_specs(cfg, shape)
        return St.make_prefill_step(cfg), (params, _distribute(
            binput, St.batch_shardings(binput, mesh))), cfg
    ios = St.input_specs(cfg, shape)
    cshard = St.cache_shardings(cfg, shape.global_batch, shape.seq_len,
                                mesh)
    # the last position of a full cache: the port's decode takes it as
    # a Python int
    return St.make_decode_step(cfg), (
        params, _distribute(ios["cache"], cshard),
        _distribute(ios["batch"], St.batch_shardings(ios["batch"], mesh)),
        shape.seq_len - 1), cfg


@contextlib.contextmanager
def _uncounted_shape_inference(local: LocalTraffic):
    """DTensor infers an op's output metadata by running the op on
    tensors of the global shapes under a FakeTensorMode, the first time
    it meets the op's schema (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``, torch 2.11 and 2.13); the mode
    runs them on meta tensors, which reach ``local`` as if they were
    local ops (a whole model's logits, a whole KV cache). They are no
    device's work: ``local`` counts nothing while the propagator runs
    them."""
    inner = ShardingPropagator._propagate_tensor_meta_non_cached

    @functools.wraps(inner)
    def uncounted(self, *args, **kwargs):
        local.inferring += 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            local.inferring -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = uncounted
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = inner


def placements_key(t) -> str:
    """A DTensor's placements as ``"S(0),R,P(sum)"``, the same on every
    torch version."""
    return ",".join("R" if p.is_replicate() else f"S({p.dim})"
                    if p.is_shard() else f"P({p.reduce_op})"
                    for p in t.placements)


@contextlib.contextmanager
def _residual_placements(seen: dict):
    """Count, at each call of ``transformer.seq_shards`` (the residual
    stream at a block boundary), the placements the stream arrives in
    and those it leaves in, into ``seen["arrived"]`` and
    ``seen["pinned"]``."""
    inner = T.seq_shards

    def counted(x):
        out = inner(x)
        if isinstance(x, DTensor):
            for key, t in (("arrived", x), ("pinned", out)):
                d = seen.setdefault(key, {})
                d[placements_key(t)] = d.get(placements_key(t), 0) + 1
        return out

    T.seq_shards = counted
    try:
        yield
    finally:
        T.seq_shards = inner


def trace(step, args) -> tuple:
    """Run ``step(*args)`` once under the counter: (output,
    LocalTraffic)."""
    local = LocalTraffic()
    with _uncounted_shape_inference(local), local, implicit_replication(), \
            _residual_placements(local.residuals):
        out = step(*args)
    return out, local


def measure(cfg0, shape, mesh, optimizer: str = "adamw",
            variant: dict | None = None) -> dict:
    """The row of one (config, input shape) on ``mesh``: see the module
    docstring."""
    chips = mesh.size()
    t0 = time.perf_counter()
    step, args, cfg = build_step(cfg0, shape, mesh, optimizer, variant)
    arg_bytes = _local_bytes(args)
    arg_storages = _storage_sizes(args)
    out, local = trace(step, args)
    trace_s = time.perf_counter() - t0
    aliased = sum(arg_storages.get(k, 0) for k in _storage_sizes(out))

    total_p, active_p = count_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) * active_p * tokens
    flops = local.flops
    coll = local.collectives()
    terms = {"compute_s": flops / R.PEAK_FLOPS,
             "memory_s": local.bytes / R.HBM_BW,
             "collective_s": coll["moved_bytes_per_device"] / R.LINK_BW}
    return {
        "variant": variant or {},
        "mesh": "x".join(map(str, mesh.shape)), "chips": chips,
        "kind": shape.kind, "device": "meta",
        "torch": torch.__version__,
        "residual_placements": local.residuals,
        "trace_s": round(trace_s, 2),
        "flops_per_device": flops, "bytes_per_device": local.bytes,
        "flops_by_op": dict(sorted(local.flops_by_op.items(),
                                   key=lambda kv: -kv[1]["per_device"])),
        "collectives": coll,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": _local_bytes(out),
                   "temp_size_in_bytes": local.peak_bytes,
                   "alias_size_in_bytes": aliased},
        "params_total": total_p, "params_active": active_p,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / (flops * chips)
                               if flops else 0.0),
        **terms, "dominant": max(terms, key=terms.get),
    }


def _pod_flattened(spec) -> tuple:
    """A multi-pod spec with ("pod", "data") as the one axis "data"."""
    return tuple("data" if e == ("pod", "data") else e for e in spec)


def check_pod_flattening(cfg0, shape, mesh3, mesh2) -> None:
    """The (2, 16, 16) mesh's rules name "pod" only beside "data", pod
    major (the batch rule), so every parameter, cache and batch spec on
    it is the (32, 16) mesh's spec with ("pod", "data") for "data":
    the step traced on that flattening has the same layout. Raises
    where a spec breaks that."""
    cfg = St.config_for_shape(cfg0, shape)
    trees = [lambda m: St.param_shardings(cfg, m),
             lambda m: St.batch_shardings(St.input_specs(cfg, shape), m)]
    if shape.kind == "decode":
        trees.append(lambda m: St.cache_shardings(
            cfg, shape.global_batch, shape.seq_len, m))
    for tree in trees:
        for s3, s2 in zip(opt_lib.tree_leaves(tree(mesh3)),
                          opt_lib.tree_leaves(tree(mesh2))):
            if _pod_flattened(s3.spec) != s2.spec or any(
                    e != ("pod", "data") and "pod" in (e or ())
                    for e in s3.spec):
                raise AssertionError(f"spec {s3.spec} on the multi-pod "
                                     f"mesh is not {s2.spec} flattened")


def analyze(arch: str, shape_name: str, *, multi_pod: bool = False,
            optimizer: str = "adamw", variant: dict | None = None) -> dict:
    """The row of one production combo, on the (16, 16) mesh or, with
    ``multi_pod``, the (2, 16, 16) one. The latter is traced on its
    (32, 16) flattening (:func:`check_pod_flattening`): DTensor's
    sharding propagation over three mesh dims takes minutes an op."""
    cfg0, shape = get_config(arch), INPUT_SHAPES[shape_name]
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu")
    row = {"arch": arch, "shape": shape_name}
    if multi_pod:
        flat = mesh_lib.make_host_mesh(32, 16, device="cpu")
        check_pod_flattening(cfg0, shape, mesh, flat)
        row.update(measure(cfg0, shape, flat, optimizer, variant),
                   mesh="2x16x16", traced_on="32x16")
        return row
    row.update(measure(cfg0, shape, mesh, optimizer, variant))
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--out", default=None)
    # perf knobs, as the reference's
    ap.add_argument("--moe-groups", type=int, default=0)
    ap.add_argument("--pad-experts", type=int, default=0)
    ap.add_argument("--ssm-streaming", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--zero2", action="store_true")
    return ap.parse_args(argv)


def variant_of(args) -> dict:
    variant = {}
    if args.moe_groups:
        variant["moe_groups"] = args.moe_groups
    if args.pad_experts:
        variant["moe_pad_experts"] = args.pad_experts
    if args.ssm_streaming:
        variant["ssm_streaming"] = True
    if args.microbatches:
        variant["microbatches"] = args.microbatches
    if args.zero1:
        variant["zero1"] = True
    if args.zero2:
        variant["zero1"] = True
        variant["zero2"] = True
    return variant


def main(argv=None) -> int:
    args = parse_args(argv)
    variant = variant_of(args)
    archs = all_archs() if (args.all or not args.arch) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    # one fake group, as wide as the widest mesh asked for: a narrower
    # mesh is built over its first ranks
    mesh_lib.init_fake_process_group(512 if any(meshes) else 256)
    ok = True
    outf = open(args.out, "a") if args.out else None
    for a in archs:
        for s in shapes:
            for mp in meshes:
                tag = f"{a} × {s} × {'2x16x16' if mp else '16x16'}"
                try:
                    r = analyze(a, s, multi_pod=mp, optimizer=args.optimizer,
                                variant=variant or None)
                    line = json.dumps(r)
                    print(f"PASS {tag}: dominant={r['dominant']} "
                          f"compute={r['compute_s']:.4g}s "
                          f"memory={r['memory_s']:.4g}s "
                          f"collective={r['collective_s']:.4g}s "
                          f"trace={r['trace_s']}s", flush=True)
                except Exception as e:
                    ok = False
                    print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
                    line = json.dumps({"arch": a, "shape": s,
                                       "multi_pod": mp,
                                       "torch": torch.__version__,
                                       "error": f"{type(e).__name__}: {e}"})
                if outf:
                    outf.write(line + "\n")
                    outf.flush()
    if outf:
        outf.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
