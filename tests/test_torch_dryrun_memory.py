"""The dry run's memory columns (``launch/dryrun.py``): the peak of live
bytes a traced step allocates (``temp_size_in_bytes``) and the argument
bytes its outputs share (``alias_size_in_bytes``).

* Hand counts on small steps traced on the meta device with ``trace``:
  ``relu(x @ w).sum()`` peaks at the product and its relu, 2·B·N·4
  bytes; a one-layer forward and backward peaks at the first weight's
  gradient, made while the hidden gradient, the second weight's
  gradient, the loss and its seed gradient live; in-place ops add
  nothing, on an argument or on the step's own buffer.
* A small mamba2 config on a (4, 2) fake mesh (chunk 256, S = 2048),
  where the plain scan's all-chunk decay matrices set the peak (the
  segment sums and their exp, two at once): the streaming scan's peak
  is lower by at least one of them less one chunk's. A sharded product
  peaks at its local output: DTensor's shape inference, which runs the
  op on meta tensors of the global shapes, counts nothing. A decode step
  updates its cache in place: its outputs alias the cache's argument
  bytes; a prefill aliases nothing.
"""
import json
import os
import subprocess
import sys
import textwrap

import torch

from repro_torch.launch import dryrun as DR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, D, F, N = 8, 40, 32, 24


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def test_peak_of_product_and_relu():
    _, local = DR.trace(lambda x, w: torch.relu(x @ w).sum(),
                        (_meta(B, D), _meta(D, N)))
    assert local.peak_bytes == 2 * B * N * 4


def test_peak_of_forward_and_backward():
    """At ∂w1 = xᵀ·∂h these live: ∂h (B·F), ∂w2 (F), the loss and its
    seed gradient (one float each) and ∂w1 (D·F); the relu output that
    autograd saved was freed with its node, before it (the forward's
    peak, h and relu(h), is 2·B·F). At the end ∂w1, ∂w2 and the loss
    live on."""
    def step(x, w1, w2):
        loss = (torch.relu(x @ w1) @ w2).sum()
        loss.backward()
        return loss

    _, local = DR.trace(step, (_meta(B, D), _meta(D, F, grad=True),
                               _meta(F, 1, grad=True)))
    assert local.peak_bytes == 4 * (D * F + B * F + F + 2)
    assert local.live_bytes == 4 * (D * F + F + 1)


def test_in_place_ops_add_nothing():
    def step(x, w):
        y = x @ w
        y.relu_()
        y.mul_(2.0)
        return y

    _, local = DR.trace(step, (_meta(B, D), _meta(D, N)))
    assert local.peak_bytes == B * N * 4
    _, local = DR.trace(lambda z: z.add_(1.0).mul_(3.0), (_meta(B, N),))
    assert local.peak_bytes == 0


def test_a_view_keeps_its_base_storage_alive():
    def step(x, w):
        return (x @ w)[:, :1]        # the product dies; its view lives

    _, local = DR.trace(step, (_meta(B, D), _meta(D, N)))
    assert local.peak_bytes == local.live_bytes == B * N * 4


MESH = """
    import dataclasses, json
    import torch
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as mesh_lib

    torch.set_num_threads(1)
    mesh_lib.init_fake_process_group(8)
    mesh = mesh_lib.make_host_mesh(4, 2, device="cpu")
    cfg = get_config("mamba2-1.3b", smoke=True).with_overrides(ssm_chunk=256)
    pre = dataclasses.replace(INPUT_SHAPES["prefill_32k"], global_batch=4,
                              seq_len=2048)
    out = {"heads": cfg.ssm_heads}
    for key, v in (("default", None), ("streaming", {"ssm_streaming": True})):
        out[key] = DR.measure(cfg, pre, mesh, variant=v)["memory"]
    # DTensor's shape inference runs on global shapes: not counted
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = distribute_tensor(torch.empty(16, 32, 64, device="meta"), mesh,
                          [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty(64, 96, device="meta"), mesh,
                          [Replicate(), Shard(1)])
    out["product_peak"] = DR.trace(lambda: x @ w, ())[1].peak_bytes
    dec = dataclasses.replace(INPUT_SHAPES["decode_32k"], global_batch=8,
                              seq_len=64)
    out["decode"] = DR.measure(get_config("mamba2-1.3b", smoke=True), dec,
                               mesh)["memory"]
    print(json.dumps(out))
"""


def test_streaming_scan_lowers_the_peak_and_decode_aliases_its_cache():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(MESH)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    out = json.loads(r.stdout.strip().splitlines()[-1])
    # the scan runs on each rank's batch rows (4 over the data axis's 4)
    # and heads (over the model axis's 2)
    B, H, S, l = 4 // 4, out["heads"] // 2, 2048, 256
    all_chunks = B * H * S * l * 4           # (B, H, S/l, l, l) float32
    one_chunk = B * H * l * l * 4
    plain, stream = out["default"], out["streaming"]
    assert plain["temp_size_in_bytes"] >= 2 * all_chunks   # exp(segsum)
    assert plain["temp_size_in_bytes"] - stream["temp_size_in_bytes"] \
        >= all_chunks - one_chunk
    assert plain["alias_size_in_bytes"] == stream["alias_size_in_bytes"] == 0
    assert out["product_peak"] == (16 // 4) * 32 * (96 // 2) * 4
    dec = out["decode"]
    assert 0 < dec["alias_size_in_bytes"] <= dec["argument_size_in_bytes"]
    assert dec["temp_size_in_bytes"] > 0
