"""Tree checkpoints in PyTorch's own format (the port of
:mod:`repro.checkpoint.checkpoint`).

A checkpoint is one ``torch.save`` of ``{"meta": {...}, "leaves":
{path: tensor}}``, read back with ``torch.load(..., weights_only=True)``:
no pickled code, only tensors and plain containers. Trees are nested
dicts, lists and tuples of tensors or numpy arrays; a leaf is keyed by
its path in the reference's spelling (``['carry']['W']['w1']``), so the
structure is rebuilt from the template and dict order does not matter.
The reference writes msgpack, which this package does not need: tensors
of every dtype (bfloat16 included) round-trip bitwise through
``torch.save``.

``save`` is atomic (write a temp file, flush, fsync, ``os.replace``), so
a snapshot interrupted mid-write never corrupts the previous checkpoint,
and a failed write removes its temp file. The copy of each leaf to the
host is explicit and happens in ``save``. Every checkpoint is stamped
with provenance metadata (git SHA, torch version, save time); caller
keys win. ``restore`` validates the WHOLE tree against the template and
reports every missing, extra or mismatched leaf in one ``ValueError``.
Tensors come back on the template's device, numpy leaves as numpy.
"""
from __future__ import annotations

import datetime
import functools
import os
import subprocess

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path, leaf) pairs; dict keys in sorted order, as jax flattens."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree, leaves, prefix: str = ""):
    """The template's structure with each leaf taken from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _to_host(x) -> torch.Tensor:
    """A leaf as a CPU tensor with a storage of its own (a view would
    save its whole base storage)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x, copy=True))


@functools.lru_cache(maxsize=1)
def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def _ckpt_meta() -> dict:
    return {"git_sha": _git_sha(),
            "torch_version": str(torch.__version__),
            "saved_at": datetime.datetime.now(
                datetime.timezone.utc).isoformat()}


def save(path: str, tree, metadata: dict | None = None) -> None:
    """Atomically snapshot ``tree`` (+ provenance-stamped metadata)."""
    payload = {"meta": {**_ckpt_meta(), **(metadata or {})},
               "leaves": {p: _to_host(v) for p, v in _flatten(tree)}}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # a failed write must not leave a half-written temp behind, and
        # must never touch the previous checkpoint at ``path``
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _template_dtype(tmpl) -> torch.dtype:
    if isinstance(tmpl, torch.Tensor):
        return tmpl.dtype
    return torch.from_numpy(np.asarray(tmpl).reshape(-1)[:0]).dtype


def restore(path: str, like):
    """Restore into the structure of ``like`` (a template tree).

    Returns ``(tree, metadata)``. Raises one ``ValueError`` naming
    EVERY leaf path that is missing from the checkpoint, absent from
    the template, or mismatched in shape or dtype."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    leaves = payload["leaves"]
    flat = _flatten(like)
    problems: list[str] = []
    out = {}
    for key, tmpl in flat:
        if key not in leaves:
            problems.append(f"{key}: missing from checkpoint")
            continue
        arr = leaves[key]
        t_shape = tuple(np.shape(tmpl))
        t_dtype = _template_dtype(tmpl)
        if tuple(arr.shape) != t_shape:
            problems.append(
                f"{key}: shape {tuple(arr.shape)} != template {t_shape}")
        elif arr.dtype != t_dtype:
            problems.append(
                f"{key}: dtype {arr.dtype} != template {t_dtype}")
        elif isinstance(tmpl, torch.Tensor):
            out[key] = arr.to(tmpl.device)
        else:
            out[key] = arr.numpy()
    template_keys = {key for key, _ in flat}
    for key in leaves:
        if key not in template_keys:
            problems.append(f"{key}: in checkpoint but not in template")
    if problems:
        raise ValueError(
            f"checkpoint {path!r} does not match the restore template "
            f"({len(problems)} mismatched leaf path(s)):\n  "
            + "\n  ".join(problems))
    return _rebuild(like, out), payload["meta"]
