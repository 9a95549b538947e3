"""host-sync-in-hot-path: no device->host syncs inside the round loops.

The engine's throughput rests on round loops that never wait for the
host: the staged rounds are on the card, the aggregation rounds are
known from τ, and the history is read back once after the loop. A
``.item()``, ``float(t)``, ``.cpu()`` or ``torch.cuda.synchronize()``
inside a loop serializes the card per round (``core/sanitize.py``'s
guard catches it at run time; this rule at parse time). The hot scopes
are derived statically:

* the bodies of the ``for t in range(...)`` round loops of the engines
  (``run_rounds_*`` and ``_run_scan_*``; the legacy engine, the
  per-round oracle that reads back as it goes, is not one);
* program builders by naming convention, functions matching
  ``*_program`` / ``*_body``, with every ``def`` nested in them;
* the methods (``__init__`` apart) of the round and program classes
  (class names ending in ``Round`` or ``Program``: ``_ScanRound``,
  ``_BucketProgram``), which the loops call every round.

Reads of shape/dtype metadata (``int(x.shape[0])``) are host math on
static information and stay allowed, as do ``float()``/``int()`` of
literals.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.core import (Finding, ModuleInfo, Rule, call_name,
                                       mentions_shape)

SCOPE = ("core/*", "distributed/*", "data/pipeline.py")
LOOP_FN_RE = re.compile(r"^_?run_(rounds|scan)_(?!legacy)")
BUILDER_RE = re.compile(r"(_program|_body)$")
CLASS_RE = re.compile(r"(Round|Program)$")
SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
SYNC_CALLS = ("torch.cuda.synchronize", "synchronize")
HOST_CASTS = ("float", "int", "bool")
NP_PULLS = ("np.asarray", "np.array", "numpy.asarray", "numpy.array")
DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _round_loop(node: ast.AST) -> bool:
    return (isinstance(node, ast.For) and isinstance(node.target, ast.Name)
            and node.target.id == "t" and isinstance(node.iter, ast.Call)
            and call_name(node.iter) == "range")


def _hot_functions(mod: ModuleInfo) -> dict:
    """id(FunctionDef) -> reason, for every function that is hot as a
    whole (builders and their nested defs, round/program methods)."""
    hot: dict = {}

    def mark(fn, reason):
        for sub in ast.walk(fn):
            if isinstance(sub, DEFS):
                hot.setdefault(id(sub), reason)

    for node in ast.walk(mod.tree):
        if isinstance(node, DEFS) and BUILDER_RE.search(node.name):
            mark(node, f"program builder {node.name}")
        elif isinstance(node, ast.ClassDef) and CLASS_RE.search(node.name):
            for item in node.body:
                if isinstance(item, DEFS) and item.name != "__init__":
                    mark(item, f"{node.name}.{item.name}")
    return hot


def _reason(mod: ModuleInfo, node: ast.AST, hot: dict) -> str | None:
    """Why ``node`` is in a hot scope, or None."""
    loop = None
    for anc in mod.ancestors(node):
        if isinstance(anc, DEFS):
            if id(anc) in hot:
                return hot[id(anc)]
            if loop is not None and LOOP_FN_RE.search(anc.name):
                return f"round loop of {anc.name}"
            return None
        if loop is None and _round_loop(anc):
            loop = anc
    return None


class HostSyncRule(Rule):
    name = "host-sync-in-hot-path"
    description = (".item()/.cpu()/float()/synchronize on device values"
                   " inside round loops and program builders")

    def check_module(self, mod: ModuleInfo):
        if not mod.match(*SCOPE):
            return
        hot = _hot_functions(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            reason = _reason(mod, node, hot)
            if reason is not None:
                yield from self._check_hot_call(mod, node, reason)

    def _check_hot_call(self, mod: ModuleInfo, node: ast.Call, reason):
        name = call_name(node)
        tail = name.rsplit(".", 1)[-1]
        if tail in SYNC_METHODS and "." in name:
            yield Finding(
                self.name, mod.rel, node.lineno,
                f"`.{tail}()` in a hot scope ({reason}) forces a"
                " device->host sync per round; keep results on the"
                " device and read them once after the loop")
        elif name in SYNC_CALLS:
            yield Finding(
                self.name, mod.rel, node.lineno,
                f"`{name}` in a hot scope ({reason}) waits for the"
                " card per round; synchronize after the loop")
        elif name in NP_PULLS or name in HOST_CASTS:
            if not node.args:
                return
            arg = node.args[0]
            if isinstance(arg, ast.Constant) or mentions_shape(arg):
                return  # static metadata / literal: host math is fine
            yield Finding(
                self.name, mod.rel, node.lineno,
                f"`{name}(...)` of a device value in a hot scope"
                f" ({reason}) reads it on the host mid-loop; use torch"
                " ops or move it out of the loop")


RULES = [HostSyncRule()]
