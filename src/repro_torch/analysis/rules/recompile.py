"""recompile-hazard: call sites that defeat the port's program and build
caches.

The port compiles two things at run time: the CUDA kernels (``nvcc``,
through ``kernels/_build``, keyed on the source's digest) and, in the
reference's sense, the sweep engine's bucket programs (one per
(program, shape) key, ``engine.batched_compile_count``). Two statically
visible hazards:

* ``_build.build`` / ``_build.load`` / ``torch.compile`` invoked inside
  a Python ``for``/``while`` of the same function: a build or a fresh
  compiled wrapper per iteration (hoist it and reuse the result);
* cached program builders (``functools.lru_cache``/``cache``-decorated
  functions, and the ``*_program`` builders that key a program table,
  the ``_bucket_program`` pattern) with mutable default arguments or
  ``**kwargs``: the cache key silently aliases or stops deduplicating
  (key on hashable scalars only).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, ModuleInfo, Rule, call_name

BUILD_CALLS = ("_build.build", "_build.load", "torch.compile")
LOOPS = (ast.For, ast.While, ast.AsyncFor)
MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                    ast.DictComp, ast.SetComp)


def _cached_builder(fn: ast.FunctionDef) -> bool:
    if fn.name.endswith("_program"):
        return True
    return any("lru_cache" in call_name(d) or "cache" == call_name(d)
               or call_name(d).endswith(".cache")
               for d in fn.decorator_list)


class RecompileHazardRule(Rule):
    name = "recompile-hazard"
    description = ("kernel build / torch.compile in a Python loop, or a"
                   " mutable-keyed cached program builder")

    def check_module(self, mod: ModuleInfo):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                yield from self._check_call(mod, node)
            elif isinstance(node, ast.FunctionDef):
                yield from self._check_builder(mod, node)

    def _check_call(self, mod: ModuleInfo, node: ast.Call):
        name = call_name(node)
        if name not in BUILD_CALLS:
            return
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break  # loops outside the enclosing def don't count
            if isinstance(anc, LOOPS):
                yield Finding(
                    self.name, mod.rel, node.lineno,
                    f"`{name}(...)` inside a Python loop builds or"
                    " compiles per iteration; hoist it and reuse the"
                    " result")
                break

    def _check_builder(self, mod: ModuleInfo, fn: ast.FunctionDef):
        if not _cached_builder(fn):
            return
        if fn.args.kwarg is not None:
            yield Finding(
                self.name, mod.rel, fn.lineno,
                f"cached program builder `{fn.name}` takes **kwargs:"
                " the cache key stops deduplicating; enumerate"
                " hashable scalar parameters")
        for default in (fn.args.defaults + fn.args.kw_defaults):
            if isinstance(default, MUTABLE_LITERALS):
                yield Finding(
                    self.name, mod.rel, fn.lineno,
                    f"cached program builder `{fn.name}` has a mutable"
                    " default: unhashable cache key; use scalars or"
                    " tuples")


RULES = [RecompileHazardRule()]
