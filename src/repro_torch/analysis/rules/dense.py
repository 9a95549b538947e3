"""dense-materialization: no (n, n) arrays outside designated modules.

The sparse plane exists because one dense adjacency at n = 10⁵ is
10 GB (40 GB of float32 on the card). This rule catches dense
allocations at parse time:

* ``np.zeros((n, n))`` / ``torch.zeros((n, n))``-style allocations
  (``zeros``, ``ones``, ``empty``, ``full``) whose 2-D shape repeats the
  same expression on both axes (the square-matrix signature);
* explicit outer products (``np.outer``, ``torch.outer``,
  ``a[:, None] * b[None, :]``);
* dense schedule views (``.adj_at(...)`` / ``.adj_view(...)`` calls and
  ``plan.s``, the (T, n, n) share tensor) outside the modules designated
  to own them.

Designated modules (the dense oracles, the schedule internals behind
the guarded views, the models' feature squares, the kernels) are skipped
wholesale; everywhere else a hit needs a
``disable=dense-materialization`` waiver with a reason.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, ModuleInfo, Rule, call_name

ALLOC_TAILS = ("zeros", "ones", "empty", "full")
ALLOC_ROOTS = ("np", "numpy", "torch")
OUTER_FNS = ("np.outer", "numpy.outer", "torch.outer")
VIEW_CALLS = ("adj_at", "adj_view")

DESIGNATED = ("core/schedule.py", "core/topology.py", "core/movement.py",
              "models/*", "kernels/*", "tests/*", "test_*.py")


def _is_none_slice(node: ast.AST, pos: int) -> bool:
    # a[:, None] (pos=1) or a[None, :] (pos=0)
    if not isinstance(node, ast.Subscript):
        return False
    sl = node.slice
    if not (isinstance(sl, ast.Tuple) and len(sl.elts) == 2):
        return False
    e = sl.elts[pos]
    return isinstance(e, ast.Constant) and e.value is None


class DenseMaterializationRule(Rule):
    name = "dense-materialization"
    description = ("(n, n) allocation / dense schedule view outside a"
                   " designated oracle module")

    def check_module(self, mod: ModuleInfo):
        if mod.match(*DESIGNATED):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                yield from self._check_call(mod, node)
            elif isinstance(node, ast.Attribute):
                if (node.attr == "s" and isinstance(node.ctx, ast.Load)
                        and isinstance(node.value, ast.Name)):
                    yield Finding(
                        self.name, mod.rel, node.lineno,
                        f"dense plan view `{ast.unparse(node)}`: the"
                        " (T, n, n) share tensor; use the COO edge"
                        " arrays (`plan.edges()`)")
            elif (isinstance(node, ast.BinOp)
                  and isinstance(node.op, ast.Mult)):
                l, r = node.left, node.right
                if ((_is_none_slice(l, 1) and _is_none_slice(r, 0))
                        or (_is_none_slice(l, 0) and _is_none_slice(r, 1))):
                    yield Finding(
                        self.name, mod.rel, node.lineno,
                        "broadcast outer product"
                        " (`a[:, None] * b[None, :]`) materializes a"
                        " dense square; use the edge-list plane")

    def _check_call(self, mod: ModuleInfo, node: ast.Call):
        name = call_name(node)
        if name in OUTER_FNS:
            yield Finding(self.name, mod.rel, node.lineno,
                          f"`{name}` materializes a dense square;"
                          " use the edge-list plane")
            return
        tail = name.rsplit(".", 1)[-1]
        if tail in VIEW_CALLS and "." in name:
            yield Finding(
                self.name, mod.rel, node.lineno,
                f"dense schedule view `.{tail}(...)`: O(n²) per round"
                " and raises past DENSE_VIEW_MAX_N; use `.edges_at(t)`")
            return
        if tail in ALLOC_TAILS and name.split(".", 1)[0] in ALLOC_ROOTS:
            if not node.args:
                return
            shape = node.args[0]
            if (isinstance(shape, (ast.Tuple, ast.List))
                    and len(shape.elts) == 2
                    and not isinstance(shape.elts[0], ast.Constant)
                    and ast.unparse(shape.elts[0])
                    == ast.unparse(shape.elts[1])):
                yield Finding(
                    self.name, mod.rel, node.lineno,
                    f"square allocation `{ast.unparse(node)[:60]}`:"
                    " (n, n) memory is unaffordable at fog scale;"
                    " build edge arrays instead")


RULES = [DenseMaterializationRule()]
