"""nan-unsafe-masking: never multiply by a mask in aggregation code.

``mask * update`` is not a select: when a faulty device uploads a
NaN/Inf parameter, NaN·0 is NaN and one corrupted update poisons eq.
(4)'s sum even though its mask is 0. The engine's guarded aggregation
therefore uses ``torch.where(mask, update, 0.0)`` wherever a masked
operand can be non-finite. This rule flags multiplications where one
operand looks like a 0/1 participation mask and the other like
parameters, gradients or updates, inside the aggregation-bearing
modules.

Heuristic, by design: operand roles come from identifier tokens (a
``_``-split part in the mask vocabulary against the param/grad
vocabulary; mask wins when both match, so ``p_flag * qok``, mask·mask
and finite by construction, stays quiet). A genuine mask-by-multiply
(the fault plane's intentional corruption injection) carries a waiver
with its justification.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (Finding, ModuleInfo, Rule,
                                       name_parts, root_token)

SCOPE = ("core/engine.py", "core/federated.py", "core/faults.py",
         "distributed/*")

MASK_TOKENS = {"mask", "masks", "active", "act", "ok", "qok", "alive",
               "fin", "finite", "keep", "contributing", "contrib",
               "upl", "cor", "corrupt", "corrupted", "surv", "flag",
               "flags", "sel", "select", "gate"}
PARAM_TOKENS = {"w", "wu", "wg", "p", "g", "gg", "grad", "grads",
                "param", "params", "update", "updates", "delta", "num",
                "leaf", "stack", "upload", "uploads"}


def _role(node: ast.AST) -> str | None:
    tok = root_token(node)
    if tok is None:
        return None
    parts = name_parts(tok)
    if parts & MASK_TOKENS:
        return "mask"
    if parts & PARAM_TOKENS:
        return "param"
    return None


class NanUnsafeMaskingRule(Rule):
    name = "nan-unsafe-masking"
    description = ("multiplicative masking of a possibly non-finite"
                   " operand (NaN·0 = NaN); use torch.where")

    def check_module(self, mod: ModuleInfo):
        if not mod.match(*SCOPE):
            return
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Mult)):
                continue
            roles = {_role(node.left), _role(node.right)}
            if roles == {"mask", "param"}:
                yield Finding(
                    self.name, mod.rel, node.lineno,
                    f"`{ast.unparse(node)[:60]}` multiplies a mask"
                    " into a parameter/gradient operand: NaN·0 = NaN"
                    " lets one corrupt upload poison eq. (4); use"
                    " `torch.where(mask, x, 0.0)`")


RULES = [NanUnsafeMaskingRule()]
