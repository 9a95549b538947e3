"""oracle-pairing: every sparse/edge/tier function of the port needs
its oracle test.

The sparse plane's correctness rests on equivalence with the dense
paths (greedy on CSR against the dense argmin, segment reductions
against masked sums, flat staging against per-cell lists, tiers against
their flat oracle), and the port's on equivalence with the reference.
That only holds for functions a test actually cross-checks. This
repo-level rule lists every public function named ``*_edges``,
``*_flat``, ``*_tier`` or ``*_hierarchical`` defined in the linted
modules and flags the ones whose name appears in no ``test_torch_*.py``
file of the test tree: the reference's tests name the reference's
functions, so they do not count.

The finding anchors at the ``def`` line, so a function that cannot be
tested on its own (a thin re-export) can carry a line waiver there.
"""
from __future__ import annotations

import ast
import fnmatch
import os
import re

from repro_torch.analysis.core import Finding, Rule

NAME_RE = re.compile(r"(_edges|_flat|_tier|_hierarchical)$")
TESTS_GLOB = "test_torch_*.py"


class OraclePairingRule(Rule):
    name = "oracle-pairing"
    description = ("public *_edges/*_flat/*_tier/*_hierarchical "
                   "function named in no test_torch_*.py file")

    def check_repo(self, mods, ctx):
        if not ctx.tests_sources:
            return
        corpus = "\n".join(
            text for rel, text in ctx.tests_sources.items()
            if fnmatch.fnmatch(os.path.basename(rel), TESTS_GLOB))
        for mod in mods:
            if mod.match("tests/*", "test_*.py"):
                continue
            for node in mod.tree.body:
                if not isinstance(node, ast.FunctionDef):
                    continue
                if node.name.startswith("_"):
                    continue
                if not NAME_RE.search(node.name):
                    continue
                if re.search(rf"\b{re.escape(node.name)}\b", corpus):
                    continue
                yield Finding(
                    self.name, mod.rel, node.lineno,
                    f"`{node.name}` is named in no {TESTS_GLOB}: pair"
                    " every sparse/edge/tier path with an oracle"
                    " equivalence test")


RULES = [OraclePairingRule()]
