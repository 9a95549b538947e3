"""fog-lint core: findings, waivers, module model, rule registry, runner
(the port's copy of :mod:`repro.analysis.core`).

The analyzer is plugin-based: each module under
:mod:`repro_torch.analysis.rules` exports a ``RULES`` list of
:class:`Rule` instances; :func:`repro_torch.analysis.rules.all_rules`
assembles the registry. Rules come in two shapes:

* per-module — ``check_module(mod)`` yields findings for one parsed
  file (most rules);
* repo-level — ``check_repo(mods, ctx)`` sees every module plus the
  test-tree sources (the oracle-pairing rule cross-references src/
  against tests/).

Waivers are inline comments::

    x = np.zeros((n, n))  # foglint: disable=<rule> -- <why>

A waiver applies to findings of the named rule(s) on its own line or
the line directly below it (comment-above style); ``disable-file=``
waives a rule for the whole file. The justification after ``--`` is
MANDATORY: a waiver without one raises a non-waivable
``waiver-justification`` finding, so CI fails on undocumented escapes.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
import re
from typing import Iterable, Sequence

WAIVER_RE = re.compile(
    r"#\s*foglint:\s*(?P<kind>disable|disable-file)\s*="
    r"\s*(?P<rules>[\w-]+(?:\s*,\s*[\w-]+)*)"
    r"(?:\s+--\s*(?P<why>\S.*?))?\s*$")

# findings about the waiver machinery itself can never be waived
UNWAIVABLE = {"waiver-justification", "parse-error", "unknown-rule"}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str           # posix path relative to the lint root
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Waiver:
    path: str
    line: int
    rules: tuple
    justification: str
    file_level: bool

    def format(self) -> str:
        scope = "file" if self.file_level else "line"
        why = self.justification or "MISSING JUSTIFICATION"
        return (f"{self.path}:{self.line}: [{','.join(self.rules)}]"
                f" ({scope}) -- {why}")


class ModuleInfo:
    """One parsed source file plus its waivers and a parent map."""

    def __init__(self, rel: str, source: str):
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self.waivers = _parse_waivers(self.rel, self.lines)
        self._parents: dict = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    def match(self, *globs: str) -> bool:
        return any(fnmatch.fnmatch(self.rel, g) for g in globs)

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST):
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def waived(self, finding: Finding) -> bool:
        if finding.rule in UNWAIVABLE:
            return False
        for w in self.waivers:
            if finding.rule not in w.rules and "all" not in w.rules:
                continue
            if not w.justification:
                continue  # an unjustified waiver waives nothing
            if w.file_level or finding.line in (w.line, w.line + 1):
                return True
        return False


def _parse_waivers(rel: str, lines: Sequence[str]) -> list:
    out = []
    for i, text in enumerate(lines, start=1):
        m = WAIVER_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(","))
        out.append(Waiver(rel, i, rules, (m.group("why") or "").strip(),
                          m.group("kind") == "disable-file"))
    return out


class Rule:
    """Base rule. Subclasses set ``name``/``description`` and override
    one of the two hooks."""

    name = "rule"
    description = ""

    def check_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        return ()

    def check_repo(self, mods: Sequence[ModuleInfo],
                   ctx: "RepoContext") -> Iterable[Finding]:
        return ()


@dataclasses.dataclass
class RepoContext:
    """Cross-module inputs for repo-level rules."""

    tests_sources: dict  # rel path -> source text (may be empty)


@dataclasses.dataclass
class LintResult:
    findings: list       # surviving (unwaived) findings
    waived: list         # findings suppressed by a justified waiver
    waivers: list        # every waiver comment seen

    @property
    def ok(self) -> bool:
        return not self.findings


# ---------------------------------------------------------------------------
# shared AST helpers used by several rules
# ---------------------------------------------------------------------------


def call_name(node: ast.AST) -> str:
    """Dotted name of a call target: ``np.random.default_rng`` -> that
    string; unresolvable pieces become ``?``."""
    if isinstance(node, ast.Call):
        node = node.func
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("?")
    return ".".join(reversed(parts))


def root_token(node: ast.AST) -> str | None:
    """Semantic root identifier of an expression, for heuristic
    operand classification: ``cor.reshape(x)`` -> ``cor``;
    ``plan.s`` -> ``s`` (the attribute carries the meaning);
    ``w[k]`` -> ``w``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        return root_token(node.value)
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute):  # method call: x.reshape(...)
            return root_token(fn.value)
        return None
    if isinstance(node, ast.UnaryOp):
        return root_token(node.operand)
    return None


def name_parts(token: str) -> set:
    return set(token.lower().split("_"))


def mentions_shape(node: ast.AST) -> bool:
    """True if the expression reads only shape/dtype metadata anywhere
    inside (``x.shape[0]``, ``a.ndim``) — host math on metadata is not
    a device sync."""
    return any(isinstance(sub, ast.Attribute)
               and sub.attr in ("shape", "ndim", "dtype", "size")
               for sub in ast.walk(node))


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def collect_py_files(paths: Sequence[str]) -> list:
    files = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            files.extend(os.path.join(dirpath, f)
                         for f in sorted(filenames) if f.endswith(".py"))
    return files


def _load_tests(tests_dir: str | None) -> dict:
    out = {}
    if tests_dir and os.path.isdir(tests_dir):
        for f in collect_py_files([tests_dir]):
            with open(f, encoding="utf-8") as fh:
                out[os.path.basename(f)] = fh.read()
    return out


def lint_sources(sources: dict, rules: Sequence[Rule], *,
                 tests_sources: dict | None = None) -> LintResult:
    """Lint in-memory sources ({rel_path: text}) — the fixture entry
    point; :func:`lint_paths` reduces to this."""
    mods, findings = [], []
    for rel, text in sources.items():
        try:
            mods.append(ModuleInfo(rel, text))
        except SyntaxError as e:
            findings.append(Finding("parse-error", rel, e.lineno or 1,
                                    f"could not parse: {e.msg}"))
    raw = list(findings)
    for mod in mods:
        for w in mod.waivers:
            if not w.justification:
                raw.append(Finding(
                    "waiver-justification", w.path, w.line,
                    "waiver is missing a justification"
                    " (use `# foglint: disable=<rule> -- <why>`)"))
        for rule in rules:
            raw.extend(rule.check_module(mod))
    ctx = RepoContext(tests_sources=dict(tests_sources or {}))
    for rule in rules:
        raw.extend(rule.check_repo(mods, ctx))
    by_rel = {m.rel: m for m in mods}
    kept, waived = [], []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        mod = by_rel.get(f.path)
        (waived if mod is not None and mod.waived(f) else kept).append(f)
    waivers = [w for m in mods for w in m.waivers]
    return LintResult(kept, waived, waivers)


def lint_paths(paths: Sequence[str], rules: Sequence[Rule], *,
               tests_dir: str | None = None,
               root: str | None = None) -> LintResult:
    root = os.path.abspath(root or os.path.commonpath(
        [os.path.abspath(p) for p in paths]))
    sources = {}
    for f in collect_py_files(list(paths)):
        rel = os.path.relpath(os.path.abspath(f), root)
        with open(f, encoding="utf-8") as fh:
            sources[rel] = fh.read()
    return lint_sources(sources, rules,
                        tests_sources=_load_tests(tests_dir))
