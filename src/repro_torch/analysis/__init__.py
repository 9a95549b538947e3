"""fog-lint for the port: static analysis of the invariants the fog
engine's design rests on (the port's copy of :mod:`repro.analysis`, its
rules in torch idiom).

    PYTHONPATH=src python -m repro_torch.analysis        # lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis --list-waivers

Rules: dense-materialization, nan-unsafe-masking, recompile-hazard,
host-sync-in-hot-path, rng-stream-discipline, oracle-pairing.
"""
from repro_torch.analysis.core import (Finding, LintResult,  # noqa: F401
                                       ModuleInfo, RepoContext, Rule,
                                       Waiver, lint_paths, lint_sources)
from repro_torch.analysis.rules import all_rules, rules_by_name  # noqa: F401
