"""Rule plugin registry: every module here exports ``RULES``."""
from __future__ import annotations

import importlib

RULE_MODULES = ("dense", "masking", "recompile", "hostsync", "rng",
                "oracle")


def all_rules() -> list:
    rules = []
    for modname in RULE_MODULES:
        mod = importlib.import_module(f"{__name__}.{modname}")
        rules.extend(mod.RULES)
    return rules


def rules_by_name(names=None) -> list:
    rules = all_rules()
    if names is None:
        return rules
    wanted = set(names)
    known = {r.name for r in rules}
    unknown = wanted - known
    if unknown:
        raise ValueError(f"unknown rule(s): {sorted(unknown)};"
                         f" known: {sorted(known)}")
    return [r for r in rules if r.name in wanted]
