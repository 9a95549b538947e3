"""rng-stream-discipline: producers must derive their seeds.

The fault plane's twin contract (``FaultSchedule`` draws from
``seed + 7919``, so fault randomness never perturbs the data stream),
the churn and flap producers and the synthetic data generators all rely
on every random stream being a pure function of an explicit, derived
seed. Each of these breaks that silently:

* numpy: a bare ``np.random.default_rng()`` (OS entropy: runs cannot be
  repeated), a hardcoded ``default_rng(0)`` (streams collide across
  call sites instead of deriving from the scenario seed), a module-level
  ``np.random.*`` draw (hidden global state);
* torch: ``torch.manual_seed`` (the global generator, shared with every
  other caller), a ``torch.Generator()`` that is not seeded in the same
  expression from a derived value (``torch.Generator().manual_seed(
  seed)``), and ``torch.rand``/``randn``/``randint``/``randperm``/
  ``rand_like``/``randn_like``/``normal``/``bernoulli``/``multinomial``
  without ``generator=``.

Scope: the producer modules (topology, faults, costs, the schedule,
synthetic data, the pipeline). A flagged site either derives its seed
or carries a waiver saying why a fixed stream is right there.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, ModuleInfo, Rule, call_name

SCOPE = ("core/topology.py", "core/faults.py", "core/costs.py",
         "data/synthetic.py", "data/pipeline.py", "core/schedule.py")

GLOBAL_NP_FNS = {"rand", "randn", "randint", "random", "choice",
                 "permutation", "shuffle", "normal", "uniform",
                 "poisson", "binomial", "seed"}
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
               "randn_like", "randint_like", "normal", "bernoulli",
               "multinomial"}


def _seeded_generator(mod: ModuleInfo, node: ast.Call) -> bool:
    """``torch.Generator(...).manual_seed(x)`` with x not a literal."""
    attr = mod.parent(node)
    call = mod.parent(attr) if attr is not None else None
    return (isinstance(attr, ast.Attribute) and attr.attr == "manual_seed"
            and isinstance(call, ast.Call) and call.func is attr
            and bool(call.args)
            and not isinstance(call.args[0], ast.Constant))


class RngDisciplineRule(Rule):
    name = "rng-stream-discipline"
    description = ("underived rng seed in a producer module (bare/"
                   "literal default_rng, global np.random or torch"
                   " stream, unseeded torch.Generator)")

    def check_module(self, mod: ModuleInfo):
        if not mod.match(*SCOPE):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                yield from self._check(mod, node, call_name(node))

    def _check(self, mod, node, name):
        tail = name.rsplit(".", 1)[-1]
        if name.endswith("default_rng"):
            if not node.args and not node.keywords:
                yield Finding(
                    self.name, mod.rel, node.lineno,
                    "`default_rng()` with no seed draws OS entropy: the"
                    " produced stream cannot be repeated; derive the"
                    " seed from the scenario config")
            elif node.args and isinstance(node.args[0], ast.Constant):
                yield Finding(
                    self.name, mod.rel, node.lineno,
                    f"`default_rng({node.args[0].value!r})` hardcodes"
                    " the stream: call sites collide instead of"
                    " deriving from the scenario seed")
        elif (name.startswith(("np.random.", "numpy.random."))
              and tail in GLOBAL_NP_FNS):
            yield Finding(
                self.name, mod.rel, node.lineno,
                f"`{name}` uses the hidden global numpy stream;"
                " thread an explicit Generator instead")
        elif name == "torch.manual_seed":
            yield Finding(
                self.name, mod.rel, node.lineno,
                "`torch.manual_seed` seeds the global torch stream that"
                " every caller shares; draw from a"
                " `torch.Generator().manual_seed(<derived seed>)`")
        elif name == "torch.Generator":
            if not _seeded_generator(mod, node):
                yield Finding(
                    self.name, mod.rel, node.lineno,
                    "`torch.Generator()` without a derived"
                    " `.manual_seed(...)` in the same expression starts"
                    " from a fixed or unknown state")
        elif (name.startswith("torch.") and name.count(".") == 1
              and tail in TORCH_DRAWS
              and not any(k.arg == "generator" for k in node.keywords)):
            yield Finding(
                self.name, mod.rel, node.lineno,
                f"`{name}` without `generator=` draws from the global"
                " torch stream; pass a Generator seeded from the"
                " scenario")


RULES = [RngDisciplineRule()]
