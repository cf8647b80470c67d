"""Graph-invariant linter: structured checks of what the port runs — the
port of ``repro/analysis``.

The hazards that sink this system are graph-shape bugs, not value bugs:
an overlap pipeline whose windows no longer overlap (PR 5), a backward
that re-runs the forward grouped kernel (PR 3), a quantized wire feeding
a matmul (PR 10), a serving step built per call (PR 7).  Outputs stay
right while the program quietly loses the property.  The reference
checks its traced jaxprs and compiled HLO; eager PyTorch has neither, so
this package checks the record of one run:

* ``graph.OpGraph`` — the ordered aten ops, logged collectives and
  kernel-wrapper calls of one run of a function (and of its backward),
  each with its phase and enclosing kernel wrappers
  (:func:`trace_graph`); there is no HLO view;
* ``rules`` — the registry of ``Rule(name, level, check(Graph) ->
  [Finding])``, the reference's nine rules under their names;
* ``lint`` — the config-matrix CLI, ``python -m repro_torch.analysis.lint
  [--config NAME] [--json PATH] [--device cuda|cpu]``: the reference's 36
  cells, each mesh's cells in one spawn of gloo ranks, and the probes;
  writes ``LINT_moe_torch.json`` and exits 1 on error findings.

Library entry points::

    from repro_torch import analysis

    g = analysis.trace_graph(fn, *args, context={"cfg": cfg,
                                                 "model_size": 4, ...})
    findings = analysis.lint_ops(g)                 # every op-graph rule
    findings = analysis.run_rule("dtype-leak", g)   # one rule
    findings = analysis.lint_probe(donated=train_state)

Findings carry ``(rule, level, location, message, config)``;
``location`` is the structural path (``bwd/grouped_matmul``), so a
finding names where in the program the invariant broke.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

from repro_torch.analysis.graph import OpGraph, OpSite, ProbeGraph, trace_graph
from repro_torch.analysis.rules import (COLLECTIVE_PRIMITIVES, DOT_PRIMITIVES,
                                        LEVELS, REGISTRY, Finding, Rule,
                                        lint_graph, register, rules_for,
                                        run_rule)

__all__ = [
    "COLLECTIVE_PRIMITIVES", "DOT_PRIMITIVES", "Finding", "LEVELS",
    "OpGraph", "OpSite", "ProbeGraph", "REGISTRY", "Rule", "lint_graph",
    "lint_ops", "lint_probe", "register", "rules_for", "run_rule",
    "trace_graph",
]


def lint_ops(graph: OpGraph, *,
             rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run the registered op-graph rules over a recorded graph — the
    reference's ``lint_jaxpr``."""
    return lint_graph(graph, rules)


def lint_probe(rules: Optional[Iterable[str]] = None,
               **context) -> List[Finding]:
    """Run the probe rules over runtime evidence, e.g.
    ``lint_probe(donated=state)`` or
    ``lint_probe(trace_counts=engine.trace_counts)``."""
    return lint_graph(ProbeGraph(context), rules)
