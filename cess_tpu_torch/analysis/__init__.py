"""cesslint: AST-based static analysis for the cess_tpu_torch codebase.

The port's copy of the reference's analyzers (``cess_tpu/analysis``):
every rule as it is there, so the same source gives the same findings
whichever package analyses it.

Rule families over one shared parse (core.py) and one shared
interprocedural pass (flow.py — call graph, thread roots, taint):

- trace-safety (trace_safety.py)      — ops/, serve/
- lock-discipline (lock_discipline.py) — serve/, node/
- consensus-determinism (determinism.py) — chain/
- sim-determinism (sim_determinism.py) — sim/, obs/ planes
- span-balance (span_balance.py)       — serve/, node/, obs/
- witness-purity (witness_purity.py)   — package-wide taint flow
- race (race.py)                       — cross-thread lock sets
- seam-cost (seam_cost.py)             — zero-cost hook guards

``trace-safety`` checks ``@jax.jit`` and ``pallas_call`` bodies; the
port has neither, so over ``cess_tpu_torch/`` it finds nothing.

CLI: ``python -m cess_tpu_torch.analysis [paths] [--rule ID] [--json]
[--fix-hints] [--baseline FILE] [--write-baseline] [--sarif PATH]``
(default path ``cess_tpu_torch/``). Gate: tests/test_torch_lint.py.
Suppress a single true positive with ``# cesslint: disable=<rule-id>``
on (or directly above) the line; bulk legacy debt goes in the port's
baseline, ``cess_tpu_torch/analysis/cesslint_baseline.json``.
"""
from .core import (Directive, Finding, LintResult, ParsedModule, Rule,
                   all_rules, apply_baseline, lint_modules, lint_paths,
                   lint_source, load_baseline, sarif_report,
                   write_baseline)

__all__ = [
    "Directive", "Finding", "LintResult", "ParsedModule", "Rule",
    "all_rules", "apply_baseline", "lint_modules", "lint_paths",
    "lint_source", "load_baseline", "sarif_report", "write_baseline",
]
