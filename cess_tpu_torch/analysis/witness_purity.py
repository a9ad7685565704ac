"""witness-purity: taint tracking from nondeterminism sources into
replay-witness sinks.

The house replay contract — "same seed ⇒ byte-identical witness" — is
re-proven per PR by hand-written replay drills, but the property is
static: a witness byte can only diverge if a nondeterministic VALUE
(wall clock, entropy, thread id, object address, hash-order escape)
flows into the bytes the witness serializes. This rule makes that a
compile-time property: the flow layer's taint lattice (flow.py)
propagates sources through calls, parameters, fields and containers
to a fixpoint, and any taint reaching a witness sink is an error.

Sinks (the taint-sink registry, documented in README):
- the RETURN value of any function named ``witness``, ``canon``,
  ``transition_log``, ``fired_log`` or ``placement_log`` — the
  serialization points every replay assertion compares;
- APPENDS into journal-shaped fields (attribute name containing
  ``journal``, ``transition``, ``fired``, ``placement`` or
  ``witness``) — the count-sequenced logs those methods read back.

Only explicit dataflow counts (see flow.py): a detector whose
*decisions* are count-sequenced but whose observation timing is
wall-clock driven is the house design, not a finding.
"""
from __future__ import annotations

import ast
import re

from .core import Finding, ParsedModule, Rule, register
from .flow import ORDER_SOURCE, Taint, _TaintPass, flow_graph

#: functions whose return value IS witness bytes
SINK_FUNCS = frozenset({"witness", "canon", "transition_log",
                        "fired_log", "placement_log"})
#: fields that hold count-sequenced witness journals
SINK_FIELD_RE = re.compile(
    r"journal|transition|fired|placement|witness", re.IGNORECASE)
#: container-mutating methods that feed a sink field
_ADDERS = frozenset({"append", "appendleft", "extend", "add", "insert"})


class _SinkPass(_TaintPass):
    """A reporting pass over one function: re-evaluates taint with
    the converged facts and records tainted sink touches."""

    def __init__(self, graph, fi, hits: list):
        super().__init__(graph, fi)
        self.hits = hits                 # (node, kind, taints)
        self.sink_fn = fi.name in SINK_FUNCS
        self.aliases: dict[str, str] = {}    # local -> sink field attr

    def _stmt(self, node):
        # track local aliases of sink fields BEFORE evaluating the
        # statement (``journal = self._journals.get(...)``)
        if isinstance(node, ast.Assign):
            attr = _sink_field_read(node.value)
            if attr is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.aliases[t.id] = attr
        if isinstance(node, ast.Return) and node.value is not None \
                and self.sink_fn:
            t = self._expr(node.value)
            if t:
                self.hits.append((node, "return", t))
        super()._stmt(node)

    def _call(self, node):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _ADDERS:
            recv = node.func.value
            attr = None
            if isinstance(recv, ast.Name):
                attr = self.aliases.get(recv.id)
            else:
                attr = _sink_field_read(recv)
            if attr is not None and SINK_FIELD_RE.search(attr):
                t = set()
                for a in node.args:
                    t |= self._expr(a)
                if t:
                    self.hits.append((node, f"append to self.{attr}", t))
        return super()._call(node)


def _sink_field_read(expr: ast.AST) -> str | None:
    """The self-attr a (possibly subscripted/called) expression reads
    through, when that attr looks like a witness journal."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Attribute) \
                and isinstance(sub.value, ast.Name) \
                and sub.value.id == "self" \
                and SINK_FIELD_RE.search(sub.attr):
            return sub.attr
    return None


@register
class WitnessPurity(Rule):
    id = "witness-purity"
    description = ("nondeterministic value (wall clock / entropy / "
                   "thread id / id() / hash-order escape) flows into "
                   "a replay-witness sink")
    hint = ("witnesses must be pure functions of the seed and the "
            "count-sequenced event stream: derive the value from a "
            "sequence counter or a SHA-256 stream over the seed, or "
            "keep the timing field OUT of the witnessed bytes")

    def applies(self, path: str) -> bool:
        return True              # package-wide: the flow graph needs
        #                          every module to resolve calls

    def check_project(self, mods: list[ParsedModule]) -> list[Finding]:
        graph = flow_graph(mods)
        by_path = {m.path: m for m in mods}
        out: list[Finding] = []
        seen: set[tuple] = set()
        for fi in graph.functions.values():
            hits: list = []
            _SinkPass(graph, fi, hits).run()
            mod = by_path.get(fi.path)
            if mod is None:
                continue
            qual = f"{fi.cls}.{fi.name}" if fi.cls else fi.name
            for node, kind, taints in hits:
                origin = _pick(taints)
                key = (fi.fqid, getattr(node, "lineno", 0),
                       origin.source)
                if key in seen:
                    continue
                seen.add(key)
                what = "returns a value" if kind == "return" \
                    else f"{kind} records a value"
                why = "iteration order of an unordered container " \
                      "escapes into the witness" \
                    if origin.source == ORDER_SOURCE \
                    else f"influenced by {origin.describe()}"
                out.append(self.finding(
                    mod, node,
                    f"witness sink `{qual}` {what} {why} — same-seed "
                    "replays can diverge byte-for-byte"))
        return out


def _pick(taints: set[Taint]) -> Taint:
    """Deterministic representative origin (wallclock-style sources
    outrank order taint; then lexicographic)."""
    return min(taints, key=lambda t: (t.source == ORDER_SOURCE,
                                      t.source, t.path, t.line))
