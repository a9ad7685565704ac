"""span-balance: every ``Tracer.start(...)`` must be closed.

The tracing subsystem (obs/) records a span only when it
FINISHES — an unclosed span never reaches the ring buffer, silently
orphans every child that named it as parent, and (if made current)
leaks a stale context that mis-parents unrelated spans. The safe
shapes are structural:

- ``with tracer.start(...):`` / ``with tracer.start(...) as sp:``
  (the context manager finishes on exit, error attr included), or
- starting inside a ``try:`` whose ``finally`` owns the ``finish()``
  (the generator/driver shape — serve/stream.py).

A span that legitimately OUTLIVES its frame (the engine's per-request
spans are finished by the batcher thread at resolve time) is the
exception, not the rule — those sites carry an inline
``# cesslint: disable=span-balance`` with the justification, exactly
like the other analyzer families handle justified violations.

Detection is receiver-name based (an attribute call ``<recv>.start()``
where the receiver's last segment names a tracer): AST analysis cannot
type ``x.start()``, and matching every ``.start()`` would drown in
``Thread.start()`` false positives. The obs package itself is exempt
(it is the implementation being wrapped).
"""
from __future__ import annotations

import ast

from .core import Finding, ParsedModule, Rule, dotted, path_parts, register


def _is_tracer_start(node: ast.AST) -> bool:
    """A call ``<recv>.start(...)`` whose receiver's final name
    segment identifies a tracer (``tracer``, ``_tracer``,
    ``self.tracer``, ``engine_tracer``, ...)."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "start"):
        return False
    recv = dotted(node.func.value)
    if recv is None:
        return False
    return recv.rsplit(".", 1)[-1].lower().endswith("tracer")


@register
class SpanBalance(Rule):
    id = "span-balance"
    description = ("Tracer.start(...) not managed by a with block or "
                   "a try/finally")
    hint = ("wrap the call: `with tracer.start(...) as span:` (or use "
            "obs.span(...)), or start inside a try: whose finally: "
            "calls span.finish(); a span that must outlive the frame "
            "needs an inline justification "
            "(# cesslint: disable=span-balance)")

    def applies(self, path: str) -> bool:
        # everywhere tracing is threaded — except trace.py itself,
        # whose whole job is constructing and managing spans. The
        # exemption used to cover the whole obs package; a later change adds
        # obs/slo.py (a CONSUMER of spans, not the implementation), so
        # the carve-out is now exactly the implementation module.
        parts = path_parts(path)
        return not ("obs" in parts and parts
                    and parts[-1] == "trace.py")

    def check(self, mod: ParsedModule) -> list[Finding]:
        managed: set[int] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                # anything inside a with-item's context expression is
                # closed by __exit__ (IfExp-wrapped starts included)
                for item in node.items:
                    for sub in ast.walk(item.context_expr):
                        if _is_tracer_start(sub):
                            managed.add(id(sub))
            elif isinstance(node, ast.Try) and node.finalbody:
                # a start anywhere under a try/finally is treated as
                # balanced — the finally path owns the finish()
                for sub in ast.walk(node):
                    if _is_tracer_start(sub):
                        managed.add(id(sub))
        out = []
        for node in ast.walk(mod.tree):
            if _is_tracer_start(node) and id(node) not in managed:
                out.append(self.finding(
                    mod, node,
                    f"`{dotted(node.func)}(...)` is not closed by a "
                    "with block or try/finally — an unfinished span "
                    "never reaches the ring buffer and orphans its "
                    "children"))
        return out
