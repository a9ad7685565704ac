"""seam-cost: zero-cost-when-off hook seams must really be zero-cost.

Every observability/resilience plane hangs off the hot path through
one idiom — load a carrier, check it, bail:

    rec = _RECORDER            # one module-global load
    if rec is None:            # one check
        return                 # disarmed: nothing allocated, nothing
    rec.note(...)              #           formatted, nothing called

The contract is repeated in a dozen docstrings ("one load, one
check") but until now nothing verified it, and the failure mode is
silent: an f-string, a dict literal or a helper call drifting above
the guard taxes EVERY production request to feed a hook that is off.
This rule recognizes the guard shape structurally and audits the
statements the disarmed path executes before it.

Carriers (the seam registry, documented in README):
- module globals named ``_ALLCAPS`` (``_RECORDER``, ``_TRACER``,
  ``_PLAN``) and no-arg ``.get()`` reads off them (the ContextVar
  idiom ``_CURRENT.get()`` — a load-equivalent);
- optional plane attributes read off ``self``: the ``SEAM_ATTRS``
  registry (``self.slo``, ``self.adaptive``, ``self.profile``, ...).

Before the guard only docstrings and pure-load binds (name,
constant, attribute chain, carrier ``.get()``) may run; any
allocation (container/tuple literal), f-string, arithmetic or call
is a finding.  Functions that do real work before a late guard are
NOT seams and are skipped — the audit stops at the first
non-bind statement, so ``self._drain(); rec = _RECORDER; ...`` is
legitimate armed-and-disarmed work, while ``payload = f"{a}:{b}"``
before the guard is the bug.

Registered hooks (``REGISTERED_HOOKS``) — the seams production code
actually calls — must additionally HAVE a conforming guard at all.
"""
from __future__ import annotations

import ast
import re

from .core import Finding, ParsedModule, Rule, register

#: module-global seam carriers: _RECORDER, _TRACER, _PLAN, _CURRENT...
CARRIER_RE = re.compile(r"^_[A-Z][A-Z0-9_]*$")
#: optional plane attributes consumers guard with ``x = self.<attr>``
SEAM_ATTRS = frozenset({
    "slo", "adaptive", "profile", "tracer", "recorder", "flight",
    "fleet", "chainwatch", "remediation", "custody", "watch",
    "admission", "resilience", "plan",
})
#: (path suffix, function) pairs that MUST carry the guard — the
#: hooks every subsystem calls unconditionally on hot paths
REGISTERED_HOOKS = frozenset({
    ("obs/flight.py", "note"),
    ("obs/trace.py", "span"),
    ("obs/trace.py", "current_span"),
    ("obs/trace.py", "event"),
    ("obs/trace.py", "context"),
    ("resilience/faults.py", "_fire"),
})


def _is_carrier(node: ast.AST, binds: dict[str, bool]) -> bool:
    """Is this expression a seam carrier read (directly, or a local
    bound from one)?"""
    if isinstance(node, ast.Name):
        return CARRIER_RE.match(node.id) is not None \
            or binds.get(node.id, False)
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name):
        if node.value.id == "self" and node.attr in SEAM_ATTRS:
            return True
        return CARRIER_RE.match(node.value.id) is not None
    return False


def _pure_load(node: ast.AST) -> bool:
    """Name / constant / dotted attribute chain — no allocation, no
    call, no formatting."""
    if isinstance(node, (ast.Name, ast.Constant)):
        return True
    if isinstance(node, ast.Attribute):
        return _pure_load(node.value)
    return False


def _carrier_get(node: ast.AST) -> bool:
    """``_CURRENT.get()`` — the no-arg ContextVar read, one load
    equivalent."""
    return (isinstance(node, ast.Call)
            and not node.args and not node.keywords
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and isinstance(node.func.value, ast.Name)
            and CARRIER_RE.match(node.func.value.id) is not None)


def _allowed_bind(rhs: ast.AST) -> bool:
    return _pure_load(rhs) or _carrier_get(rhs)


def _guard_test(test: ast.AST) -> tuple[ast.AST, bool] | None:
    """(tested expr, negated) for ``X is None`` / ``not X`` (negated:
    the body is the DISARMED path) or ``X is not None`` / ``X``
    (body is the armed path)."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value is None:
        if isinstance(test.ops[0], ast.Is):
            return test.left, True
        if isinstance(test.ops[0], ast.IsNot):
            return test.left, False
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return test.operand, True
    if isinstance(test, (ast.Name, ast.Attribute)):
        return test, False
    return None


def _cheap_return(body: list[ast.stmt]) -> bool:
    """The disarmed path: a single return of nothing / a constant / a
    pure load (``return NOOP_SPAN``)."""
    if len(body) != 1 or not isinstance(body[0], ast.Return):
        return False
    value = body[0].value
    return value is None or _pure_load(value)


@register
class SeamCost(Rule):
    id = "seam-cost"
    description = ("work (allocation / f-string / call) on the "
                   "disarmed path before a zero-cost seam guard")
    hint = ("the disarmed path must be one carrier load plus one "
            "None/truthiness check — move every allocation, format "
            "and call below the guard so an un-armed hook costs "
            "nothing")

    def applies(self, path: str) -> bool:
        return True

    def check(self, mod: ParsedModule) -> list[Finding]:
        out: list[Finding] = []
        hooks_due = {name for (suffix, name) in REGISTERED_HOOKS
                     if mod.path.endswith(suffix)}
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            guarded = self._audit(mod, fn, out)
            if guarded and fn.name in hooks_due:
                hooks_due.discard(fn.name)
            elif not guarded and fn.name in hooks_due:
                out.append(self.finding(
                    mod, fn,
                    f"registered zero-cost hook `{fn.name}` has no "
                    "one-load + None-check guard at the top — every "
                    "call pays full cost even when the plane is "
                    "disarmed"))
                hooks_due.discard(fn.name)
        return out

    def _audit(self, mod: ParsedModule,
               fn: ast.FunctionDef, out: list[Finding]) -> bool:
        """Walk the statement prefix; returns True when a conforming
        seam guard was found (after reporting any expensive
        statements the disarmed path would execute first)."""
        body = list(fn.body)
        if body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            body = body[1:]                       # docstring
        binds: dict[str, bool] = {}               # name -> carrier?
        prefix: list[tuple[ast.stmt, ast.AST]] = []   # (stmt, rhs)
        for i, stmt in enumerate(body):
            if isinstance(stmt, ast.Assign) \
                    and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                rhs = stmt.value
                binds[stmt.targets[0].id] = (
                    _is_carrier(rhs, binds) or _carrier_get(rhs))
                prefix.append((stmt, rhs))
                continue
            if isinstance(stmt, ast.If):
                parsed = _guard_test(stmt.test)
                if parsed is None:
                    return False
                tested, negated = parsed
                if not _is_carrier(tested, binds):
                    return False
                if negated:                # if X is None: return ...
                    seam = _cheap_return(stmt.body)
                else:                      # if X is not None: <body>
                    seam = i == len(body) - 1 and not stmt.orelse
                if not seam:
                    return False
                carrier = ast.unparse(tested)
                for bstmt, rhs in prefix:
                    if not _allowed_bind(rhs):
                        out.append(self.finding(
                            mod, bstmt,
                            f"`{ast.unparse(bstmt.targets[0])} = "
                            f"{ast.unparse(rhs)}` runs before the "
                            f"disarmed-seam guard on `{carrier}` — "
                            "this work is paid even when the hook "
                            "is off"))
                return True
            return False                   # real work: not a seam
        return False
