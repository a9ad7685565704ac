"""Consensus-determinism analyzers for the runtime pallets (chain/).

Every replica must compute bit-identical state transitions from the
same block stream. Three bug classes break that silently:

- iterating a ``set`` (hash order — randomized per process for
  bytes/str keys) or a ``dict`` (insertion order — divergent when
  replicas built the map along different paths) on a path that feeds
  hashing, state roots, or extrinsic application;
- reading the wall clock or an OS entropy source inside a state
  transition (replicas disagree; replay disagrees with live
  execution);
- float arithmetic (platform-dependent rounding; the reference
  runtime is integer-only for exactly this reason).

Rules:
- consensus-unordered-iter : for/comprehension over .keys()/.values()/
                             .items()/set(...) without sorted(...)
                             (order-insensitive folds like
                             sum()/min()/max()/any()/all() are exempt)
- consensus-wallclock      : time.time / random.* / os.urandom /
                             datetime.now / uuid4 in a chain module
- consensus-float          : float literal, true division, or
                             float(...) in a chain module
"""
from __future__ import annotations

import ast

from .core import Finding, ParsedModule, Rule, dotted, path_parts, register


class _ChainRule(Rule):
    def applies(self, path: str) -> bool:
        return "chain" in path_parts(path)


# -- unordered iteration ------------------------------------------------------
_UNORDERED_METHODS = {"keys", "values", "items"}
_WRAP_TRANSPARENT = {"list", "tuple", "iter", "reversed", "enumerate"}
_ORDER_INSENSITIVE = {"sorted", "sum", "min", "max", "any", "all", "len",
                      "set", "frozenset", "dict", "Counter"}


_CONTAINER_CTORS = {"dict", "set", "frozenset", "defaultdict", "Counter"}


def _local_containers(scope: ast.AST) -> set[str]:
    """Names in this scope assigned ONLY from dict/set displays,
    comprehensions, or dict()/set()-style constructors — cheap local
    inference so bare ``for k in d:`` is caught, not just
    ``d.items()``. A name also assigned from anything else is
    ambiguous and dropped."""
    container: set[str] = set()
    other: set[str] = set()
    for node in ast.walk(scope):
        if node is not scope and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue            # nested scopes infer separately
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        is_container = isinstance(
            value, (ast.Dict, ast.Set, ast.DictComp, ast.SetComp)) \
            or (isinstance(value, ast.Call)
                and (dotted(value.func) or "").rsplit(".", 1)[-1]
                in _CONTAINER_CTORS)
        for t in targets:
            if isinstance(t, ast.Name):
                (container if is_container else other).add(t.id)
    return container - other


def _unordered_root(expr: ast.AST,
                    containers: set[str] = frozenset()) -> ast.AST | None:
    """The unordered set/dict-view subexpression an iteration order
    depends on, or None if the expression has a defined order."""
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return expr
    if isinstance(expr, ast.Name) and expr.id in containers:
        return expr
    if isinstance(expr, ast.Call):
        fq = dotted(expr.func) or ""
        leaf = fq.rsplit(".", 1)[-1]
        if isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in _UNORDERED_METHODS \
                and not expr.args:
            # a dict DISPLAY iterates in source order — deterministic
            if isinstance(expr.func.value, ast.Dict):
                return None
            return expr
        if leaf in ("set", "frozenset"):
            return expr
        if leaf in _WRAP_TRANSPARENT and expr.args:
            return _unordered_root(expr.args[0], containers)
        if leaf == "zip":
            for a in expr.args:
                r = _unordered_root(a, containers)
                if r is not None:
                    return r
    return None


def _scope_nodes(scope: ast.AST):
    """Nodes of one scope, not descending into nested functions."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


@register
class UnorderedIter(_ChainRule):
    id = "consensus-unordered-iter"
    description = ("set/dict iteration without sorted() in a consensus "
                   "module")
    hint = ("wrap the iterable in sorted(...) (key=repr for "
            "heterogeneous keys), or suppress with a comment proving "
            "the consumer is order-independent")

    def check(self, mod: ParsedModule) -> list[Finding]:
        # comprehensions that are the direct argument of an
        # order-insensitive fold (sum(x for ...), sorted([... for ...]))
        exempt: set[ast.AST] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                fq = dotted(node.func) or ""
                if fq.rsplit(".", 1)[-1] in _ORDER_INSENSITIVE:
                    for a in node.args:
                        exempt.add(a)
        out = []
        scopes = [mod.tree] + [
            n for n in ast.walk(mod.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            containers = _local_containers(scope)
            for node in _scope_nodes(scope):
                sites: list[tuple[ast.AST, ast.AST]] = []
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    sites.append((node.iter, node))
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.DictComp, ast.GeneratorExp)):
                    if node in exempt:
                        continue
                    for gen in node.generators:
                        sites.append((gen.iter, node))
                for iterable, at in sites:
                    root = _unordered_root(iterable, containers)
                    if root is None:
                        continue
                    desc = ast.unparse(root) if hasattr(ast, "unparse") \
                        else "unordered iterable"
                    out.append(self.finding(
                        mod, at,
                        f"iteration over `{desc}` has no canonical "
                        "order in a consensus module"))
        return out


# -- wall clock / entropy -----------------------------------------------------
_WALLCLOCK = {"time.time", "time.time_ns", "time.monotonic",
              "time.monotonic_ns", "time.perf_counter",
              "datetime.now", "datetime.utcnow",
              "datetime.datetime.now", "datetime.datetime.utcnow",
              "os.urandom", "uuid.uuid4", "uuid.uuid1"}
_WALLCLOCK_PREFIXES = ("random.", "np.random.", "numpy.random.",
                       "secrets.")


@register
class Wallclock(_ChainRule):
    id = "consensus-wallclock"
    description = ("wall-clock or process-entropy source in a "
                   "consensus module")
    hint = ("derive from on-chain inputs instead: block number, "
            "randomness pallet output, or a seeded deterministic "
            "stream")

    def check(self, mod: ParsedModule) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Attribute):
                continue
            fq = dotted(node)
            if fq is None:
                continue
            if fq in _WALLCLOCK or fq.startswith(_WALLCLOCK_PREFIXES):
                out.append(self.finding(
                    mod, node,
                    f"`{fq}` is nondeterministic across replicas"))
        return out


# -- float arithmetic ---------------------------------------------------------
@register
class FloatArithmetic(_ChainRule):
    id = "consensus-float"
    description = ("float literal, true division, or float() in a "
                   "consensus module")
    hint = ("use integer arithmetic: `//` with an explicit rounding "
            "rule, or fixed-point (PER_BILL-style) ratios")

    def check(self, mod: ParsedModule) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, float):
                out.append(self.finding(
                    mod, node,
                    f"float literal {node.value!r} in a consensus "
                    "module"))
            elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                out.append(self.finding(
                    mod, node,
                    "true division `/` produces platform-rounded "
                    "floats"))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id == "float":
                out.append(self.finding(
                    mod, node, "float(...) in a consensus module"))
        return out
