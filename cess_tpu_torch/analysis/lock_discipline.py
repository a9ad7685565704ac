"""Lock-discipline analyzers for the multithreaded node (serve/, node/).

The serve engine (serve/engine.py) is a lock-and-condition-variable
core; the gossip/RPC/DHT layers (node/net.py, node/rpc.py,
node/dht.py) share state across accept/dial/author/handler threads.
The bug classes here — a field mutated outside the lock that guards it
everywhere else, a blocking call made while holding a lock every other
thread needs, two locks taken in opposite orders on different paths —
produce rare, timing-dependent corruption no unit test reliably
reproduces, but all three are mechanically detectable from the AST.

Rules:
- lock-unguarded-write : an attribute written under ``with self.<lock>``
                         in one method is written WITHOUT the lock in
                         another (``__init__`` is pre-publication and
                         exempt)
- lock-blocking-call   : time.sleep / Future.result / Thread.join /
                         socket recv-accept / block_until_ready while
                         a lock is held (``cond.wait`` is exempt — it
                         releases the lock)
- lock-order-cycle     : lock acquisition order forms a cycle across
                         methods/classes (syntactic nesting plus
                         one level of self.method / typed-attribute
                         call resolution)
"""
from __future__ import annotations

import ast
import dataclasses

from .core import Finding, ParsedModule, Rule, dotted, path_parts, register

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}
_BLOCKING_METHODS = {"result", "join", "recv", "recv_into", "accept",
                     "block_until_ready", "sendall"}
_BLOCKING_CALLS = {"time.sleep"}


def _lock_factory(value: ast.AST) -> ast.Call | None:
    """The threading.Lock()/RLock()/Condition() call inside an
    assignment value, if any (handles ``x if y else Lock()``)."""
    for n in ast.walk(value):
        if isinstance(n, ast.Call):
            fq = dotted(n.func) or ""
            if fq.rsplit(".", 1)[-1] in _LOCK_FACTORIES \
                    and ("threading" in fq or "." not in fq):
                return n
    return None


@dataclasses.dataclass
class _Write:
    attr: str
    method: str
    # canonical locks held at the write; None means "caller holds the
    # lock" (the *_locked method convention) — trusted, not reported
    held: frozenset | None
    node: ast.AST


@dataclasses.dataclass
class _Blocking:
    call: str
    lock: str
    method: str
    node: ast.AST


@dataclasses.dataclass
class _ClassLocks:
    """Everything the walker learned about one class."""
    name: str
    mod: ParsedModule
    lock_attrs: dict[str, str]          # attr -> canonical lock attr
    rlocks: set[str]                    # reentrant (self-nesting ok)
    conditions: set[str]                # attrs that are Condition objects
    writes: list[_Write]
    blocking: list[_Blocking]
    # lock-order evidence: (outer, inner) -> example node
    nest_edges: dict[tuple[str, str], ast.AST]
    # re-acquisition of a held non-reentrant lock: (attr, node)
    self_nest: list[tuple[str, ast.AST]]
    held_calls: list[tuple[str, str, ast.AST]]  # (held lock, call fq, node)
    attr_types: dict[str, str]          # self.X = ClassName(...) in __init__
    method_locks: dict[str, set[str]]   # method -> locks acquired directly


def _self_attr_target(node: ast.AST) -> str | None:
    """The X of a ``self.X = ...`` / ``self.X[...] = ...`` /
    ``del self.X[...]`` target."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class _MethodWalker(ast.NodeVisitor):
    """Walk one method body tracking which of the class's locks are
    held (syntactic ``with self.<lock>`` scopes)."""

    def __init__(self, cls: _ClassLocks, method: str):
        self.cls = cls
        self.method = method
        self.stack: list[str] = []      # canonical lock names held
        # convention: a ``*_locked`` method is only called with the
        # lock already held — its writes are guarded by the caller
        self.assume_locked = method.endswith("_locked")

    # -- lock scopes -----------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            fq = dotted(item.context_expr)
            if fq and fq.startswith("self."):
                attr = fq[len("self."):]
                if attr in self.cls.lock_attrs:
                    lock = self.cls.lock_attrs[attr]
                    if lock in self.stack:
                        # re-acquiring a held lock: fine for RLock,
                        # guaranteed self-deadlock otherwise
                        if lock not in self.cls.rlocks:
                            self.cls.self_nest.append((attr, node))
                    elif self.stack:
                        self.cls.nest_edges.setdefault(
                            (self.stack[-1], lock), node)
                    self.cls.method_locks.setdefault(
                        self.method, set()).add(lock)
                    self.stack.append(lock)
                    acquired.append(lock)
        for child in node.body:
            self.visit(child)
        for _ in acquired:
            self.stack.pop()

    # -- nested defs run on their own thread/time: fresh lock context ----
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        saved, self.stack = self.stack, []
        for child in node.body:
            self.visit(child)
        self.stack = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        saved, self.stack = self.stack, []
        self.visit(node.body)
        self.stack = saved

    # -- writes ----------------------------------------------------------
    def _record_write(self, target: ast.AST, node: ast.AST) -> None:
        attr = _self_attr_target(target)
        if attr is not None and attr not in self.cls.lock_attrs:
            self.cls.writes.append(_Write(
                attr=attr, method=self.method,
                held=None if self.assume_locked
                else frozenset(self.stack), node=node))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                self._record_write(el, node)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write(node.target, node)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_write(node.target, node)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._record_write(t, node)

    # -- calls -----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        fq = dotted(node.func) or ""
        if self.stack or self.assume_locked:
            held = self.stack[-1] if self.stack else "(caller-held lock)"
            leaf = fq.rsplit(".", 1)[-1]
            receiver = fq.rsplit(".", 1)[0] if "." in fq else ""
            blocking = (fq in _BLOCKING_CALLS
                        or (isinstance(node.func, ast.Attribute)
                            and leaf in _BLOCKING_METHODS))
            if leaf == "wait":
                # Condition.wait releases its OWN lock — exempt iff
                # the receiver is a known Condition and nothing BUT
                # that condition's lock is held. Event.wait (or a
                # cond.wait under a second, unrelated lock) blocks.
                attr = receiver[len("self."):] \
                    if receiver.startswith("self.") else None
                if attr in self.cls.conditions:
                    own = self.cls.lock_attrs[attr]
                    blocking = bool(set(self.stack) - {own})
                elif attr is None and "cond" in receiver.lower():
                    blocking = False    # local alias: benefit of doubt
                else:
                    blocking = True
            if blocking:
                self.cls.blocking.append(_Blocking(
                    call=fq or leaf, lock=held,
                    method=self.method, node=node))
            if fq.startswith("self.") and self.stack:
                self.cls.held_calls.append((self.stack[-1], fq, node))
        self.generic_visit(node)


def _analyze_class(mod: ParsedModule, cls_node: ast.ClassDef) -> _ClassLocks:
    cls = _ClassLocks(name=cls_node.name, mod=mod, lock_attrs={},
                      rlocks=set(), conditions=set(), writes=[],
                      blocking=[], nest_edges={}, self_nest=[],
                      held_calls=[], attr_types={}, method_locks={})
    methods = [n for n in cls_node.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    # pass 1: find lock attributes + attribute types (constructor wiring)
    for m in methods:
        for node in ast.walk(m):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                attr = _self_attr_target(t) if not isinstance(
                    t, ast.Subscript) else None
                if attr is None:
                    continue
                fac = _lock_factory(node.value)
                if fac is not None:
                    fq = dotted(fac.func) or ""
                    kind = fq.rsplit(".", 1)[-1]
                    canonical = attr
                    if kind == "Condition":
                        cls.conditions.add(attr)
                        if fac.args:
                            inner = dotted(fac.args[0]) or ""
                            if inner.startswith("self."):
                                canonical = inner[len("self."):]
                    cls.lock_attrs[attr] = canonical
                    if kind == "RLock":
                        cls.rlocks.add(attr)
                elif isinstance(node.value, ast.Call):
                    fq = dotted(node.value.func) or ""
                    leaf = fq.rsplit(".", 1)[-1]
                    if leaf and leaf[0].isupper():
                        cls.attr_types[attr] = leaf
    # conditions created before their lock: canonicalize transitively
    for attr, canon in list(cls.lock_attrs.items()):
        seen = {attr}
        while canon in cls.lock_attrs and canon not in seen \
                and cls.lock_attrs[canon] != canon:
            seen.add(canon)
            canon = cls.lock_attrs[canon]
        cls.lock_attrs[attr] = canon
    # pass 2: walk every method with lock context
    for m in methods:
        walker = _MethodWalker(cls, m.name)
        for child in m.body:
            walker.visit(child)
    return cls


def _classes(mod: ParsedModule) -> list[_ClassLocks]:
    # one walk per module, shared by all three lock rules
    cached = getattr(mod, "_lock_classes", None)
    if cached is None:
        cached = [_analyze_class(mod, n) for n in ast.walk(mod.tree)
                  if isinstance(n, ast.ClassDef)]
        mod._lock_classes = cached
    return cached


class _NodeRule(Rule):
    def applies(self, path: str) -> bool:
        parts = path_parts(path)
        # resilience/ joined: HealthMonitor windows and
        # ResilienceStats counters are touched from batcher AND
        # submitter threads — exactly this family's territory.
        # obs/ joined: Tracer ring + Span attrs are shared
        # between submitter, batcher and scrape threads.
        # sim/ joined: the sim is single-threaded by design,
        # so any lock it grows must follow the same discipline as the
        # threaded stack it stands in for.
        # ops/regen.py joined: RegenCodec's warm/apply
        # caches are shared by the engine batcher and pool-lane worker
        # threads, so any locking it grows is this family's territory.
        # ops/xor_sched.py + ops/rs_xor.py joined: the
        # schedule memo and executor jit caches are hit from the same
        # batcher/pool-lane threads via _MatrixApply.
        if "ops" in parts and parts[-1] in ("regen.py", "xor_sched.py",
                                            "rs_xor.py"):
            return True
        return "serve" in parts or "node" in parts \
            or "resilience" in parts or "obs" in parts \
            or "sim" in parts


@register
class LockUnguardedWrite(_NodeRule):
    id = "lock-unguarded-write"
    description = ("attribute written under the lock in one method and "
                   "without it in another")
    hint = ("take the guarding lock around this write, or suppress "
            "with a comment explaining why lock-free is safe here "
            "(pre-publication, single-writer, etc.)")

    def check(self, mod: ParsedModule) -> list[Finding]:
        out = []
        for cls in _classes(mod):
            if not cls.lock_attrs:
                continue
            # infer each attribute's guard: the lock most often held
            # at its locked writes (ties break lexicographically)
            candidates: dict[str, dict[str, int]] = {}
            for w in cls.writes:
                if w.method == "__init__" or w.held is None:
                    continue
                for lock in w.held:
                    candidates.setdefault(w.attr, {})[lock] = \
                        candidates.setdefault(w.attr, {}).get(lock, 0) + 1
            guards = {attr: min(counts, key=lambda k: (-counts[k], k))
                      for attr, counts in candidates.items()}
            for w in cls.writes:
                if w.held is None or w.attr not in guards \
                        or w.method in ("__init__", "__new__"):
                    continue
                guard = guards[w.attr]
                if guard in w.held:
                    continue
                how = f"under {', '.join(sorted(w.held))} instead" \
                    if w.held else "without it"
                out.append(self.finding(
                    mod, w.node,
                    f"{cls.name}.{w.attr} is written under "
                    f"{cls.name}.{guard} elsewhere but {how} in "
                    f"`{w.method}`"))
        return out


@register
class LockBlockingCall(_NodeRule):
    id = "lock-blocking-call"
    description = "blocking call while a lock is held"
    hint = ("move the blocking call outside the `with` block (collect "
            "under the lock, act after releasing), or suppress with "
            "justification")

    def check(self, mod: ParsedModule) -> list[Finding]:
        out = []
        for cls in _classes(mod):
            for b in cls.blocking:
                out.append(self.finding(
                    mod, b.node,
                    f"{b.call}(...) blocks while holding "
                    f"{cls.name}.{b.lock} in `{b.method}`"))
        return out


@register
class LockOrderCycle(_NodeRule):
    id = "lock-order-cycle"
    description = ("lock acquisition order forms a cycle (or a "
                   "non-reentrant lock is re-acquired while held)")
    hint = ("pick one global acquisition order for these locks and "
            "restructure the paths that violate it")

    def check(self, mod: ParsedModule) -> list[Finding]:
        # the degenerate one-lock cycle: with self._lock: with
        # self._lock: deadlocks unless the lock is an RLock
        out = []
        for cls in _classes(mod):
            for attr, node in cls.self_nest:
                out.append(self.finding(
                    mod, node,
                    f"{cls.name}.{attr} re-acquired while already "
                    "held — a non-reentrant lock self-deadlocks here",
                    hint="use threading.RLock, or restructure so the "
                         "inner scope runs with the lock already "
                         "held (e.g. a *_locked helper)"))
        return out

    def check_project(self, mods: list[ParsedModule]) -> list[Finding]:
        classes = [c for m in mods for c in _classes(m)]
        by_name = {c.name: c for c in classes}
        # node ids: "Class.attr" (canonical); edges with example sites
        edges: dict[tuple[str, str], tuple[ParsedModule, ast.AST]] = {}

        def lock_id(cls: _ClassLocks, attr: str) -> str:
            return f"{cls.name}.{attr}"

        for cls in classes:
            for (outer, inner), node in cls.nest_edges.items():
                edges.setdefault(
                    (lock_id(cls, outer), lock_id(cls, inner)),
                    (cls.mod, node))
            for held, fq, node in cls.held_calls:
                # resolve one call level: self.m() and self.X.m()
                parts = fq.split(".")
                target_cls, meth = None, None
                if len(parts) == 2:                      # self.m()
                    target_cls, meth = cls, parts[1]
                elif len(parts) == 3:                    # self.X.m()
                    tname = cls.attr_types.get(parts[1])
                    if tname in by_name:
                        target_cls, meth = by_name[tname], parts[2]
                if target_cls is None:
                    continue
                for lock in target_cls.method_locks.get(meth, ()):
                    a = lock_id(cls, held)
                    b = lock_id(target_cls, lock)
                    if a != b:
                        edges.setdefault((a, b), (cls.mod, node))
        # cycle detection: DFS over the edge graph
        graph: dict[str, list[str]] = {}
        for a, b in edges:
            graph.setdefault(a, []).append(b)
        out, reported = [], set()

        def dfs(start: str, node: str, path: list[str]) -> None:
            for nxt in graph.get(node, ()):
                if nxt == start:
                    cyc = tuple(sorted(path))
                    if cyc in reported:
                        continue
                    reported.add(cyc)
                    # the closing edge always exists: nxt came from
                    # graph[path[-1]], which is built from edges' keys
                    mod, site = edges[(path[-1], start)]
                    chain = " -> ".join(path + [start])
                    out.append(self.finding(
                        mod, site,
                        f"lock-order cycle: {chain}"))
                elif nxt not in path:
                    dfs(start, nxt, path + [nxt])

        for start in sorted(graph):
            dfs(start, start, [start])
        return out
