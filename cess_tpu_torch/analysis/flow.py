"""flow: the shared interprocedural layer under the dataflow rules.

Six PRs of observability/remediation planes rest on three house
contracts — count-sequenced replay witnesses, lock-guarded shared
state across batcher/author/announce threads, and zero-cost-when-off
hook seams — that the per-file AST rules cannot see: each contract is
a property of how values FLOW between functions, classes and threads.
This module builds, once per scan, the package-wide facts the three
rule families on top of it consume:

- an import-resolved CALL GRAPH: ``f()``, ``self.m()``,
  ``self.attr.m()`` (typed-attribute resolution reusing the
  lock-discipline machinery: ``self.X = ClassName(...)``, annotated
  ``__init__`` params stored onto ``self``, dataclass field
  annotations), ``alias.f()`` through relative imports, and
  ``ClassName(...)`` constructors;
- THREAD-ROOT attribution: which methods run on which thread —
  ``Thread(target=self.m)`` targets (directly or through one level of
  spawn-helper indirection), methods registered as listeners/
  callbacks (``x.add_listener(self.m)``-style), and everything else
  on the public ``caller`` root — closed over resolvable call edges;
- a TAINT LATTICE over nondeterminism sources (``time.*``,
  ``random.*``, ``threading.get_ident``, ``id()``, dict/set
  iteration order escapes): per-function return taint, per-class
  field taint and per-parameter taint, iterated to a fixpoint so a
  wallclock read three calls away from a witness still reaches it.

Only EXPLICIT dataflow is tracked (assignments, calls, containers,
field writes) — never implicit flow through branch conditions: a
count-sequenced state machine whose *timing* of observations is
wall-clock driven is exactly the house design, not a bug
(Engler et al., "bugs as deviant behavior": infer the codebase's own
contracts, flag deviations — not every theoretical channel).

The graph is built once per ``lint_modules`` run and cached on the
first module of the scanned set, so the three families share one
pass (the same parse-once discipline core.py applies per file).
"""
from __future__ import annotations

import ast
import dataclasses

from .core import ParsedModule, dotted

# ---------------------------------------------------------------------------
# taint sources — the nondeterminism registry (documented in README)
# ---------------------------------------------------------------------------
#: exact dotted names whose *call or read* yields a nondeterministic
#: value (wall clocks, entropy, thread identity)
TAINT_SOURCES = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "time.process_time_ns",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "os.urandom", "os.getpid", "uuid.uuid4", "uuid.uuid1",
    "threading.get_ident", "threading.get_native_id",
    "threading.current_thread", "threading.active_count",
})
#: dotted-name prefixes treated as sources (whole entropy families)
TAINT_PREFIXES = ("random.", "np.random.", "numpy.random.", "secrets.")
#: builtins whose result is process-dependent (``id`` is an address;
#: ``hash`` of str/bytes is salted per process via PYTHONHASHSEED)
TAINT_BUILTINS = frozenset({"id", "hash"})
#: the order-taint tag for values whose CONTENT is deterministic but
#: whose iteration order is not (set/dict-view escapes)
ORDER_SOURCE = "unordered-iteration"

#: calls that erase ORDER taint (the result's order is canonical or
#: order no longer exists) but pass value taint through
ORDER_SANITIZERS = frozenset({"sorted", "len", "sum", "min", "max",
                              "any", "all", "set", "frozenset",
                              "dict", "Counter", "collections.Counter"})
#: calls whose result is untainted regardless of arguments (structure
#: queries, types — no nondeterministic bytes survive them)
VALUE_SANITIZERS = frozenset({"len", "isinstance", "type", "bool",
                              "callable", "hasattr"})

_UNORDERED_METHODS = {"keys", "values", "items"}


@dataclasses.dataclass(frozen=True)
class Taint:
    """One nondeterminism origin: which source, observed where."""
    source: str
    path: str
    line: int

    def describe(self) -> str:
        return f"`{self.source}` at {self.path}:{self.line}"


# cap per-fact taint sets so the fixpoint stays bounded (first-come
# origins win; a fact past the cap is already a reportable finding)
_TAINT_CAP = 6


# ---------------------------------------------------------------------------
# graph nodes
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FuncInfo:
    """One function or method."""
    fqid: str                        # "path::Class.meth" / "path::func"
    path: str
    name: str
    cls: str | None                  # owning class name, if a method
    node: ast.AST                    # FunctionDef / AsyncFunctionDef
    params: list[str]                # positional+kw param names (no self)
    mod: ParsedModule = None


@dataclasses.dataclass
class ClassInfo:
    name: str
    path: str
    node: ast.ClassDef
    methods: dict[str, FuncInfo]
    attr_types: dict[str, str]       # self.X -> ClassName
    thread_targets: set[str]         # method names run as Thread targets
    listener_methods: set[str]       # methods registered as callbacks


# calls whose leaf name registers a bound method as a cross-thread
# callback (the flight-recorder listener idiom and friends)
LISTENER_REGISTRARS = frozenset({
    "add_listener", "add_handler", "subscribe", "register_listener",
    "attach_listener", "on_edge",
})

#: the implicit root every public method runs on
CALLER_ROOT = "caller"


class FlowGraph:
    """Package-wide call graph + thread roots + taint facts."""

    def __init__(self, mods: list[ParsedModule]):
        self.mods = mods
        self.functions: dict[str, FuncInfo] = {}
        self.classes: dict[str, ClassInfo] = {}      # by unique name
        self._class_dupes: set[str] = set()
        self.module_funcs: dict[str, dict[str, str]] = {}  # path -> name -> fqid
        self.imports: dict[str, dict[str, str]] = {}       # path -> alias -> path
        # taint facts (the fixpoint state)
        self.ret_taints: dict[str, set[Taint]] = {}
        self.field_taints: dict[tuple[str, str], set[Taint]] = {}
        self.param_taints: dict[tuple[str, int], set[Taint]] = {}
        # where a field FIRST picked up each taint (finding evidence)
        self.field_sites: dict[tuple[str, str], tuple[str, int]] = {}
        # worklist machinery: fact keys changed this round, and which
        # functions READ each fact key (reads are syntactic — stable
        # across rounds — so one full pass learns the whole map)
        self._dirty: set[tuple] = set()
        self._readers: dict[tuple, set[str]] = {}
        self._collect()
        self._resolve_thread_roots()
        self._taint_fixpoint()

    # -- construction ------------------------------------------------------
    def _collect(self) -> None:
        by_path = {m.path: m for m in self.mods}
        for mod in self.mods:
            self.imports[mod.path] = _import_map(mod, by_path)
            funcs: dict[str, str] = {}
            self.module_funcs[mod.path] = funcs
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    fi = self._add_func(mod, node, None)
                    funcs[node.name] = fi.fqid
                elif isinstance(node, ast.ClassDef):
                    self._add_class(mod, node)

    def _add_func(self, mod: ParsedModule, node: ast.AST,
                  cls: str | None) -> FuncInfo:
        qual = f"{cls}.{node.name}" if cls else node.name
        fqid = f"{mod.path}::{qual}"
        args = node.args
        params = [a.arg for a in args.posonlyargs + args.args
                  if a.arg not in ("self", "cls")]
        params += [a.arg for a in args.kwonlyargs]
        fi = FuncInfo(fqid=fqid, path=mod.path, name=node.name,
                      cls=cls, node=node, params=params, mod=mod)
        self.functions[fqid] = fi
        return fi

    def _add_class(self, mod: ParsedModule, node: ast.ClassDef) -> None:
        methods: dict[str, FuncInfo] = {}
        attr_types: dict[str, str] = {}
        # dataclass-style field annotations: ``world: World``
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                t = _annotation_class(stmt.annotation)
                if t:
                    attr_types[stmt.target.id] = t
        for stmt in node.body:
            if not isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            methods[stmt.name] = self._add_func(mod, stmt, node.name)
            # annotated params stored onto self:  def __init__(self,
            # board: SloBoard): ... self.board = board
            ann = {a.arg: _annotation_class(a.annotation)
                   for a in stmt.args.args if a.annotation is not None}
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Assign):
                    continue
                for t in sub.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if isinstance(sub.value, ast.Name) \
                            and ann.get(sub.value.id):
                        attr_types.setdefault(attr, ann[sub.value.id])
                    elif isinstance(sub.value, ast.Call):
                        leaf = (dotted(sub.value.func) or "") \
                            .rsplit(".", 1)[-1]
                        if leaf and leaf[0].isupper():
                            attr_types.setdefault(attr, leaf)
        ci = ClassInfo(name=node.name, path=mod.path, node=node,
                       methods=methods, attr_types=attr_types,
                       thread_targets=set(), listener_methods=set())
        if node.name in self.classes:
            self._class_dupes.add(node.name)
            self.classes.pop(node.name, None)
        elif node.name not in self._class_dupes:
            self.classes[node.name] = ci
        # always findable by (path, name) even when the name collides
        self.module_funcs.setdefault(mod.path, {})
        for mname, fi in methods.items():
            self.functions[fi.fqid] = fi
        self._classes_by_path = getattr(self, "_classes_by_path", {})
        self._classes_by_path[(mod.path, node.name)] = ci

    # -- call resolution ---------------------------------------------------
    def class_of(self, name: str | None) -> ClassInfo | None:
        if name is None:
            return None
        return self.classes.get(name)

    def resolve_call(self, fq: str | None, caller: FuncInfo,
                     local_types: dict[str, str] | None = None,
                     ) -> FuncInfo | None:
        """Best-effort single target for a dotted callee, or None."""
        if not fq:
            return None
        parts = fq.split(".")
        local_types = local_types or {}
        owner = self.class_of(caller.cls)
        # self.m()  /  cls-local call
        if parts[0] == "self" and owner is not None:
            if len(parts) == 2:
                return owner.methods.get(parts[1])
            if len(parts) == 3:
                tcls = self.class_of(owner.attr_types.get(parts[1]))
                if tcls is not None:
                    return tcls.methods.get(parts[2])
            return None
        # f()  — module function or class constructor in scope
        if len(parts) == 1:
            fqid = self.module_funcs.get(caller.path, {}).get(parts[0])
            if fqid:
                return self.functions.get(fqid)
            tcls = self.class_of(parts[0]) \
                if parts[0][:1].isupper() else None
            if tcls is not None:
                return tcls.methods.get("__init__")
            return None
        # alias.f() through the import map;  Local.m() via local types
        if len(parts) == 2:
            head, leaf = parts
            target_path = self.imports.get(caller.path, {}).get(head)
            if target_path is not None:
                fqid = self.module_funcs.get(target_path, {}).get(leaf)
                if fqid:
                    return self.functions.get(fqid)
                tcls = self._classes_by_path.get((target_path, leaf))
                if tcls is not None:
                    return tcls.methods.get("__init__")
            tcls = self.class_of(local_types.get(head)) \
                or (self.class_of(head) if head[:1].isupper() else None)
            if tcls is not None:
                return tcls.methods.get(leaf)
        # alias.Class.m() / alias.Class()
        if len(parts) == 3:
            target_path = self.imports.get(caller.path, {}).get(parts[0])
            if target_path is not None:
                tcls = self._classes_by_path.get((target_path, parts[1]))
                if tcls is not None:
                    return tcls.methods.get(parts[2])
        return None

    # -- thread roots ------------------------------------------------------
    def _resolve_thread_roots(self) -> None:
        """Mark Thread targets and listener registrations, including
        one level of spawn-helper indirection
        (``self._spawn(self._author_loop)`` where the helper does
        ``Thread(target=fn)``)."""
        # pass 1: direct Thread(target=self.m) + helpers whose PARAM
        # becomes a Thread target + listener registrations
        spawn_params: dict[str, set[int]] = {}   # fqid -> param indexes
        for fi in list(self.functions.values()):
            owner = self.class_of(fi.cls)
            local_types = _local_class_types(fi.node)
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                fq = dotted(node.func) or ""
                leaf = fq.rsplit(".", 1)[-1]
                if leaf == "Thread":
                    target = _kwarg(node, "target")
                    tfq = dotted(target) if target is not None else None
                    if tfq and tfq.startswith("self.") and owner:
                        owner.thread_targets.add(tfq[len("self."):])
                    elif tfq and tfq in fi.params:
                        spawn_params.setdefault(fi.fqid, set()).add(
                            fi.params.index(tfq))
                elif leaf in LISTENER_REGISTRARS:
                    for arg in node.args:
                        afq = dotted(arg)
                        if not afq or "." not in afq:
                            continue
                        head, meth = afq.rsplit(".", 1)
                        tcls = None
                        if head == "self" and owner is not None:
                            tcls = owner
                        elif owner is not None \
                                and head.startswith("self."):
                            tcls = self.class_of(
                                owner.attr_types.get(head[5:]))
                        else:
                            tcls = self.class_of(local_types.get(head))
                        if tcls is not None and meth in tcls.methods:
                            tcls.listener_methods.add(meth)
        # pass 2: callers of spawn helpers pass self.m as the target
        if spawn_params:
            for fi in list(self.functions.values()):
                owner = self.class_of(fi.cls)
                if owner is None:
                    continue
                for node in ast.walk(fi.node):
                    if not isinstance(node, ast.Call):
                        continue
                    callee = self.resolve_call(dotted(node.func), fi)
                    if callee is None or callee.fqid not in spawn_params:
                        continue
                    for idx in spawn_params[callee.fqid]:
                        if idx < len(node.args):
                            afq = dotted(node.args[idx]) or ""
                            if afq.startswith("self."):
                                owner.thread_targets.add(afq[5:])

    def method_roots(self, ci: ClassInfo) -> dict[str, set[str]]:
        """method name -> thread roots it can run on. Thread-target
        and listener methods seed their own roots; every OTHER method
        seeds ``caller``; roots close over resolvable self-call
        edges (a helper called from the batcher loop runs on the
        batcher thread)."""
        roots: dict[str, set[str]] = {}
        for name in ci.methods:
            if name in ci.thread_targets:
                roots[name] = {f"thread:{name}"}
            elif name in ci.listener_methods:
                roots[name] = {f"listener:{name}"}
            elif name.startswith("_") and not name.endswith("__"):
                # private helper: reachable only through the edges
                # below — seeding ``caller`` here would hand every
                # loop-only helper a phantom second root
                roots[name] = set()
            else:
                roots[name] = {CALLER_ROOT}
        # close over intra-class call edges (self.m() and the
        # *_locked/helper conventions); a few rounds reach fixpoint
        edges: dict[str, set[str]] = {name: set() for name in ci.methods}
        for name, fi in ci.methods.items():
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call):
                    fq = dotted(node.func) or ""
                    if fq.startswith("self.") and "." not in fq[5:] \
                            and fq[5:] in ci.methods:
                        edges[name].add(fq[5:])
                elif isinstance(node, ast.Attribute) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id == "self" \
                        and node.attr in ci.methods \
                        and node.attr not in ci.thread_targets \
                        and not isinstance(node.ctx, ast.Store):
                    # bound-method reference (callbacks, futures) —
                    # but NOT a known thread target: the reference in
                    # ``Thread(target=self._run)`` is the spawn site,
                    # not a synchronous call on the spawning thread
                    edges[name].add(node.attr)
        for _ in range(len(ci.methods)):
            changed = False
            for src, callees in edges.items():
                for callee in callees:
                    if callee in ("__init__", "__new__"):
                        continue
                    before = len(roots[callee])
                    # a helper invoked from a thread root runs there
                    # IN ADDITION to anywhere else it is reachable
                    # from — except __init__ (pre-publication)
                    roots[callee] |= roots[src]
                    changed |= len(roots[callee]) != before
            if not changed:
                break
        # __init__ runs pre-thread-start, on the constructing thread
        for name in ("__init__", "__new__"):
            if name in roots:
                roots[name] = {CALLER_ROOT}
        return roots

    # -- taint -------------------------------------------------------------
    def _taint_fixpoint(self) -> None:
        """Worklist iteration: one full pass learns every function's
        (syntactic, hence stable) fact reads; afterwards only the
        readers of facts that actually changed re-run — deep call
        chains converge without re-walking 1500 function bodies per
        round. The finite taint sets + per-fact cap make the lattice
        finite, so this terminates; the pass budget is pure defense."""
        for fi in self.functions.values():
            p = _TaintPass(self, fi)
            p.run()
            for key in p.reads:
                self._readers.setdefault(key, set()).add(fi.fqid)
        budget = 40 * max(1, len(self.functions))
        while self._dirty and budget > 0:
            dirty, self._dirty = self._dirty, set()
            affected: set[str] = set()
            for key in dirty:
                affected |= self._readers.get(key, set())
            for fqid in affected:
                fi = self.functions.get(fqid)
                if fi is None:
                    continue
                budget -= 1
                _TaintPass(self, fi).run()

    def _merge(self, store: dict, kind: str, key,
               taints: set[Taint]) -> bool:
        if not taints:
            return False
        cur = store.setdefault(key, set())
        before = len(cur)
        for t in taints:
            if len(cur) >= _TAINT_CAP:
                break
            cur.add(t)
        if len(cur) != before:
            self._dirty.add((kind, key))
            return True
        return False


def _import_map(mod: ParsedModule,
                by_path: dict[str, ParsedModule]) -> dict[str, str]:
    """alias -> module path, for modules inside the scanned set.
    Resolves ``from ..obs import flight as _flight`` and
    ``from . import clock`` against the module's own path."""
    out: dict[str, str] = {}
    pkg_parts = mod.path.split("/")[:-1]        # containing package
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[:len(pkg_parts) - (node.level - 1)]
            else:
                base = (node.module or "").split(".")
            rel = (node.module or "").split(".") if node.level else []
            stem = base + [p for p in rel if p]
            for alias in node.names:
                cand = "/".join(stem + [alias.name]) + ".py"
                if cand in by_path:
                    out[alias.asname or alias.name] = cand
                else:
                    # ``from .clock import EventQueue`` — names from a
                    # sibling module: map the NAME to that module so
                    # ``EventQueue(...)`` resolves through it
                    sib = "/".join(stem) + ".py"
                    if sib in by_path:
                        out.setdefault(alias.asname or alias.name, sib)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                cand = alias.name.replace(".", "/") + ".py"
                if cand in by_path:
                    out[alias.asname or alias.name] = cand
    return out


def _annotation_class(ann: ast.AST | None) -> str | None:
    """The ClassName inside an annotation (handles ``X | None`` and
    string annotations), if it looks like a class."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _annotation_class(ann.left) or _annotation_class(ann.right)
    name = dotted(ann)
    if name:
        leaf = name.rsplit(".", 1)[-1]
        if leaf[:1].isupper():
            return leaf
    return None


def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _kwarg(call: ast.Call, name: str) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _local_class_types(fn: ast.AST) -> dict[str, str]:
    """name -> ClassName for ``x = ClassName(...)`` locals (used by
    listener registration and receiver typing)."""
    out: dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            leaf = (dotted(node.value.func) or "").rsplit(".", 1)[-1]
            if leaf and leaf[0].isupper():
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = leaf
    return out


# ---------------------------------------------------------------------------
# the per-function taint pass
# ---------------------------------------------------------------------------
class _TaintPass:
    """One forward pass over a function body, updating the graph's
    return/field/param facts. Statements are walked in source order,
    twice, so loop-carried locals stabilize within the pass."""

    def __init__(self, graph: FlowGraph, fi: FuncInfo):
        self.g = graph
        self.fi = fi
        self.owner = graph.class_of(fi.cls)
        self.env: dict[str, set[Taint]] = {}
        self.local_types = _local_class_types(fi.node)
        self.changed = False
        self.reads: set[tuple] = set()   # fact keys this body reads

    def _read_ret(self, fqid: str) -> set[Taint]:
        self.reads.add(("ret", fqid))
        return set(self.g.ret_taints.get(fqid, ()))

    def _read_param(self, key: tuple) -> set[Taint]:
        self.reads.add(("param", key))
        return set(self.g.param_taints.get(key, ()))

    def _read_field(self, key: tuple) -> set[Taint]:
        self.reads.add(("field", key))
        return set(self.g.field_taints.get(key, ()))

    def run(self) -> bool:
        body = getattr(self.fi.node, "body", [])
        for _ in range(2):
            for stmt in body:
                self._stmt(stmt)
        return self.changed

    # -- statements --------------------------------------------------------
    def _stmt(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                       # nested scopes analyzed on their own
        if isinstance(node, ast.Assign):
            t = self._expr(node.value)
            for tgt in node.targets:
                self._assign(tgt, t)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self._assign(node.target, self._expr(node.value))
        elif isinstance(node, ast.AugAssign):
            t = self._expr(node.value) | self._read_target(node.target)
            self._assign(node.target, t)
        elif isinstance(node, ast.Return):
            if node.value is not None:
                t = self._expr(node.value)
                self.changed |= self.g._merge(self.g.ret_taints,
                                              "ret", self.fi.fqid, t)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            t = self._expr(node.iter)
            if _unordered_iter(node.iter, self.env):
                t = t | {Taint(ORDER_SOURCE, self.fi.path,
                               getattr(node.iter, "lineno", 1))}
            self._assign(node.target, t)
            for child in node.body + node.orelse:
                self._stmt(child)
        elif isinstance(node, (ast.If, ast.While)):
            self._expr(node.test)
            for child in node.body + node.orelse:
                self._stmt(child)
        elif isinstance(node, ast.With) or isinstance(node, ast.AsyncWith):
            for item in node.items:
                t = self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, t)
            for child in node.body:
                self._stmt(child)
        elif isinstance(node, ast.Try):
            for child in (node.body + node.orelse + node.finalbody):
                self._stmt(child)
            for h in node.handlers:
                for child in h.body:
                    self._stmt(child)
        elif isinstance(node, ast.Expr):
            self._expr(node.value)
        elif isinstance(node, (ast.Delete, ast.Pass, ast.Break,
                               ast.Continue, ast.Import, ast.ImportFrom,
                               ast.Global, ast.Nonlocal, ast.Assert,
                               ast.Raise)):
            if isinstance(node, ast.Assert):
                self._expr(node.test)
            if isinstance(node, ast.Raise) and node.exc is not None:
                self._expr(node.exc)
        elif isinstance(node, ast.Match):
            self._expr(node.subject)
            for case in node.cases:
                for child in case.body:
                    self._stmt(child)

    def _assign(self, tgt: ast.AST, taints: set[Taint]) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._assign(el, taints)
            return
        if isinstance(tgt, ast.Starred):
            self._assign(tgt.value, taints)
            return
        if isinstance(tgt, ast.Subscript):
            # d[k] = v taints d as a whole — but a keyed store
            # LAUNDERS order taint: the container's content no longer
            # depends on which iteration order produced it (value
            # taints like wall clocks survive)
            taints = {t for t in taints if t.source != ORDER_SOURCE}
            tgt = tgt.value
            taints = taints | self._read_target(tgt)
        if isinstance(tgt, ast.Name):
            cur = self.env.get(tgt.id, set())
            self.env[tgt.id] = cur | taints if taints else taints
            return
        attr = _self_attr(tgt) if isinstance(tgt, ast.Attribute) else None
        if attr is not None and self.owner is not None:
            key = (self.owner.name, attr)
            if taints and key not in self.g.field_sites:
                self.g.field_sites[key] = (self.fi.path,
                                           getattr(tgt, "lineno", 1))
            self.changed |= self.g._merge(self.g.field_taints, "field",
                                          key, taints)

    def _read_target(self, tgt: ast.AST) -> set[Taint]:
        if isinstance(tgt, ast.Name):
            return set(self.env.get(tgt.id, ()))
        if isinstance(tgt, ast.Attribute):
            return self._expr(tgt)
        return set()

    # -- expressions -------------------------------------------------------
    def _expr(self, node: ast.AST | None) -> set[Taint]:
        if node is None:
            return set()
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Name):
            t = set(self.env.get(node.id, ()))
            if node.id in self.fi.params:
                t |= self._read_param(
                    (self.fi.fqid, self.fi.params.index(node.id)))
            return t
        if isinstance(node, ast.Attribute):
            fq = dotted(node)
            if fq is not None:
                if fq in TAINT_SOURCES or fq.startswith(TAINT_PREFIXES):
                    return {Taint(fq, self.fi.path, node.lineno)}
                # self.X -> field taints; typed locals: x.attr
                if fq.startswith("self.") and "." not in fq[5:] \
                        and self.owner is not None:
                    return self._read_field((self.owner.name, fq[5:]))
                parts = fq.split(".")
                if len(parts) == 2:
                    tname = self.local_types.get(parts[0]) \
                        or (self.owner.attr_types.get(parts[0])
                            if self.owner else None)
                    if tname and tname in self.g.classes:
                        return self._read_field((tname, parts[1]))
                if len(parts) == 3 and parts[0] == "self" \
                        and self.owner is not None:
                    tname = self.owner.attr_types.get(parts[1])
                    if tname and tname in self.g.classes:
                        return self._read_field((tname, parts[2]))
            return self._expr(node.value)
        if isinstance(node, (ast.BinOp,)):
            return self._expr(node.left) | self._expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._expr(node.operand)
        if isinstance(node, ast.BoolOp):
            out = set()
            for v in node.values:
                out |= self._expr(v)
            return out
        if isinstance(node, ast.Compare):
            out = self._expr(node.left)
            for c in node.comparators:
                out |= self._expr(c)
            return out
        if isinstance(node, ast.IfExp):
            self._expr(node.test)
            return self._expr(node.body) | self._expr(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            out = set()
            for el in node.elts:
                out |= self._expr(el)
            return out
        if isinstance(node, ast.Set):
            out = set()
            for el in node.elts:
                out |= self._expr(el)
            return out
        if isinstance(node, ast.Dict):
            out = set()
            for k in node.keys:
                out |= self._expr(k)
            for v in node.values:
                out |= self._expr(v)
            return out
        if isinstance(node, ast.Subscript):
            return self._expr(node.value) | self._expr(node.slice)
        if isinstance(node, ast.Starred):
            return self._expr(node.value)
        if isinstance(node, ast.JoinedStr):
            out = set()
            for v in node.values:
                out |= self._expr(v)
            return out
        if isinstance(node, ast.FormattedValue):
            return self._expr(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            out = set()
            for gen in node.generators:
                t = self._expr(gen.iter)
                if _unordered_iter(gen.iter, self.env) \
                        and not isinstance(node, ast.SetComp):
                    t = t | {Taint(ORDER_SOURCE, self.fi.path,
                                   getattr(gen.iter, "lineno", 1))}
                self._assign(gen.target, t)
                out |= t
            if isinstance(node, ast.DictComp):
                out |= self._expr(node.key) | self._expr(node.value)
                # a dict comprehension is a keyed store: content is
                # order-independent, so its OWN generators' order
                # taint is laundered (value taints survive)
                out = {t for t in out if t.source != ORDER_SOURCE}
            else:
                out |= self._expr(node.elt)
            return out
        if isinstance(node, ast.Slice):
            return (self._expr(node.lower) | self._expr(node.upper)
                    | self._expr(node.step))
        if isinstance(node, ast.Lambda):
            return set()
        if isinstance(node, (ast.Constant, ast.NamedExpr)):
            if isinstance(node, ast.NamedExpr):
                t = self._expr(node.value)
                self._assign(node.target, t)
                return t
            return set()
        if isinstance(node, ast.Await):
            return self._expr(node.value)
        return set()

    def _call(self, node: ast.Call) -> set[Taint]:
        fq = dotted(node.func)
        leaf = (fq or "").rsplit(".", 1)[-1]
        arg_taints = set()
        for a in node.args:
            arg_taints |= self._expr(a)
        for kw in node.keywords:
            arg_taints |= self._expr(kw.value)
        # sources
        if fq and (fq in TAINT_SOURCES or fq.startswith(TAINT_PREFIXES)):
            return {Taint(fq, self.fi.path, node.lineno)}
        if fq in TAINT_BUILTINS:
            return {Taint(f"{fq}()", self.fi.path, node.lineno)}
        # order escapes:  list(d)/tuple(s.keys()) without sorted
        if leaf in ("list", "tuple", "iter", "next") and node.args \
                and _unordered_iter(node.args[0], self.env):
            arg_taints = arg_taints | {
                Taint(ORDER_SOURCE, self.fi.path, node.lineno)}
        # sanitizers
        if leaf in VALUE_SANITIZERS:
            return set()
        if leaf in ORDER_SANITIZERS:
            return {t for t in arg_taints if t.source != ORDER_SOURCE}
        # method receiver taint rides through (x.strip() of tainted x)
        recv_taints = set()
        if isinstance(node.func, ast.Attribute):
            recv_taints = self._expr(node.func.value)
        # resolved callee: propagate arg taints into params, return
        # the callee's known return taints
        callee = self.g.resolve_call(fq, self.fi, self.local_types)
        if callee is not None:
            for i, a in enumerate(node.args):
                t = self._expr(a)
                if t and i < len(callee.params):
                    self.changed |= self.g._merge(
                        self.g.param_taints, "param",
                        (callee.fqid, i), t)
            for kw in node.keywords:
                t = self._expr(kw.value)
                if t and kw.arg in callee.params:
                    self.changed |= self.g._merge(
                        self.g.param_taints, "param",
                        (callee.fqid, callee.params.index(kw.arg)), t)
                elif t and kw.arg is None:
                    # **kwargs fan-out: taint every parameter
                    for i in range(len(callee.params)):
                        self.changed |= self.g._merge(
                            self.g.param_taints, "param",
                            (callee.fqid, i), t)
            out = self._read_ret(callee.fqid)
            if callee.name == "__init__" and callee.cls:
                # constructing a class whose fields are tainted does
                # not itself yield a tainted VALUE; field reads do
                out = set()
            return out | recv_taints
        # unresolved: conservative pass-through of args + receiver
        return arg_taints | recv_taints


def _unordered_iter(expr: ast.AST, env: dict) -> bool:
    """Does iterating ``expr`` observe hash/insertion order? (set and
    dict-view escapes; ``sorted(...)`` upstream clears it)"""
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call):
        fq = dotted(expr.func) or ""
        leaf = fq.rsplit(".", 1)[-1]
        if isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in _UNORDERED_METHODS \
                and not expr.args \
                and not isinstance(expr.func.value, ast.Dict):
            return True
        if leaf in ("set", "frozenset"):
            return True
    return False


# ---------------------------------------------------------------------------
# the shared-graph cache (one build per lint_modules run)
# ---------------------------------------------------------------------------
def flow_graph(mods: list[ParsedModule]) -> FlowGraph:
    """The FlowGraph for this exact module set, built once and cached
    on the first module (all flow rules apply package-wide, so every
    family sees the same list and shares the build)."""
    if not mods:
        return FlowGraph([])
    anchor = mods[0]
    key = tuple(id(m) for m in mods)
    cached = getattr(anchor, "_flow_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    graph = FlowGraph(mods)
    anchor._flow_cache = (key, graph)
    return graph
