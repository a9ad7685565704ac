"""Trace-safety analyzers for the device code (ops/, serve/).

A function traced by ``jax.jit`` (or handed to ``pallas_call``) runs
its Python body ONCE per compile, against abstract tracers — so Python
side effects silently freeze at trace-time values, host conversions
(`.item()`, `float(tracer)`, `np.*` on a traced arg) either fail under
jit or force a device->host sync, and an out-of-range integer literal
fed into a narrow dtype wraps silently on the uint8/uint32 lanes the
GF(2^8)/M31 kernels (ops/gf.py, ops/pfield.py) do exact math on.
These are invisible to unit tests that only check eager results —
and mechanically detectable from the AST.

Rules:
- trace-global-mutation : ``global``/``nonlocal`` inside a traced body
- trace-print           : ``print`` inside a traced body
- trace-host-sync       : ``.item()``/``.tolist()``/``.tobytes()``/
                          ``float/int/bool(traced arg)`` inside a
                          traced body
- trace-host-transfer   : ``np.*`` applied to a traced argument
- dtype-overflow        : integer literal outside the target integer
                          dtype's range in ``np.uint8(...)``-style
                          constructions
"""
from __future__ import annotations

import ast

from .core import Finding, ParsedModule, Rule, dotted, path_parts, register

_JIT = {"jax.jit", "jit"}
_PARTIAL = {"functools.partial", "partial"}


def _static_spec(call: ast.Call) -> tuple[set[int], set[str]]:
    """(positional indices, parameter names) marked static in a
    jax.jit(...)/partial(jax.jit, ...) call."""
    nums: set[int] = set()
    names: set[str] = set()
    for kw in call.keywords:
        if kw.arg not in ("static_argnums", "static_argnames"):
            continue
        v = kw.value
        elts = v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]
        for e in elts:
            if isinstance(e, ast.Constant):
                if isinstance(e.value, int):
                    nums.add(e.value)
                elif isinstance(e.value, str):
                    names.add(e.value)
    return nums, names


def _jit_decorator(dec: ast.AST) -> tuple[bool, set[int], set[str]]:
    """(is_jit, static argnums, static argnames)."""
    if dotted(dec) in _JIT:
        return True, set(), set()
    if isinstance(dec, ast.Call):
        fq = dotted(dec.func)
        if fq in _JIT:
            return (True, *_static_spec(dec))
        if fq in _PARTIAL and dec.args and dotted(dec.args[0]) in _JIT:
            return (True, *_static_spec(dec))
    return False, set(), set()


def _traced_functions(mod: ParsedModule
                      ) -> list[tuple[ast.FunctionDef, set[str]]]:
    """Every function the device will trace, with its TRACED parameter
    names (static_argnums positions excluded — those stay Python).
    Cached on the module: all four trace rules share one walk."""
    cached = getattr(mod, "_traced_fns", None)
    if cached is not None:
        return cached
    # names referenced as jax.jit(fn, ...) / pl.pallas_call(kernel, ...)
    # — keeping the call-form's static_argnums/argnames
    wrapped: dict[str, tuple[set[int], set[str]]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and node.args:
            fq = dotted(node.func) or ""
            if fq in _JIT or fq.endswith("pallas_call"):
                target = node.args[0]
                if isinstance(target, ast.Name):
                    wrapped[target.id] = _static_spec(node) \
                        if fq in _JIT else (set(), set())
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        is_jit, nums, names = False, set(), set()
        for dec in node.decorator_list:
            is_jit, nums, names = _jit_decorator(dec)
            if is_jit:
                break
        if not is_jit:
            if node.name not in wrapped:
                continue
            nums, names = wrapped[node.name]
        a = node.args
        positional = [p.arg for p in a.posonlyargs + a.args]
        params = {p for i, p in enumerate(positional)
                  if i not in nums and p not in names}
        params.update(p.arg for p in a.kwonlyargs
                      if p.arg not in names)
        for extra in (a.vararg, a.kwarg):
            if extra is not None:
                params.add(extra.arg)
        out.append((node, params))
    mod._traced_fns = out
    return out


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _DeviceRule(Rule):
    def applies(self, path: str) -> bool:
        parts = path_parts(path)
        # obs/ joined: the tracing hooks sit beside jitted
        # hot paths, so the same trace-safety discipline applies there.
        # sim/ joined: scenario rounds run armed-tracer
        # spans around the same runtime paths the live stack jits
        return "ops" in parts or "serve" in parts or "obs" in parts \
            or "sim" in parts


@register
class TraceGlobalMutation(_DeviceRule):
    id = "trace-global-mutation"
    description = ("global/nonlocal statement inside a jit-traced "
                   "function body")
    hint = ("return the value from the traced function (or carry it "
            "through the functional state) instead of mutating "
            "enclosing scope at trace time")

    def check(self, mod: ParsedModule) -> list[Finding]:
        out = []
        for fn, _ in _traced_functions(mod):
            for node in ast.walk(fn):
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    kind = ("global" if isinstance(node, ast.Global)
                            else "nonlocal")
                    out.append(self.finding(
                        mod, node,
                        f"`{kind} {', '.join(node.names)}` inside "
                        f"jit-traced `{fn.name}`: the mutation runs "
                        "once at trace time, not per call"))
        return out


@register
class TracePrint(_DeviceRule):
    id = "trace-print"
    description = "print() inside a jit-traced function body"
    hint = ("use jax.debug.print (prints per execution) or log "
            "outside the traced function; print() fires once at "
            "trace time with tracer reprs")

    def check(self, mod: ParsedModule) -> list[Finding]:
        out = []
        for fn, _ in _traced_functions(mod):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id == "print":
                    out.append(self.finding(
                        mod, node,
                        f"print() inside jit-traced `{fn.name}` fires "
                        "at trace time only"))
        return out


_SYNC_METHODS = {"item", "tolist", "tobytes"}
_SYNC_BUILTINS = {"float", "int", "bool"}


@register
class TraceHostSync(_DeviceRule):
    id = "trace-host-sync"
    description = (".item()/.tolist()/.tobytes() or float/int/bool on "
                   "a traced value inside a jit body")
    hint = ("keep the value on device (jnp ops / astype); concretize "
            "only outside the traced function")

    def check(self, mod: ParsedModule) -> list[Finding]:
        out = []
        for fn, params in _traced_functions(mod):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and f.attr in _SYNC_METHODS:
                    out.append(self.finding(
                        mod, node,
                        f".{f.attr}() inside jit-traced `{fn.name}` "
                        "forces a host sync (fails on tracers)"))
                elif isinstance(f, ast.Name) \
                        and f.id in _SYNC_BUILTINS and node.args \
                        and isinstance(node.args[0], ast.Name) \
                        and node.args[0].id in params:
                    out.append(self.finding(
                        mod, node,
                        f"{f.id}({node.args[0].id}) concretizes a "
                        f"traced argument of `{fn.name}`"))
        return out


_NP_ROOTS = ("np.", "numpy.")


@register
class TraceHostTransfer(_DeviceRule):
    id = "trace-host-transfer"
    description = "np.* applied to a traced argument inside a jit body"
    hint = ("use the jnp equivalent on traced values; numpy calls "
            "pull the tracer to host (TracerArrayConversionError or a "
            "silent device->host transfer)")

    def check(self, mod: ParsedModule) -> list[Finding]:
        out = []
        for fn, params in _traced_functions(mod):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                fq = dotted(node.func) or ""
                if not fq.startswith(_NP_ROOTS):
                    continue
                touched = sorted(params & set().union(
                    *(_names_in(a) for a in node.args), *(
                        _names_in(kw.value) for kw in node.keywords))
                ) if (node.args or node.keywords) else []
                if touched:
                    out.append(self.finding(
                        mod, node,
                        f"{fq}(...) over traced argument(s) "
                        f"{', '.join(touched)} inside jit-traced "
                        f"`{fn.name}`"))
        return out


_INT_RANGES = {
    "uint8": (0, 2**8 - 1), "uint16": (0, 2**16 - 1),
    "uint32": (0, 2**32 - 1), "uint64": (0, 2**64 - 1),
    "int8": (-2**7, 2**7 - 1), "int16": (-2**15, 2**15 - 1),
    "int32": (-2**31, 2**31 - 1), "int64": (-2**63, 2**63 - 1),
}
_ARRAY_CTORS = {"array", "asarray", "full", "full_like"}


def _dtype_name(node: ast.AST | None) -> str | None:
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in _INT_RANGES else None
    name = dotted(node)
    if name is None:
        return None
    leaf = name.rsplit(".", 1)[-1]
    return leaf if leaf in _INT_RANGES else None


_FOLD_OPS = {
    ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b, ast.Pow: lambda a, b: a ** b,
    ast.LShift: lambda a, b: a << b, ast.RShift: lambda a, b: a >> b,
    ast.BitOr: lambda a, b: a | b, ast.BitAnd: lambda a, b: a & b,
    ast.BitXor: lambda a, b: a ^ b, ast.FloorDiv: lambda a, b: a // b,
    ast.Mod: lambda a, b: a % b,
}


def _const_value(node: ast.AST) -> int | None:
    """Fold a constant integer expression (handles ``2**40``-style
    literals); None when not statically an int."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_value(node.operand)
        return None if v is None else -v
    if isinstance(node, ast.BinOp) and type(node.op) in _FOLD_OPS:
        a, b = _const_value(node.left), _const_value(node.right)
        if a is None or b is None:
            return None
        if isinstance(node.op, ast.Pow) and (abs(a) > 2 ** 16
                                             or not 0 <= b < 256):
            return None          # keep folding cheap and exact
        try:
            return _FOLD_OPS[type(node.op)](a, b)
        except (ZeroDivisionError, OverflowError, ValueError):
            return None
    return None


def _int_literals(node: ast.AST):
    """Statically-known ints inside a literal payload (scalar, folded
    constant expression, or list/tuple/set of those)."""
    value = _const_value(node)
    if value is not None:
        yield node, value
        return
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        for el in node.elts:
            yield from _int_literals(el)


@register
class DtypeOverflow(_DeviceRule):
    id = "dtype-overflow"
    description = ("integer literal outside the target dtype's range "
                   "in an explicit dtype construction")
    hint = ("the literal wraps silently on the narrow lane; widen the "
            "dtype or reduce the literal into range explicitly")

    def check(self, mod: ParsedModule) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fq = dotted(node.func) or ""
            leaf = fq.rsplit(".", 1)[-1]
            payloads: list[ast.AST] = []
            dtype: str | None = None
            if leaf in _INT_RANGES and node.args:
                # np.uint8(x) / jnp.uint32(x) style cast
                dtype, payloads = leaf, [node.args[0]]
            elif leaf in _ARRAY_CTORS:
                # payload position: full/full_like(shape, VALUE, dtype)
                # vs array/asarray(VALUE, dtype)
                val_i = 1 if leaf in ("full", "full_like") else 0
                kw_dtype = next((kw.value for kw in node.keywords
                                 if kw.arg == "dtype"), None)
                pos_dtype = node.args[val_i + 1] \
                    if len(node.args) > val_i + 1 else None
                dtype = _dtype_name(kw_dtype if kw_dtype is not None
                                    else pos_dtype)
                if dtype is not None and len(node.args) > val_i:
                    payloads = [node.args[val_i]]
            if dtype is None:
                continue
            lo, hi = _INT_RANGES[dtype]
            for payload in payloads:
                for lit, value in _int_literals(payload):
                    if not lo <= value <= hi:
                        out.append(self.finding(
                            mod, lit,
                            f"literal {value} out of {dtype} range "
                            f"[{lo}, {hi}] in {fq}(...)"))
        return out
