"""Run a test of the JAX package's chain on both packages at once.

``run_on_both(module, name, monkeypatch, tmp_path)`` calls the test
function ``name`` of the reference's test module ``module`` (for example
``tests/test_chain.py``) with every ``Runtime`` it builds replaced by a
``Twin``: a ``Lockstep`` of ``cess_tpu``'s and ``cess_tpu_torch``'s
runtimes behind one object. The module's own functions of the JAX
package (``migrations``, ``sign_extrinsic``, ``ed25519``...) become twins
of the two packages' too; its classes and exception types stay the
reference's, so the test's ``isinstance`` checks and ``pytest.raises``
read as written.

Every attribute, call, item and assignment on a twin runs on both
objects: arguments of the reference's types reach the port through the
two codecs (a twin argument gives each package its own object), and the
outcomes must agree (the same result, compared by encoding, or the same
exception type and ``DispatchError`` name). After each of them every
runtime pair must hold the same state root and the same new events
(``Lockstep.check``). A plain result (encodable, a scalar) comes back as
the reference's value; a live one (a pallet, a state, a method) comes
back as a twin. The test's own asserts then read the reference's values,
which the port's equal.

The module imports neither package itself.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import importlib
import inspect
import re
import types

from torch_chain_wiring import Lockstep

REF, PORT = "cess_tpu", "cess_tpu_torch"
_SCALARS = (type(None), bool, int, float, str, bytes)


class Session:
    """The locksteps one reference test builds, and how values cross."""

    def __init__(self):
        self.locksteps: list[Lockstep] = []
        self.calls = 0                          # twin operations run
        self.codecs = [importlib.import_module(f"{p}.codec")
                       for p in (REF, PORT)]

    # -- values across the packages ---------------------------------------
    def arg(self, i: int, v):
        """Value ``v`` (the reference's types, or twins) for package ``i``."""
        if isinstance(v, Twin):
            return v._objs[i]
        if isinstance(v, _SCALARS) or i == 0 and not _holds_twin(v):
            return v
        if isinstance(v, (tuple, list)) and _holds_twin(v):
            return type(v)(self.arg(i, x) for x in v)
        if isinstance(v, dict) and _holds_twin(v):
            return {self.arg(i, k): self.arg(i, x) for k, x in v.items()}
        try:
            raw = self.codecs[0].encode(v)
        except self.codecs[0].CodecError:  # not a protocol value: as is
            return v
        return self.codecs[i].decode(raw)

    def wrap(self, what: str, vals: list):
        """The reference's value after the port's agreed, or a twin."""
        first = vals[0]
        if isinstance(first, _SCALARS):
            if any(type(v) is not type(first) or v != first for v in vals):
                raise RuntimeError(f"{what}: values differ: {vals!r}")
            return first
        if isinstance(first, type) and issubclass(first, BaseException):
            # the reference's, for ``pytest.raises``: a twin raises the
            # reference's exception once the port's has matched it
            return first
        if isinstance(first, collections.abc.Iterator):
            return iter(self.wrap(what, [list(v) for v in vals]))
        try:
            raw = self.codecs[0].encode(first)
        except self.codecs[0].CodecError:  # a live object
            return Twin(self, vals, what)
        for codec, v in zip(self.codecs[1:], vals[1:]):
            if codec.encode(v) != raw:
                raise RuntimeError(f"{what}: values differ")
        return first

    def each(self, what: str, objs: list, fn):
        """``fn(i, obj)`` for each package, then every agreement check."""
        self.calls += 1
        outcomes = []
        for i, o in enumerate(objs):
            try:
                outcomes.append((None, fn(i, o)))
            except Exception as e:         # compared across packages
                outcomes.append((e, None))
        names = {None if e is None else
                 (type(e).__name__, getattr(e, "name", None))
                 for e, _ in outcomes}
        if len(names) != 1:
            raise RuntimeError(f"{what}: outcomes differ: {outcomes}")
        for ls in self.locksteps:
            ls.check(what)
        err, _ = outcomes[0]
        if err is not None:
            raise err
        return self.wrap(what, [v for _, v in outcomes])

    def module(self, name: str) -> "Twin":
        """Module ``name`` (e.g. "chain.extrinsic") of both packages."""
        return Twin(self, [importlib.import_module(f"{p}.{name}")
                           for p in (REF, PORT)], name)

    def runtime(self, config=None):
        """The reference's ``Runtime(config)``, as a twin."""
        objs = []
        for i, pkg in enumerate((REF, PORT)):
            mod = importlib.import_module(f"{pkg}.chain.runtime")
            cfg = config if config is None or i == 0 else \
                mod.RuntimeConfig(**dataclasses.asdict(config))
            objs.append(mod.Runtime(cfg))
        ls = Lockstep(objs)
        ls.check("Runtime()")
        self.locksteps.append(ls)
        return Twin(self, objs, "rt")


def _holds_twin(v) -> bool:
    if isinstance(v, Twin):
        return True
    if isinstance(v, (tuple, list)):
        return any(_holds_twin(x) for x in v)
    if isinstance(v, dict):
        return any(_holds_twin(k) or _holds_twin(x) for k, x in v.items())
    return False


class Twin:
    """One object of each package behind one handle (module docstring)."""

    __slots__ = ("_s", "_objs", "_what")

    def __init__(self, session: Session, objs: list, what: str):
        object.__setattr__(self, "_s", session)
        object.__setattr__(self, "_objs", list(objs))
        object.__setattr__(self, "_what", what)

    def _each(self, what, fn):
        return self._s.each(f"{self._what}{what}", self._objs, fn)

    def __getattr__(self, name):
        return self._each(f".{name}", lambda i, o: getattr(o, name))

    def __setattr__(self, name, value):
        self._each(f".{name} =", lambda i, o: setattr(
            o, name, self._s.arg(i, value)))

    def __call__(self, *args, **kwargs):
        s = self._s
        return self._each("()", lambda i, o: o(
            *(s.arg(i, a) for a in args),
            **{k: s.arg(i, v) for k, v in kwargs.items()}))

    def __getitem__(self, key):
        return self._each("[]", lambda i, o: o[self._s.arg(i, key)])

    def __setitem__(self, key, value):
        self._each("[] =", lambda i, o: o.__setitem__(
            self._s.arg(i, key), self._s.arg(i, value)))

    def __contains__(self, x):
        return self._each(" in", lambda i, o: self._s.arg(i, x) in o)

    def __len__(self):
        return self._each(" len", lambda i, o: len(o))

    def __bool__(self):
        return self._each(" bool", lambda i, o: bool(o))

    def __iter__(self):
        lists = [list(o) for o in self._objs]
        if len({len(v) for v in lists}) != 1:
            raise RuntimeError(f"{self._what}: lengths differ")
        for n, vals in enumerate(zip(*lists)):
            yield self._s.wrap(f"{self._what}[{n}]", list(vals))

    def __instancecheck__(self, instance):
        return isinstance(instance, tuple(self._objs))

    def __repr__(self):
        return f"Twin({self._what}: {self._objs[0]!r})"


def _twin_globals(session: Session, module) -> dict:
    """The module's globals to replace: ``Runtime``, and each module or
    function of the reference package with a counterpart in the port."""
    out = {}
    for name, v in vars(module).items():
        if name == "Runtime":
            out[name] = session.runtime
            continue
        if isinstance(v, types.ModuleType):
            mod_name = v.__name__
        elif isinstance(v, types.FunctionType):
            mod_name = v.__module__
        else:
            continue
        if mod_name != REF and not mod_name.startswith(REF + "."):
            continue
        port_name = PORT + mod_name[len(REF):]
        try:
            port_mod = importlib.import_module(port_name)
        except ImportError:
            continue
        other = port_mod if isinstance(v, types.ModuleType) \
            else getattr(port_mod, v.__name__, None)
        if other is not None:
            out[name] = Twin(session, [v, other], name)
    return out


class _PatchBoth:
    """``monkeypatch`` whose ``setattr`` on a module of the reference
    package sets the same name in the port's module too."""

    def __init__(self, monkeypatch):
        self._mp = monkeypatch

    def setattr(self, target, name, value, raising=True):
        self._mp.setattr(target, name, value, raising=raising)
        if isinstance(target, types.ModuleType) \
                and target.__name__.startswith(REF + "."):
            port = importlib.import_module(
                PORT + target.__name__[len(REF):])
            self._mp.setattr(port, name, value, raising=raising)

    def __getattr__(self, name):
        return getattr(self._mp, name)


def fixtures(module: str, monkeypatch, tmp_path):
    """A session bound to reference test ``module`` (its globals of the
    JAX package twinned, undone by ``monkeypatch``), and a function that
    builds one of its fixtures (or ``monkeypatch``, ``tmp_path``) there."""
    mod = importlib.import_module(module)
    session = Session()
    for gname, twin in _twin_globals(session, mod).items():
        monkeypatch.setattr(mod, gname, twin)

    def value_of(param):
        if param == "monkeypatch":
            return _PatchBoth(monkeypatch)
        if param == "tmp_path":
            return tmp_path
        fn = getattr(mod, param)._get_wrapped_function()
        return fn(**{p: value_of(p) for p in inspect.signature(fn).parameters})

    return session, value_of


def run_on_both(module: str, name: str, monkeypatch, tmp_path, *,
                pure: bool = False) -> Session:
    """Reference test ``module``::``name`` on both packages (module
    docstring), with its fixtures built the same way. It must build a
    ``Runtime``; a ``pure`` test must at least call a twin."""
    session, value_of = fixtures(module, monkeypatch, tmp_path)
    fn = getattr(importlib.import_module(module), name)
    fn(**{p: value_of(p) for p in inspect.signature(fn).parameters})
    if not (session.locksteps or pure and session.calls):
        raise RuntimeError(f"{module}::{name} ran nothing on both packages")
    return session


# the reference's node layer, which the port does not have yet
_NODE_LAYER = re.compile(
    r"\bcess_tpu\.node\.(network|rpc|chain_spec|metrics|net|ws|cli)\b")


def reference_tests(module: str, leave_out: dict | None = None) -> list[str]:
    """The test functions of reference test ``module``, in file order,
    less ``leave_out`` (name -> why) and less the tests that build a
    node of the reference's node layer instead of taking its ``rt``."""
    mod = importlib.import_module(module)
    names = [n for n, v in vars(mod).items()
             if n.startswith("test_") and callable(v)]
    leave_out = leave_out or {}
    missing = set(leave_out) - set(names)
    if missing:
        raise RuntimeError(f"{module} has no {sorted(missing)}")
    return [n for n in names if n not in leave_out
            and not _drives_a_node(getattr(mod, n))]


def _drives_a_node(fn) -> bool:
    return "rt" not in inspect.signature(fn).parameters \
        and bool(_NODE_LAYER.search(inspect.getsource(fn)))
