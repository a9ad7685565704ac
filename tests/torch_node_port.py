"""Run a reference node test on the port as written, and on both packages
slot by slot.

``port_module(name)`` is the reference test module ``tests/<name>.py``
with every ``cess_tpu`` module name read as ``cess_tpu_torch`` (and, per
file, the few literal edits of ``SWAPS``: the port runs on the card unless
a caller asks for the CPU, so a key or pipeline the test builds is asked
for it). The module is written to a directory of its own on ``sys.path``,
so that a worker process it spawns imports it by name.

``run(name, test, request)`` calls one test function of it with its
fixtures (module-scoped ones built once per module and test file, as
pytest would). A test file may instead import the module's tests,
``from port_<name> import *`` after ``port_module(name)``, and let pytest
collect them, classes, parameter sets and marks included.
``run_lockstep(name, test, request)`` runs the reference's test and the
port's, each recording after every slot (``Network.run_slot``) and every
top-level commit, import, sync and warp sync of a ``Node`` its outcome
and, for each replica it moved, the head hash, the state root and the
events it added (hashed from each package's codec bytes), and asserts the
two records equal step by step. Module-scoped fixtures and their state
carry across the cases of one test file, in file order (``--dist
loadfile``).

The module imports neither package itself.
"""
from __future__ import annotations

import atexit
import contextlib
import functools
import hashlib
import importlib
import inspect
import os
import re
import shutil
import sys
import tempfile

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
REF, PORT = "cess_tpu", "cess_tpu_torch"

# literal edits a reference file needs on the port: (old, new), each of
# which must occur in the file (``@TESTS@`` in ``new``: this directory)
SWAPS = {
    "test_network": [
        ("key = podr2.Podr2Key.generate(7)",
         'key = podr2.Podr2Key.generate(7, device="cpu")'),
        ("pipe = StoragePipeline(cfg, podr2_key=key)",
         'pipe = StoragePipeline(cfg, podr2_key=key, device="cpu")'),
    ],
    # the 8 host devices the JAX package's tests see (tests/conftest.py)
    "test_sim": [
        ('n_nodes=20)', 'n_nodes=20, devices=["cpu"] * 8)'),
        ('n_nodes=20, tracer=tracer)',
         'n_nodes=20, tracer=tracer, devices=["cpu"] * 8)'),
        ('n_nodes=100)', 'n_nodes=100, devices=["cpu"] * 8)'),
    ],
    # the real tree's tests read the repository, and the port's CLI and
    # baseline stand in for tools/cesslint.py and its baseline
    "test_lint": [
        ('REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))',
         'REPO = os.path.dirname(@TESTS@)'),
        ('os.path.join(REPO, "tools", "cesslint_baseline.json")',
         'os.path.join(REPO, "cess_tpu_torch", "analysis", '
         '"cesslint_baseline.json")'),
        ('os.path.join(REPO, "tools", "cesslint.py")',
         '"-m", "cess_tpu_torch.analysis"'),
    ],
}


@functools.lru_cache(maxsize=None)
def _port_dir() -> str:
    path = tempfile.mkdtemp(prefix="port_tests_")
    atexit.register(shutil.rmtree, path, True)
    sys.path.insert(0, path)
    return path


def port_source(name: str) -> str:
    with open(os.path.join(TESTS, f"{name}.py")) as f:
        src = f.read()
    for old, new in SWAPS.get(name, ()):
        if old not in src:
            raise RuntimeError(f"tests/{name}.py no longer holds {old!r}")
        src = src.replace(old, new.replace("@TESTS@", repr(TESTS)))
    return re.sub(r"\bcess_tpu\b", PORT, src)


def port_module(name: str):
    """``tests/<name>.py`` on the port, imported as ``port_<name>``."""
    mod_name = f"port_{name}"
    if mod_name not in sys.modules:
        path = os.path.join(_port_dir(), f"{mod_name}.py")
        with open(path, "w") as f:
            f.write(port_source(name))
        importlib.invalidate_caches()
        importlib.import_module(mod_name)
    return sys.modules[mod_name]


def reference_tests(name: str, only=None, leave_out=()) -> list[str]:
    """The test functions of ``tests/<name>.py`` in file order (``only``:
    these, which must exist), less ``leave_out``."""
    src = open(os.path.join(TESTS, f"{name}.py")).read()
    names = re.findall(r"^def (test_\w+)\(", src, re.M)
    missing = set(only or ()) - set(names) | set(leave_out) - set(names)
    if missing:
        raise RuntimeError(f"tests/{name}.py has no {sorted(missing)}")
    return [n for n in names if (only is None or n in only)
            and n not in leave_out]


# -- fixtures ----------------------------------------------------------------
_MODULE_FIXTURES: dict = {}       # (module name, fixture) -> value


def _fixture(mod, param: str, request, scoped: dict):
    if param in scoped:
        return scoped[param]
    if param in ("tmp_path", "monkeypatch", "capsys", "capfd"):
        return request.getfixturevalue(param)
    fix = getattr(mod, param)
    fn = fix._get_wrapped_function() if hasattr(
        fix, "_get_wrapped_function") else fix.__wrapped__
    scope = getattr(getattr(fix, "_fixture_function_marker", None),
                    "scope", "function")
    key = (request.module.__name__, mod.__name__, param)
    if scope == "module" and key in _MODULE_FIXTURES:
        return _MODULE_FIXTURES[key]
    value = fn(**{p: _fixture(mod, p, request, scoped)
                  for p in inspect.signature(fn).parameters})
    if inspect.isgenerator(value):
        gen, value = value, next(value)
        request.addfinalizer(lambda: next(gen, None))
    if scope == "module":
        _MODULE_FIXTURES[key] = value
    scoped[param] = value
    return value


def call(mod, test: str, request, tmp_name: str | None = None):
    """Test function ``test`` of module ``mod`` with its fixtures
    (``tmp_name``: ``tmp_path`` is that directory of pytest's)."""
    fn = getattr(mod, test)
    scoped: dict = {}
    if tmp_name is not None:
        tmp = request.getfixturevalue("tmp_path") / tmp_name
        tmp.mkdir()
        scoped["tmp_path"] = tmp
    return fn(**{p: _fixture(mod, p, request, scoped)
                 for p, v in inspect.signature(fn).parameters.items()
                 if v.default is inspect.Parameter.empty})


def run(name: str, test: str, request):
    """The reference's ``tests/<name>.py::<test>`` on the port."""
    return call(port_module(name), test, request)


# -- slot-by-slot records ------------------------------------------------------
class SlotRecord:
    """What each ``Network.run_slot`` of one package left behind."""

    def __init__(self, pkg: str):
        self.codec = importlib.import_module(f"{pkg}.codec")
        self.slots: list = []

    @staticmethod
    def _new_events(state) -> list:
        """The events ``state`` gained since it was last read here (its
        whole retained log once the log has been cut to its cap)."""
        hist = state.event_history
        seen = getattr(state, "_slot_record_seen", 0)
        new = hist[seen:] if seen <= len(hist) < state.EVENT_HISTORY_CAP \
            else hist
        state._slot_record_seen = len(hist)
        return [e for _, e in new] + list(state.events)

    def _events_digest(self, state) -> bytes:
        return hashlib.sha256(self.codec.encode(
            self._new_events(state))).digest()

    def _replica(self, node) -> tuple:
        return (node.chain[-1].hash(), node.runtime.state.state_root(),
                self._events_digest(node.runtime.state))

    def note(self, what: str, nodes, outcome) -> None:
        self.slots.append((what, outcome,
                           tuple(self._replica(n) for n in nodes)))


# what is recorded: every ``Network.run_slot`` (all replicas), and every
# top-level ``Node`` commit, import, sync and warp sync (that replica)
_NETWORK_STEPS = ("run_slot",)
_NODE_STEPS = ("commit_proposal", "import_block", "sync_from",
               "warp_sync_from")


@contextlib.contextmanager
def recording(pkg: str, monkeypatch):
    """Record every step of package ``pkg``'s nodes (``_NETWORK_STEPS``,
    ``_NODE_STEPS``) that is not inside another."""
    rec = SlotRecord(pkg)
    network = importlib.import_module(f"{pkg}.node.network")
    depth = [0]

    def wrap(cls, step, nodes_of):
        inner = getattr(cls, step)

        def recorded(self, *args, **kwargs):
            depth[0] += 1
            try:
                out = inner(self, *args, **kwargs)
            except Exception as e:
                outcome = ("raised", type(e).__name__)
                raise
            else:
                outcome = ("block", out.header.hash()) \
                    if isinstance(out, network.Block) else ("value", out)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    rec.note(step, nodes_of(self), outcome)
            return out
        return recorded

    with monkeypatch.context() as mp:
        for step in _NETWORK_STEPS:
            mp.setattr(network.Network, step,
                       wrap(network.Network, step, lambda net: net.nodes))
        for step in _NODE_STEPS:
            mp.setattr(network.Node, step,
                       wrap(network.Node, step, lambda node: [node]))
        yield rec


def run_lockstep(name: str, test: str, request, min_slots: int = 0):
    """The reference's test and the port's, their slot records equal."""
    mp = request.getfixturevalue("monkeypatch")
    with recording(REF, mp) as ref:
        call(reference_module_fresh(name), test, request, REF)
    with recording(PORT, mp) as port:
        call(port_module(name), test, request, PORT)
    assert len(ref.slots) == len(port.slots) >= min_slots, \
        (len(ref.slots), len(port.slots))
    for i, (a, b) in enumerate(zip(ref.slots, port.slots)):
        if a != b:
            pytest.fail(f"{name}::{test}: record {i} ({a[0]}) differs: "
                        f"{a!r} != {b!r}")
    return ref, port


@functools.lru_cache(maxsize=None)
def reference_module_fresh(name: str):
    """``tests/<name>.py`` as a module of its own (``ref_<name>``), so its
    module-scoped fixtures here are apart from pytest's."""
    path = os.path.join(_port_dir(), f"ref_{name}.py")
    with open(os.path.join(TESTS, f"{name}.py")) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(src)
    importlib.invalidate_caches()
    return importlib.import_module(f"ref_{name}")
