"""The port's ``Runtime`` against the reference's on staking, offences,
im-online and the election: the runtime-only tests of
tests/test_staking.py and test_election.py (those that build a node of
the reference's node layer, which the port has not yet, left out), each
run as written on a twin of both packages' runtimes
(tests/torch_runtime_twin.py). After every call both runtimes hold the
same state root and the same new events, and a refused call fails on
both with the same ``DispatchError`` name; tolerance 0. A test that
patches a reference module's constant (``monkeypatch``) patches the
port's module alike.
"""
import pytest

from torch_runtime_twin import reference_tests, run_on_both

CASES = [(m, n) for m in ("test_staking", "test_election")
         for n in reference_tests(m)]


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m[5:]}::{n[5:]}" for m, n in CASES])
def test_staking_scenario_on_both_runtimes(module, name, monkeypatch,
                                           tmp_path):
    run_on_both(module, name, monkeypatch, tmp_path)
