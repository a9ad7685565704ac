"""The port's ``Runtime`` against the reference's on the pallets beyond
the storage-audit plane: the runtime-only tests of tests/test_assets.py,
test_indices.py, test_governance.py, test_contracts.py,
and test_scheduler.py, each run as
written on a twin of both packages' runtimes
(tests/torch_runtime_twin.py). After every call both runtimes hold the
same state root and the same new events, and a refused call fails on
both with the same ``DispatchError`` name; tolerance 0. A test that
patches a reference module's constant (``monkeypatch``) patches the
port's module alike.
"""
import pytest

from torch_runtime_twin import reference_tests, run_on_both

CASES = [(m, n) for m in ("test_assets", "test_indices", "test_governance",
                          "test_contracts", "test_scheduler")
         for n in reference_tests(m)]


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m[5:]}::{n[5:]}" for m, n in CASES])
def test_pallet_scenario_on_both_runtimes(module, name, monkeypatch,
                                          tmp_path):
    run_on_both(module, name, monkeypatch, tmp_path)
