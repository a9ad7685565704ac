"""The port's EVM (``chain/evm.py``, ``chain/evm_interp.py``) against the
reference's: the tests of tests/test_evm.py that need only the runtime
(its ``rt`` fixture, and the interpreter's primitives), each run as
written on a twin of both packages (tests/torch_runtime_twin.py): equal
state roots, events, receipts, return data and error names after every
call; tolerance 0. The reference's deviations from mainnet (SHA3 as
NIST sha3_256, CREATE2 over sha256, ecrecover's sha3 addresses) are
the spec and hold in both.
"""
import pytest

from torch_runtime_twin import reference_tests, run_on_both

CASES = reference_tests("test_evm", {
    # a local import of crypto.ripemd160: tests/test_torch_crypto.py
    # holds the port's RIPEMD-160 to the reference's and to hashlib
    "test_ripemd160_fallback_matches_hashlib": "local import",
})
PURE = {"test_interp_primitives"}       # the interpreter alone


@pytest.mark.parametrize("name", CASES)
def test_evm_scenario_on_both(name, monkeypatch, tmp_path):
    run_on_both("test_evm", name, monkeypatch, tmp_path, pure=name in PURE)
