"""The scenario library of the simulated network on both packages,
second half (the first is ``test_torch_sim_lockstep.py``), and the two
host helpers whose bytes reach the finalized chain: the adversarial
miner's stored bytes and the TEE attestation's seeded RSA pair."""
import numpy as np
import pytest

import torch_sim_twin as twin
from torch_sim_twin import _one_thread, _yield_cpu  # noqa: F401 (autouse)

NAMES = ("miner_attrition", "miner_churn", "partition_heal",
         "perf_regression_autopilot", "repair_storm", "restoral_auction")


@pytest.mark.parametrize("name", NAMES)
def test_scenario_on_both_packages(name):
    twin.run_both(name)


def test_library_is_covered():
    """The two halves cover the library, whose scenarios are the
    reference's field for field."""
    from cess_tpu.sim import SCENARIOS as JSCENARIOS
    from cess_tpu_torch.sim import SCENARIOS

    import test_torch_sim_lockstep as first

    assert sorted(SCENARIOS) == sorted(JSCENARIOS) \
        == sorted(first.NAMES + NAMES)
    for name, sc in SCENARIOS.items():
        ref = JSCENARIOS[name]
        assert [getattr(sc, f) for f in sc.__dataclass_fields__] \
            == [getattr(ref, f) for f in ref.__dataclass_fields__]


class _Gateway:
    def __init__(self, store: dict):
        self.fragment_store = store


def _miner(cls):
    miner = cls.__new__(cls)
    miner.retry, miner.clock = None, None
    return miner


def test_adversarial_miner_stores_the_same_bytes():
    """The port's numpy XOR stores the bytes the reference's byte loop
    does, for every size up to a whole 1 MiB fragment; a fragment the
    gateway lacks is refused by both."""
    from cess_tpu.crypto.hashing import fragment_hash as jhash
    from cess_tpu.sim.world import AdversarialMiner as JMiner
    from cess_tpu_torch.node.hashing import fragment_hash
    from cess_tpu_torch.sim.world import AdversarialMiner

    rng = np.random.default_rng(14)
    blobs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (1, 63, 64, 4097, 1 << 20)]
    gw = _Gateway({fragment_hash(b): b for b in blobs})
    assert all(jhash(b) == h for h, b in gw.fragment_store.items())
    port, ref = _miner(AdversarialMiner), _miner(JMiner)
    for h, blob in gw.fragment_store.items():
        got, want = port._transfer(gw, h), ref._transfer(gw, h)
        assert got == want == bytes(b ^ 0xA5 for b in blob)
        assert fragment_hash(got) != h
    assert port._transfer(gw, b"\0" * 32) is None \
        and ref._transfer(gw, b"\0" * 32) is None


def test_sim_rsa_keypairs_are_equal():
    """The TEE attestation's RSA pairs (seeds 5 and 6) sign what lands in
    the finalized chain, so both packages derive the same pair."""
    from cess_tpu.sim.world import _sim_rsa_keypair as jpair
    from cess_tpu_torch.sim.world import _sim_rsa_keypair

    for seed in (5, 6):
        got, want = _sim_rsa_keypair(1024, seed), jpair(1024, seed)
        assert (got.n, got.e, got.d) == (want.n, want.e, want.d)
        assert got.n.bit_length() == 1024
        assert got.public.n == want.public.n
