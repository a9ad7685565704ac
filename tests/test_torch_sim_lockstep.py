"""The scenario library of the simulated network on both packages, first
half: each scenario at 20 nodes through the JAX package and through the
port alone (``torch_sim_twin.run_both``), with equal witnesses, rounds,
pool snapshots and profile counts (tolerance 0). The second half is in
``test_torch_sim_lockstep2.py``."""
import pytest

import torch_sim_twin as twin
from torch_sim_twin import _one_thread, _yield_cpu  # noqa: F401 (autouse)

NAMES = ("adversarial_audit", "equivocating_validator", "gateway_hotspot",
         "gateway_hotspot_fleet", "gateway_hotspot_pool")


@pytest.mark.parametrize("name", NAMES)
def test_scenario_on_both_packages(name):
    twin.run_both(name)
