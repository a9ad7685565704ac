"""The reference's storage-network tests (``tests/test_network.py``'s
``storage_net``: 3 validators, a gateway, 4 miners, a TEE with its BLS key,
two validators' offchain workers) on the port's node and agents, each as
written (``torch_node_port``), in file order on one module-scoped network.
The agents run on ``AgentPipeline``s on the CPU at the fixture's 64 KiB
segments (its key and pipeline asked for the CPU). Both packages step by
step: ``test_torch_node_storage_lockstep*.py``.
"""
import pytest

import torch_node_port as tp

STORAGE_TESTS = ("test_file_upload_through_network",
                 "test_audit_round_over_network",
                 "test_data_loss_detected_and_repaired",
                 "test_dropped_filler_fails_idle_audit_and_punishes",
                 "test_pois_filler_setup_and_audit",
                 "test_repair_symbols_mode_cuts_ingress",
                 "test_repair_symbol_corruption_falls_back_to_fragments",
                 "test_repair_rejects_corrupt_reconstruction")
CASES = tp.reference_tests("test_network", only=STORAGE_TESTS)


@pytest.mark.parametrize("name", CASES)
def test_reference_storage_test_on_the_port(name, request):
    tp.run("test_network", name, request)
