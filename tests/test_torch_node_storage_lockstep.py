"""The reference's storage-network tests on both packages step by step,
first half: the upload, the audit round, a repaired data loss and a
dropped filler's idle punishment. The reference's test runs on the JAX
package (its agents on the JAX pipeline) and the port's on the port (its
agents on ``AgentPipeline``s on the CPU, 64 KiB segments), each on its own
module-scoped ``storage_net``; after every slot, import and sync the head
hashes on every replica, the state roots and the new events must be equal
(tolerance 0). The second half is ``test_torch_node_storage_lockstep2.py``
(a file of its own, so another worker runs it).
"""
import pytest

import torch_node_port as tp

CASES = tp.reference_tests("test_network", only=(
    "test_file_upload_through_network", "test_audit_round_over_network",
    "test_data_loss_detected_and_repaired",
    "test_dropped_filler_fails_idle_audit_and_punishes"))


@pytest.mark.parametrize("name", CASES)
def test_reference_storage_test_slot_by_slot(name, request):
    tp.run_lockstep("test_network", name, request, min_slots=1)
