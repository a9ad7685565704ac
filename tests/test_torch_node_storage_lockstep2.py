"""The reference's storage-network tests on both packages step by step,
second half: on a network of its own, the upload again (the repairs need
an active file), the secret-seeded fillers and the three repair tests
(symbol chains, a corrupted symbol's fallback, a corrupt survivor
refused). As ``test_torch_node_storage_lockstep.py``: every slot, import
and sync leaves equal head hashes, state roots and new events on both
packages (tolerance 0).
"""
import pytest

import torch_node_port as tp

CASES = tp.reference_tests("test_network", only=(
    "test_file_upload_through_network", "test_pois_filler_setup_and_audit",
    "test_repair_symbols_mode_cuts_ingress",
    "test_repair_symbol_corruption_falls_back_to_fragments",
    "test_repair_rejects_corrupt_reconstruction"))


@pytest.mark.parametrize("name", CASES)
def test_reference_storage_test_slot_by_slot(name, request):
    tp.run_lockstep("test_network", name, request, min_slots=1)
