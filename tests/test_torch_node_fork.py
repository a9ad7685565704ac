"""The reference's fork, finality and network tests on the port's node:
``tests/test_fork.py`` (partitions, reorgs, finality, equivocations, warp
sync) and the tests of ``tests/test_network.py`` that need no storage
network (block production, forged origins, nonces, tampered roots, the
validators' election worker), each as written (``torch_node_port``) and
each also on both packages step by step: equal head hashes on every
replica, equal state roots and equal new events after every slot, import
and sync (tolerance 0).
"""
import pytest

import torch_node_port as tp

NETWORK_TESTS = ("test_block_production_and_replica_determinism",
                 "test_forged_origin_rejected",
                 "test_internal_pallet_methods_not_dispatchable",
                 "test_nonce_replay_rejected",
                 "test_import_rejects_tampered_state_root",
                 "test_ocw_mines_unsigned_election_solution")

CASES = ([("test_fork", n) for n in tp.reference_tests("test_fork")]
         + [("test_network", n) for n in tp.reference_tests(
             "test_network", only=NETWORK_TESTS)])


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m}::{n}" for m, n in CASES])
def test_reference_node_test_on_the_port(module, name, request):
    tp.run(module, name, request)


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m}::{n}" for m, n in CASES])
def test_reference_node_test_slot_by_slot(module, name, request):
    tp.run_lockstep(module, name, request, min_slots=1)
