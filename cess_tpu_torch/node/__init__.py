"""cess_tpu_torch.node: the device half of the off-chain agents.

The port's counterpart of what ``cess_tpu/node/offchain.py`` runs on the
device, and of its proof wire format (the agents' classes, which need a
node, are not ported):

- hashing.py   ``fragment_hash`` (``crypto.hashing``'s sha256) and an
               own copy of ``filler_bytes``, byte-equal to the TPU
               package's.
- offchain.py  ``HostPodr2`` (the ``podr2`` surface the agents read, host
               arrays in and out), ``AgentPipeline`` with its
               ``DeviceFragments`` handle, ``host_codec``, and the agents'
               steps: ``upload_batch``, ``prove_owed``, ``verify_owed``,
               ``certify_fillers``, ``warm_restoral``,
               ``repair_via_fragments``, ``repair_symbol``,
               ``repair_via_symbols``; ``Proof``, ``proof_wire_bytes``
               and ``build_proof``, the proof's wire bytes.
"""
