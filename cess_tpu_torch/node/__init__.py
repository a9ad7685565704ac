"""cess_tpu_torch.node: the device half of the off-chain agents.

The port's counterpart of what ``cess_tpu/node/offchain.py`` runs on the
device (the chain half, extrinsics and events, is not ported):

- hashing.py   own copies of ``fragment_hash`` (sha256) and
               ``filler_bytes``, byte-equal to the TPU package's.
- offchain.py  ``HostPodr2`` (the ``podr2`` surface the agents read, host
               arrays in and out), ``AgentPipeline`` with its
               ``DeviceFragments`` handle, ``host_codec``, and the agents'
               steps: ``upload_batch``, ``prove_owed``, ``verify_owed``,
               ``certify_fillers``, ``warm_restoral``,
               ``repair_via_fragments``, ``repair_symbol``,
               ``repair_via_symbols``.
"""
