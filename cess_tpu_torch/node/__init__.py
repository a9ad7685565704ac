"""Node layer: consensus, block production/import, offchain ecosystem.

The port's counterpart of ``cess_tpu/node``, module for module, with
the reference's public names; every module but ``offchain`` is host code
and imports without torch (this package imports ``consensus`` only):

- chain_spec.py genesis config (``ChainSpec``, ``dev_spec``,
                ``local_spec``, JSON export) and ``build_runtime`` over
                the port's ``Runtime``; ``genesis_hash`` equal to the
                reference's for the same spec.
- consensus.py  RRSC-style VRF slot lottery with epoch randomness and the
                credit-weighted validator election.
- mmr.py        the header Merkle mountain range and its proofs.
- finality.py   the vote-based finality gadget, justifications and
                equivocation evidence.
- store.py      the on-disk block log and state snapshots (the
                reference's bytes: a data directory crosses packages).
- network.py    ``Header``, ``Block``, ``Node`` (author, import, reorg,
                warp sync, session rotation) and the in-process
                ``Network``; block hashes equal the reference's.
- offchain.py   the agents (``OssGateway``, ``MinerAgent``, ``TeeAgent``,
                ``ValidatorOcw``) around a ``Node``, on the device steps
                of the same module (``upload_batch``, ``build_proof``,
                ``verify_owed``, ``certify_fillers``, the repairs) on the
                card, or on the CPU when given CPU pipelines and keys.
- hashing.py    ``fragment_hash`` and ``filler_bytes``.
- metrics.py    Prometheus exposition, telemetry stream, block logs.
- rpc.py        the JSON-RPC server (chain, state, author, eth, mmr,
                grandpa, payment, system and ``cess_*`` methods).
- ws.py         websocket pubsub (``newHeads``, logs).
- dht.py        Kademlia-style authority discovery.
- net.py        ``NodeService``: TCP gossip and sync, wire bytes equal
                to the reference's (port and JAX nodes form one network).
- cli.py        ``python -m cess_tpu_torch.node.cli``: ``--engine``
                takes off, cpu, auto and cuda.
"""
from .consensus import Rrsc, SlotClaim, elect_validators  # noqa: F401
