"""Host hashes of the off-chain agents: fragment identities and fillers.

The port's own copies of ``cess_tpu/crypto/hashing.py``'s
``fragment_hash`` and ``cess_tpu/node/offchain.py``'s ``filler_bytes``
(the port imports nothing of that package). Both are protocol facts:
the bytes must equal the reference's, since a fragment's hash is its
on-chain identity and the low 8 bytes of it are its PoDR2 id.
"""
from __future__ import annotations

import hashlib


def fragment_hash(data) -> bytes:
    """The on-chain identity of a fragment: its raw 32-byte sha256."""
    return hashlib.sha256(data).digest()


def filler_bytes(miner: str, index: int, size: int) -> bytes:
    """Deterministic filler (idle file) content: a SHA-256 counter-mode
    stream over (miner, index), so miner, TEE and auditor each regenerate
    a filler byte for byte."""
    seed = b"cess-filler:" + miner.encode() + index.to_bytes(8, "little")
    n = -(-size // 32)
    return b"".join(hashlib.sha256(seed + c.to_bytes(8, "little")).digest()
                    for c in range(n))[:size]
