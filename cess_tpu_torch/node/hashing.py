"""Host hashes of the off-chain agents: fragment identities and fillers.

``fragment_hash`` is ``crypto/hashing.py``'s, re-exported; ``filler_bytes``
is the port's own copy of ``cess_tpu/node/offchain.py``'s (the port
imports nothing of that package). Both are protocol facts:
the bytes must equal the reference's, since a fragment's hash is its
on-chain identity and the low 8 bytes of it are its PoDR2 id.
"""
from __future__ import annotations

import hashlib

from ..crypto.hashing import fragment_hash  # noqa: F401


def filler_bytes(miner: str, index: int, size: int) -> bytes:
    """Deterministic filler (idle file) content: a SHA-256 counter-mode
    stream over (miner, index), so miner, TEE and auditor each regenerate
    a filler byte for byte."""
    seed = b"cess-filler:" + miner.encode() + index.to_bytes(8, "little")
    n = -(-size // 32)
    return b"".join(hashlib.sha256(seed + c.to_bytes(8, "little")).digest()
                    for c in range(n))[:size]
