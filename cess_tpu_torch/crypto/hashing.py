"""Hash helpers (host side).

Fragment/segment hashes are 64-byte hex-digest identities in the
reference (primitives/common/src/lib.rs:56 Hash([u8;64]) — an ASCII
hex sha256); here hashes are raw 32-byte sha256 digests.
"""
from __future__ import annotations

import hashlib


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def blake2b_256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def fragment_hash(data: bytes) -> bytes:
    """The on-chain identity of a fragment (goes into SegmentInfo)."""
    return sha256(data)
