"""Threefry-2x32 and the PoDR2 protocol's derivations, in plain NumPy.

A frozen statement of the randomness the audit protocol fixes: the
20-round threefry2x32 hash on uint32 words (wrap-around arithmetic), and
from it the key, fold-in, split, random words and bounded integers of a
counter-based generator, the round key of a seed, the challenge (block
indices and coefficients), the per-fragment aggregation coefficients and
the per-block PRF of a fragment id.
"""
from __future__ import annotations

import hashlib

import numpy as np

from . import m31

U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
CHALLENGE_NUM, CHALLENGE_DEN = 46, 1000     # challenged share of blocks


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << U32(r)) | (x >> U32(32 - r))


def hash2x32(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """threefry2x32 of counter (x0, x1) under key (k0, k1), broadcasting;
    every argument holds uint32 words."""
    k0, k1, x0, x1 = (np.asarray(v, dtype=U32) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ U32(_PARITY))
    with np.errstate(over="ignore"):
        x0 = x0 + k0
        x1 = x1 + k1
        for g in range(5):
            for r in _ROT[g % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(g + 1) % 3]
            x1 = x1 + ks[(g + 2) % 3] + U32(g + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """The key [2] of an integer seed in [0, 2^64)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], U32)


def fold_in(k: np.ndarray, data) -> np.ndarray:
    """Keys [..., 2] folded with 32-bit words (broadcasting) -> [..., 2]."""
    data = np.asarray(data, dtype=U32)
    y0, y1 = hash2x32(k[..., 0], k[..., 1], np.zeros_like(data), data)
    return np.stack([y0, y1], axis=-1)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """Key [2] -> [num, 2]."""
    n = np.arange(num, dtype=np.uint64)
    y0, y1 = hash2x32(k[0], k[1], (n >> np.uint64(32)).astype(U32),
                      (n & np.uint64(0xFFFFFFFF)).astype(U32))
    return np.stack([y0, y1], axis=-1)


def bits(k: np.ndarray, count: int) -> np.ndarray:
    """Random words [..., count] from keys [..., 2]: the counter is each
    element's flat index."""
    n = np.arange(count, dtype=U32)
    y0, y1 = hash2x32(k[..., 0, None], k[..., 1, None], np.zeros_like(n), n)
    return y0 ^ y1


def randint(k: np.ndarray, count: int, lo: int, hi: int) -> np.ndarray:
    """``count`` integers in [lo, hi) from key [2] (int64)."""
    k_hi, k_lo = split(k, 2)
    higher = bits(k_hi, count).astype(np.int64)
    lower = bits(k_lo, count).astype(np.int64)
    span = max(1, hi - lo)
    mult = ((1 << 16) % span) ** 2 % (1 << 32) % span
    off = ((((higher % span) * mult) & 0xFFFFFFFF) + lower % span)
    return lo + (off & 0xFFFFFFFF) % span


def round_key(seed: bytes, prefix: bytes = b"") -> np.ndarray:
    d = hashlib.sha256(prefix + seed).digest()
    w0 = int.from_bytes(d[:4], "little")
    w1 = int.from_bytes(d[4:8], "little")
    return fold_in(key(w0), U32(w1))


def challenge(seed: bytes, blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """(block indices [c] int64, coefficients nu [c] int64 in [0, p)),
    c = 46/1000 of the blocks (at least 1)."""
    count = max(1, blocks * CHALLENGE_NUM // CHALLENGE_DEN)
    k_idx, k_nu = split(round_key(seed), 2)
    return (randint(k_idx, count, 0, blocks),
            m31.from_u32(bits(k_nu, count)))


def fragment_keys(k: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Keys [F, 2] of fragment ids [F, 2] (lo, hi words)."""
    ids = np.asarray(ids, dtype=U32)
    return fold_in(fold_in(k, ids[:, 0]), ids[:, 1])


def aggregate_coeffs(seed: bytes, ids: np.ndarray) -> np.ndarray:
    """Aggregation coefficients r [F] int64 of fragment ids [F, 2]."""
    k = round_key(seed, b"cess-podr2-agg:")
    return m31.from_u32(bits(fragment_keys(k, ids), 1)[:, 0])


def prf(prf_key: np.ndarray, ids: np.ndarray, blocks: np.ndarray,
        limbs: int) -> np.ndarray:
    """f(id, b) [F, C, limbs] int64 in [0, p) for ids [F, 2] and block
    indices [C]."""
    fk = fragment_keys(np.asarray(prf_key, dtype=U32), ids)     # [F, 2]
    kb = fold_in(fk[:, None, :], np.asarray(blocks, dtype=U32)[None, :])
    return m31.from_u32(bits(kb, limbs))


def fragment_id(fragment_hash: bytes) -> np.ndarray:
    """The PoDR2 id of a fragment: the low 8 bytes of its hash as the
    (lo, hi) uint32 words."""
    v = int.from_bytes(fragment_hash[:8], "little")
    return np.array([v & 0xFFFFFFFF, v >> 32], U32)
