"""The Mersenne field F_p, p = 2^31 - 1, in NumPy int64, exactly.

Elements are int64 in [0, p). A product of two elements is below 2^62
and is reduced at once, so a sum of up to 2^32 reduced products cannot
overflow. ``dot_u16`` multiplies 16-bit data by field elements through
float64 matrix products on 16-bit halves of the elements: each partial
sum stays below 2^53, where float64 is exact.
"""
from __future__ import annotations

import numpy as np

P = (1 << 31) - 1


def from_u32(x: np.ndarray) -> np.ndarray:
    """Unsigned 32-bit words -> [0, p) (x mod p)."""
    x = np.asarray(x).astype(np.int64)
    r = (x & P) + (x >> 31)
    return np.where(r >= P, r - P, r)


def dot(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    """sum_i a_i * b_i mod p along ``axis`` (broadcasting), exact."""
    return ((a.astype(np.int64) * b.astype(np.int64)) % P).sum(axis) % P


def dot_u16(m: np.ndarray, w: np.ndarray) -> np.ndarray:
    """m [..., s] (values below 2^16, s <= 2^21) times w [s, L] (field
    elements) mod p -> [..., L] int64, exact."""
    mf = m.astype(np.float64)
    lo = (w & 0xFFFF).astype(np.float64)
    hi = (w >> 16).astype(np.float64)
    a = (mf @ lo).astype(np.int64) % P
    b = (mf @ hi).astype(np.int64) % P
    return (a + (b << 16) % P) % P


def elems(block_bytes: np.ndarray) -> np.ndarray:
    """uint8 [..., 2s] -> little-endian 16-bit elements [..., s] int64."""
    b = np.ascontiguousarray(block_bytes, dtype=np.uint8)
    return b.view("<u2").astype(np.int64)
