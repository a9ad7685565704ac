"""GF(2^8) arithmetic for the erasure codec (NumPy, host side).

The field is GF(2^8) with polynomial 0x11D. This module builds the
small constant matrices the codec applies on the device: the Cauchy
parity matrix of a systematic RS(k, m) code, decode and repair matrices
for an erasure pattern, the split nibble tables the GF apply kernel
keeps in shared memory, and the GF(2) bit-matrix form of a GF matrix.
Everything here is NumPy; the tensors built from it live on the device.
"""
from __future__ import annotations

import functools

import numpy as np

POLY = 0x11D
FIELD = 256
ORDER = 255  # multiplicative group order


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(2 * ORDER, dtype=np.uint8)
    log = np.zeros(FIELD, dtype=np.int32)
    x = 1
    for i in range(ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[ORDER:] = exp[:ORDER]
    return exp, log


EXP, LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return int(EXP[ORDER - LOG[a]])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP[(LOG[a] * n) % ORDER])


@functools.cache
def mul_table() -> np.ndarray:
    """Full 256x256 multiplication table; MUL[a, b] = a*b in GF(2^8)."""
    la = LOG.reshape(FIELD, 1)
    lb = LOG.reshape(1, FIELD)
    t = EXP[(la + lb) % ORDER].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    t.flags.writeable = False  # shared cached table
    return t


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product a @ b of uint8 matrices (XOR-accumulate)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[0]
    mt = mul_table()
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(a.shape[1]):
            c = a[i, j]
            if c:
                out[i] ^= mt[c][b[j]]
    return out


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination."""
    m = np.array(m, dtype=np.uint8)
    n = m.shape[0]
    assert m.shape == (n, n)
    aug = np.concatenate([m, np.eye(n, dtype=np.uint8)], axis=1)
    mt = mul_table()
    for col in range(n):
        pivot = next((row for row in range(col, n) if aug[row, col]), None)
        if pivot is None:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = mt[gf_inv(int(aug[col, col]))][aug[col]]
        for row in range(n):
            if row != col and aug[row, col]:
                aug[row] ^= mt[int(aug[row, col])][aug[col]]
    return aug[:, n:].copy()


def cauchy_parity_matrix(k: int, m: int) -> np.ndarray:
    """The m x k Cauchy parity matrix C[i, j] = 1 / ((k + i) ^ j)."""
    if k + m > FIELD:
        raise ValueError(f"k + m = {k + m} exceeds field size {FIELD}")
    c = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            c[i, j] = gf_inv((k + i) ^ j)
    return c


def systematic_generator(k: int, m: int) -> np.ndarray:
    """(k+m) x k generator: identity rows, then the Cauchy rows."""
    return np.concatenate(
        [np.eye(k, dtype=np.uint8), cauchy_parity_matrix(k, m)], axis=0)


def _check_rows(k: int, m: int, rows: tuple[int, ...], what: str) -> None:
    if len(set(rows)) != len(rows):
        raise ValueError(f"duplicate {what} shard indices: {rows}")
    for r in rows:
        if not 0 <= int(r) < k + m:
            raise ValueError(f"{what} shard index {r} out of range for "
                             f"RS({k},{m}) with {k + m} rows")


def decode_matrix(k: int, m: int, present: tuple[int, ...]) -> np.ndarray:
    """Matrix R with data = R @ shards[present] for any k present rows."""
    if len(present) != k:
        raise ValueError(
            f"need exactly k={k} present shard indices, got {len(present)}")
    _check_rows(k, m, present, "present")
    return gf_mat_inv(systematic_generator(k, m)[list(present)])


def repair_matrix(k: int, m: int, present: tuple[int, ...],
                  missing: tuple[int, ...]) -> np.ndarray:
    """Matrix M with shards[missing] = M @ shards[present]."""
    _check_rows(k, m, missing, "missing")
    g = systematic_generator(k, m)
    return gf_matmul(g[list(missing)], decode_matrix(k, m, present))


@functools.cache
def _single_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix of multiply-by-c: M[a, b] = bit a of (c * 2^b)."""
    m = np.zeros((8, 8), dtype=np.uint8)
    for b in range(8):
        prod = gf_mul(c, 1 << b)
        for a in range(8):
            m[a, b] = (prod >> a) & 1
    m.flags.writeable = False
    return m


def expand_bitmatrix(gf_mat: np.ndarray) -> np.ndarray:
    """Expand an (r x k) GF(2^8) byte matrix to its (8r x 8k) GF(2) form:
    row 8i+a is output bit a of output byte i, column 8j+b is input bit
    b of input byte j."""
    gf_mat = np.asarray(gf_mat, dtype=np.uint8)
    r, k = gf_mat.shape
    out = np.zeros((8 * r, 8 * k), dtype=np.uint8)
    for i in range(r):
        for j in range(k):
            out[8 * i:8 * i + 8, 8 * j:8 * j + 8] = \
                _single_bitmatrix(int(gf_mat[i, j]))
    return out


def nibble_tables(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split tables (lo, hi) of an (r x q) GF matrix, each [r, q, 16]
    uint8, with ``mat[i, j] * b == lo[i, j, b & 15] ^ hi[i, j, b >> 4]``."""
    mat = np.asarray(mat, dtype=np.uint8)
    mt = mul_table()
    nib = np.arange(16, dtype=np.uint8)
    lo = mt[mat][..., nib]
    hi = mt[mat][..., nib << 4]
    return lo, hi
