"""GF(2^8) Reed-Solomon, systematic Cauchy code, in plain NumPy.

A frozen statement of the erasure code the storage network fixes: the
field is GF(2^8) with polynomial 0x11D; a segment of k*n bytes is cut into
k data rows of n bytes, and parity row i is sum_j C[i, j] * row_j with
C[i, j] = 1 / ((k + i) xor j). A lost row is rebuilt from any k present
rows through the inverse of the generator's present rows.
"""
from __future__ import annotations

import numpy as np

POLY = 0x11D


def _tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(510, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:] = exp[:255]
    return exp, log


EXP, LOG = _tables()
# MUL[a] is the 256-byte lookup table of multiplication by a
MUL = np.zeros((256, 256), dtype=np.uint8)
MUL[1:, 1:] = EXP[(LOG[1:, None] + LOG[None, 1:]) % 255]


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return int(EXP[255 - LOG[a]])


def generator(k: int, m: int) -> np.ndarray:
    """(k+m) x k: identity rows, then the Cauchy parity rows."""
    g = np.zeros((k + m, k), dtype=np.uint8)
    g[:k] = np.eye(k, dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            g[k + i, j] = inv((k + i) ^ j)
    return g


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) product of two small matrices."""
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(a.shape[1]):
            out[i] ^= MUL[a[i, j]][b[j]]
    return out


def mat_inv(a: np.ndarray) -> np.ndarray:
    """Inverse of a square GF(2^8) matrix (Gauss-Jordan)."""
    n = a.shape[0]
    aug = np.concatenate([a.astype(np.uint8), np.eye(n, dtype=np.uint8)], 1)
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r, col])
        aug[[col, piv]] = aug[[piv, col]]
        aug[col] = MUL[inv(int(aug[col, col]))][aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= MUL[aug[r, col]][aug[col]]
    return aug[:, n:].copy()


def apply(mat: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """mat [r, q] applied to rows [q, n] uint8 -> [r, n]."""
    out = np.zeros((mat.shape[0], rows.shape[1]), dtype=np.uint8)
    for i in range(mat.shape[0]):
        for j in range(mat.shape[1]):
            c = int(mat[i, j])
            if c == 1:
                out[i] ^= rows[j]
            elif c:
                out[i] ^= MUL[c][rows[j]]
    return out


def encode(k: int, m: int, segment: np.ndarray) -> np.ndarray:
    """One segment [k*n] uint8 -> its fragments [k+m, n]."""
    data = np.asarray(segment, dtype=np.uint8).reshape(k, -1)
    return np.concatenate([data, apply(generator(k, m)[k:], data)])


def repair_matrix(k: int, m: int, present, missing) -> np.ndarray:
    """M with rows[missing] = M @ rows[present], for k present rows."""
    g = generator(k, m)
    return matmul(g[list(missing)], mat_inv(g[list(present)]))


def rebuild(k: int, m: int, survivors: np.ndarray, present, row: int
            ) -> np.ndarray:
    """Lost row ``row`` [n] from survivors [k, n] ordered as ``present``."""
    return apply(repair_matrix(k, m, present, (row,)), survivors)[0]
