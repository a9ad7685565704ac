"""Regenerating-code repair plane: computed repair symbols and the
closed-form Cauchy decode.

The port's own copy of ``cess_tpu/ops/regen.py`` (the port imports
nothing from that package):

- Fast Product-Matrix Regenerating Codes (arxiv 1412.3022): each helper
  scales its survivor fragment by one repair coefficient
  (``repair_coeffs``) and XOR-folds it into a partial-sum accumulator
  passed down the helper chain (``fold_symbol_host``); by GF(2^8)
  linearity the final aggregate IS the lost fragment, so the rebuilder
  takes in one fragment instead of k.
- Cauchy MDS Array Codes With Efficient Decoding Method (arxiv
  1611.09968): the surviving-parity-by-missing-data subsystem is itself
  Cauchy, so its inverse has a closed product form (``cauchy_inverse``)
  and the decode matrix follows by one Schur complement step
  (``decode_matrix``). A field inverse is unique, so the result is
  byte-identical to Gauss-Jordan (``gf.decode_matrix``).

``RegenCodec`` is ``TorchCodec`` with these constructions, the batched
symbol fold (``fold_symbol``: the [1, coeff] GF matrix over
(accumulator, fragment) row pairs, through the codec's strategy) and
``warm_fold`` on the same warm-program cache as ``warm_reconstruct``.
``RegenReference`` is its NumPy twin. Nothing here reads a clock or
draws entropy: the same pattern always gives the same matrices.
"""
from __future__ import annotations

import numpy as np
import torch

from . import gf
from .rs import MatrixApply, TorchCodec
from .rs_ref import ReferenceCodec

__all__ = [
    "cauchy_inverse", "decode_matrix", "repair_matrix", "repair_coeffs",
    "fold_symbol_host", "fold_symbol_pairs", "RegenCodec",
    "RegenReference",
]


def _check_pattern(k: int, m: int, present: tuple[int, ...],
                   what: str = "present") -> tuple[int, ...]:
    """Refuse malformed erasure patterns: duplicates and out-of-range
    rows."""
    present = tuple(int(r) for r in present)
    rows = k + m
    if len(set(present)) != len(present):
        raise ValueError(f"duplicate {what} shard indices: {present}")
    for r in present:
        if not 0 <= r < rows:
            raise ValueError(f"{what} shard index {r} out of range for "
                             f"RS({k},{m}) with {rows} rows")
    return present


def cauchy_inverse(xs, ys) -> np.ndarray:
    """Closed-form inverse of the Cauchy matrix A[i, j] = 1/(xs[i] ^ ys[j]).

        inv[j, i] = prod_l (xs[l]^ys[j]) * prod_l (xs[i]^ys[l])
                    / ((xs[i]^ys[j]) * prod_{l!=j} (ys[j]^ys[l])
                                     * prod_{l!=i} (xs[i]^xs[l]))

    (subtraction is XOR in GF(2^8)): O(t^2) multiplies after the O(t)
    prefix products, and exactly Gauss-Jordan's result.
    """
    xs = tuple(int(x) for x in xs)
    ys = tuple(int(y) for y in ys)
    t = len(xs)
    if len(ys) != t:
        raise ValueError(f"need square Cauchy geometry, got {len(xs)} "
                         f"x-nodes and {len(ys)} y-nodes")
    if len(set(xs)) != t or len(set(ys)) != t or set(xs) & set(ys):
        raise ValueError("Cauchy nodes must be distinct and disjoint")
    full_x = [1] * t
    full_y = [1] * t
    for i in range(t):
        for l in range(t):
            full_x[i] = gf.gf_mul(full_x[i], xs[i] ^ ys[l])
            full_y[i] = gf.gf_mul(full_y[i], xs[l] ^ ys[i])
    node_x = [1] * t
    node_y = [1] * t
    for i in range(t):
        for l in range(t):
            if l == i:
                continue
            node_x[i] = gf.gf_mul(node_x[i], xs[i] ^ xs[l])
            node_y[i] = gf.gf_mul(node_y[i], ys[i] ^ ys[l])
    inv = np.zeros((t, t), dtype=np.uint8)
    for j in range(t):
        for i in range(t):
            num = gf.gf_mul(full_y[j], full_x[i])
            den = gf.gf_mul(xs[i] ^ ys[j],
                            gf.gf_mul(node_y[j], node_x[i]))
            inv[j, i] = gf.gf_mul(num, gf.gf_inv(den))
    return inv


def decode_matrix(k: int, m: int, present: tuple[int, ...]) -> np.ndarray:
    """Decode matrix for ``present`` by one Schur complement step over the
    closed-form Cauchy inverse. Present data rows pin their own bytes;
    each surviving parity row q gives an equation over the missing data
    columns M,

        sum_{j in M} c[q, j] * data_j = shard_q ^ sum_{d in D} c[q, d] * shard_d,

    whose t x t matrix c[q, j] = 1/((k+q) ^ j) is Cauchy."""
    present = _check_pattern(k, m, present)
    if len(present) != k:
        raise ValueError(f"need exactly k={k} present shard indices, "
                         f"got {len(present)}")
    pos = {r: p for p, r in enumerate(present)}
    data_rows = [r for r in present if r < k]
    parity_rows = [r - k for r in present if r >= k]
    missing_cols = [j for j in range(k) if j not in pos]
    inv = np.zeros((k, k), dtype=np.uint8)
    for d in data_rows:
        inv[d, pos[d]] = 1
    if not missing_cols:
        return inv
    w = cauchy_inverse([k + q for q in parity_rows], missing_cols)
    mt = gf.mul_table()
    for b, col in enumerate(missing_cols):
        for a, q in enumerate(parity_rows):
            coeff = int(w[b, a])
            inv[col, pos[k + q]] ^= coeff
            for d in data_rows:
                inv[col, pos[d]] ^= int(
                    mt[coeff, gf.gf_inv((k + q) ^ d)])
    return inv


def repair_matrix(k: int, m: int, present: tuple[int, ...],
                  missing: tuple[int, ...]) -> np.ndarray:
    """Generator rows of ``missing`` times the closed-form decode matrix:
    byte-identical to ``gf.repair_matrix``."""
    missing = _check_pattern(k, m, missing, what="missing")
    g = gf.systematic_generator(k, m)
    return gf.gf_matmul(g[list(missing)], decode_matrix(k, m, present))


def repair_coeffs(k: int, m: int, present: tuple[int, ...],
                  missing: tuple[int, ...]) -> tuple[int, ...]:
    """The helpers' coefficients for one lost row: the helper at survivor
    position p contributes coeff[p] * fragment_p, and the XOR of all k
    contributions is the lost fragment."""
    missing = tuple(int(r) for r in missing)
    if len(missing) != 1:
        raise ValueError("repair symbols regenerate ONE row per chain; "
                         f"got missing={missing}")
    row = repair_matrix(k, m, present, missing)
    return tuple(int(c) for c in row[0])


def fold_symbol_host(acc: np.ndarray, fragment: np.ndarray,
                     coeff: int) -> np.ndarray:
    """One helper's hop on the host: acc ^ coeff * fragment."""
    mt = gf.mul_table()
    acc = np.asarray(acc, dtype=np.uint8)
    fragment = np.asarray(fragment, dtype=np.uint8)
    return (acc ^ mt[int(coeff)][fragment]).astype(np.uint8)


def fold_symbol_pairs(pairs: np.ndarray, coeff: int) -> np.ndarray:
    """Host twin of ``RegenCodec.fold_symbol``: pairs [..., 2, n] of
    (accumulator, fragment) rows -> [..., 1, n]."""
    pairs = np.asarray(pairs, dtype=np.uint8)
    if pairs.shape[-2] != 2:
        raise ValueError(f"expected (accumulator, fragment) row pairs, "
                         f"got {pairs.shape[-2]} rows")
    mt = gf.mul_table()
    return (pairs[..., 0:1, :]
            ^ mt[int(coeff)][pairs[..., 1:2, :]]).astype(np.uint8)


def _symbol_matrix(coeff: int) -> np.ndarray:
    """The fold as a GF matrix: [1, coeff] applied to (acc, fragment)."""
    coeff = int(coeff)
    if not 0 <= coeff < gf.FIELD:
        raise ValueError(f"repair coefficient {coeff} outside GF(2^8)")
    return np.array([[1, coeff]], dtype=np.uint8)


class RegenCodec(TorchCodec):
    """``TorchCodec`` whose decode and repair matrices come from the
    closed-form Cauchy construction, with the symbol fold on the device.
    Its warm programs (``warm_reconstruct``, ``warm_fold``) share one
    cache and one ``warm_hits`` count. ``strategy`` takes the TPU
    package's position; ``device`` is keyword-only."""

    def __init__(self, k: int, m: int, strategy: str | None = None, *,
                 device=None):
        super().__init__(k, m, device, strategy)

    def _matrix(self, kind: str, present: tuple[int, ...],
                missing: tuple[int, ...]) -> np.ndarray:
        if kind == "decode":
            return decode_matrix(self.k, self.m, present)
        if kind == "symbol":
            return _symbol_matrix(present[0])
        return repair_matrix(self.k, self.m, present, missing)

    def _symbol(self, coeff: int) -> tuple[tuple, MatrixApply]:
        # a warm key that never collides with a reconstruct's (whose first
        # element is a tuple of rows), and the fold's matrix apply
        return (("symbol", int(coeff)), ()), self._matrix_for(
            "symbol", (int(coeff),))

    def warm_fold(self, coeff: int, shape, device=None):
        """Prepare the fold of one coefficient for pairs of exactly
        ``shape``, as ``warm_reconstruct`` does for a pattern."""
        key, apply_ = self._symbol(coeff)
        return self._warm_program(key, apply_, shape, device)

    def fold_symbol(self, pairs, coeff: int) -> torch.Tensor:
        """pairs [..., 2, n] uint8 (accumulator, fragment) rows ->
        [..., 1, n]: acc ^ coeff * fragment; a warmed coefficient and shape
        replays its warm program."""
        key, apply_ = self._symbol(coeff)
        pairs = self._shards(pairs, 2, "pair")
        out = self._warm_call(key, pairs)
        return out if out is not None else self._apply(apply_, pairs)

    def repair_coeffs(self, present: tuple[int, ...],
                      missing: tuple[int, ...]) -> tuple[int, ...]:
        """``repair_coeffs`` for this codec's geometry."""
        return repair_coeffs(self.k, self.m, tuple(present), tuple(missing))


class RegenReference(ReferenceCodec):
    """NumPy twin of ``RegenCodec``: the same closed-form matrices applied
    with the host GF matmul loop."""

    def reconstruct(self, survivors: np.ndarray, present: tuple[int, ...],
                    missing: tuple[int, ...] | None = None) -> np.ndarray:
        present = tuple(present)
        if missing is None:
            missing = tuple(i for i in range(self.k + self.m)
                            if i not in present)
        mat = repair_matrix(self.k, self.m, present, tuple(missing))
        return self._apply(mat, survivors)

    def decode_data(self, survivors: np.ndarray,
                    present: tuple[int, ...]) -> np.ndarray:
        mat = decode_matrix(self.k, self.m, tuple(present))
        return self._apply(mat, survivors)

    def fold_symbol(self, pairs: np.ndarray, coeff: int) -> np.ndarray:
        return fold_symbol_pairs(pairs, coeff)

    def repair_coeffs(self, present: tuple[int, ...],
                      missing: tuple[int, ...]) -> tuple[int, ...]:
        return repair_coeffs(self.k, self.m, tuple(present),
                             tuple(missing))
