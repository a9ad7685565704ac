"""Reference (NumPy, host) systematic Reed-Solomon erasure codec.

The port's own copy of ``cess_tpu/ops/rs_ref.py``'s ``ReferenceCodec``
(the port imports nothing from that package): the plain GF matmul loop
of ``gf``, kept as the base of ``regen.RegenReference``. The port's
``make_codec(k, m, "cpu")`` stays ``TorchCodec`` on the CPU.
"""
from __future__ import annotations

import numpy as np

from . import gf


class ReferenceCodec:
    """Systematic RS(k, m) over GF(2^8) with a Cauchy parity matrix.

    ``encode`` maps k data shards to k+m shards (data rows first);
    ``reconstruct`` recovers any missing shards from any k survivors.
    Shards are uint8 arrays of equal length; a leading batch dimension
    is supported ([..., k, n] -> [..., k+m, n]).
    """

    def __init__(self, k: int, m: int):
        if k < 1 or m < 0 or k + m > gf.FIELD:
            raise ValueError(f"invalid RS geometry k={k}, m={m}")
        self.k = k
        self.m = m
        self.parity = gf.cauchy_parity_matrix(k, m)

    def _apply(self, mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
        """GF matmul of mat [r, q] with shards [..., q, n] -> [..., r, n]."""
        shards = np.asarray(shards, dtype=np.uint8)
        lead = shards.shape[:-2]
        q, n = shards.shape[-2:]
        flat = shards.reshape(-1, q, n)
        out = np.empty((flat.shape[0], mat.shape[0], n), dtype=np.uint8)
        for b in range(flat.shape[0]):
            out[b] = gf.gf_matmul(mat, flat[b])
        return out.reshape(*lead, mat.shape[0], n)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """[..., k, n] data shards -> [..., k+m, n] coded shards."""
        data = np.asarray(data, dtype=np.uint8)
        if data.shape[-2] != self.k:
            raise ValueError(f"expected {self.k} data shards, got {data.shape[-2]}")
        parity = self._apply(self.parity, data)
        return np.concatenate([data, parity], axis=-2)

    def encode_parity(self, data: np.ndarray) -> np.ndarray:
        """[..., k, n] -> just the [..., m, n] parity shards."""
        return self._apply(self.parity, np.asarray(data, dtype=np.uint8))

    def reconstruct(self, survivors: np.ndarray, present: tuple[int, ...],
                    missing: tuple[int, ...] | None = None) -> np.ndarray:
        """Recover shards from any k survivors [..., k, n] ordered as
        ``present``: the [..., len(missing), n] rows ``missing`` (default:
        every absent row, in order)."""
        present = tuple(present)
        if missing is None:
            missing = tuple(i for i in range(self.k + self.m) if i not in present)
        mat = gf.repair_matrix(self.k, self.m, present, tuple(missing))
        return self._apply(mat, survivors)

    def decode_data(self, survivors: np.ndarray, present: tuple[int, ...]) -> np.ndarray:
        """Recover the original k data shards from any k survivors."""
        mat = gf.decode_matrix(self.k, self.m, tuple(present))
        return self._apply(mat, survivors)
