"""ctypes binding for the native (C++) ErasureCodec backend.

The port's own copy of ``cess_tpu/ops/rs_native.py`` over its own copy
of the C++ source, ``cess_tpu_torch/native/rs_native.cpp``, which
``_build.build_host`` compiles with g++ into ``build/native/`` at first
use. ``NativeCodec`` has the reference's surface (numpy in, numpy out,
``threads=``) and the same bytes as ``TorchCodec``. It is the CPU
baseline that the card's codec is measured against (``bench.py``'s
CPU-speedup metric, BASELINE.md, >= 40x); a failed build raises
ImportError, which ``make_codec(k, m, "native")`` turns into
NotImplementedError.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import _build
from . import gf


def _load() -> ctypes.CDLL:
    try:
        so = _build.build_host("rs_native")
    except (OSError, _build.HostBuildError) as e:
        raise ImportError(f"cannot build native codec: {e}") from e
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise ImportError(f"cannot load {so}: {e}") from e
    lib.cess_rs_apply.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.cess_rs_apply.restype = None
    lib.cess_rs_simd.restype = ctypes.c_int
    return lib


_LIB = _load()


def simd_level() -> int:
    """0 = scalar build, 2 = AVX2 build."""
    return int(_LIB.cess_rs_simd())


def _as_u8_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def apply_matrix(mat: np.ndarray, shards: np.ndarray,
                 threads: int = 1) -> np.ndarray:
    """GF matrix [r, q] applied to shards [..., q, n] -> [..., r, n]."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    r, q = mat.shape
    lead = shards.shape[:-2]
    if shards.shape[-2] != q:
        raise ValueError(f"expected {q} shard rows, got {shards.shape[-2]}")
    n = shards.shape[-1]
    batch = int(np.prod(lead, dtype=np.int64)) if lead else 1
    out = np.empty((*lead, r, n), dtype=np.uint8)
    _LIB.cess_rs_apply(_as_u8_ptr(mat), r, q, _as_u8_ptr(shards),
                       batch, n, _as_u8_ptr(out), int(threads))
    return out


class NativeCodec:
    """Systematic RS(k, m) on the native C++ path (ErasureCodec
    surface: encode / encode_parity / reconstruct / decode_data)."""

    def __init__(self, k: int, m: int, threads: int = 1):
        if k < 1 or m < 0 or k + m > gf.FIELD:
            raise ValueError(f"invalid RS geometry k={k}, m={m}")
        self.k = k
        self.m = m
        self.threads = threads
        self.parity = gf.cauchy_parity_matrix(k, m)

    def encode_parity(self, data: np.ndarray) -> np.ndarray:
        return apply_matrix(self.parity, data, self.threads)

    def encode(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.uint8)
        if data.shape[-2] != self.k:
            raise ValueError(
                f"expected {self.k} data shards, got {data.shape[-2]}")
        return np.concatenate([data, self.encode_parity(data)], axis=-2)

    def reconstruct(self, survivors: np.ndarray, present: tuple[int, ...],
                    missing: tuple[int, ...] | None = None) -> np.ndarray:
        present = tuple(present)
        if missing is None:
            missing = tuple(i for i in range(self.k + self.m)
                            if i not in present)
        mat = gf.repair_matrix(self.k, self.m, present, tuple(missing))
        return apply_matrix(mat, survivors, self.threads)

    def decode_data(self, survivors: np.ndarray,
                    present: tuple[int, ...]) -> np.ndarray:
        mat = gf.decode_matrix(self.k, self.m, tuple(present))
        return apply_matrix(mat, survivors, self.threads)
