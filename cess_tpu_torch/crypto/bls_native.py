"""ctypes binding for the native (C++) BLS12-381 backend.

The port's own copy of ``cess_tpu/crypto/bls_native.py``: it loads the
library that ``_build.build_host`` compiles with g++ from
``cess_tpu_torch/native/bls381.cpp`` into ``build/native/`` at first
use. The native code mirrors ``crypto/bls12381.py``
construction-for-construction, so signatures are byte-identical and
every verify agrees (``tests/test_torch_crypto.py``). ``bls12381.py``
dispatches here automatically; ``CESS_TPU_NO_NATIVE_BLS=1``, the
reference's switch, forces the pure-Python path.
"""
from __future__ import annotations

import ctypes
import os

from .. import _build


def _load() -> ctypes.CDLL:
    if os.environ.get("CESS_TPU_NO_NATIVE_BLS"):
        raise ImportError("native BLS disabled by CESS_TPU_NO_NATIVE_BLS")
    try:
        so = _build.build_host("bls381")
    except (OSError, _build.HostBuildError) as e:
        raise ImportError(f"cannot build native BLS: {e}") from e
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise ImportError(f"cannot load native BLS: {e}") from e
    u8p, szp = ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t)
    sz = ctypes.c_size_t
    lib.cessbls_verify.argtypes = [u8p, u8p, sz, u8p, u8p, sz]
    lib.cessbls_verify.restype = ctypes.c_int
    lib.cessbls_sign.argtypes = [u8p, u8p, sz, u8p, sz, u8p]
    lib.cessbls_sign.restype = ctypes.c_int
    lib.cessbls_pk_from_sk.argtypes = [u8p, u8p]
    lib.cessbls_pk_from_sk.restype = ctypes.c_int
    lib.cessbls_aggregate_verify.argtypes = [sz, u8p, u8p, szp, u8p,
                                             u8p, sz]
    lib.cessbls_aggregate_verify.restype = ctypes.c_int
    lib.cessbls_aggregate.argtypes = [sz, u8p, u8p]
    lib.cessbls_aggregate.restype = ctypes.c_int
    lib.cessbls_selftest.argtypes = []
    lib.cessbls_selftest.restype = ctypes.c_int
    if lib.cessbls_selftest() != 1:
        raise ImportError("native BLS selftest failed")   # wrong build
    return lib


_lib = _load()


def verify(pk: bytes, msg: bytes, sig: bytes, dst: bytes) -> bool:
    if len(pk) != 96 or len(sig) != 48:
        return False
    return _lib.cessbls_verify(pk, msg, len(msg), sig, dst,
                               len(dst)) == 1


def sign(sk_be32: bytes, msg: bytes, dst: bytes) -> bytes:
    out = ctypes.create_string_buffer(48)
    if _lib.cessbls_sign(sk_be32, msg, len(msg), dst, len(dst),
                         out) != 0:
        raise ValueError("native sign failed")
    return out.raw


def pk_from_sk(sk_be32: bytes) -> bytes:
    out = ctypes.create_string_buffer(96)
    if _lib.cessbls_pk_from_sk(sk_be32, out) != 0:
        raise ValueError("native pk derivation failed")
    return out.raw


def aggregate(sigs: list[bytes]) -> bytes:
    if any(len(s) != 48 for s in sigs):
        raise ValueError("signatures must be 48 bytes")
    out = ctypes.create_string_buffer(48)
    if _lib.cessbls_aggregate(len(sigs), b"".join(sigs), out) != 0:
        raise ValueError("invalid signature in aggregate")
    return out.raw


def aggregate_verify(pk_msg_pairs: list[tuple[bytes, bytes]],
                     agg_sig: bytes, dst: bytes) -> bool:
    if len(agg_sig) != 48 \
            or any(len(pk) != 96 for pk, _ in pk_msg_pairs):
        return False
    pks = b"".join(pk for pk, _ in pk_msg_pairs)
    msgs = b"".join(m for _, m in pk_msg_pairs)
    lens = (ctypes.c_size_t * len(pk_msg_pairs))(
        *[len(m) for _, m in pk_msg_pairs])
    return _lib.cessbls_aggregate_verify(len(pk_msg_pairs), pks, msgs,
                                         lens, agg_sig, dst,
                                         len(dst)) == 1
