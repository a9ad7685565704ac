"""Pure-Python RIPEMD-160 (the 0x3 EVM precompile's hash).

hashlib only exposes ripemd160 when the OpenSSL build ships the legacy
provider; nodes differing in that build detail must NOT diverge on a
consensus-visible precompile result. chain/evm.py resolves the
implementation ONCE at import — hashlib when available (faster),
otherwise this module — and both produce identical digests (standard
algorithm, cross-checked in tests/test_evm.py against known vectors).

Reference: the RIPEMD-160 specification (Dobbertin, Bosselaers,
Preneel, 1996); this is a direct transcription of the spec's
compression function, not a port of any particular implementation.
"""
from __future__ import annotations

import struct

_R1 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
       7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
       3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
       1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
       4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]
_R2 = [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
       6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
       15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
       8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
       12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]
_S1 = [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
       7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
       11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
       11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
       9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]
_S2 = [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
       9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
       9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
       15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
       8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]
_K1 = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_K2 = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]

_M32 = 0xFFFFFFFF


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def _f(j: int, x: int, y: int, z: int) -> int:
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | (~x & z)
    if j < 48:
        return (x | ~y) ^ z
    if j < 64:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z)


def digest(message: bytes) -> bytes:
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    padded = message + b"\x80"
    padded += b"\0" * ((56 - len(padded)) % 64)
    padded += struct.pack("<Q", 8 * len(message))
    for off in range(0, len(padded), 64):
        x = struct.unpack("<16I", padded[off:off + 64])
        a1, b1, c1, d1, e1 = h
        a2, b2, c2, d2, e2 = h
        for j in range(80):
            rnd = j // 16
            t = (a1 + _f(j, b1, c1, d1) + x[_R1[j]] + _K1[rnd]) & _M32
            a1, e1, d1, c1, b1 = \
                e1, d1, _rol(c1, 10), b1, (_rol(t, _S1[j]) + e1) & _M32
            t = (a2 + _f(79 - j, b2, c2, d2) + x[_R2[j]] + _K2[rnd]) & _M32
            a2, e2, d2, c2, b2 = \
                e2, d2, _rol(c2, 10), b2, (_rol(t, _S2[j]) + e2) & _M32
        h = [(h[1] + c1 + d2) & _M32,
             (h[2] + d1 + e2) & _M32,
             (h[3] + e1 + a2) & _M32,
             (h[4] + a1 + b2) & _M32,
             (h[0] + b1 + c2) & _M32]
    return struct.pack("<5I", *h)
