"""Ed25519 signatures (RFC 8032, pure Python).

Replaces the reference's sr25519 session/VRF key machinery (Substrate
keystore + schnorrkel, external) for block authorship and the
hash-based VRF of the reference package. Pure-Python bigint math is
plenty for control-plane signing rates; the data plane never signs.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
BASE_Y = 4 * pow(5, P - 2, P) % P


def _recover_x(y: int, sign: int) -> int:
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P:
        raise ValueError("invalid point")
    if x & 1 != sign:
        x = P - x
    return x


BASE = (_recover_x(BASE_Y, 0), BASE_Y, 1, _recover_x(BASE_Y, 0) * BASE_Y % P)


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _mul(s: int, p=None):
    q = (0, 1, 1, 0)
    if p is None:
        # base-point multiply: the doublings 2^i*B are shared by every
        # scalar, so they are precomputed once (_BASE_POW2) and only
        # the conditional adds remain
        return _mul_tab(s, _BASE_POW2)
    while s:
        if s & 1:
            q = _add(q, p)
        p = _add(p, p)
        s >>= 1
    return q


def _mul_tab(s: int, table):
    q = (0, 1, 1, 0)
    for i in range(s.bit_length()):
        if (s >> i) & 1:
            q = _add(q, table[i])
    return q


def _pow2_table(p, n):
    out = []
    for _ in range(n):
        out.append(p)
        p = _add(p, p)
    return out


# scalars are < 2^255 (the clamped secret sets bit 254; r/s/k are < L)
_BASE_POW2 = _pow2_table(BASE, 256)


@functools.lru_cache(maxsize=512)
def _pubkey_pow2(public: bytes):
    """Doubles table for a signer's point: gossip re-verifies the same
    few keys under ever-new messages, so the k*A multiply amortizes to
    adds-only after one verify per key. Bounded — eviction just
    rebuilds. Raises ValueError on an invalid encoding (caller
    handles)."""
    return tuple(_pow2_table(_decompress(public), 256))


def _compress(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(b: bytes):
    v = int.from_bytes(b, "little")
    y = v & ((1 << 255) - 1)
    if y >= P:
        raise ValueError("invalid point encoding")
    x = _recover_x(y, v >> 255)
    return (x, y, 1, x * y % P)


def _h(data: bytes) -> int:
    return int.from_bytes(hashlib.sha512(data).digest(), "little")


@dataclasses.dataclass(frozen=True)
class SigningKey:
    seed: bytes  # 32 bytes

    @staticmethod
    def generate(seed_material: bytes) -> "SigningKey":
        return SigningKey(hashlib.sha256(seed_material).digest())

    # cached_property stores via __dict__, which a frozen dataclass
    # allows — both are pure functions of the immutable seed, and a
    # long-lived node key signs every block/vote it authors
    @functools.cached_property
    def _expanded(self) -> tuple[int, bytes]:
        h = hashlib.sha512(self.seed).digest()
        a = int.from_bytes(h[:32], "little")
        a &= (1 << 254) - 8
        a |= 1 << 254
        return a, h[32:]

    @functools.cached_property
    def public(self) -> bytes:
        a, _ = self._expanded
        return _compress(_mul(a))

    def sign(self, message: bytes) -> bytes:
        a, prefix = self._expanded
        pub = self.public
        r = _h(prefix + message) % L
        rp = _compress(_mul(r))
        k = _h(rp + pub + message) % L
        s = (r + k * a) % L
        return rp + s.to_bytes(32, "little")


def verify(public: bytes, message: bytes, signature: bytes) -> bool:
    """Memoized: verification is a pure function of its byte inputs,
    and gossip delivers the identical (vote, signature) to every node
    on the network — at cluster-simulation scale the
    same triple is re-checked hundreds of times. The bounded cache
    dedupes those without changing any verdict."""
    try:
        return _verify_cached(public, message, signature)
    except TypeError:           # unhashable input (e.g. bytearray)
        return _verify(public, message, signature)


@functools.lru_cache(maxsize=65536)
def _verify_cached(public: bytes, message: bytes,
                   signature: bytes) -> bool:
    return _verify(public, message, signature)


def _verify(public: bytes, message: bytes, signature: bytes) -> bool:
    if len(signature) != 64 or len(public) != 32:
        return False
    try:
        a_tab = _pubkey_pow2(public)
        r_pt = _decompress(signature[:32])
    except ValueError:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    k = _h(signature[:32] + public + message) % L
    # s*B == R + k*A  (check via compression to avoid projective compare)
    lhs = _mul(s)
    rhs = _add(r_pt, _mul_tab(k, a_tab))
    return _compress(lhs) == _compress(rhs)
