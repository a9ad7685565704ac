"""ECVRF over edwards25519 (RFC 9381 construction, try-and-increment).

The reference's RRSC consensus claims slots with sr25519/schnorrkel
VRFs (SURVEY.md §2.3 forked-Substrate row). Round 1 used
``sha256(ed25519_sig)`` as the VRF — broken, because Ed25519
signatures are malleable BY THE KEY HOLDER (any nonce r yields a valid
signature), letting a malicious authority grind slot lotteries.

This is a real VRF with verifier-enforced uniqueness:

    Gamma  = a · H          H = hash_to_curve(pk, input)
    output = SHA-512(suite ‖ 0x03 ‖ 8·Gamma)[:32]
    proof  = (Gamma, c, s)  a DLEQ proof that log_B(A) == log_H(Gamma)

``Gamma`` is a pure function of (secret key, input) — the prover has
no nonce freedom over it, and the DLEQ proof (c, s) binds Gamma to the
registered public key: U = s·B − c·A, V = s·H − c·Gamma,
c' = H2(H, Gamma, U, V) must equal c. Different (c, s) pairs for the
same key+input can exist, but they all carry the SAME Gamma and hence
the same output — re-rolling the lottery is impossible by construction
(tested in tests/test_node.py::test_vrf_uniqueness_under_nonce_grinding).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib

from .. import codec
from . import ed25519
from .ed25519 import L, P, _add, _compress, _decompress, _mul

SUITE = b"cess-ecvrf-ed25519-tai"
_IDENTITY = _compress((0, 1, 1, 0))


def _neg(p):
    x, y, z, t = p
    return ((-x) % P, y, z, (-t) % P)


def _cofactor_mul(p):
    for _ in range(3):
        p = _add(p, p)
    return p


def _hash_to_curve(public: bytes, data: bytes):
    """Try-and-increment (ECVRF-ED25519-SHA512-TAI): hash to candidate
    y-encodings until one decompresses; clear the cofactor so H is in
    the prime-order subgroup."""
    ctr = 0
    while True:
        h = hashlib.sha512(SUITE + b"\x01" + public + data
                           + ctr.to_bytes(4, "little")).digest()[:32]
        try:
            pt = _cofactor_mul(_decompress(h))
        except ValueError:
            ctr += 1
            continue
        if _compress(pt) != _IDENTITY:
            return pt
        ctr += 1


def _challenge(*points: bytes) -> int:
    h = hashlib.sha512(SUITE + b"\x02" + b"".join(points)).digest()
    return int.from_bytes(h[:16], "little")  # 128-bit challenge


def _output_from_gamma(gamma) -> bytes:
    return hashlib.sha512(SUITE + b"\x03"
                          + _compress(_cofactor_mul(gamma))).digest()[:32]


@codec.register
@dataclasses.dataclass(frozen=True)
class VrfProof:
    output: bytes     # 32 bytes, uniform; unique per (key, input)
    gamma: bytes      # compressed point a·H
    c: bytes          # 16-byte DLEQ challenge
    s: bytes          # 32-byte DLEQ response


def _derive_nonce(prefix: bytes, h_bytes: bytes) -> int:
    """Deterministic DLEQ nonce (tests monkeypatch this to demonstrate
    that nonce freedom cannot change the output; reusing a nonce
    across inputs leaks the key, so it is not caller-selectable)."""
    return int.from_bytes(hashlib.sha512(prefix + h_bytes).digest(),
                          "little") % L


def vrf_sign(key: ed25519.SigningKey, data: bytes) -> VrfProof:
    a, prefix = key._expanded
    public = key.public
    h_pt = _hash_to_curve(public, data)
    h_bytes = _compress(h_pt)
    gamma = _mul(a, h_pt)
    gamma_bytes = _compress(gamma)
    k = _derive_nonce(prefix, h_bytes)
    u = _compress(_mul(k))          # k·B
    v = _compress(_mul(k, h_pt))    # k·H
    c = _challenge(h_bytes, gamma_bytes, u, v)
    s = (k + c * a) % L
    return VrfProof(output=_output_from_gamma(gamma), gamma=gamma_bytes,
                    c=c.to_bytes(16, "little"), s=s.to_bytes(32, "little"))


def vrf_verify(public: bytes, data: bytes, proof: VrfProof) -> bool:
    """Memoized like :func:`ed25519.verify`: a slot claim's proof is a
    pure function of its inputs and every node on the network verifies
    the identical claim — the bounded cache collapses those re-checks
    at simulation scale without changing any verdict."""
    try:
        return _vrf_verify_cached(public, data, proof)
    except TypeError:           # unhashable input shapes: verify raw
        return _vrf_verify(public, data, proof)


@functools.lru_cache(maxsize=16384)
def _vrf_verify_cached(public: bytes, data: bytes,
                       proof: VrfProof) -> bool:
    return _vrf_verify(public, data, proof)


def _vrf_verify(public: bytes, data: bytes, proof: VrfProof) -> bool:
    if not (isinstance(proof, VrfProof) and isinstance(proof.gamma, bytes)
            and isinstance(proof.c, bytes) and len(proof.c) == 16
            and isinstance(proof.s, bytes) and len(proof.s) == 32
            and isinstance(proof.output, bytes)
            and isinstance(public, bytes) and len(public) == 32):
        return False
    try:
        a_pt = _decompress(public)
        gamma = _decompress(proof.gamma)
    except ValueError:
        return False
    # ECVRF_validate_key (RFC 9381 §5.4.5): a small-order public key
    # (a = 0 in the cofactor-cleared subgroup) makes Gamma degenerate
    # and the output an input-INDEPENDENT constant — an attacker
    # registering the identity point would win every slot. Reject any
    # key or Gamma that cofactor-clears to the identity.
    if _compress(_cofactor_mul(a_pt)) == _IDENTITY \
            or _compress(_cofactor_mul(gamma)) == _IDENTITY:
        return False
    c = int.from_bytes(proof.c, "little")
    s = int.from_bytes(proof.s, "little")
    if s >= L:
        return False
    h_pt = _hash_to_curve(public, data)
    # U = s·B − c·A ; V = s·H − c·Gamma
    u = _add(_mul(s), _neg(_mul(c, a_pt)))
    v = _add(_mul(s, h_pt), _neg(_mul(c, gamma)))
    if _challenge(_compress(h_pt), proof.gamma, _compress(u),
                  _compress(v)) != c:
        return False
    return proof.output == _output_from_gamma(gamma)


def output_below(output: bytes, threshold_num: int, threshold_den: int) -> bool:
    """Slot lottery check: uniform output < c fraction of 2^128."""
    v = int.from_bytes(output[:16], "little")
    return v * threshold_den < (1 << 128) * threshold_num
