"""Minimal secp256k1 ECDSA: sign + public-key recovery (ecrecover).

Backs the EVM precompile at address 0x1 (the reference runs full
pallet-evm with Frontier's precompile set,
runtime/src/lib.rs:1310-1380). Pure Python over the
standard short-Weierstrass curve; affine arithmetic with modular
inverses is plenty for precompile call rates (ecrecover is priced at
3000 gas — the chain's own hot loops never touch this module).

Recovered "Ethereum address" derivation here is
sha3_256(x32 || y32)[12:] — NOT keccak256 — consistent with the
interpreter's documented SHA3 deviation (evm_interp.py): hash-derived
identities use the same hash family everywhere in this framework.
"""
from __future__ import annotations

import hashlib
import hmac

# curve: y^2 = x^3 + 7 over F_p
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
Gx = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
Gy = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _add(p1, p2):
    """Affine point addition; None is the identity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _mul(k: int, point):
    acc = None
    while k:
        if k & 1:
            acc = _add(acc, point)
        point = _add(point, point)
        k >>= 1
    return acc


def pubkey(secret: int):
    return _mul(secret % N, (Gx, Gy))


def _rfc6979_k(secret: int, msg_hash: bytes) -> int:
    """Deterministic nonce (RFC 6979, SHA-256): signing never needs an
    RNG, so tests and replicas are reproducible."""
    x = secret.to_bytes(32, "big")
    k, v = b"\x00" * 32, b"\x01" * 32
    k = hmac.new(k, v + b"\x00" + x + msg_hash, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + msg_hash, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(secret: int, msg_hash: bytes) -> tuple[int, int, int]:
    """Returns (v, r, s) with v in {27, 28} and low-s normalization
    (what eth tooling produces and ecrecover expects)."""
    z = int.from_bytes(msg_hash, "big")
    while True:
        k = _rfc6979_k(secret, msg_hash)
        R = _mul(k, (Gx, Gy))
        r = R[0] % N
        if r == 0:
            msg_hash = hashlib.sha256(msg_hash).digest()
            continue
        s = _inv(k, N) * (z + r * secret) % N
        if s == 0:
            msg_hash = hashlib.sha256(msg_hash).digest()
            continue
        recid = R[1] & 1
        if s > N // 2:
            s = N - s
            recid ^= 1
        return 27 + recid, r, s


def recover(msg_hash: bytes, v: int, r: int, s: int):
    """Recover the signing public key (x, y); None when the signature
    is invalid (the precompile then returns empty output)."""
    if v not in (27, 28) or not (1 <= r < N) or not (1 <= s < N):
        return None
    x = r          # high-r recovery (r + N) is vanishingly rare; skip
    try:
        y = pow((pow(x, 3, P) + 7) % P, (P + 1) // 4, P)
    except ValueError:
        return None
    if (y * y - (pow(x, 3, P) + 7)) % P != 0:
        return None
    if (y & 1) != (v - 27):
        y = P - y
    z = int.from_bytes(msg_hash, "big")
    rinv = _inv(r, N)
    # Q = r^-1 (s*R - z*G)
    q = _add(_mul(s * rinv % N, (x, y)),
             _mul((-z * rinv) % N, (Gx, Gy)))
    return q


def recover_address(msg_hash: bytes, v: int, r: int, s: int) -> bytes | None:
    """The 0x1 precompile's output: 20-byte address of the signer
    (sha3_256 of the uncompressed point — see module docstring)."""
    q = recover(msg_hash, v, r, s)
    if q is None:
        return None
    pub = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return hashlib.sha3_256(pub).digest()[12:]


def address_of(secret: int) -> bytes:
    q = pubkey(secret)
    pub = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return hashlib.sha3_256(pub).digest()[12:]
