"""RSA PKCS#1 v1.5 signature verification (pure Python).

Replaces the reference's `rsa` crate usage for TEE message checks
(primitives/enclave-verify/src/lib.rs:221-228) and the
signature check half of the IAS report validation (:135-219). Modular
exponentiation on multi-thousand-bit ints is fast enough host-side;
this is control-plane work, not the device data plane.
"""
from __future__ import annotations

import dataclasses
import hashlib

from .. import codec

# DigestInfo prefixes (DER) for EMSA-PKCS1-v1_5
_DIGEST_PREFIX = {
    "sha256": bytes.fromhex("3031300d060960864801650304020105000420"),
    "sha384": bytes.fromhex("3041300d060960864801650304020205000430"),
    "sha512": bytes.fromhex("3051300d060960864801650304020305000440"),
}


@codec.register
@dataclasses.dataclass(frozen=True)
class RsaPublicKey:
    n: int
    e: int = 65537

    @property
    def byte_len(self) -> int:
        return (self.n.bit_length() + 7) // 8

    def fingerprint(self) -> bytes:
        material = self.n.to_bytes(self.byte_len, "big") \
            + self.e.to_bytes(4, "big")
        return hashlib.sha256(material).digest()


def rsa_verify_pkcs1v15(key: RsaPublicKey, message: bytes, signature: bytes,
                        hash_name: str = "sha256") -> bool:
    """RSASSA-PKCS1-v1_5 verification; constant-structure EM compare."""
    k = key.byte_len
    if len(signature) != k:
        return False
    s = int.from_bytes(signature, "big")
    if s >= key.n:
        return False
    em = pow(s, key.e, key.n).to_bytes(k, "big")
    h = hashlib.new(hash_name, message).digest()
    t = _DIGEST_PREFIX[hash_name] + h
    if k < len(t) + 11:
        return False
    expected = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return em == expected


# -- test/dev signing helper (the chain only ever verifies) -----------------

@dataclasses.dataclass(frozen=True)
class RsaKeyPair:
    n: int
    e: int
    d: int

    @property
    def public(self) -> RsaPublicKey:
        return RsaPublicKey(self.n, self.e)

    def sign_pkcs1v15(self, message: bytes, hash_name: str = "sha256") -> bytes:
        k = (self.n.bit_length() + 7) // 8
        h = hashlib.new(hash_name, message).digest()
        t = _DIGEST_PREFIX[hash_name] + h
        em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
        return pow(int.from_bytes(em, "big"), self.d, self.n).to_bytes(k, "big")


def generate_rsa_keypair(bits: int = 2048, seed: int = 0) -> RsaKeyPair:
    """Deterministic test keypair (Miller-Rabin primes from a seeded
    stream). Dev/test only — not for production key material."""
    import random

    rng = random.Random(seed)

    def is_probable_prime(n: int, rounds: int = 40) -> bool:
        if n < 2:
            return False
        for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
            if n % p == 0:
                return n == p
        d, r = n - 1, 0
        while d % 2 == 0:
            d //= 2
            r += 1
        for _ in range(rounds):
            a = rng.randrange(2, n - 1)
            x = pow(a, d, n)
            if x in (1, n - 1):
                continue
            for _ in range(r - 1):
                x = x * x % n
                if x == n - 1:
                    break
            else:
                return False
        return True

    def gen_prime(b: int) -> int:
        while True:
            cand = rng.getrandbits(b) | (1 << (b - 1)) | 1
            if is_probable_prime(cand):
                return cand

    e = 65537
    while True:
        p = gen_prime(bits // 2)
        q = gen_prime(bits // 2)
        if p == q:
            continue
        phi = (p - 1) * (q - 1)
        if phi % e:
            d = pow(e, -1, phi)
            return RsaKeyPair(n=p * q, e=e, d=d)
