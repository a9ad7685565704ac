"""Host-side crypto for the chain layer (the port's own copy of the
reference package's ``crypto/``: hashing, Ed25519 and its VRF, RSA,
BLS12-381, and the EVM precompiles' secp256k1 and RIPEMD-160).

The reference vendors ring/webpki/verify-bls-signatures (Rust+C+asm,
SURVEY.md §2.3) for SGX attestation verification, RSA message checks
and BLS proof signatures. Here the host path is pure Python (RSA
PKCS#1 v1.5 verify, SHA-2, Ed25519+VRF) with the batched field math on
the card; BLS12-381 has a C++ fast path behind the same functions.
"""
from .rsa import rsa_verify_pkcs1v15, RsaPublicKey  # noqa: F401
from .hashing import sha256, blake2b_256  # noqa: F401


def __getattr__(name: str):
    # ``verify_bls`` imports bls12381 on first access, not with the
    # package: its native backend is compiled at its first import, and
    # the hashes here must not wait for that
    if name == "verify_bls":
        from .bls12381 import verify

        return verify
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
