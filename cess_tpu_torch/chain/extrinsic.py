"""Signed extrinsics: the transaction envelope + signature pipeline.

Mirrors the reference's UncheckedExtrinsic/SignedExtra stack
(runtime/src/lib.rs:1564-1590): a transaction carries
(signer, public key, nonce, call, args) and an ed25519 signature over
the codec-canonical payload bound to the chain's genesis hash (no
cross-chain replay). Verification happens twice, like the reference:
at pool admission (cheap pre-dispatch validity) and again inside block
execution (`Runtime.apply_signed`), because imported blocks carry
transactions the local pool never saw.
"""
from __future__ import annotations

import dataclasses

from .. import codec
from ..crypto import ed25519

SIGNING_CONTEXT = b"cess-tpu/extrinsic-v1"


@codec.register
@dataclasses.dataclass(frozen=True)
class SignedExtrinsic:
    signer: str         # account alias
    public: bytes       # 32-byte ed25519 key the alias is bound to
    nonce: int
    call: str           # "pallet.method"
    args: tuple
    kwargs: tuple       # sorted ((key, value), ...) pairs
    signature: bytes    # 64 bytes over signing_payload(...)

    def encoded(self) -> bytes:
        return codec.encode(self)

    def __len__(self) -> int:
        """True wire size (the chain's length-fee input)."""
        return len(self.encoded())


def signing_payload(genesis: bytes, signer: str, public: bytes, nonce: int,
                    call: str, args: tuple, kwargs: tuple) -> bytes:
    return SIGNING_CONTEXT + codec.encode(
        (genesis, signer, public, nonce, call, args, kwargs))


def sign_extrinsic(key: ed25519.SigningKey, genesis: bytes, signer: str,
                   nonce: int, call: str, args: tuple = (),
                   kwargs: dict | None = None) -> SignedExtrinsic:
    kw = tuple(sorted((kwargs or {}).items()))
    payload = signing_payload(genesis, signer, key.public, nonce, call,
                              tuple(args), kw)
    return SignedExtrinsic(signer=signer, public=key.public, nonce=nonce,
                           call=call, args=tuple(args), kwargs=kw,
                           signature=key.sign(payload))


def verify_signature(xt: SignedExtrinsic, genesis: bytes) -> bool:
    try:
        payload = signing_payload(genesis, xt.signer, xt.public, xt.nonce,
                                  xt.call, xt.args, xt.kwargs)
    except codec.CodecError:
        return False
    return ed25519.verify(xt.public, payload, xt.signature)
