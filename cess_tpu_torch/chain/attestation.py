"""Structured TEE attestation: parsed reports + signer cert chains.

The reference verifies an Intel IAS attestation in two steps
(primitives/enclave-verify/src/lib.rs:135-219):
the report-signing certificate must chain to a PINNED root
(IAS_SERVER_ROOTS, :46-93) and be time-valid (a fixed verification
instant, :150), then the report signature is checked with that cert,
and the quote body is parsed at fixed offsets for MRENCLAVE
(bytes 112..144), MRSIGNER (176..208) and the bound public key
(368..401) (:181-219).

This module mirrors that structure natively: an ``AttestationReport``
is a typed, parsed object (never substring-matched); its signer is an
end-entity ``SignerCert`` verified through an explicit chain to a
root key pinned on chain; and ``report_data`` must equal the SHA-256
binding of (podr2_pk, controller) — so a report can neither be forged
field-by-field nor replayed for a different key or registrant.
"""
from __future__ import annotations

import dataclasses
import hashlib

from .. import codec
from ..crypto.rsa import RsaPublicKey, rsa_verify_pkcs1v15
from .state import DispatchError

# The reference validates certs against a FIXED instant
# (webpki::Time::from_seconds_since_unix_epoch(1670515200), lib.rs:150);
# same pinned-clock design here.
ATTESTATION_TIME = 1670515200

CERT_SIGNING_CONTEXT = b"cess-tpu/attest-cert-v1:"
REPORT_SIGNING_CONTEXT = b"cess-tpu/attest-report-v1:"
REPORT_DATA_CONTEXT = b"cess-tpu/podr2-bind-v1:"

MAX_CHAIN_LEN = 3


@codec.register
@dataclasses.dataclass(frozen=True)
class SignerCert:
    """One link of the report-signing chain (webpki EndEntityCert /
    intermediate analog)."""

    subject: str
    pubkey: RsaPublicKey
    not_after: int        # unix seconds
    signature: bytes      # by the PARENT key over signing_payload()

    def signing_payload(self) -> bytes:
        return CERT_SIGNING_CONTEXT + codec.encode(
            (self.subject, self.pubkey.n, self.pubkey.e, self.not_after))


@codec.register
@dataclasses.dataclass(frozen=True)
class AttestationReport:
    """The parsed quote body (ref fixed offsets 112/176/368)."""

    mrenclave: bytes      # 32: enclave measurement
    mr_signer: bytes      # 32: enclave signer measurement
    report_data: bytes    # 32: sha256 binding of (podr2_pk, controller)
    timestamp: int        # report issue time, unix seconds

    def signing_payload(self) -> bytes:
        return REPORT_SIGNING_CONTEXT + codec.encode(self)


def report_data_binding(podr2_pk: bytes, controller: str,
                        bls_pk: bytes = b"") -> bytes:
    """What an honest enclave puts in report_data: binds the PoDR2 key
    AND the registering controller (and the BLS verdict-signing master
    key when the worker carries one), so none can be swapped."""
    extra = b"|bls:" + bls_pk if bls_pk else b""
    return hashlib.sha256(REPORT_DATA_CONTEXT + podr2_pk + b"|"
                          + controller.encode() + extra).digest()


def _check_shape(report: AttestationReport,
                 chain: tuple[SignerCert, ...]) -> None:
    ok = (isinstance(report, AttestationReport)
          and isinstance(report.mrenclave, bytes)
          and len(report.mrenclave) == 32
          and isinstance(report.mr_signer, bytes)
          and len(report.mr_signer) == 32
          and isinstance(report.report_data, bytes)
          and len(report.report_data) == 32
          and isinstance(report.timestamp, int))
    if not ok:
        raise DispatchError("tee_worker.MalformedReport")
    if not (isinstance(chain, tuple) and 1 <= len(chain) <= MAX_CHAIN_LEN
            and all(isinstance(c, SignerCert)
                    and isinstance(c.subject, str)
                    and isinstance(c.pubkey, RsaPublicKey)
                    and isinstance(c.not_after, int)
                    and isinstance(c.signature, bytes) for c in chain)):
        raise DispatchError("tee_worker.MalformedCertChain")


def verify_attestation(roots: tuple[RsaPublicKey, ...],
                       chain: tuple[SignerCert, ...],
                       report: AttestationReport, report_sig: bytes,
                       now: int = ATTESTATION_TIME) -> None:
    """Full verification; raises DispatchError on any failure.

    chain[0] is signed by a pinned root; each subsequent cert by its
    predecessor; the LAST cert signs the report (the reference's
    verify_is_valid_tls_server_cert + verify_signature split)."""
    _check_shape(report, chain)
    if not roots:
        raise DispatchError("tee_worker.NoPinnedRoot")
    head = chain[0]
    if not any(rsa_verify_pkcs1v15(root, head.signing_payload(),
                                   head.signature) for root in roots):
        raise DispatchError("tee_worker.UntrustedSigner",
                            "cert chain does not reach a pinned root")
    for parent, cert in zip(chain, chain[1:]):
        if not rsa_verify_pkcs1v15(parent.pubkey, cert.signing_payload(),
                                   cert.signature):
            raise DispatchError("tee_worker.BrokenCertChain", cert.subject)
    for cert in chain:
        if cert.not_after < now:
            raise DispatchError("tee_worker.CertExpired", cert.subject)
    if not isinstance(report_sig, bytes) or not rsa_verify_pkcs1v15(
            chain[-1].pubkey, report.signing_payload(), report_sig):
        raise DispatchError("tee_worker.VerifyCertFailed",
                            "report signature invalid")


# -- dev/test issuance helpers (the chain only ever verifies) ----------------

def issue_cert(parent_keypair, subject: str, pubkey: RsaPublicKey,
               not_after: int = ATTESTATION_TIME + 10 * 365 * 86400
               ) -> SignerCert:
    c = SignerCert(subject=subject, pubkey=pubkey, not_after=not_after,
                   signature=b"")
    return dataclasses.replace(
        c, signature=parent_keypair.sign_pkcs1v15(c.signing_payload()))


def issue_report(signer_keypair, mrenclave: bytes, podr2_pk: bytes,
                 controller: str, mr_signer: bytes = b"\x05" * 32,
                 timestamp: int = ATTESTATION_TIME, bls_pk: bytes = b""
                 ) -> tuple[AttestationReport, bytes]:
    report = AttestationReport(
        mrenclave=mrenclave, mr_signer=mr_signer,
        report_data=report_data_binding(podr2_pk, controller, bls_pk),
        timestamp=timestamp)
    return report, signer_keypair.sign_pkcs1v15(report.signing_payload())
