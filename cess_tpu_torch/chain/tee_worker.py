"""TEE "scheduler" worker registry (reference: c-pallets/tee-worker).

Register with an attestation report verified on-chain (controller and
stash binding, libp2p PeerId, PoDR2 public key); the network-wide
PoDR2 key is the first registered worker's; an MRENCLAVE whitelist
gates registration; punishment slashes the worker's stash via staking
and records a scheduler-credit punishment.
Mirrors c-pallets/tee-worker/src/lib.rs: register
:138-177 (verify_miner_cert -> enclave-verify lib.rs:135-219),
TeePodr2Pk :122-123, update_whitelist :210-218, ScheduleFind incl.
punish_scheduler :294-321.

Attestation: a STRUCTURED report + signer certificate chain
(cess_tpu_torch/chain/attestation.py) — the report is parsed, its
report_data must equal the (podr2_pk, controller) binding, its
MRENCLAVE must be whitelisted, and the signing cert must chain to a
root pinned on chain — mirroring the reference's webpki chain
verification + fixed-offset quote parsing
(primitives/enclave-verify/src/lib.rs:46-219).
"""
from __future__ import annotations

import dataclasses

from ..crypto import bls12381
from ..crypto.rsa import RsaPublicKey
from .. import codec
from .attestation import (AttestationReport, SignerCert,
                          report_data_binding, verify_attestation)
from .state import DispatchError, State

PALLET = "tee_worker"


@codec.register
@dataclasses.dataclass(frozen=True)
class TeeWorkerInfo:
    controller: str
    stash: str
    peer_id: bytes
    podr2_pk: bytes
    # BLS12-381 G2 master pubkey (96B) for publicly verifiable verdict
    # signatures; empty for workers registered before the capability
    # (the reference's enclave_verify::verify_bls key material,
    # primitives/enclave-verify/src/lib.rs:230-235).
    bls_pk: bytes = b""


class TeeWorker:
    def __init__(self, state: State, staking=None, credit=None):
        self.state = state
        self.staking = staking          # runtime wiring
        self.credit = credit

    # -- governance ----------------------------------------------------------
    def update_whitelist(self, mrenclave: bytes) -> None:
        """Root: allow an enclave measurement (lib.rs:210-218)."""
        wl = self.state.get(PALLET, "whitelist", default=())
        if mrenclave not in wl:
            self.state.put(PALLET, "whitelist", wl + (mrenclave,))

    def pin_ias_signer(self, key: RsaPublicKey) -> None:
        """Root: pin an attestation ROOT key (the IAS root CA analog;
        cert chains must terminate here)."""
        if not isinstance(key, RsaPublicKey):
            raise DispatchError("tee_worker.BadRootKey")
        pins = self.state.get(PALLET, "ias_pins", default=())
        if key not in pins:
            self.state.put(PALLET, "ias_pins", pins + (key,))

    # -- registration (lib.rs:138-177) ----------------------------------------
    def register(self, controller: str, stash: str, peer_id: bytes,
                 podr2_pk: bytes, report: AttestationReport,
                 report_sig: bytes,
                 cert_chain: tuple[SignerCert, ...],
                 bls_pk: bytes = b"", bls_pop: bytes = b"") -> None:
        if self.state.contains(PALLET, "worker", controller):
            raise DispatchError("tee_worker.Registered")
        roots = self.state.get(PALLET, "ias_pins", default=())
        verify_attestation(roots, cert_chain, report, report_sig)
        wl = self.state.get(PALLET, "whitelist", default=())
        if report.mrenclave not in wl:   # parsed field, exact match
            raise DispatchError("tee_worker.NonTeeWorker",
                                "MRENCLAVE not whitelisted")
        if report.report_data != report_data_binding(podr2_pk, controller,
                                                     bls_pk):
            raise DispatchError("tee_worker.VerifyCertFailed",
                                "report_data does not bind podr2_pk"
                                " + controller")
        if bls_pk:
            # the verdict-signing master key must come with a proof of
            # possession (rogue-key discipline for later aggregation)
            if not (isinstance(bls_pk, bytes)
                    and len(bls_pk) == bls12381.PK_BYTES
                    and isinstance(bls_pop, bytes)
                    and bls12381.verify_possession(bls_pk, bls_pop)):
                raise DispatchError("tee_worker.BadBlsKey",
                                    "invalid BLS pk or possession proof")
        self.state.put(PALLET, "worker", controller, TeeWorkerInfo(
            controller=controller, stash=stash, peer_id=peer_id,
            podr2_pk=podr2_pk, bls_pk=bls_pk))
        # network PoDR2 key = first registered worker's (lib.rs:122-123)
        if not self.state.contains(PALLET, "podr2_pk"):
            self.state.put(PALLET, "podr2_pk", podr2_pk)
        self.state.deposit_event(PALLET, "RegistrationTeeWorker",
                                 controller=controller)

    def exit(self, controller: str) -> None:
        w = self.worker(controller)
        if w is None:
            raise DispatchError("tee_worker.NonTeeWorker")
        if w.bls_pk:
            # preserve the verdict-signing key: sealed verdicts in the
            # audit log must stay publicly verifiable AFTER the worker
            # leaves (an exited TEE must not launder its history).
            # APPEND-ONLY: a re-registration with a new key followed by
            # another exit must not overwrite older eras' keys
            old = self.state.get(PALLET, "retired_bls", controller,
                                 default=())
            if w.bls_pk not in old:
                self.state.put(PALLET, "retired_bls", controller,
                               old + (w.bls_pk,))
        self.state.delete(PALLET, "worker", controller)
        self.state.deposit_event(PALLET, "ExitTeeWorker",
                                 controller=controller)

    # -- queries ---------------------------------------------------------------
    def worker(self, controller: str) -> TeeWorkerInfo | None:
        return self.state.get(PALLET, "worker", controller)

    def tee_podr2_pk(self) -> bytes | None:
        return self.state.get(PALLET, "podr2_pk")

    def bls_keys_of(self, controller: str) -> tuple[bytes, ...]:
        """EVERY verdict-signing key this controller has ever held
        (live + retired eras) — the trusted set a sealed record's
        stamped key must belong to. A controller that exits and
        re-registers with a new key keeps its whole history."""
        keys = self.state.get(PALLET, "retired_bls", controller,
                              default=())
        w = self.worker(controller)
        if w is not None and w.bls_pk and w.bls_pk not in keys:
            keys = keys + (w.bls_pk,)
        return keys

    def bls_key_of(self, controller: str) -> bytes:
        """The controller's CURRENT verdict-signing key (live, else
        the most recently retired)."""
        w = self.worker(controller)
        if w is not None and w.bls_pk:
            return w.bls_pk
        keys = self.state.get(PALLET, "retired_bls", controller,
                              default=())
        return keys[-1] if keys else b""

    # -- ScheduleFind trait (lib.rs:287-321) -------------------------------------
    def controller_list(self) -> tuple[str, ...]:
        return tuple(k[0] for k, _ in self.state.iter_prefix(PALLET, "worker"))

    def punish_scheduler(self, controller: str) -> None:
        """Verify-timeout escalation: slash the stash 5% of the minimum
        validator bond + credit punishment (staking slashing.rs:694-705)."""
        w = self.worker(controller)
        if w is None:
            return
        if self.staking is not None:
            self.staking.slash_scheduler(w.stash)
        if self.credit is not None:
            self.credit.record_punishment(w.controller)
        self.state.deposit_event(PALLET, "PunishScheduler",
                                 controller=controller)

    def record_work(self, controller: str, nbytes: int) -> None:
        """Verified bytes feed the credit score (SchedulerCreditCounter)."""
        if self.credit is not None and self.worker(controller) is not None:
            self.credit.record_proceed_block_size(controller, nbytes)
