"""PoDR2 audit rounds (reference: c-pallets/audit).

Validators' offchain workers build identical challenge snapshots; the
chain accepts one at >=2/3 matching proposals; snapshotted miners
submit aggregated proofs; a randomly assigned TEE verifies; rewards and
escalating punishments apply; timeout sweeps run every block.

Mirrors c-pallets/audit/src/lib.rs:
save_challenge_info w/ 2/3 aggregation :377-425, generation_challenge
:901-988, submit_proof :430-479, submit_verify_result :484-545,
clear_challenge :614-655, clear_verify_mission :657-737, fault
tolerance = 2 consecutive failures (constants.rs:1-3).

The proof *content* here is the PoDR2 scheme's (mu, sigma) blob
(cess_tpu_torch/ops/podr2.py, <= SIGMA_MAX bytes); the chain treats it as
opaque, exactly like the reference.
"""
from __future__ import annotations

import dataclasses
import hashlib

from .. import codec, constants
from ..crypto import bls12381, ed25519
from .sminer import Sminer
from .state import DispatchError, State

PALLET = "audit"

SESSION_SIGNING_CONTEXT = b"cess-tpu/audit-proposal-v1:"
VERDICT_SIGNING_CONTEXT = b"cess-tpu/tee-verdict-v1:"
VERDICT_LOG_MAX = 1024         # bounded public verdict log

CHALLENGE_LIFE_BASE = 300      # blocks; + per-miner extension like the ref
CHALLENGE_LIFE_PER_MINER = 1
VERIFY_LIFE = constants.BLOCKS_PER_HOUR   # VerifyDuration = +1h (:395-411)


@codec.register
@dataclasses.dataclass(frozen=True)
class NetSnapshot:
    total_reward: int
    total_idle_space: int
    total_service_space: int
    random_indices: tuple[int, ...]     # challenged chunk indices
    randoms: tuple[bytes, ...]          # 20-byte randoms per index


@codec.register
@dataclasses.dataclass(frozen=True)
class MinerSnapshot:
    """Per-miner challenge snapshot (ref types.rs:9-50). The owed
    fragment/filler sets are FROZEN here at challenge creation so the
    miner's proof and the TEE's verification fold over the exact same
    sets even when deals/restorals land mid-round (exact-set
    aggregation has no subset tolerance)."""
    miner: str
    idle_space: int
    service_space: int
    service_frags: tuple = ()     # owed service fragment hashes, sorted
    fillers: tuple = ()           # owed filler hashes, sorted


@codec.register
@dataclasses.dataclass(frozen=True)
class ChallengeInfo:
    net: NetSnapshot
    miners: tuple[MinerSnapshot, ...]   # still-pending miners
    start: int
    challenge_deadline: int
    verify_deadline: int
    cleared: bool = False


@codec.register
@dataclasses.dataclass(frozen=True)
class ProveInfo:
    miner: str
    snapshot: MinerSnapshot
    idle_proof: bytes
    service_proof: bytes


@codec.register
@dataclasses.dataclass(frozen=True)
class VerdictRecord:
    """A TEE verdict sealed for THIRD-PARTY re-verification: anyone
    holding the worker's on-chain 96-byte BLS pubkey can recheck
    bls12381.verify(bls_pk, verdict_message(...), bls_sig) without any
    TEE secret — the public-verifiability property the reference gets
    from enclave_verify::verify_bls
    (primitives/enclave-verify/src/lib.rs:230-235)."""
    tee: str
    miner: str
    mission_digest: bytes       # sha256 of the codec-encoded ProveInfo
    idle_ok: bool
    service_ok: bool
    bls_sig: bytes              # 48-byte G1 signature ("" = legacy worker)
    # the key that sealed this record, stamped by the chain at accept
    # time (the worker's then-current registered key): verification
    # survives the TEE exiting and re-registering with a NEW key, as
    # long as the stamp is in tee_worker.bls_keys_of's trusted set
    bls_pk: bytes = b""


def verdict_message(tee: str, mission_digest: bytes, idle_ok: bool,
                    service_ok: bool) -> bytes:
    """The exact bytes a TEE master key signs for one verify result."""
    return (VERDICT_SIGNING_CONTEXT
            + codec.encode((tee, mission_digest, idle_ok, service_ok)))


def mission_digest(mission: ProveInfo) -> bytes:
    return hashlib.sha256(codec.encode(mission)).digest()


def reverify_verdict(record: VerdictRecord, bls_pk: bytes) -> bool:
    """Public re-verification of a stored verdict — pure function of
    on-chain data, no secrets."""
    return bls12381.verify(
        bls_pk, verdict_message(record.tee, record.mission_digest,
                                record.idle_ok, record.service_ok),
        record.bls_sig)


def reverify_verdicts_batch(records, bls_keys: dict) -> bool:
    """Audit the WHOLE sealed log in one pairing product (the
    cess_teeVerdicts RPC output feeds straight in): ~N times cheaper
    than per-record verification for an external auditor. Duplicate
    messages are handled — exact duplicates collapse into one check,
    and message collisions with differing signatures verify
    individually (deterministic BLS: at most one can be valid) — so a
    False ALWAYS means some record is forged; the caller locates it
    with per-record reverify_verdict."""
    def key_for(r) -> bytes | None:
        """The key this record verifies under: its stamped sealing key
        when it belongs to the TEE's trusted set (bls_keys values may
        be one key or the full era history), else the newest key."""
        allowed = bls_keys.get(r.tee)
        if allowed is None:
            return None
        if isinstance(allowed, (bytes, bytearray)):
            allowed = (bytes(allowed),)
        else:
            allowed = tuple(allowed)
        if not allowed:
            return None
        if r.bls_pk:
            return r.bls_pk if r.bls_pk in allowed else None
        return allowed[-1]

    seen: dict[bytes, bytes] = {}      # message -> signature
    uniq: list[VerdictRecord] = []
    singles: list[VerdictRecord] = []
    for r in records:
        msg = verdict_message(r.tee, r.mission_digest, r.idle_ok,
                              r.service_ok)
        if msg not in seen:
            seen[msg] = r.bls_sig
            uniq.append(r)
        elif seen[msg] != r.bls_sig:
            # same message, different signature: BLS signatures are
            # deterministic, so at most one can be valid — check these
            # individually instead of poisoning the aggregate
            singles.append(r)
        # exact duplicates: one aggregated check covers both
    for r in singles:
        pk = key_for(r)
        if pk is None or not reverify_verdict(r, pk):
            return False
    if not uniq:
        return True
    try:
        agg = bls12381.aggregate([r.bls_sig for r in uniq])
    except ValueError:
        return False
    pairs = []
    for r in uniq:
        pk = key_for(r)
        if pk is None:
            return False
        pairs.append((pk, verdict_message(r.tee, r.mission_digest,
                                          r.idle_ok, r.service_ok)))
    return bls12381.aggregate_verify(pairs, agg)


class Audit:
    def __init__(self, state: State, sminer: Sminer, tee_worker=None,
                 storage_handler=None, file_bank=None,
                 challenge_life: int = CHALLENGE_LIFE_BASE,
                 verify_life: int = VERIFY_LIFE):
        self.state = state
        self.sminer = sminer
        self.tee_worker = tee_worker        # runtime wiring
        self.storage_handler = storage_handler
        self.file_bank = file_bank
        self.challenge_life = challenge_life
        self.verify_life = verify_life

    # -- session keys -------------------------------------------------------
    def set_keys(self, validators: tuple[str, ...]) -> None:
        """Session hook: the audit key set (lib.rs:1104-1142)."""
        self.state.put(PALLET, "keys", tuple(validators))

    def keys(self) -> tuple[str, ...]:
        return self.state.get(PALLET, "keys", default=())

    # -- challenge generation (OCW side; lib.rs:901-988) ---------------------
    def generation_challenge(self) -> tuple[NetSnapshot, tuple[MinerSnapshot, ...]]:
        """Deterministic snapshot every validator's OCW reproduces:
        all positive miners + 46/1000 random chunk indices + randoms."""
        miners = []
        for w in self.sminer.all_miners():
            m = self.sminer.miner(w)
            # frozen miners still hold data and stay challenged; only
            # exited/locked ones leave the audit set (lib.rs:901-988)
            if m.state in ("positive", "frozen") \
                    and (m.idle_space or m.service_space):
                service = tuple(sorted(
                    k[0] for k, _ in self.state.iter_prefix(
                        "file_bank", "frag_of_miner", w)))
                fillers = tuple(sorted(
                    self.file_bank.filler_hashes(w)
                    if self.file_bank else ()))
                miners.append(MinerSnapshot(w, m.idle_space,
                                            m.service_space, service,
                                            fillers))
        miners = tuple(miners[:constants.CHALLENGE_MINER_MAX])
        seed = self.state.get("system", "randomness", default=b"")
        n_chunks = constants.CHUNK_COUNT * constants.CHALLENGE_RATE_NUM \
            // constants.CHALLENGE_RATE_DEN + 1   # 47 (:956-964)
        indices = []
        randoms = []
        for i in range(n_chunks):
            h = hashlib.sha256(seed + i.to_bytes(4, "little")).digest()
            indices.append(int.from_bytes(h[:4], "little") % constants.CHUNK_COUNT)
            randoms.append(h[4:4 + constants.CHALLENGE_RANDOM_LEN])
        total = self.sminer.reward_pool_balance()
        net = NetSnapshot(
            total_reward=total,
            total_idle_space=(self.storage_handler.total_idle_space()
                              if self.storage_handler else 0),
            total_service_space=(self.storage_handler.total_service_space()
                                 if self.storage_handler else 0),
            random_indices=tuple(indices), randoms=tuple(randoms))
        return net, miners

    @staticmethod
    def snapshot_digest(net: NetSnapshot,
                        miners: tuple[MinerSnapshot, ...]) -> bytes:
        return hashlib.sha256(codec.encode((net, miners))).digest()

    # -- proposal aggregation (lib.rs:377-425) --------------------------------
    def save_challenge_info(self, validator: str, net: NetSnapshot,
                            miners: tuple[MinerSnapshot, ...],
                            signature: bytes) -> None:
        """Unsigned-transaction analog: ``signature`` is the session
        key's ed25519 signature over the snapshot digest, checked
        against the on-chain session-key registry — the reference's
        check_unsign/validate_unsigned (lib.rs:595-611,739-772).

        Aggregation counts DISTINCT voters per digest (a frozenset),
        so a validator alternating votes between digests can never
        raise any digest's count above one — the vote-switching
        count-pumping of the round-1 increment scheme is impossible
        by construction."""
        keys = self.keys()
        if validator not in keys:
            raise DispatchError("audit.NotAuditKey", validator)
        session_pub = self.state.get("system", "session_key", validator)
        if session_pub is None:
            raise DispatchError("audit.NoSessionKey", validator)
        digest = self.snapshot_digest(net, miners)
        if not ed25519.verify(session_pub, SESSION_SIGNING_CONTEXT + digest,
                              signature):
            raise DispatchError("audit.BadSessionSignature", validator)
        if self.challenge() is not None:
            raise DispatchError("audit.ChallengeInProgress")
        now = self.state.block
        # voters kept as a SORTED tuple: frozenset repr order is
        # PYTHONHASHSEED-dependent and would poison the state root
        # across processes
        voters, born = self.state.get(PALLET, "proposal", digest,
                                      default=((), now))
        if born + self.challenge_life < now:
            # stale proposal: old votes must not count toward quorum —
            # this vote starts a fresh accumulation window
            voters, born = (), now
        if validator in voters:
            raise DispatchError("audit.AlreadyProposed")
        voters = tuple(sorted((*voters, validator)))
        # keep the FIRST-SEEN born stamp: refreshing it on every vote
        # would let a trickle of votes keep a digest alive forever
        self.state.put(PALLET, "proposal", digest, (voters, born))
        # prune stale proposals so failed rounds don't leak state
        for (k,), (_, born) in list(self.state.iter_prefix(PALLET,
                                                           "proposal")):
            if born + self.challenge_life < now:
                self.state.delete(PALLET, "proposal", k)
        if len(voters) * 3 >= len(keys) * 2:
            life = self.challenge_life + CHALLENGE_LIFE_PER_MINER * len(miners)
            self.state.put(PALLET, "challenge", ChallengeInfo(
                net=net, miners=miners, start=now,
                challenge_deadline=now + life,
                verify_deadline=now + life + self.verify_life))
            for (k,), _ in list(self.state.iter_prefix(PALLET, "proposal")):
                self.state.delete(PALLET, "proposal", k)
            self.state.deposit_event(PALLET, "ChallengeStart", start=now,
                                     miners=len(miners))

    def verdicts(self) -> tuple[VerdictRecord, ...]:
        """The bounded public log of BLS-sealed TEE verdicts."""
        return self.state.get(PALLET, "verdicts", default=())

    def challenge(self) -> ChallengeInfo | None:
        return self.state.get(PALLET, "challenge")

    # -- proofs (lib.rs:430-479) ----------------------------------------------
    def submit_proof(self, miner: str, idle_proof: bytes,
                     service_proof: bytes) -> None:
        ch = self.challenge()
        if ch is None or ch.cleared:
            raise DispatchError("audit.NoChallenge")
        if self.state.block > ch.challenge_deadline:
            raise DispatchError("audit.ChallengeExpired")
        # proofs are opaque WIRE BYTES; the SIGMA_MAX cap measures the
        # actual serialized size (runtime/src/lib.rs:992), not a
        # self-reported length
        if not (isinstance(idle_proof, bytes)
                and isinstance(service_proof, bytes)):
            raise DispatchError("audit.MalformedProof")
        if len(idle_proof) > constants.SIGMA_MAX \
                or len(service_proof) > constants.SIGMA_MAX:
            raise DispatchError("audit.ProofTooLarge")
        snap = next((s for s in ch.miners if s.miner == miner), None)
        if snap is None:
            raise DispatchError("audit.NotChallengedMiner")
        # pop own snapshot (:454-474)
        self.state.put(PALLET, "challenge", dataclasses.replace(
            ch, miners=tuple(s for s in ch.miners if s.miner != miner)))
        tee = self._random_tee(miner)
        missions = self.state.get(PALLET, "unverify", tee, default=())
        if len(missions) >= constants.VERIFY_MISSION_MAX:
            raise DispatchError("audit.TeeOverloaded", tee)
        self.state.put(PALLET, "unverify", tee, missions + (ProveInfo(
            miner=miner, snapshot=snap, idle_proof=idle_proof,
            service_proof=service_proof),))
        # submitting at all resets the missed-challenge strike ladder
        self.state.delete(PALLET, "clear_strikes", miner)
        self.state.deposit_event(PALLET, "SubmitProof", miner=miner, tee=tee)

    def _random_tee(self, material: str) -> str:
        tees = self.tee_worker.controller_list() if self.tee_worker else ()
        if not tees:
            raise DispatchError("audit.NoTeeWorker")
        seed = self.state.get("system", "randomness", default=b"")
        h = hashlib.sha256(seed + material.encode()).digest()
        return sorted(tees)[int.from_bytes(h[:4], "little") % len(tees)]

    # -- verification results (lib.rs:484-545) ---------------------------------
    def submit_verify_result(self, tee: str, miner: str, idle_ok: bool,
                             service_ok: bool, bls_sig: bytes = b"") -> None:
        missions = self.state.get(PALLET, "unverify", tee, default=())
        mission = next((p for p in missions if p.miner == miner), None)
        if mission is None:
            raise DispatchError("audit.NonExistentMission")
        worker = self.tee_worker.worker(tee) if self.tee_worker else None
        if worker is not None and worker.bls_pk:
            # a worker that registered a BLS master key MUST seal every
            # verdict; the chain checks the pairing so the sealed record
            # below is verifiable by anyone from on-chain data alone
            digest = mission_digest(mission)
            if not bls12381.verify(
                    worker.bls_pk,
                    verdict_message(tee, digest, idle_ok, service_ok),
                    bls_sig):
                raise DispatchError("audit.BadVerdictSignature")
            log = self.state.get(PALLET, "verdicts", default=())
            log += (VerdictRecord(tee=tee, miner=miner,
                                  mission_digest=digest, idle_ok=idle_ok,
                                  service_ok=service_ok, bls_sig=bls_sig,
                                  bls_pk=worker.bls_pk),)
            self.state.put(PALLET, "verdicts", log[-VERDICT_LOG_MAX:])
        rest = tuple(p for p in missions if p.miner != miner)
        if rest:
            self.state.put(PALLET, "unverify", tee, rest)
        else:
            self.state.delete(PALLET, "unverify", tee)
        ch = self.challenge()
        if ch is None:
            return
        if idle_ok and service_ok:
            self.state.delete(PALLET, "fail_count", miner)
            self.sminer.calculate_miner_reward(
                miner, ch.net.total_reward, ch.net.total_idle_space,
                ch.net.total_service_space, mission.snapshot.idle_space,
                mission.snapshot.service_space)
        else:
            fails = self.state.get(PALLET, "fail_count", miner, default=0) + 1
            self.state.put(PALLET, "fail_count", miner, fails)
            if fails >= constants.AUDIT_FAULT_TOLERANCE:
                if not idle_ok:
                    self.sminer.idle_punish(miner)
                if not service_ok:
                    self.sminer.service_punish(miner)
                self.state.delete(PALLET, "fail_count", miner)
        if self.tee_worker:
            self.tee_worker.record_work(tee,
                                        mission.snapshot.service_space
                                        + mission.snapshot.idle_space)
        self.state.deposit_event(PALLET, "VerifyResult", miner=miner,
                                 idle=idle_ok, service=service_ok)

    # -- sweeps (on_initialize; lib.rs:340-345,614-737) --------------------------
    def on_initialize(self) -> None:
        ch = self.challenge()
        if ch is None:
            return
        now = self.state.block
        if not ch.cleared and now > ch.challenge_deadline:
            self._clear_challenge(ch)
            ch = self.challenge()
            if ch is None:
                return
        if now > ch.verify_deadline:
            extended = self._clear_verify_missions(ch)
            if not extended:
                self.state.delete(PALLET, "challenge")
                self.state.delete(PALLET, "verify_extended")
                self.state.deposit_event(PALLET, "ChallengeEnd", block=now)

    def _clear_challenge(self, ch: ChallengeInfo) -> None:
        """Non-submitters: escalating clear punish, 3rd strike = force
        exit (:614-655)."""
        for snap in ch.miners:
            strikes = self.state.get(PALLET, "clear_strikes", snap.miner,
                                     default=0) + 1
            self.state.put(PALLET, "clear_strikes", snap.miner, strikes)
            try:
                self.sminer.clear_punish(snap.miner, strikes)
            except DispatchError:
                continue
            if strikes >= 3:
                if self.file_bank is not None:
                    self.file_bank.force_miner_exit(snap.miner)
                else:
                    self.sminer.force_exit(snap.miner)
                self.state.delete(PALLET, "clear_strikes", snap.miner)
        self.state.put(PALLET, "challenge",
                       dataclasses.replace(ch, miners=(), cleared=True))

    def _clear_verify_missions(self, ch: ChallengeInfo) -> bool:
        """Overdue TEEs: slash + credit punishment; missions reassign
        ONCE to other TEEs with an extended window (:657-737). Returns
        True if the challenge was extended for the reassigned work."""
        pending = list(self.state.iter_prefix(PALLET, "unverify"))
        if not pending:
            return False
        laggards = {tee for (tee,), _ in pending}
        for tee in sorted(laggards):
            if self.tee_worker:
                self.tee_worker.punish_scheduler(tee)
            self.state.delete(PALLET, "unverify", tee)
        already_extended = self.state.get(PALLET, "verify_extended",
                                          default=False)
        others = sorted(set(self.tee_worker.controller_list() if
                            self.tee_worker else ()) - laggards)
        if already_extended or not others:
            self.state.delete(PALLET, "verify_extended")
            return False  # drop the missions; round ends
        all_missions = [m for (_,), ms in pending for m in ms]
        for i, mission in enumerate(all_missions):
            target = others[i % len(others)]
            cur = self.state.get(PALLET, "unverify", target, default=())
            self.state.put(PALLET, "unverify", target, cur + (mission,))
        self.state.put(PALLET, "verify_extended", True)
        self.state.put(PALLET, "challenge", dataclasses.replace(
            ch, verify_deadline=ch.verify_deadline + self.verify_life))
        self.state.deposit_event(PALLET, "VerifyReassigned",
                                 missions=len(all_missions))
        return True
