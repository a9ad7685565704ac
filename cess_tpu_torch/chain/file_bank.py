"""File lifecycle (reference: c-pallets/file-bank, the largest pallet).

Upload declaration with whole-file dedup, deal creation with random
miner assignment and scheduler-driven timeout/retry (<=5), storage
confirmation (transfer_report), tag-calculation window (calculate_end),
deletion, buckets, ownership transfer, filler (idle file) accounting,
fragment restoral orders, and miner exit with cooling.

Mirrors c-pallets/file-bank/src/:
upload_declaration lib.rs:423-499, generate_deal functions.rs:127-152,
random_assign_miner functions.rs:187-283, deal_reassign_miner
lib.rs:504-540, transfer_report lib.rs:623-697, calculate_end
lib.rs:702-726, replace_file_report lib.rs:731-760, fillers
lib.rs:798-859, restoral orders lib.rs:943-1122, miner exit
lib.rs:1128-1207 + functions.rs:543-573, lease-expiry GC lib.rs:362-402.

Layout note (device-first geometry): a deal assigns FRAGMENT_COUNT = k+m
miners; miner j stores fragment row j of EVERY segment — so the
off-chain encode batch is one [segments, k+m, fragment_size] device
array whose row-j slice ships to one miner (cess_tpu_torch/models/pipeline).
"""
from __future__ import annotations

import dataclasses
import hashlib

from .. import codec, constants
from .scheduler import Scheduler
from .sminer import Sminer
from .state import DispatchError, State
from .storage_handler import StorageHandler

PALLET = "file_bank"

CALCULATE = "calculate"   # fragments stored, tags being computed
ACTIVE = "active"

MINER_COOLING_BLOCKS = constants.ONE_DAY_BLOCKS  # exit cooling ledger


@codec.register
@dataclasses.dataclass(frozen=True)
class SegmentInfo:
    hash: bytes
    fragment_hashes: tuple[bytes, ...]   # len == fragment_count


@codec.register
@dataclasses.dataclass(frozen=True)
class UserBrief:
    user: str
    file_name: str
    bucket: str


@codec.register
@dataclasses.dataclass(frozen=True)
class DealInfo:
    file_hash: bytes
    owner: UserBrief
    file_size: int
    segments: tuple[SegmentInfo, ...]
    assigned: tuple[str, ...]           # miner per fragment row
    complete: frozenset[str]            # miners that reported
    count: int                          # reassignment retries
    needed_space: int


@codec.register
@dataclasses.dataclass(frozen=True)
class FileInfo:
    file_size: int
    segments: tuple[SegmentInfo, ...]
    miners: tuple[str, ...]             # fragment row -> miner
    owners: tuple[UserBrief, ...]
    state: str
    needed_space: int


@codec.register
@dataclasses.dataclass(frozen=True)
class RestoralOrder:
    miner: str              # claimant ("" = unclaimed)
    origin_miner: str
    file_hash: bytes
    fragment_hash: bytes
    fragment_row: int
    gen_block: int
    deadline: int           # claim deadline (re-opens on expiry)


@codec.register
@dataclasses.dataclass(frozen=True)
class RestoralTarget:
    """Exit cooling ledger gating withdrawal (functions.rs:543-573)."""
    miner: str
    service_space: int
    restored_space: int
    cooling_block: int


class FileBank:
    def __init__(self, state: State, balances, storage: StorageHandler,
                 sminer: Sminer, scheduler: Scheduler,
                 fragment_count: int = constants.FRAGMENT_COUNT,
                 oss=None):
        self.state = state
        self.storage = storage
        self.sminer = sminer
        self.scheduler = scheduler
        self.fragment_count = fragment_count
        self.oss = oss  # OssFindAuthor provider, set by runtime wiring

    # -- queries -----------------------------------------------------------
    def deal(self, file_hash: bytes) -> DealInfo | None:
        return self.state.get(PALLET, "deal", file_hash)

    def file(self, file_hash: bytes) -> FileInfo | None:
        return self.state.get(PALLET, "file", file_hash)

    def user_files(self, user: str) -> list[bytes]:
        return [k[0] for k, _ in self.state.iter_prefix(PALLET, "hold", user)]

    def restoral_order(self, fragment_hash: bytes) -> RestoralOrder | None:
        return self.state.get(PALLET, "restoral", fragment_hash)

    def pending_replacements(self, miner: str) -> int:
        return self.state.get(PALLET, "pending_replace", miner, default=0)

    def restoral_target(self, miner: str) -> RestoralTarget | None:
        return self.state.get(PALLET, "restoral_target", miner)

    # -- permission (functions.rs:516-521) ----------------------------------
    def _check_permission(self, operator: str, owner: str) -> None:
        if operator == owner:
            return
        if self.oss is not None and self.oss.is_authorized(owner, operator):
            return
        raise DispatchError("file_bank.NoPermission",
                            f"{operator} not authorized by {owner}")

    # -- buckets -------------------------------------------------------------
    def create_bucket(self, operator: str, owner: str, name: str) -> None:
        self._check_permission(operator, owner)
        if not (3 <= len(name) <= 63) or not name.replace("-", "").isalnum():
            raise DispatchError("file_bank.InvalidBucketName", name)
        if self.state.contains(PALLET, "bucket", owner, name):
            raise DispatchError("file_bank.BucketExists", name)
        self.state.put(PALLET, "bucket", owner, name, ())
        self.state.deposit_event(PALLET, "CreateBucket", owner=owner, name=name)

    def delete_bucket(self, operator: str, owner: str, name: str) -> None:
        self._check_permission(operator, owner)
        files = self.state.get(PALLET, "bucket", owner, name)
        if files is None:
            raise DispatchError("file_bank.NonExistentBucket", name)
        if files:
            raise DispatchError("file_bank.BucketNotEmpty", name)
        self.state.delete(PALLET, "bucket", owner, name)
        self.state.deposit_event(PALLET, "DeleteBucket", owner=owner, name=name)

    def _bucket_add(self, owner: str, name: str, file_hash: bytes) -> None:
        files = self.state.get(PALLET, "bucket", owner, name)
        if files is None:
            raise DispatchError("file_bank.NonExistentBucket", name)
        self.state.put(PALLET, "bucket", owner, name, files + (file_hash,))

    def _bucket_remove(self, owner: str, name: str, file_hash: bytes) -> None:
        files = self.state.get(PALLET, "bucket", owner, name)
        if files is not None:
            self.state.put(PALLET, "bucket", owner, name,
                           tuple(f for f in files if f != file_hash))

    # -- upload (lib.rs:423-499) ----------------------------------------------
    def upload_declaration(self, operator: str, file_hash: bytes,
                           segments: list[tuple[bytes, tuple[bytes, ...]]],
                           owner: UserBrief, file_size: int) -> None:
        self._check_permission(operator, owner.user)
        # check_file_spec (functions.rs:4-14): counts only, hashes trusted
        if not 0 < len(segments) <= constants.SEGMENT_COUNT_MAX:
            raise DispatchError("file_bank.SegmentCountError")
        if any(len(frags) != self.fragment_count for _, frags in segments):
            raise DispatchError("file_bank.FragmentCountError")
        if file_size <= 0:
            raise DispatchError("file_bank.InvalidFileSize")
        needed = len(segments) * constants.SEGMENT_SIZE \
            * constants.SPACE_OVERHEAD_NUM // constants.SPACE_OVERHEAD_DEN

        existing = self.file(file_hash)
        if existing is not None:
            # whole-file dedup: just add ownership (lib.rs:466-487)
            if any(o.user == owner.user for o in existing.owners):
                raise DispatchError("file_bank.OwnedFile")
            if not self.storage.check_user_space(owner.user, needed):
                raise DispatchError("storage_handler.InsufficientStorage")
            self.storage.unlock_and_used_user_space(owner.user, 0, needed)
            self._bucket_add(owner.user, owner.bucket, file_hash)
            self.state.put(PALLET, "file", file_hash, dataclasses.replace(
                existing, owners=existing.owners + (owner,)))
            self.state.put(PALLET, "hold", owner.user, file_hash, True)
            self.state.deposit_event(PALLET, "UploadDeclaration",
                                     operator=operator, owner=owner.user,
                                     file_hash=file_hash, shared=True)
            return

        if self.deal(file_hash) is not None:
            raise DispatchError("file_bank.DealExists")
        seg_infos = tuple(SegmentInfo(h, tuple(f)) for h, f in segments)
        self.storage.lock_user_space(owner.user, needed)
        assigned = self._random_assign_miner(file_hash, len(segments))
        deal = DealInfo(file_hash=file_hash, owner=owner,
                        file_size=file_size, segments=seg_infos,
                        assigned=assigned, complete=frozenset(), count=0,
                        needed_space=needed)
        self.state.put(PALLET, "deal", file_hash, deal)
        self._start_deal_task(file_hash)
        self.state.deposit_event(PALLET, "UploadDeclaration",
                                 operator=operator, owner=owner.user,
                                 file_hash=file_hash, shared=False)

    def _random_assign_miner(self, file_hash: bytes, seg_count: int,
                             exclude: frozenset[str] = frozenset(),
                             rows_needed: int | None = None) -> tuple[str, ...]:
        """Pick fragment_count distinct positive miners with enough idle
        space, deterministically seeded (functions.rs:187-283); each
        selected miner locks seg_count * FRAGMENT_SIZE."""
        rows = rows_needed if rows_needed is not None else self.fragment_count
        need = seg_count * constants.FRAGMENT_SIZE
        candidates = [w for w in self.sminer.all_miners()
                      if w not in exclude and self.sminer.is_positive(w)
                      and self.sminer.get_miner_idle_space(w) >= need]
        if len(candidates) < rows:
            raise DispatchError("file_bank.NotQualifiedMiner",
                                f"{len(candidates)} candidates < {rows}")
        seed = self.state.get("system", "randomness", default=b"") + file_hash
        rng_order = sorted(
            candidates,
            key=lambda w: hashlib.sha256(seed + w.encode()).digest())
        chosen = tuple(rng_order[:rows])
        for w in chosen:
            self.sminer.lock_space(w, need)
        return chosen

    def _start_deal_task(self, file_hash: bytes) -> None:
        # timeout = 600 blocks per assigned miner (functions.rs:154-168)
        life = constants.DEAL_TIMEOUT_BLOCKS * self.fragment_count
        self.scheduler.schedule_named(
            f"deal:{file_hash.hex()}", self.state.block + life,
            PALLET, "deal_timeout", file_hash)

    # -- deal progression -------------------------------------------------------
    def transfer_report(self, miner: str, file_hash: bytes) -> None:
        """A miner confirms it stored its fragment rows (lib.rs:623-697)."""
        deal = self.deal(file_hash)
        if deal is None:
            raise DispatchError("file_bank.NonExistentDeal")
        if miner not in deal.assigned:
            raise DispatchError("file_bank.NotAssignedMiner")
        if miner in deal.complete:
            raise DispatchError("file_bank.AlreadyReported")
        complete = deal.complete | {miner}
        deal = dataclasses.replace(deal, complete=complete)
        self.state.put(PALLET, "deal", file_hash, deal)
        self.state.deposit_event(PALLET, "TransferReport", miner=miner,
                                 file_hash=file_hash)
        if complete != frozenset(deal.assigned):
            return
        # last reporter: file enters Calculate (tag window), space settles
        owner = deal.owner
        self.state.put(PALLET, "file", file_hash, FileInfo(
            file_size=deal.file_size, segments=deal.segments,
            miners=deal.assigned, owners=(owner,), state=CALCULATE,
            needed_space=deal.needed_space))
        self.state.put(PALLET, "hold", owner.user, file_hash, True)
        self._bucket_add(owner.user, owner.bucket, file_hash)
        seg_count = len(deal.segments)
        for row, w in enumerate(deal.assigned):
            # each miner may now replace seg_count fillers (lib.rs:663-668)
            self.state.put(PALLET, "pending_replace", w,
                           self.pending_replacements(w) + seg_count)
            for seg in deal.segments:
                self.state.put(PALLET, "frag_of_miner", w,
                               seg.fragment_hashes[row],
                               (file_hash, row))
        self.storage.unlock_and_used_user_space(
            owner.user, deal.needed_space, deal.needed_space)
        self.scheduler.cancel_named(f"deal:{file_hash.hex()}")
        self.scheduler.schedule_named(
            f"calc:{file_hash.hex()}",
            self.state.block + constants.DEAL_TIMEOUT_BLOCKS,
            PALLET, "calculate_end", file_hash)
        self.state.deposit_event(PALLET, "StorageCompleted",
                                 file_hash=file_hash)

    def calculate_end(self, file_hash: bytes) -> None:
        """Tag window closed: locked miner space becomes service space,
        file goes Active (lib.rs:702-726). Root/scheduled origin."""
        f = self.file(file_hash)
        if f is None or f.state != CALCULATE:
            return
        seg_space = len(f.segments) * constants.FRAGMENT_SIZE
        for w in f.miners:
            self.sminer.unlock_space_to_service(w, seg_space)
        self.state.put(PALLET, "file", file_hash,
                       dataclasses.replace(f, state=ACTIVE))
        self.state.delete(PALLET, "deal", file_hash)
        self.scheduler.cancel_named(f"calc:{file_hash.hex()}")
        self.state.deposit_event(PALLET, "CalculateEnd", file_hash=file_hash)

    def deal_timeout(self, file_hash: bytes) -> None:
        """Scheduled retry: reassign non-reporting miners, <=5 attempts
        then abort with refund (lib.rs:504-540)."""
        deal = self.deal(file_hash)
        if deal is None:
            return
        seg_count = len(deal.segments)
        need = seg_count * constants.FRAGMENT_SIZE
        laggards = [w for w in deal.assigned if w not in deal.complete]
        if deal.count >= constants.DEAL_MAX_RETRIES:
            for w in deal.assigned:
                self.sminer.unlock_space(w, need)
            self.storage.unlock_user_space(deal.owner.user, deal.needed_space)
            self.state.delete(PALLET, "deal", file_hash)
            self.state.deposit_event(PALLET, "DealAborted", file_hash=file_hash)
            return
        for w in laggards:
            self.sminer.unlock_space(w, need)
        try:
            replacements = self._random_assign_miner(
                file_hash, seg_count,
                exclude=frozenset(deal.assigned),
                rows_needed=len(laggards))
        except DispatchError:
            # no candidates: keep the same laggards assigned, re-lock
            for w in laggards:
                self.sminer.lock_space(w, need)
            replacements = tuple(laggards)
        new_assigned = []
        it = iter(replacements)
        for w in deal.assigned:
            new_assigned.append(next(it) if w in laggards else w)
        deal = dataclasses.replace(deal, assigned=tuple(new_assigned),
                                   count=deal.count + 1)
        self.state.put(PALLET, "deal", file_hash, deal)
        self._start_deal_task(file_hash)
        self.state.deposit_event(PALLET, "DealReassigned",
                                 file_hash=file_hash, count=deal.count)

    # -- deletion (lib.rs) -------------------------------------------------------
    def delete_file(self, operator: str, owner: str, file_hash: bytes) -> None:
        self._check_permission(operator, owner)
        f = self.file(file_hash)
        if f is None:
            raise DispatchError("file_bank.NonExistentFile")
        brief = next((o for o in f.owners if o.user == owner), None)
        if brief is None:
            raise DispatchError("file_bank.NotOwner")
        owners = tuple(o for o in f.owners if o.user != owner)
        self.storage.free_used_space(owner, f.needed_space)
        self.state.delete(PALLET, "hold", owner, file_hash)
        self._bucket_remove(owner, brief.bucket, file_hash)
        if owners:
            self.state.put(PALLET, "file", file_hash,
                           dataclasses.replace(f, owners=owners))
        else:
            self._drop_file_storage(file_hash, f)
        self.state.deposit_event(PALLET, "DeleteFile", owner=owner,
                                 file_hash=file_hash)

    def _drop_file_storage(self, file_hash: bytes, f: FileInfo) -> None:
        seg_space = len(f.segments) * constants.FRAGMENT_SIZE
        for row, w in enumerate(f.miners):
            if f.state == ACTIVE:
                self.sminer.sub_miner_service_space(w, seg_space)
                self.storage.sub_total_service_space(seg_space)
            else:
                self.sminer.unlock_space(w, seg_space)
            for seg in f.segments:
                self.state.delete(PALLET, "frag_of_miner", w,
                                  seg.fragment_hashes[row])
        self.state.delete(PALLET, "file", file_hash)
        self.scheduler.cancel_named(f"calc:{file_hash.hex()}")

    def ownership_transfer(self, operator: str, old_owner: str,
                           new_brief: UserBrief, file_hash: bytes) -> None:
        self._check_permission(operator, old_owner)
        f = self.file(file_hash)
        if f is None:
            raise DispatchError("file_bank.NonExistentFile")
        if not any(o.user == old_owner for o in f.owners):
            raise DispatchError("file_bank.NotOwner")
        if any(o.user == new_brief.user for o in f.owners):
            raise DispatchError("file_bank.OwnedFile", "target already owns")
        if not self.storage.check_user_space(new_brief.user, f.needed_space):
            raise DispatchError("storage_handler.InsufficientStorage")
        old_brief = next(o for o in f.owners if o.user == old_owner)
        self.storage.unlock_and_used_user_space(new_brief.user, 0, f.needed_space)
        self.storage.free_used_space(old_owner, f.needed_space)
        self._bucket_remove(old_owner, old_brief.bucket, file_hash)
        self._bucket_add(new_brief.user, new_brief.bucket, file_hash)
        self.state.delete(PALLET, "hold", old_owner, file_hash)
        self.state.put(PALLET, "hold", new_brief.user, file_hash, True)
        owners = tuple(o for o in f.owners if o.user != old_owner) + (new_brief,)
        self.state.put(PALLET, "file", file_hash,
                       dataclasses.replace(f, owners=owners))
        self.state.deposit_event(PALLET, "OwnershipTransfer",
                                 file_hash=file_hash, old=old_owner,
                                 new=new_brief.user)

    # -- fillers (idle files; lib.rs:798-859) -------------------------------------
    # The reference's FillerMap keys (miner, filler_hash) with TEE
    # attribution and delete_filler. Here a filler's CONTENT is
    # PRF-derived from (miner, index) (cess_tpu_torch.node.hashing.
    # filler_bytes); the TEE regenerates it, checks the hash, tags it,
    # and signs the batch — so idle space only enters the ledger
    # against TEE-certified, auditable content.
    #
    # Known limitation (shared with this reference snapshot's
    # generated idle files, lib.rs:798-859): publicly-derivable filler
    # content proves TAG possession, not dedicated disk — a miner can
    # regenerate challenged fillers on demand. CESS later replaced
    # this with PoIS; a miner-secret-seeded variant is the upgrade
    # path here.
    FILLER_CERT_CONTEXT = b"cess-filler-cert-v1:"

    def filler_hashes(self, miner: str) -> list[bytes]:
        return [k[0] for k, _ in self.state.iter_prefix(PALLET, "filler",
                                                        miner)]

    def filler_cert_nonce(self, miner: str) -> int:
        return self.state.get(PALLET, "filler_cert_nonce", miner, default=0)

    def upload_filler(self, miner: str, hashes: tuple[bytes, ...],
                      tee: str, tee_sig: bytes) -> None:
        """TEE-certified filler registration: every filler hash goes
        into the registry with the certifying TEE recorded; idle space
        is credited per filler (8 MiB protocol units).

        The cert covers (miner, hashes, cert_nonce) where cert_nonce
        is the miner's on-chain filler-cert counter — a cert can never
        be replayed to re-credit idle space after delete_filler /
        replace_file_report removed the filler."""
        from ..crypto import ed25519

        if not hashes or len(set(hashes)) != len(hashes):
            raise DispatchError("file_bank.InvalidCount")
        if not self.sminer.is_positive(miner):
            raise DispatchError("sminer.StateNotPositive")
        tee_registry = self.state.get("tee_worker", "worker", tee)
        if tee_registry is None:
            raise DispatchError("file_bank.NonExistentTee", tee)
        tee_pub = self.state.get("system", "account_key", tee)
        nonce = self.filler_cert_nonce(miner)
        payload = self.FILLER_CERT_CONTEXT + codec.encode(
            (miner, tuple(hashes), nonce))
        if tee_pub is None or not isinstance(tee_sig, bytes) \
                or not ed25519.verify(tee_pub, payload, tee_sig):
            raise DispatchError("file_bank.BadFillerCert", miner)
        for h in hashes:
            if self.state.contains(PALLET, "filler", miner, h):
                raise DispatchError("file_bank.FillerExists", h.hex())
        for h in hashes:
            self.state.put(PALLET, "filler", miner, h,
                           (tee, self.state.block))
        self.state.put(PALLET, "filler_cert_nonce", miner, nonce + 1)
        self.sminer.add_miner_idle_space(
            miner, len(hashes) * constants.FRAGMENT_SIZE)
        self.state.deposit_event(PALLET, "FillerUpload", miner=miner,
                                 count=len(hashes))

    def delete_filler(self, miner: str, filler_hash: bytes) -> None:
        """Remove one filler from the registry and the idle ledger
        (lib.rs:798-859 delete_filler)."""
        if not self.state.contains(PALLET, "filler", miner, filler_hash):
            raise DispatchError("file_bank.NonExistentFiller")
        m = self.sminer.miner(miner)
        if m is not None and m.idle_space < constants.FRAGMENT_SIZE:
            # the filler's space is currently locked for a deal:
            # deleting now would strand the reservation and drift the
            # registry against the idle ledger (invariant:
            # idle + lock + pending_replace*FRAG == fillers*FRAG)
            raise DispatchError("file_bank.IdleSpaceLocked", miner)
        self.state.delete(PALLET, "filler", miner, filler_hash)
        if m is not None:
            self.state.put("sminer", "miner", miner, dataclasses.replace(
                m, idle_space=m.idle_space - constants.FRAGMENT_SIZE))
            self.storage.sub_total_idle_space(constants.FRAGMENT_SIZE)

    def replace_file_report(self, miner: str,
                            filler_hashes: tuple[bytes, ...]) -> None:
        """Miner deletes specific fillers freed by stored service
        fragments (lib.rs:731-760): each named filler leaves the
        registry, so it stops being audited and stops counting as
        idle space."""
        pending = self.pending_replacements(miner)
        count = len(filler_hashes)
        if count <= 0 or count > pending:
            raise DispatchError("file_bank.InvalidCount",
                                f"{count} > pending {pending}")
        if len(set(filler_hashes)) != count:
            raise DispatchError("file_bank.InvalidCount", "duplicate hash")
        for h in filler_hashes:
            if not self.state.contains(PALLET, "filler", miner, h):
                raise DispatchError("file_bank.NonExistentFiller")
        # registry-only removal: the replaced space already left the
        # idle ledger when the deal's lock converted to service
        # (unlock_space_to_service at calculate_end) — delete_filler
        # here would subtract it a second time and drift
        # idle + lock + pending*FRAG below fillers*FRAG
        for h in filler_hashes:
            self.state.delete(PALLET, "filler", miner, h)
        self.state.put(PALLET, "pending_replace", miner, pending - count)
        self.state.deposit_event(PALLET, "ReplaceFiller", miner=miner,
                                 count=count)

    # -- restoral orders (lib.rs:943-1122) ----------------------------------------
    def generate_restoral_order(self, miner: str, file_hash: bytes,
                                fragment_hash: bytes) -> None:
        """A miner reports one of ITS fragments broken/lost."""
        entry = self.state.get(PALLET, "frag_of_miner", miner, fragment_hash)
        if entry is None:
            raise DispatchError("file_bank.NotFragmentOwner")
        if self.restoral_order(fragment_hash) is not None:
            raise DispatchError("file_bank.OrderExists")
        fh, row = entry
        if fh != file_hash:
            raise DispatchError("file_bank.HashMismatch")
        self._push_restoral(miner, file_hash, fragment_hash, row)

    def _push_restoral(self, origin_miner: str, file_hash: bytes,
                       fragment_hash: bytes, row: int) -> None:
        self.state.put(PALLET, "restoral", fragment_hash, RestoralOrder(
            miner="", origin_miner=origin_miner, file_hash=file_hash,
            fragment_hash=fragment_hash, fragment_row=row,
            gen_block=self.state.block,
            deadline=self.state.block + constants.RESTORAL_ORDER_LIFE))
        self.state.deposit_event(PALLET, "GenerateRestoralOrder",
                                 fragment_hash=fragment_hash)

    def claim_restoral_order(self, miner: str, fragment_hash: bytes) -> None:
        """Any positive miner claims a pending restoral (lib.rs)."""
        if not self.sminer.is_positive(miner):
            raise DispatchError("sminer.StateNotPositive")
        order = self.restoral_order(fragment_hash)
        if order is None:
            raise DispatchError("file_bank.NonExistentOrder")
        if order.miner and self.state.block <= order.deadline:
            raise DispatchError("file_bank.OrderClaimed")
        self.state.put(PALLET, "restoral", fragment_hash, dataclasses.replace(
            order, miner=miner,
            deadline=self.state.block + constants.RESTORAL_ORDER_LIFE))
        self.state.deposit_event(PALLET, "ClaimRestoralOrder", miner=miner,
                                 fragment_hash=fragment_hash)

    def restoral_order_complete(self, miner: str, fragment_hash: bytes) -> None:
        """Claimant repaired the fragment: ownership (and its service
        space) transfers (lib.rs:1068-1122)."""
        order = self.restoral_order(fragment_hash)
        if order is None:
            raise DispatchError("file_bank.NonExistentOrder")
        if order.miner != miner:
            raise DispatchError("file_bank.NotClaimant")
        if self.state.block > order.deadline:
            raise DispatchError("file_bank.OrderExpired")
        f = self.file(order.file_hash)
        if f is None:
            self.state.delete(PALLET, "restoral", fragment_hash)
            return
        # move fragment-row ownership: origin loses, claimant gains
        self.sminer.sub_miner_service_space(order.origin_miner,
                                            constants.FRAGMENT_SIZE)
        self.sminer.add_miner_service_space(miner, constants.FRAGMENT_SIZE)
        self.state.delete(PALLET, "frag_of_miner", order.origin_miner,
                          fragment_hash)
        self.state.put(PALLET, "frag_of_miner", miner, fragment_hash,
                       (order.file_hash, order.fragment_row))
        # the file's row->miner mapping flips to the claimant once the
        # origin holds no fragment of that row anymore
        row = order.fragment_row
        if not any(self.state.contains(PALLET, "frag_of_miner",
                                       order.origin_miner,
                                       s.fragment_hashes[row])
                   for s in f.segments):
            miners = tuple(miner if i == row else w
                           for i, w in enumerate(f.miners))
            self.state.put(PALLET, "file", order.file_hash,
                           dataclasses.replace(f, miners=miners))
        # exit bookkeeping
        tgt = self.restoral_target(order.origin_miner)
        if tgt is not None:
            self.state.put(PALLET, "restoral_target", order.origin_miner,
                           dataclasses.replace(
                               tgt, restored_space=tgt.restored_space
                               + constants.FRAGMENT_SIZE))
        self.state.delete(PALLET, "restoral", fragment_hash)
        self.state.deposit_event(PALLET, "RestoralComplete", miner=miner,
                                 fragment_hash=fragment_hash)

    # -- miner exit (lib.rs:1128-1207) ---------------------------------------------
    def miner_exit_prep(self, miner: str) -> None:
        """Begin exit: every held fragment becomes a restoral order;
        withdrawal gates on full restoral + cooling."""
        m = self.sminer.begin_exit(miner)
        count = 0
        for (frag_hash,), (file_hash, row) in list(
                self.state.iter_prefix(PALLET, "frag_of_miner", miner)):
            if self.restoral_order(frag_hash) is None:
                self._push_restoral(miner, file_hash, frag_hash, row)
            count += 1
        self.state.put(PALLET, "restoral_target", miner, RestoralTarget(
            miner=miner, service_space=count * constants.FRAGMENT_SIZE,
            restored_space=0,
            cooling_block=self.state.block + MINER_COOLING_BLOCKS))

    def force_miner_exit(self, miner: str) -> None:
        """Audit escalation (3rd clear strike): lock the miner and open
        restoral orders for everything it held (audit lib.rs:637-648)."""
        m = self.sminer.force_exit(miner)
        if m is None:
            return
        count = 0
        for (frag_hash,), (file_hash, row) in list(
                self.state.iter_prefix(PALLET, "frag_of_miner", miner)):
            if self.restoral_order(frag_hash) is None:
                self._push_restoral(miner, file_hash, frag_hash, row)
            count += 1
        self.state.put(PALLET, "restoral_target", miner, RestoralTarget(
            miner=miner, service_space=count * constants.FRAGMENT_SIZE,
            restored_space=0,
            cooling_block=self.state.block + MINER_COOLING_BLOCKS))

    def miner_withdraw(self, miner: str) -> None:
        tgt = self.restoral_target(miner)
        if tgt is None:
            raise DispatchError("file_bank.NonExistentTarget")
        if self.state.block < tgt.cooling_block:
            raise DispatchError("file_bank.CoolingNotOver")
        if tgt.restored_space < tgt.service_space:
            raise DispatchError("file_bank.RestoralIncomplete",
                                f"{tgt.restored_space}/{tgt.service_space}")
        self.sminer.withdraw(miner)
        self.state.delete(PALLET, "restoral_target", miner)
        self.state.delete(PALLET, "pending_replace", miner)

    # -- hooks (lease GC, lib.rs:362-402) -------------------------------------------
    def on_initialize(self, dead_users: list[str]) -> None:
        """GC files of users whose lease died (<=300 files per block)."""
        queue = list(self.state.get(PALLET, "gc_queue", default=()))
        queue.extend(dead_users)
        budget = constants.FROZEN_SWEEP_MAX_FILES
        remaining = []
        for user in queue:
            files = self.user_files(user)
            for fh in files[:budget]:
                try:
                    self.delete_file(user, user, fh)
                except DispatchError:
                    self.state.delete(PALLET, "hold", user, fh)
            budget -= min(len(files), budget)
            if len(files) > constants.FROZEN_SWEEP_MAX_FILES or budget <= 0:
                if self.user_files(user):
                    remaining.append(user)
                    continue
            if not self.user_files(user):
                self.storage.remove_dead_lease(user)
        self.state.put(PALLET, "gc_queue", tuple(remaining))
