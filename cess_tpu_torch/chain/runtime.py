"""Composition root: pallets wired + block executive.

Mirrors the reference runtime (SURVEY.md §2.2): construct_runtime
composition with cross-pallet trait wiring, the Executive's
on_initialize order (audit sweeps -> storage-handler lease sweep ->
file-bank GC -> scheduler-credit rollover -> scheduler dispatch,
runtime/src/lib.rs:1479-1540 §3.4), transactional extrinsic dispatch,
and era rotation driving staking payouts + sminer reward tranches.

Consensus (who authors blocks, epoch randomness) lives in
node/; the runtime consumes randomness via
("system", "randomness") exactly like the reference's
ParentBlockRandomness.
"""
from __future__ import annotations

import dataclasses
import hashlib

from .. import constants
from .audit import Audit
from .balances import Balances
from .assets import Assets
from .cacher import Cacher
from .indices import Indices, Preimage
from .contracts import Contracts
from .election import Election
from .evm import Evm
from .extrinsic import SignedExtrinsic, verify_signature
from .file_bank import FileBank
from .governance import Council, TechnicalCommittee, Treasury
from .im_online import ImOnline
from . import migrations
from .offences import Offences
from .oss import Oss
from .scheduler import Scheduler
from .scheduler_credit import SchedulerCredit
from .sminer import Sminer
from .staking import Staking
from .state import DispatchError, State
from .storage_handler import StorageHandler
from .system import System
from .tee_worker import TeeWorker

ROOT = "root"
TREASURY = "treasury"

# extrinsics only the root / scheduler origin may call
ROOT_ONLY = {
    "file_bank.calculate_end",
    "file_bank.deal_timeout",
    "file_bank.force_miner_exit",
    "tee_worker.update_whitelist",
    "tee_worker.pin_ias_signer",
    "audit.set_keys",
    "council.set_members",
    "technical_committee.set_members",
    "system.apply_runtime_upgrade",
    "assets.set_fee_rate",
}

# the dispatch surface — FRAME's #[pallet::call] analog. Pallet
# methods NOT listed here (mint, set_sudo, lock_space, punish hooks,
# ...) are internal: reachable only through other pallets or hooks,
# never from a transaction.
SIGNED_CALLS = {
    "system.set_session_key", "system.remark",
    "balances.transfer",
    "storage_handler.buy_space", "storage_handler.expansion_space",
    "storage_handler.renewal_space",
    "sminer.regnstk", "sminer.increase_collateral",
    "sminer.update_beneficiary", "sminer.update_peer_id",
    "sminer.commit_filler_seed",
    "oss.register", "oss.update", "oss.destroy",
    "oss.authorize", "oss.cancel_authorize",
    "cacher.register", "cacher.update", "cacher.logout", "cacher.pay",
    "staking.bond", "staking.unbond", "staking.withdraw_unbonded",
    "staking.validate", "staking.chill", "staking.nominate",
    "im_online.heartbeat",
    "election.submit_solution", "election.submit_unsigned",
    "council.propose", "council.vote", "council.close",
    "technical_committee.propose", "technical_committee.vote",
    "technical_committee.close",
    "treasury.propose_spend", "treasury.propose_bounty",
    "sminer.faucet",
    "evm.deposit", "evm.withdraw", "evm.deploy", "evm.call",
    "contracts.deploy", "contracts.call", "contracts.upload_code",
    "contracts.instantiate",
    "assets.create", "assets.destroy", "assets.set_team",
    "assets.transfer_ownership",
    "assets.set_metadata", "assets.mint", "assets.burn",
    "assets.transfer", "assets.freeze", "assets.thaw",
    "assets.freeze_asset", "assets.thaw_asset", "assets.set_fee_asset",
    "indices.claim", "indices.free", "indices.transfer",
    "preimage.note_preimage", "preimage.unnote_preimage",
    "treasury.add_child_bounty", "treasury.award_child_bounty",
    "treasury.close_child_bounty",
    "tee_worker.register", "tee_worker.exit",
    "file_bank.create_bucket", "file_bank.delete_bucket",
    "file_bank.upload_declaration", "file_bank.transfer_report",
    "file_bank.delete_file", "file_bank.ownership_transfer",
    "file_bank.upload_filler", "file_bank.replace_file_report",
    "file_bank.delete_filler",
    "file_bank.generate_restoral_order", "file_bank.claim_restoral_order",
    "file_bank.restoral_order_complete", "file_bank.miner_exit_prep",
    "file_bank.miner_withdraw",
    "audit.save_challenge_info", "audit.submit_proof",
    "audit.submit_verify_result",
    "offences.report_equivocation",
}
DISPATCHABLE = SIGNED_CALLS | ROOT_ONLY

# calls exempt from fees: the reference submits these as validated
# unsigned / operational transactions (audit/src/lib.rs:739-772), so
# the TEE/miner/validator accounts need no spendable balance to keep
# the audit loop alive
FEELESS = {
    "audit.save_challenge_info",
    "audit.submit_proof",
    # NOT submit_verify_result: the reference dispatches it
    # ensure_signed and fee-paying (audit/src/lib.rs:484-491), and the
    # on-chain BLS pairing check makes it the single most expensive
    # dispatch — a feeless failure path would let a compromised TEE
    # burn every replica's CPU for free (fees stick on failed calls)
    # evidence-carrying, self-validating (ref submits equivocation
    # reports as validated unsigned transactions)
    "offences.report_equivocation",
    # ref im-online heartbeats are validated unsigned operational txs
    "im_online.heartbeat",
    # OCW-mined election solutions ride as validated unsigned txs in
    # the reference (lib.rs:834-863); admission fully verifies the
    # session signature + exact score, so the feeless lane can't be
    # spammed with junk
    "election.submit_unsigned",
}


# Per-dispatch weights: the JAX package's measured table, copied as
# it stands (weights_generated.py; the analog of the reference's
# frame-benchmarking-generated per-pallet weights.rs). Unit: one
# balances.transfer dispatch; scaled x10 here so weight fees stay
# significant next to byte fees. The table covers EVERY entry of
# DISPATCHABLE.
from .weights_generated import GENERATED_WEIGHTS

# Hand-set floors for heavy dispatches the measurement script has no
# scenario for yet (attestation/TEE setup is involved): they must not
# silently drop to weight 0 and become spammable.
HAND_WEIGHTS = {
    "tee_worker.register": 40,            # chain + report verification
    "audit.submit_verify_result": 50,     # BLS pairing check per verdict
    "file_bank.upload_filler": 30,
    "storage_handler.expansion_space": 10,
    "storage_handler.renewal_space": 10,
    "contracts.call": 20, "contracts.deploy": 20,
    "contracts.upload_code": 10,
}
CALL_WEIGHTS = {call: 10 * w
                for call, w in sorted(GENERATED_WEIGHTS.items())}
for _call, _floor in sorted(HAND_WEIGHTS.items()):
    # floors, not overrides: a future measured weight above the hand
    # value must win, or heavy dispatches get silently undercharged
    CALL_WEIGHTS[_call] = max(CALL_WEIGHTS.get(_call, 0), _floor)
WEIGHT_FEE = constants.TX_BYTE_FEE      # one weight unit == one byte


@dataclasses.dataclass
class RuntimeConfig:
    fragment_count: int = constants.FRAGMENT_COUNT
    era_blocks: int = constants.EPOCH_DURATION_BLOCKS * constants.SESSIONS_PER_ERA
    max_validators: int = 100                # ChainSpec default mirrored
    credit_period_blocks: int | None = None  # default: era_blocks
    audit_challenge_life: int | None = None  # default: audit module constant
    audit_verify_life: int | None = None
    genesis_spec_version: int = 0   # 0 -> current code version
    # reference defers offence slashes 28 eras (runtime :563); 0 =
    # immediate (dev/test default — deferral is config opt-in)
    slash_defer_eras: int = 0


class Runtime:
    def __init__(self, config: RuntimeConfig | None = None):
        self.config = config or RuntimeConfig()
        s = self.state = State()
        self.system = System(s)
        self.balances = Balances(s)
        self.storage_handler = StorageHandler(s, self.balances)
        self.sminer = Sminer(s, self.balances, self.storage_handler)
        self.scheduler = Scheduler(s)
        self.oss = Oss(s)
        self.cacher = Cacher(s, self.balances)
        self.assets = Assets(s, self.balances)
        self.indices = Indices(s, self.balances)
        self.preimage = Preimage(s, self.balances)
        self.staking = Staking(s, self.balances,
                               slash_defer_eras=self.config.slash_defer_eras)
        self.credit = SchedulerCredit(
            s, self.config.credit_period_blocks or self.config.era_blocks)
        self.tee_worker = TeeWorker(s, staking=self.staking,
                                    credit=self.credit)
        self.offences = Offences(s, self.staking, self.genesis_hash)
        self.im_online = ImOnline(s, self.staking, self.offences)
        self.file_bank = FileBank(s, self.balances, self.storage_handler,
                                  self.sminer, self.scheduler,
                                  fragment_count=self.config.fragment_count,
                                  oss=self.oss)
        # pass only explicitly configured lifetimes; Audit owns defaults
        audit_overrides = {
            k: v for k, v in {
                "challenge_life": self.config.audit_challenge_life,
                "verify_life": self.config.audit_verify_life,
            }.items() if v is not None}
        self.audit = Audit(
            s, self.sminer, tee_worker=self.tee_worker,
            storage_handler=self.storage_handler, file_bank=self.file_bank,
            **audit_overrides)
        self.pallets = {
            "system": self.system,
            "balances": self.balances,
            "storage_handler": self.storage_handler,
            "sminer": self.sminer,
            "scheduler": self.scheduler,
            "oss": self.oss,
            "cacher": self.cacher,
            "assets": self.assets,
            "indices": self.indices,
            "preimage": self.preimage,
            "staking": self.staking,
            "scheduler_credit": self.credit,
            "tee_worker": self.tee_worker,
            "file_bank": self.file_bank,
            "audit": self.audit,
            "offences": self.offences,
            "im_online": self.im_online,
        }
        self.treasury_pallet = Treasury(s, self.balances)
        self.council = Council(s, self)   # needs self.pallets at close()
        self.technical_committee = TechnicalCommittee(s, self)
        self.pallets["treasury"] = self.treasury_pallet
        self.pallets["council"] = self.council
        self.pallets["technical_committee"] = self.technical_committee
        self.evm = Evm(s, self.balances)
        self.pallets["evm"] = self.evm
        self.election = Election(s, self.balances, self.staking,
                                 self.credit, self.config.era_blocks,
                                 max_validators=self.config.max_validators)
        self.pallets["election"] = self.election
        self.contracts = Contracts(s)
        self.pallets["contracts"] = self.contracts
        # genesis stamps the CHAIN's spec version (ChainSpec field),
        # reproducible by any code version; upgrades activate via the
        # system.apply_runtime_upgrade extrinsic
        migrations.stamp_genesis(s, self.config.genesis_spec_version
                                 or migrations.SPEC_VERSION)
        self._update_randomness()

    # -- dispatch --------------------------------------------------------------
    def _resolve(self, call: str):
        if call not in DISPATCHABLE:
            raise DispatchError("system.UnknownCall", call)
        pallet_name, _, method_name = call.partition(".")
        pallet = self.pallets.get(pallet_name)
        fn = getattr(pallet, method_name, None)
        if pallet is None or fn is None:
            raise DispatchError("system.UnknownCall", call)
        return fn

    def apply_extrinsic(self, origin: str, call: str, *args, **kwargs):
        """RAW transactional dispatch: rolls back on DispatchError and
        re-raises (tests assert on error names like assert_noop!).

        This is the mock-runtime entry point — the analog of driving a
        FRAME pallet with RuntimeOrigin::signed(x) in unit tests. The
        node/network path never calls it: blocks carry
        ``SignedExtrinsic``s applied via :meth:`apply_signed`, which
        authenticates the origin first."""
        fn = self._resolve(call)
        if call in ROOT_ONLY:
            if origin != ROOT:
                raise DispatchError("system.BadOrigin", call)
            call_args = args
        else:
            call_args = (origin, *args)
        self.state.begin_tx()
        try:
            result = fn(*call_args, **kwargs)
        except DispatchError as e:
            self.state.rollback_tx()
            # reverted/trapping EVM executions still did metered work
            # (and paid for it): count it toward the base-fee market so
            # sustained reverting load moves the base fee like any
            # other demand (evm.Evm._fail)
            gas = getattr(e, "evm_gas_used", 0)
            if gas:
                self.evm._note_gas(gas)
            raise
        except Exception as e:
            # A validly-signed extrinsic can still carry arbitrary arg
            # *values* (codec.decode checks structure, not call
            # schemas): a TypeError/ValueError inside the call must
            # become a deterministic skip, never escape mid-block with
            # the tx open — the reference gets this for free from typed
            # SCALE call decoding (runtime/src/lib.rs:1564-1574).
            self.state.rollback_tx()
            raise DispatchError(
                "system.BadCallArgs", f"{call}: {type(e).__name__}") from e
        self.state.commit_tx()
        return result

    # -- signed pipeline (runtime/src/lib.rs:1564-1590) -----------------------
    def genesis_hash(self) -> bytes:
        return self.state.get("system", "genesis", default=b"\0" * 32)

    def set_genesis_hash(self, h: bytes) -> None:
        self.state.put("system", "genesis", h)

    def tx_fee(self, xt: SignedExtrinsic) -> int:
        """base + per-byte length + per-call weight fee
        (TransactionPayment's role; weights mirror the reference's
        measured per-dispatch weights)."""
        if xt.call in FEELESS:
            return 0
        return constants.TX_BASE_FEE + constants.TX_BYTE_FEE * len(xt) \
            + WEIGHT_FEE * CALL_WEIGHTS.get(xt.call, 0)

    @staticmethod
    def _check_shape(xt: SignedExtrinsic) -> None:
        """Structural validation of a (possibly peer-decoded)
        extrinsic: codec.decode constructs dataclasses without field
        checks, so every field is untrusted until proven well-formed.
        A self-signed-but-malformed tx must fail with a DispatchError
        (deterministic skip), never a TypeError mid-block.

        ``:`` is reserved for internal principals (the contracts VM
        names cross-contract callers ``contract:<addr>``,
        contracts.py:396): a signable account named like one could
        impersonate that contract to any callee doing caller-based
        auth, so colon names never enter the signed pipeline."""
        ok = (isinstance(xt.signer, str) and xt.signer
              and ":" not in xt.signer
              and isinstance(xt.public, bytes) and len(xt.public) == 32
              and isinstance(xt.nonce, int) and xt.nonce >= 0
              and isinstance(xt.call, str)
              and isinstance(xt.args, tuple)
              and isinstance(xt.kwargs, tuple)
              and all(isinstance(kv, tuple) and len(kv) == 2
                      and isinstance(kv[0], str) for kv in xt.kwargs)
              and isinstance(xt.signature, bytes)
              and len(xt.signature) == 64)
        if not ok:
            raise DispatchError("system.MalformedTransaction")

    def validate_signed(self, xt: SignedExtrinsic, *,
                        at_apply: bool = False,
                        pending_from_signer: int = 0) -> int:
        """Pre-dispatch validity (the SignedExtra checks): shape,
        signature over (genesis, nonce, call), account-key binding,
        sequential nonce, fee affordability. Raises DispatchError when
        invalid; returns (fee, asset_funding) so apply_signed charges
        exactly what was checked without re-resolving anything."""
        if not isinstance(xt, SignedExtrinsic):
            raise DispatchError("system.NotSigned", str(type(xt).__name__))
        self._check_shape(xt)
        if xt.call not in DISPATCHABLE:
            raise DispatchError("system.UnknownCall", xt.call)
        if not verify_signature(xt, self.genesis_hash()):
            raise DispatchError("system.BadSignature", xt.call)
        bound = self.system.account_key(xt.signer)
        if bound is not None and bound != xt.public:
            raise DispatchError("system.AccountKeyMismatch", xt.signer)
        expected = self.system.nonce(xt.signer) + pending_from_signer
        if xt.nonce != expected:
            raise DispatchError(
                "system.BadNonce", f"{xt.call}: {xt.nonce} != {expected}")
        fee = self.tx_fee(xt)
        # AssetTxPayment: an account preference + covering asset
        # balance satisfies affordability; else native tokens must.
        # The resolved funding is RETURNED so apply_signed charges
        # exactly what was checked (no re-resolution, no divergence).
        in_asset = self.assets.fee_in_asset(xt.signer, fee)
        if in_asset is None and self.balances.free(xt.signer) < fee:
            raise DispatchError("system.CannotPayFee", xt.signer)
        if at_apply and xt.call in ROOT_ONLY \
                and xt.signer != self.system.sudo():
            raise DispatchError("system.BadOrigin", xt.call)
        return fee, in_asset

    def apply_signed(self, xt: SignedExtrinsic):
        """Authenticated dispatch inside block execution. Signature,
        binding, and nonce are re-verified; the nonce bump, first-use
        key binding, and fee charge stick even if the call itself
        fails (frame-system semantics: replay protection and fees are
        not rolled back with the dispatch)."""
        fee, in_asset = self.validate_signed(xt, at_apply=True)
        self.system.bind_account_key(xt.signer, xt.public)
        self.system.bump_nonce(xt.signer)
        if fee:
            # 80% treasury / 20% block author (runtime/src/lib.rs:190-204);
            # accounts opted into AssetTxPayment pay in their chosen
            # asset when it covers the fee (assets.py)
            author = self.state.get("system", "author", default="")
            if in_asset is not None:
                aid, asset_fee = in_asset
                self.assets.charge_fee(xt.signer, aid, asset_fee,
                                       TREASURY, author)
            else:
                self.balances.transfer(xt.signer, TREASURY, fee * 8 // 10)
                self.balances.transfer(xt.signer, author or TREASURY,
                                       fee - fee * 8 // 10)
        origin = ROOT if xt.call in ROOT_ONLY else xt.signer
        return self.apply_extrinsic(origin, xt.call, *xt.args,
                                    **dict(xt.kwargs))

    def apply_in_block(self, xt) -> None:
        """Block-execution wrapper around :meth:`apply_signed`: never
        raises (a failed dispatch becomes a deterministic
        ExtrinsicFailed event, identical on every replica), and records
        the transaction-lifecycle artifacts the Ethereum RPC serves —
        tx-hash -> (block, index) plus a receipt with status, gas used,
        contract address, and the block-local log range (the
        pallet-ethereum / fc-rpc receipt mapping,
        node/src/rpc.rs:229-328). Receipts live in
        consensus state, so they reorg/rewind with their block."""
        from .. import codec

        block = self.state.block
        idx = self.state.get("ethereum", "count", block, default=0)
        log_start = self.evm.log_seq(block)
        call = getattr(xt, "call", "<malformed>")
        try:
            txhash = hashlib.sha256(codec.encode(xt)).digest()
        except Exception:
            txhash = None              # unencodable: skip the eth view
        try:
            self.apply_signed(xt)
        except DispatchError as e:
            self.state.deposit_event("system", "ExtrinsicFailed",
                                     call=call, error=e.name)
            status, error = 0, e.name
            gas_used = getattr(e, "evm_gas_used", 0) \
                or CALL_WEIGHTS.get(call, 0)
            contract = None
        else:
            status, error = 1, ""
            gas_used, contract = CALL_WEIGHTS.get(call, 0), None
            if call in ("evm.call", "evm.deploy"):
                gas_used, contract = self.state.get(
                    "evm", "last_exec", default=(0, None))
        if txhash is None:
            return
        prev = self.state.get("ethereum", "txloc", txhash)
        if prev is not None:
            # success-write-wins: a re-included duplicate (stale-nonce
            # replay by a later block author) must not re-point
            # eth_getTransactionReceipt at its failed dispatch — but a
            # SUCCESSFUL re-execution of a tx whose first inclusion
            # failed without consuming the nonce (e.g. CannotPayFee,
            # then funded) must supersede the failed record, or the
            # receipt would forever report failure for a transfer that
            # actually moved funds
            prev_rc = self.state.get("ethereum", "receipt", *prev)
            if status == 0 or (prev_rc is not None and prev_rc[3] == 1):
                return
            # overwrite path: the old block's receipt row stays (an
            # honest record of that block's failed attempt); only the
            # hash -> location mapping moves to the succeeding dispatch
        log_count = self.evm.log_seq(block) - log_start
        self.state.put("ethereum", "txloc", txhash, (block, idx))
        self.state.put("ethereum", "receipt", block, idx,
                       (txhash, getattr(xt, "signer", ""), call, status,
                        error, gas_used, contract, log_start, log_count))
        self.state.put("ethereum", "count", block, idx + 1)

    # receipts/logs retention: the eth view keeps this many recent
    # blocks in STATE (real chains serve older receipts from block
    # archives, not state — the repo's block store retains bodies, so
    # anything older is recomputable by replay). ~6.8 h at 6 s slots.
    ETH_HISTORY_BLOCKS = 4096
    # backlog catch-up: a chain upgrading onto this code may carry
    # arbitrarily many pre-pruner blocks; the cursor drains them a few
    # per block instead of only ever pruning block N - WINDOW
    # (review-caught), staying O(small) per block
    ETH_PRUNE_BATCH = 8

    def _prune_eth_history(self) -> None:
        target = self.state.block - self.ETH_HISTORY_BLOCKS
        if target < 0:
            return
        cursor = self.state.get("ethereum", "pruned_to", default=0)
        done = 0
        while cursor <= target and done < self.ETH_PRUNE_BATCH:
            self._prune_eth_block(cursor)
            cursor += 1
            done += 1
        if done:
            self.state.put("ethereum", "pruned_to", cursor)

    def _prune_eth_block(self, stale: int) -> None:
        count = self.state.get("ethereum", "count", stale, default=0)
        for idx in range(count):
            rc = self.state.get("ethereum", "receipt", stale, idx)
            if rc is not None and self.state.get(
                    "ethereum", "txloc", rc[0]) == (stale, idx):
                # only drop the mapping if it still points HERE — a
                # superseded failed inclusion's hash was re-pointed at
                # a newer (still-retained) successful receipt, which
                # must stay resolvable until ITS block ages out
                self.state.delete("ethereum", "txloc", rc[0])
            self.state.delete("ethereum", "receipt", stale, idx)
        if count:
            self.state.delete("ethereum", "count", stale)
        nlogs = self.state.get("evm", "log_seq", stale, default=0)
        for seq in range(nlogs):
            self.state.delete("evm", "logs", stale, seq)
        if nlogs:
            self.state.delete("evm", "log_seq", stale)

    # -- block execution ---------------------------------------------------------
    def _update_randomness(self) -> None:
        prev = self.state.get("system", "randomness", default=b"genesis")
        self.state.put("system", "randomness", hashlib.sha256(
            prev + self.state.block.to_bytes(8, "little")).digest())

    def set_randomness(self, randomness: bytes) -> None:
        """Consensus hook: epoch/VRF randomness replaces the fallback
        hash chain (reference ParentBlockRandomness)."""
        self.state.put("system", "randomness", randomness)

    def init_block(self, randomness: bytes | None = None,
                   author: str = "") -> None:
        """Advance one block and run on_initialize hooks in the
        reference's construct_runtime order (§3.4). ``randomness``
        comes from consensus (the parent VRF output); without it a
        deterministic hash chain stands in. ``author`` receives the
        20% fee share."""
        self.state.archive_events()
        self.state.block += 1
        self.state.put("system", "author", author)
        # the Timestamp role (pallet_timestamp, id 2): slots are fixed
        # 6 s, so the chain clock is DERIVED — block height times the
        # slot duration — rather than an author-supplied inherent (no
        # clock-skew surface, same monotonicity guarantee)
        self.state.put("system", "now_ms",
                       self.state.block * constants.MILLISECS_PER_BLOCK)
        if randomness is not None:
            self.set_randomness(randomness)
        else:
            self._update_randomness()
        self.audit.on_initialize()
        self.evm.on_initialize()      # base-fee market roll
        self._prune_eth_history()
        dead = self.storage_handler.on_initialize()
        self.file_bank.on_initialize(dead)
        self.credit.on_initialize()
        if self.state.block % self.config.era_blocks == 0:
            era = self.staking.current_era()
            self.im_online.era_check(era)
            self.staking.end_era(era)
            # due slashes land at the START of their apply_era, before
            # the new era's exposures are captured
            self.staking.apply_due_slashes()
            self.treasury_pallet.on_spend_period()
            self.staking.capture_exposures(era + 1)
            self.sminer.release_reward_tranches()
            # resolve the multi-phase election INSIDE block execution:
            # deposit moves/slashes and the queued-solution sweep must
            # be covered by the block's undo log (a reorg that rewinds
            # this block must rewind them too, or replicas diverge).
            # The node's session-rotation hook only READS the result.
            self.election.resolve(self.config.max_validators)
            # session rotation: audit keys follow the elected set
            elected = self.staking.electable()
            if elected:
                self.audit.set_keys(tuple(elected))
        for name, pallet, method, task_args in self.scheduler.take_due():
            self.state.begin_tx()
            try:
                getattr(self.pallets[pallet], method)(*task_args)
            except DispatchError as e:
                self.state.rollback_tx()
                self.state.deposit_event("scheduler", "TaskFailed",
                                         name=name, error=e.name)
            except Exception as e:
                self.state.rollback_tx()
                self.state.deposit_event(
                    "scheduler", "TaskFailed", name=name,
                    error=f"scheduler.TaskPanicked:{type(e).__name__}")
            else:
                self.state.commit_tx()

    def run_to_block(self, n: int) -> None:
        while self.state.block < n:
            self.init_block()

    def advance_blocks(self, n: int) -> None:
        self.run_to_block(self.state.block + n)

    # -- genesis helpers -----------------------------------------------------------
    def fund(self, who: str, amount: int) -> None:
        self.balances.mint(who, amount)
