"""Storage-miner registry & economics (reference: c-pallets/sminer).

Register with staked collateral, idle/service/locked space ledger,
power = 30% idle + 70% service, proportional reward orders with
20%-immediate / 80%-over-RELEASE_NUMBER-tranches release, punishment
by collateral slash with state freeze below the collateral limit.
Mirrors c-pallets/sminer/src/: regnstk lib.rs:261-307,
power calc lib.rs:665-673, calculate_miner_reward lib.rs:675-733,
punish tiers lib.rs:735-807, collateral limit lib.rs:809-815,
MinerControl trait lib.rs:931-1110.
"""
from __future__ import annotations

import dataclasses

from .. import codec, constants
from .balances import Balances
from .state import DispatchError, State

PALLET = "sminer"
REWARD_POOL = "sminer_reward_pool"
FAUCET_ACCOUNT = "faucet"
FAUCET_AMOUNT = 10_000 * constants.DOLLARS   # ref lib.rs:478 (10000 TCESS)
FAUCET_INTERVAL = constants.ONE_DAY_BLOCKS   # ref one-day rate limit :470

POSITIVE = "positive"   # in service
FROZEN = "frozen"       # collateral below limit; replenish to recover
EXITING = "exiting"     # exit prep done, fragments being restored
LOCKED = "locked"       # force-exited by punishment


@codec.register
@dataclasses.dataclass(frozen=True)
class MinerInfo:
    beneficiary: str
    peer_id: bytes
    collateral: int
    debt: int
    state: str
    idle_space: int
    service_space: int
    lock_space: int


@codec.register
@dataclasses.dataclass(frozen=True)
class RewardOrder:
    total: int            # full order amount
    released: int         # paid out so far
    each_share: int       # per-tranche amount for the 80% part
    tranches_left: int


class Sminer:
    def __init__(self, state: State, balances: Balances, storage_handler=None):
        self.state = state
        self.balances = balances
        self.storage_handler = storage_handler  # set by runtime wiring

    # -- queries -----------------------------------------------------------
    def miner(self, who: str) -> MinerInfo | None:
        return self.state.get(PALLET, "miner", who)

    def all_miners(self) -> list[str]:
        return [k[0] for k, _ in self.state.iter_prefix(PALLET, "miner")]

    def is_positive(self, who: str) -> bool:
        m = self.miner(who)
        return m is not None and m.state == POSITIVE

    def power_of(self, m: MinerInfo) -> int:
        """power = idle*30% + service*70% (lib.rs:665-673)."""
        return (m.idle_space * constants.IDLE_POWER_WEIGHT_NUM
                + m.service_space * constants.SERVICE_POWER_WEIGHT_NUM
                ) // constants.POWER_WEIGHT_DEN

    def collateral_limit(self, m: MinerInfo) -> int:
        """2000 CESS x (1 + power/TiB) (lib.rs:809-815, constants.rs:27)."""
        return constants.BASE_COLLATERAL * constants.DOLLARS \
            * (1 + self.power_of(m) // constants.TIB)

    # -- extrinsics ----------------------------------------------------------
    def regnstk(self, who: str, beneficiary: str, peer_id: bytes,
                staked: int) -> None:
        """Register with staked collateral (lib.rs:261-307)."""
        if self.miner(who) is not None:
            raise DispatchError("sminer.AlreadyRegistered")
        base = constants.BASE_COLLATERAL * constants.DOLLARS
        if staked < base:
            raise DispatchError("sminer.CollateralNotUp",
                                f"{staked} < {base}")
        self.balances.reserve(who, staked)
        self.state.put(PALLET, "miner", who, MinerInfo(
            beneficiary=beneficiary, peer_id=peer_id, collateral=staked,
            debt=0, state=POSITIVE, idle_space=0, service_space=0,
            lock_space=0))
        self.state.deposit_event(PALLET, "Registered", who=who, staked=staked)

    def increase_collateral(self, who: str, amount: int) -> None:
        """Top up collateral; clears debt first, may unfreeze (lib.rs)."""
        m = self._require(who)
        self.balances.reserve(who, amount)
        remaining = amount
        debt = m.debt
        if debt > 0:
            pay = min(debt, remaining)
            debt -= pay
            remaining -= pay
            # debt repayment goes to the reward pool
            self.balances.slash_reserved(who, pay, REWARD_POOL)
        m = dataclasses.replace(m, collateral=m.collateral + remaining, debt=debt)
        if m.state == FROZEN and debt == 0 \
                and m.collateral >= self.collateral_limit(m):
            m = dataclasses.replace(m, state=POSITIVE)
            self.state.deposit_event(PALLET, "MinerUnfrozen", who=who)
        self.state.put(PALLET, "miner", who, m)
        self.state.deposit_event(PALLET, "CollateralIncreased",
                                 who=who, amount=amount)

    def faucet(self, who: str, target: str) -> None:
        """Dev/testnet faucet: dispense FAUCET_AMOUNT to ``target`` at
        most once per FAUCET_INTERVAL blocks, from the genesis faucet
        account — the reference's sminer faucet with its one-day rate
        limit (c-pallets/sminer/src/lib.rs:460-498). Anyone may pull
        for any target (matches the reference: the extrinsic takes a
        destination AccountId)."""
        if not isinstance(target, str) or not target:
            raise DispatchError("sminer.BadFaucetTarget")
        last = self.state.get(PALLET, "faucet_last", target, default=None)
        now = self.state.block
        if last is not None and now < last + FAUCET_INTERVAL:
            raise DispatchError("sminer.FaucetUsedToday", target)
        if self.balances.free(FAUCET_ACCOUNT) < FAUCET_AMOUNT:
            raise DispatchError("sminer.FaucetEmpty")
        self.balances.transfer(FAUCET_ACCOUNT, target, FAUCET_AMOUNT)
        self.state.put(PALLET, "faucet_last", target, now)
        self.state.deposit_event(PALLET, "FaucetDispensed", who=who,
                                 target=target, amount=FAUCET_AMOUNT)

    def update_beneficiary(self, who: str, beneficiary: str) -> None:
        m = self._require(who)
        self.state.put(PALLET, "miner", who,
                       dataclasses.replace(m, beneficiary=beneficiary))

    def update_peer_id(self, who: str, peer_id: bytes) -> None:
        m = self._require(who)
        self.state.put(PALLET, "miner", who,
                       dataclasses.replace(m, peer_id=peer_id))

    def commit_filler_seed(self, who: str, commitment: bytes) -> None:
        """One-time commitment to the miner's PoIS-direction filler
        seed (node/offchain.py slow_filler_bytes): the TEE certifies
        secret-seeded fillers only against this on-chain value.
        Immutable — rotating the seed would orphan certified fillers."""
        self._require(who)
        if not isinstance(commitment, bytes) or len(commitment) != 32:
            raise DispatchError("sminer.BadCommitment")
        if self.state.contains(PALLET, "filler_seed", who):
            raise DispatchError("sminer.SeedAlreadyCommitted", who)
        self.state.put(PALLET, "filler_seed", who, commitment)
        self.state.deposit_event(PALLET, "FillerSeedCommitted", who=who)

    def filler_seed_commitment_of(self, who: str) -> bytes | None:
        return self.state.get(PALLET, "filler_seed", who)

    # -- MinerControl trait (lib.rs:931-1110) --------------------------------
    def add_miner_idle_space(self, who: str, space: int) -> None:
        """Filler upload certified: miner gains idle space."""
        m = self._require(who)
        self.state.put(PALLET, "miner", who,
                       dataclasses.replace(m, idle_space=m.idle_space + space))
        if self.storage_handler:
            self.storage_handler.add_total_idle_space(space)

    def lock_space(self, who: str, space: int) -> None:
        """Reserve idle space for an assigned deal (lib.rs)."""
        m = self._require(who)
        if m.idle_space < space:
            raise DispatchError("sminer.InsufficientIdleSpace")
        self.state.put(PALLET, "miner", who, dataclasses.replace(
            m, idle_space=m.idle_space - space,
            lock_space=m.lock_space + space))

    def unlock_space(self, who: str, space: int) -> None:
        """Deal failed: locked space returns to idle."""
        m = self.miner(who)
        if m is None:
            return
        freed = min(m.lock_space, space)
        self.state.put(PALLET, "miner", who, dataclasses.replace(
            m, lock_space=m.lock_space - freed,
            idle_space=m.idle_space + freed))

    def unlock_space_to_service(self, who: str, space: int) -> None:
        """Deal complete (calculate_end): locked -> service
        (lib.rs:1002-1009)."""
        m = self._require(who)
        moved = min(m.lock_space, space)
        self.state.put(PALLET, "miner", who, dataclasses.replace(
            m, lock_space=m.lock_space - moved,
            service_space=m.service_space + moved))
        if self.storage_handler:
            self.storage_handler.sub_total_idle_space(moved)
            self.storage_handler.add_total_service_space(moved)

    def add_miner_service_space(self, who: str, space: int) -> None:
        """Restoral completion transfers fragment ownership."""
        m = self._require(who)
        self.state.put(PALLET, "miner", who, dataclasses.replace(
            m, service_space=m.service_space + space))

    def sub_miner_service_space(self, who: str, space: int) -> None:
        m = self.miner(who)
        if m is None:
            return
        self.state.put(PALLET, "miner", who, dataclasses.replace(
            m, service_space=max(0, m.service_space - space)))

    def get_miner_idle_space(self, who: str) -> int:
        m = self.miner(who)
        return m.idle_space if m else 0

    # -- rewards (lib.rs:675-733) --------------------------------------------
    def reward_pool_balance(self) -> int:
        return self.balances.free(REWARD_POOL)

    def calculate_miner_reward(self, who: str, total_reward: int,
                               total_idle: int, total_service: int,
                               snap_idle: int, snap_service: int) -> None:
        """Create a reward order proportional to snapshotted power:
        20% released immediately, 80% over RELEASE_NUMBER tranches."""
        m = self._require(who)
        total_power = (total_idle * constants.IDLE_POWER_WEIGHT_NUM
                       + total_service * constants.SERVICE_POWER_WEIGHT_NUM)
        if total_power == 0:
            return
        my_power = (snap_idle * constants.IDLE_POWER_WEIGHT_NUM
                    + snap_service * constants.SERVICE_POWER_WEIGHT_NUM)
        order_total = total_reward * my_power // total_power
        if order_total == 0:
            return
        immediate = order_total * constants.REWARD_IMMEDIATE_NUM \
            // constants.REWARD_IMMEDIATE_DEN
        rest = order_total - immediate
        each = rest // constants.RELEASE_NUMBER
        orders = self.state.get(PALLET, "reward_orders", who, default=())
        orders = orders + (RewardOrder(
            total=order_total, released=immediate, each_share=each,
            tranches_left=constants.RELEASE_NUMBER),)
        self.state.put(PALLET, "reward_orders", who, orders)
        self._payout(who, m.beneficiary, immediate)
        self.state.deposit_event(PALLET, "RewardOrdered", who=who,
                                 total=order_total, immediate=immediate)

    def release_reward_tranches(self) -> None:
        """Era hook: release one tranche of every open order."""
        for (who,), orders in list(self.state.iter_prefix(PALLET, "reward_orders")):
            m = self.miner(who)
            if m is None:
                self.state.delete(PALLET, "reward_orders", who)
                continue
            new_orders = []
            pay = 0
            for o in orders:
                if o.tranches_left <= 0:
                    continue
                amt = o.each_share if o.tranches_left > 1 \
                    else o.total - o.released  # remainder in last tranche
                pay += amt
                o = dataclasses.replace(o, released=o.released + amt,
                                        tranches_left=o.tranches_left - 1)
                if o.tranches_left > 0:
                    new_orders.append(o)
            if new_orders:
                self.state.put(PALLET, "reward_orders", who, tuple(new_orders))
            else:
                self.state.delete(PALLET, "reward_orders", who)
            if pay:
                self._payout(who, m.beneficiary, pay)

    def _payout(self, who: str, beneficiary: str, amount: int) -> None:
        pool = self.balances.free(REWARD_POOL)
        amount = min(amount, pool)
        if amount:
            self.balances.transfer(REWARD_POOL, beneficiary, amount)
            self.state.deposit_event(PALLET, "RewardPaid", who=who,
                                     amount=amount)

    # -- punishment (lib.rs:735-807) -----------------------------------------
    def deposit_punish(self, who: str, amount: int) -> None:
        """Slash collateral into the reward pool; shortfall becomes debt
        and the miner freezes until replenished."""
        m = self._require(who)
        taken = self.balances.slash_reserved(who, min(amount, m.collateral),
                                             REWARD_POOL)
        new_collateral = m.collateral - taken
        debt = m.debt + (amount - taken)
        m = dataclasses.replace(m, collateral=new_collateral, debt=debt)
        limit = self.collateral_limit(m)
        if (new_collateral < limit or debt > 0) and m.state == POSITIVE:
            m = dataclasses.replace(m, state=FROZEN)
            self.state.deposit_event(PALLET, "MinerFrozen", who=who)
        self.state.put(PALLET, "miner", who, m)
        self.state.deposit_event(PALLET, "Punished", who=who, amount=amount)

    def idle_punish(self, who: str) -> None:
        """Failed idle-proof audit (fault tolerance exceeded)."""
        m = self._require(who)
        self.deposit_punish(who, self.collateral_limit(m) // 10)

    def service_punish(self, who: str) -> None:
        m = self._require(who)
        self.deposit_punish(who, self.collateral_limit(m) // 10)

    def clear_punish(self, who: str, strike: int) -> None:
        """Missed challenge entirely: 30%/60%/100% of the collateral
        limit by consecutive strike (audit lib.rs:614-655)."""
        m = self._require(who)
        tier = constants.CLEAR_PUNISH_TIERS[
            min(strike, len(constants.CLEAR_PUNISH_TIERS)) - 1]
        self.deposit_punish(who, self.collateral_limit(m) * tier // 100)

    # -- exit ------------------------------------------------------------------
    def begin_exit(self, who: str) -> MinerInfo:
        m = self._require(who)
        if m.state != POSITIVE:
            raise DispatchError("sminer.StateNotPositive", m.state)
        if m.lock_space:
            raise DispatchError("sminer.PendingDeals")
        m = dataclasses.replace(m, state=EXITING)
        self.state.put(PALLET, "miner", who, m)
        if self.storage_handler:
            self.storage_handler.sub_total_idle_space(m.idle_space)
        self.state.deposit_event(PALLET, "MinerExitPrep", who=who)
        return m

    def force_exit(self, who: str) -> MinerInfo | None:
        """Third clear-punish strike: lock the miner (audit escalation)."""
        m = self.miner(who)
        if m is None:
            return None
        m = dataclasses.replace(m, state=LOCKED)
        self.state.put(PALLET, "miner", who, m)
        if self.storage_handler:
            self.storage_handler.sub_total_idle_space(m.idle_space)
        self.state.deposit_event(PALLET, "MinerForceExit", who=who)
        return m

    def withdraw(self, who: str) -> None:
        """After exit cooling: unreserve remaining collateral, drop the
        registration (file-bank gates this on restoral completion)."""
        m = self._require(who)
        if m.state not in (EXITING, LOCKED):
            raise DispatchError("sminer.NotExited")
        self.balances.unreserve(who, m.collateral)
        self.state.delete(PALLET, "miner", who)
        self.state.delete(PALLET, "reward_orders", who)
        self.state.deposit_event(PALLET, "MinerWithdrawn", who=who,
                                 collateral=m.collateral)

    # -- internals --------------------------------------------------------------
    def _require(self, who: str) -> MinerInfo:
        m = self.miner(who)
        if m is None:
            raise DispatchError("sminer.NotMiner", who)
        return m
