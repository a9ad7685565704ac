"""User-side space market (reference: c-pallets/storage-handler).

Buy/expand/renew purchased space priced per GiB per 30 days, a
per-user space ledger (total/used/locked, state normal/frozen/dead)
with lease-expiry sweeps, and network-wide idle/service totals.
Mirrors c-pallets/storage-handler/src/lib.rs:
buy_space :178-200, expansion_space :211-269, renewal_space :276-311,
lock/unlock/consume :557-588, frozen sweep :494-555, StorageHandle
trait :658-673.
"""
from __future__ import annotations

import dataclasses

from .. import codec, constants
from .balances import Balances
from .state import DispatchError, State

PALLET = "storage_handler"
TREASURY = "treasury"

NORMAL = "normal"
FROZEN = "frozen"
DEAD = "dead"

FROZEN_GRACE_BLOCKS = 10 * constants.ONE_DAY_BLOCKS  # FrozenDays=10 (runtime :955-957)


@codec.register
@dataclasses.dataclass(frozen=True)
class OwnedSpace:
    total_space: int      # bytes
    used_space: int
    locked_space: int
    start: int            # block
    deadline: int         # block
    state: str            # NORMAL | FROZEN | DEAD

    @property
    def remaining_space(self) -> int:
        return self.total_space - self.used_space - self.locked_space


class StorageHandler:
    def __init__(self, state: State, balances: Balances):
        self.state = state
        self.balances = balances
        if not state.contains(PALLET, "unit_price"):
            # genesis UnitPrice: 30 DOLLARS per GiB per 30 days
            # (reference genesis builder lib.rs:145-165)
            state.put(PALLET, "unit_price", 30 * constants.DOLLARS)

    # -- queries -----------------------------------------------------------
    def unit_price(self) -> int:
        return self.state.get(PALLET, "unit_price")

    def owned_space(self, who: str) -> OwnedSpace | None:
        return self.state.get(PALLET, "owned", who)

    def total_idle_space(self) -> int:
        return self.state.get(PALLET, "total_idle", default=0)

    def total_service_space(self) -> int:
        return self.state.get(PALLET, "total_service", default=0)

    def purchased_space(self) -> int:
        return self.state.get(PALLET, "purchased", default=0)

    # -- extrinsics ----------------------------------------------------------
    def buy_space(self, who: str, gib_count: int) -> None:
        """First purchase: gib_count GiB for 30 days (lib.rs:178-200)."""
        if gib_count <= 0:
            raise DispatchError("storage_handler.InvalidGibCount")
        if self.owned_space(who) is not None:
            raise DispatchError("storage_handler.PurchasedSpace",
                                "use expansion/renewal")
        space = gib_count * constants.GIB
        self._check_available(space)
        price = gib_count * self.unit_price()
        self.balances.transfer(who, TREASURY, price)
        now = self.state.block
        self.state.put(PALLET, "owned", who, OwnedSpace(
            total_space=space, used_space=0, locked_space=0,
            start=now, deadline=now + constants.MONTH_BLOCKS, state=NORMAL))
        self.state.put(PALLET, "purchased", self.purchased_space() + space)
        self.state.deposit_event(PALLET, "BuySpace", who=who,
                                 space=space, price=price)

    def expansion_space(self, who: str, gib_count: int) -> None:
        """Add space for the remaining lease, pro-rata (lib.rs:211-269)."""
        if gib_count <= 0:
            raise DispatchError("storage_handler.InvalidGibCount")
        own = self._require_normal(who)
        remain_blocks = own.deadline - self.state.block
        if remain_blocks <= 0:
            raise DispatchError("storage_handler.LeaseExpired")
        space = gib_count * constants.GIB
        self._check_available(space)
        price = gib_count * self.unit_price() * remain_blocks // constants.MONTH_BLOCKS
        self.balances.transfer(who, TREASURY, price)
        self.state.put(PALLET, "owned", who, dataclasses.replace(
            own, total_space=own.total_space + space))
        self.state.put(PALLET, "purchased", self.purchased_space() + space)
        self.state.deposit_event(PALLET, "ExpansionSpace", who=who,
                                 space=space, price=price)

    def renewal_space(self, who: str, days: int) -> None:
        """Extend the lease by ``days`` (lib.rs:276-311)."""
        if days <= 0:
            raise DispatchError("storage_handler.InvalidDays")
        own = self.owned_space(who)
        if own is None:
            raise DispatchError("storage_handler.NotPurchasedSpace")
        if own.state == DEAD:
            raise DispatchError("storage_handler.LeaseDead")
        gib = own.total_space // constants.GIB
        price = gib * self.unit_price() * days // 30
        self.balances.transfer(who, TREASURY, price)
        self.state.put(PALLET, "owned", who, dataclasses.replace(
            own, deadline=own.deadline + days * constants.ONE_DAY_BLOCKS,
            state=NORMAL))
        self.state.deposit_event(PALLET, "RenewalSpace", who=who,
                                 days=days, price=price)

    # -- StorageHandle trait (consumed by file-bank; lib.rs:658-673) --------
    def lock_user_space(self, who: str, space: int) -> None:
        own = self._require_normal(who)
        if own.remaining_space < space:
            raise DispatchError("storage_handler.InsufficientStorage",
                                f"remaining {own.remaining_space} < {space}")
        self.state.put(PALLET, "owned", who, dataclasses.replace(
            own, locked_space=own.locked_space + space))

    def unlock_user_space(self, who: str, space: int) -> None:
        own = self._require_owned(who)
        self.state.put(PALLET, "owned", who, dataclasses.replace(
            own, locked_space=max(0, own.locked_space - space)))

    def unlock_and_used_user_space(self, who: str, locked: int, used: int) -> None:
        """Deal completion: locked space becomes used (lib.rs:581)."""
        own = self._require_owned(who)
        self.state.put(PALLET, "owned", who, dataclasses.replace(
            own, locked_space=max(0, own.locked_space - locked),
            used_space=own.used_space + used))

    def free_used_space(self, who: str, space: int) -> None:
        own = self.owned_space(who)
        if own is None:
            return  # owner ledger may already be dead/cleared
        self.state.put(PALLET, "owned", who, dataclasses.replace(
            own, used_space=max(0, own.used_space - space)))

    def check_user_space(self, who: str, space: int) -> bool:
        own = self.owned_space(who)
        return own is not None and own.state == NORMAL \
            and own.remaining_space >= space

    # network totals (driven by sminer registrations / file lifecycle)
    def add_total_idle_space(self, space: int) -> None:
        self.state.put(PALLET, "total_idle", self.total_idle_space() + space)

    def sub_total_idle_space(self, space: int) -> None:
        self.state.put(PALLET, "total_idle",
                       max(0, self.total_idle_space() - space))

    def add_total_service_space(self, space: int) -> None:
        self.state.put(PALLET, "total_service",
                       self.total_service_space() + space)

    def sub_total_service_space(self, space: int) -> None:
        self.state.put(PALLET, "total_service",
                       max(0, self.total_service_space() - space))

    def sub_purchased_space(self, space: int) -> None:
        self.state.put(PALLET, "purchased",
                       max(0, self.purchased_space() - space))

    # -- hooks ----------------------------------------------------------------
    def on_initialize(self) -> list[str]:
        """Lease sweep (frozen_task, lib.rs:494-555): normal leases past
        deadline freeze; frozen leases past the grace period die.
        Returns the accounts that died this block (file-bank GCs their
        files, SURVEY §3.4)."""
        now = self.state.block
        died = []
        for (who,), own in self.state.iter_prefix(PALLET, "owned"):
            if own.state == NORMAL and now > own.deadline:
                self.state.put(PALLET, "owned", who,
                               dataclasses.replace(own, state=FROZEN))
                self.state.deposit_event(PALLET, "LeaseFrozen", who=who)
            elif own.state == FROZEN and now > own.deadline + FROZEN_GRACE_BLOCKS:
                self.state.put(PALLET, "owned", who,
                               dataclasses.replace(own, state=DEAD))
                self.state.deposit_event(PALLET, "LeaseDead", who=who)
                died.append(who)
        return died

    def remove_dead_lease(self, who: str) -> None:
        """Called by file-bank after GCing a dead user's files."""
        own = self.owned_space(who)
        if own is not None:
            self.state.put(PALLET, "purchased",
                           max(0, self.purchased_space() - own.total_space))
            self.state.delete(PALLET, "owned", who)

    # -- internals -----------------------------------------------------------
    def _require_owned(self, who: str) -> OwnedSpace:
        own = self.owned_space(who)
        if own is None:
            raise DispatchError("storage_handler.NotPurchasedSpace")
        return own

    def _require_normal(self, who: str) -> OwnedSpace:
        own = self._require_owned(who)
        if own.state != NORMAL:
            raise DispatchError("storage_handler.LeaseNotNormal", own.state)
        return own

    def _check_available(self, space: int) -> None:
        """Purchases are capped by unsold idle capacity (lib.rs:178-200)."""
        if self.purchased_space() + space > self.total_idle_space():
            raise DispatchError("storage_handler.InsufficientAvailableSpace")
