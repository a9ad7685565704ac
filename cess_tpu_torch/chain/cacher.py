"""CDN/cacher registry + batched download micropayments.

Reference: c-pallets/cacher — register/update/logout/pay
(src/lib.rs:88-150) with CacherInfo{payee, peer_id, byte_price} and
Bill{id, to (cacher), amount} (src/types.rs:11-28). ``pay`` settles a
batch of signed download bills from the caller's balance.
"""
from __future__ import annotations

import dataclasses

from .. import codec
from .balances import Balances
from .state import DispatchError, State

PALLET = "cacher"


@codec.register
@dataclasses.dataclass(frozen=True)
class CacherInfo:
    payee: str
    peer_id: bytes
    byte_price: int     # token units per byte


@codec.register
@dataclasses.dataclass(frozen=True)
class Bill:
    id: bytes
    to: str             # cacher account
    amount: int


class Cacher:
    def __init__(self, state: State, balances: Balances):
        self.state = state
        self.balances = balances

    def register(self, who: str, payee: str, peer_id: bytes,
                 byte_price: int) -> None:
        if self.state.contains(PALLET, "cacher", who):
            raise DispatchError("cacher.Registered")
        self.state.put(PALLET, "cacher", who,
                       CacherInfo(payee, peer_id, byte_price))
        self.state.deposit_event(PALLET, "Register", who=who)

    def update(self, who: str, payee: str, peer_id: bytes,
               byte_price: int) -> None:
        if not self.state.contains(PALLET, "cacher", who):
            raise DispatchError("cacher.UnRegister")
        self.state.put(PALLET, "cacher", who,
                       CacherInfo(payee, peer_id, byte_price))
        self.state.deposit_event(PALLET, "Update", who=who)

    def logout(self, who: str) -> None:
        if not self.state.contains(PALLET, "cacher", who):
            raise DispatchError("cacher.UnRegister")
        self.state.delete(PALLET, "cacher", who)
        self.state.deposit_event(PALLET, "Logout", who=who)

    def cacher_info(self, who: str) -> CacherInfo | None:
        return self.state.get(PALLET, "cacher", who)

    def pay(self, who: str, bills: list[Bill]) -> None:
        """Settle download bills; duplicate bill ids are rejected
        (replay protection)."""
        for bill in bills:
            info = self.cacher_info(bill.to)
            if info is None:
                raise DispatchError("cacher.UnRegister", bill.to)
            if self.state.contains(PALLET, "paid", bill.id):
                raise DispatchError("cacher.BillReplayed", bill.id.hex())
            self.balances.transfer(who, info.payee, bill.amount)
            self.state.put(PALLET, "paid", bill.id, True)
            self.state.deposit_event(PALLET, "Pay", who=who, to=bill.to,
                                     amount=bill.amount)
