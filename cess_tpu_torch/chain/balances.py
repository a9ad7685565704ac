"""Account balances: free/reserved, transfers, slashes, issuance.

The reference uses Substrate pallet-balances; this provides the subset
the CESS pallets consume: transfer, reserve/unreserve (miner collateral,
space payments), slash (punishments), and mint (era rewards inflow).
Fees/locks/vesting are out of scope for the domain logic.
"""
from __future__ import annotations

from .state import DispatchError, State

PALLET = "balances"


class Balances:
    def __init__(self, state: State):
        self.state = state

    # -- queries -----------------------------------------------------------
    def free(self, who: str) -> int:
        return self.state.get(PALLET, "free", who, default=0)

    def reserved(self, who: str) -> int:
        return self.state.get(PALLET, "reserved", who, default=0)

    def total_issuance(self) -> int:
        return self.state.get(PALLET, "issuance", default=0)

    # -- genesis / issuance --------------------------------------------------
    def mint(self, who: str, amount: int) -> None:
        assert amount >= 0
        self.state.put(PALLET, "free", who, self.free(who) + amount)
        self.state.put(PALLET, "issuance", self.total_issuance() + amount)

    def burn(self, who: str, amount: int) -> None:
        """Remove from free balance and issuance (e.g. fee burn)."""
        self._withdraw_free(who, amount)
        self.state.put(PALLET, "issuance", self.total_issuance() - amount)

    # -- operations ----------------------------------------------------------
    def _withdraw_free(self, who: str, amount: int) -> None:
        f = self.free(who)
        if f < amount:
            raise DispatchError("balances.InsufficientBalance",
                                f"{who} has {f} < {amount}")
        self.state.put(PALLET, "free", who, f - amount)

    def transfer(self, src: str, dst: str, amount: int) -> None:
        if amount < 0:
            raise DispatchError("balances.InvalidAmount")
        self._withdraw_free(src, amount)
        self.state.put(PALLET, "free", dst, self.free(dst) + amount)
        self.state.deposit_event(PALLET, "Transfer",
                                 src=src, dst=dst, amount=amount)

    def reserve(self, who: str, amount: int) -> None:
        self._withdraw_free(who, amount)
        self.state.put(PALLET, "reserved", who, self.reserved(who) + amount)

    def unreserve(self, who: str, amount: int) -> int:
        """Release up to ``amount`` from reserve; returns actually freed."""
        r = self.reserved(who)
        freed = min(r, amount)
        self.state.put(PALLET, "reserved", who, r - freed)
        self.state.put(PALLET, "free", who, self.free(who) + freed)
        return freed

    def slash_reserved(self, who: str, amount: int, beneficiary: str | None = None) -> int:
        """Take up to ``amount`` from reserve (punishments). Slashed funds
        go to ``beneficiary`` (e.g. the treasury/reward pool) or are burnt."""
        r = self.reserved(who)
        taken = min(r, amount)
        self.state.put(PALLET, "reserved", who, r - taken)
        if beneficiary is not None:
            self.state.put(PALLET, "free", beneficiary,
                           self.free(beneficiary) + taken)
        else:
            self.state.put(PALLET, "issuance", self.total_issuance() - taken)
        return taken
