"""Short account indices + preimage store (reference: pallet_indices
id 7 and pallet_preimage id 5, runtime/src/lib.rs:1486-1496).

- Indices: claimable small integers resolving to accounts (the
  short-address lookup the reference wires as its AccountId lookup).
  claim/free/transfer with a reserved deposit so squatting costs.
- Preimage: content-addressed blob store for governance calls too big
  to inline in a motion: note_preimage reserves a size-scaled deposit,
  unnote refunds it; anyone can fetch by hash. Bounded size.
"""
from __future__ import annotations

import hashlib

from .state import DispatchError, State

PALLET = "indices"
PRE_PALLET = "preimage"

INDEX_DEPOSIT = 10 ** 10          # 0.01 DOLLARS
PREIMAGE_BYTE_DEPOSIT = 10 ** 6
MAX_PREIMAGE = 128 * 1024


class Indices:
    def __init__(self, state: State, balances):
        self.state = state
        self.balances = balances

    def lookup(self, index: int) -> str | None:
        v = self.state.get(PALLET, "index", index)
        return v[0] if v is not None else None

    def claim(self, who: str, index: int) -> None:
        if not isinstance(index, int) or isinstance(index, bool) \
                or index < 0:
            raise DispatchError("indices.BadIndex")
        if self.state.contains(PALLET, "index", index):
            raise DispatchError("indices.InUse", str(index))
        self.balances.reserve(who, INDEX_DEPOSIT)
        self.state.put(PALLET, "index", index, (who, INDEX_DEPOSIT))
        self.state.deposit_event(PALLET, "IndexAssigned", who=who,
                                 index=index)

    def free(self, who: str, index: int) -> None:
        v = self.state.get(PALLET, "index", index)
        if v is None or v[0] != who:
            raise DispatchError("indices.NotOwner", str(index))
        self.balances.unreserve(who, v[1])
        self.state.delete(PALLET, "index", index)
        self.state.deposit_event(PALLET, "IndexFreed", index=index)

    def transfer(self, who: str, index: int, new: str) -> None:
        """Move the index (deposit moves with it: the old owner is
        refunded, the new owner pays)."""
        v = self.state.get(PALLET, "index", index)
        if v is None or v[0] != who:
            raise DispatchError("indices.NotOwner", str(index))
        if not isinstance(new, str) or not new:
            raise DispatchError("indices.BadIndex", "owner")
        self.balances.reserve(new, INDEX_DEPOSIT)
        self.balances.unreserve(who, v[1])
        self.state.put(PALLET, "index", index, (new, INDEX_DEPOSIT))
        self.state.deposit_event(PALLET, "IndexAssigned", who=new,
                                 index=index)


class Preimage:
    def __init__(self, state: State, balances):
        self.state = state
        self.balances = balances

    def note_preimage(self, who: str, blob: bytes) -> bytes:
        if not isinstance(blob, bytes) or not blob \
                or len(blob) > MAX_PREIMAGE:
            raise DispatchError("preimage.TooBig")
        h = hashlib.sha256(blob).digest()
        if self.state.contains(PRE_PALLET, "blob", h):
            raise DispatchError("preimage.AlreadyNoted")
        deposit = len(blob) * PREIMAGE_BYTE_DEPOSIT
        self.balances.reserve(who, deposit)
        self.state.put(PRE_PALLET, "blob", h, (who, deposit, blob))
        self.state.deposit_event(PRE_PALLET, "Noted", hash=h,
                                 size=len(blob))
        return h

    def unnote_preimage(self, who: str, h: bytes) -> None:
        v = self.state.get(PRE_PALLET, "blob", h)
        if v is None or v[0] != who:
            raise DispatchError("preimage.NotNoter")
        self.balances.unreserve(who, v[1])
        self.state.delete(PRE_PALLET, "blob", h)
        self.state.deposit_event(PRE_PALLET, "Cleared", hash=h)

    def preimage(self, h: bytes) -> bytes | None:
        v = self.state.get(PRE_PALLET, "blob", h)
        return v[2] if v is not None else None
