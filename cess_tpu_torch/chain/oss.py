"""OSS (off-chain storage gateway) registry + user authorization.

Reference: c-pallets/oss — authorize/cancel_authorize/register/update/
destroy (src/lib.rs:85-157) and the OssFindAuthor trait (:161-172)
consumed by file-bank's permission check (functions.rs:516-521).
"""
from __future__ import annotations

import dataclasses

from .. import codec
from .state import DispatchError, State

PALLET = "oss"


@codec.register
@dataclasses.dataclass(frozen=True)
class OssInfo:
    peer_id: bytes
    domain: str


class Oss:
    def __init__(self, state: State):
        self.state = state

    # -- gateway registry ----------------------------------------------------
    def register(self, who: str, peer_id: bytes, domain: str = "") -> None:
        if self.state.contains(PALLET, "oss", who):
            raise DispatchError("oss.Registered")
        self.state.put(PALLET, "oss", who, OssInfo(peer_id, domain))
        self.state.deposit_event(PALLET, "OssRegister", who=who)

    def update(self, who: str, peer_id: bytes, domain: str = "") -> None:
        if not self.state.contains(PALLET, "oss", who):
            raise DispatchError("oss.UnRegister")
        self.state.put(PALLET, "oss", who, OssInfo(peer_id, domain))
        self.state.deposit_event(PALLET, "OssUpdate", who=who)

    def destroy(self, who: str) -> None:
        if not self.state.contains(PALLET, "oss", who):
            raise DispatchError("oss.UnRegister")
        self.state.delete(PALLET, "oss", who)
        self.state.deposit_event(PALLET, "OssDestroy", who=who)

    def oss_info(self, who: str) -> OssInfo | None:
        return self.state.get(PALLET, "oss", who)

    # -- authorization --------------------------------------------------------
    def authorize(self, owner: str, operator: str) -> None:
        ops = self.state.get(PALLET, "auth", owner, default=())
        if operator in ops:
            raise DispatchError("oss.Authorized")
        self.state.put(PALLET, "auth", owner, ops + (operator,))
        self.state.deposit_event(PALLET, "Authorize", owner=owner,
                                 operator=operator)

    def cancel_authorize(self, owner: str, operator: str) -> None:
        ops = self.state.get(PALLET, "auth", owner, default=())
        if operator not in ops:
            raise DispatchError("oss.AuthorizationNotExist")
        self.state.put(PALLET, "auth", owner,
                       tuple(o for o in ops if o != operator))
        self.state.deposit_event(PALLET, "CancelAuthorize", owner=owner,
                                 operator=operator)

    # -- OssFindAuthor trait ---------------------------------------------------
    def is_authorized(self, owner: str, operator: str) -> bool:
        return operator in self.state.get(PALLET, "auth", owner, default=())
