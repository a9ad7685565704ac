"""System pallet: account identity, nonces, session keys, sudo.

The reference authenticates every extrinsic through the frame-system +
SignedExtra pipeline (signature over (call, extra, genesis), nonce
check, fee withdrawal; runtime/src/lib.rs:1564-1590).
Here the same responsibilities live in one pallet:

- account-key binding: an account (a human-readable alias; the
  reference's AccountId IS the pubkey, the alias is this framework's
  dev ergonomics) is bound to an ed25519 public key at genesis or on
  first signed use; every later extrinsic must verify against it.
- nonce: strictly sequential per account, consumed even when the
  dispatch itself fails (replay protection, like frame-system).
- session keys: validators register the ed25519 key their offchain
  worker signs audit proposals with (the reference's SessionKeys
  ``audit`` entry, runtime/src/lib.rs:150-157).
- sudo: dev-chain root origin (the reference's pallet-sudo role);
  governance (round 2+) layers council approval on top.
"""
from __future__ import annotations

from .state import DispatchError, State

PALLET = "system"


class System:
    def __init__(self, state: State):
        self.state = state

    # -- account keys ---------------------------------------------------------
    def account_key(self, who: str) -> bytes | None:
        return self.state.get(PALLET, "account_key", who)

    def bind_account_key(self, who: str, public: bytes) -> None:
        """Genesis / first-use binding. Once bound, immutable."""
        cur = self.account_key(who)
        if cur is not None and cur != public:
            raise DispatchError("system.AccountKeyMismatch", who)
        self.state.put(PALLET, "account_key", who, public)

    # -- nonces ----------------------------------------------------------------
    def nonce(self, who: str) -> int:
        return self.state.get(PALLET, "nonce", who, default=0)

    def bump_nonce(self, who: str) -> None:
        self.state.put(PALLET, "nonce", who, self.nonce(who) + 1)

    # -- session keys ----------------------------------------------------------
    def session_key(self, who: str) -> bytes | None:
        return self.state.get(PALLET, "session_key", who)

    def set_session_key(self, who: str, public: bytes) -> None:
        """Extrinsic: a validator (re)registers its session key."""
        if not isinstance(public, bytes) or len(public) != 32:
            raise DispatchError("system.BadSessionKey", who)
        self.state.put(PALLET, "session_key", who, public)
        self.state.deposit_event(PALLET, "SessionKeySet", who=who)

    def now_ms(self) -> int:
        """Chain clock (the pallet_timestamp role): derived from block
        height at the fixed 6 s slot duration, written by init_block."""
        return self.state.get(PALLET, "now_ms", default=0)

    # -- sudo ------------------------------------------------------------------
    def sudo(self) -> str | None:
        return self.state.get(PALLET, "sudo")

    def set_sudo(self, who: str | None) -> None:
        self.state.put(PALLET, "sudo", who)

    def retire_sudo(self) -> None:
        """Permanently clear the sudo key (council-motion-only; the
        chain's bootstrap->collective-control transition, the
        reference's sudo removal path)."""
        self.state.put(PALLET, "sudo", None)
        self.state.deposit_event(PALLET, "SudoRetired")

    # -- runtime upgrade -------------------------------------------------------
    # ``apply_runtime_upgrade`` runs the storage migrations of
    # ``chain/migrations``, which the port does not have yet (they need
    # the EVM and staking pallets): it comes with them.

    # -- misc ------------------------------------------------------------------
    def remark(self, who: str, data: bytes) -> None:
        self.state.deposit_event(PALLET, "Remark", who=who, size=len(data))
