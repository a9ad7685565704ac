"""Offences: consensus-fault reporting with on-chain evidence checks.

The reference composes pallet_offences + pallet_grandpa's equivocation
reporting + pallet_im_online liveness offences
(runtime/src/lib.rs:507-540): misbehaviour observed by
the consensus layer is submitted back on chain as a report with
self-contained cryptographic evidence, verified in the runtime, then
punished through staking slashing.

Here the same shape, framework-native: the finality gadget's
signed votes (the node layer's finality votes use the Vote type below) ARE
the evidence — two votes by one voter for different blocks in the same
round prove equivocation to any replica, no trust in the reporter.

Slash fractions mirror the reference's order of magnitude (GRANDPA
equivocation slashes a stake proportion and chills; im-online offences
are mild): equivocation = 10% of bond + chill; liveness (unresponsive
in era, reported by the era rotation) = 1% of bond.
"""
from __future__ import annotations

import dataclasses

from .. import codec
from .state import DispatchError, State

PALLET = "offences"

VOTE_SIGNING_CONTEXT = b"cess-tpu/finality-vote-v1:"

EQUIVOCATION_SLASH_PERMILL = 100   # 10% of bond
LIVENESS_SLASH_PERMILL = 10        # 1% of bond


@codec.register
@dataclasses.dataclass(frozen=True)
class Vote:
    """One finality vote: ``voter`` commits to ``target`` at ``round``.

    Signed with the voter's SESSION key (the on-chain
    ("system", "session_key") registry — the same keys that sign audit
    proposals), domain-separated by genesis so votes cannot replay
    across chains."""

    voter: str
    round: int
    target_hash: bytes
    target_number: int
    signature: bytes

    def signing_payload(self, genesis: bytes) -> bytes:
        return VOTE_SIGNING_CONTEXT + codec.encode(
            (genesis, self.voter, self.round, self.target_hash,
             self.target_number))


def sign_vote(key, genesis: bytes, voter: str, round_: int,
              target_hash: bytes, target_number: int) -> Vote:
    v = Vote(voter=voter, round=round_, target_hash=target_hash,
             target_number=target_number, signature=b"")
    return dataclasses.replace(
        v, signature=key.sign(v.signing_payload(genesis)))


class Offences:
    def __init__(self, state: State, staking, genesis_fn):
        self.state = state
        self.staking = staking
        self._genesis = genesis_fn   # late-bound: genesis set post-init

    def _verify_vote(self, vote: Vote) -> None:
        from ..crypto import ed25519

        if not isinstance(vote, Vote):
            raise DispatchError("offences.BadEvidence", "not a Vote")
        ok = (isinstance(vote.voter, str)
              and isinstance(vote.round, int)
              and isinstance(vote.target_hash, bytes)
              and isinstance(vote.target_number, int)
              and isinstance(vote.signature, bytes))
        if not ok:
            raise DispatchError("offences.BadEvidence", "malformed vote")
        pub = self.state.get("system", "session_key", vote.voter)
        if pub is None:
            raise DispatchError("offences.UnknownVoter", vote.voter)
        if not ed25519.verify(pub, vote.signing_payload(self._genesis()),
                              vote.signature):
            raise DispatchError("offences.BadVoteSignature", vote.voter)

    def report_equivocation(self, reporter: str, vote_a: Vote,
                            vote_b: Vote) -> None:
        """Anyone may report; the report carries both conflicting
        votes and is verified entirely on chain (the reference's
        report_equivocation_unsigned path)."""
        self._verify_vote(vote_a)
        self._verify_vote(vote_b)
        if vote_a.voter != vote_b.voter or vote_a.round != vote_b.round:
            raise DispatchError("offences.NotEquivocation",
                                "different voter or round")
        if vote_a.target_hash == vote_b.target_hash:
            raise DispatchError("offences.NotEquivocation", "same target")
        offender = vote_a.voter
        if self.state.contains(PALLET, "reported", offender, vote_a.round):
            raise DispatchError("offences.AlreadyReported", offender)
        self.state.put(PALLET, "reported", offender, vote_a.round, reporter)
        slashed = self.staking.slash_fraction(
            offender, EQUIVOCATION_SLASH_PERMILL)
        self.staking.chill(offender)
        self.state.deposit_event(
            PALLET, "EquivocationReported", offender=offender,
            round=vote_a.round, reporter=reporter, slashed=slashed)

    def report_liveness_fault(self, offender: str, era: int) -> None:
        """Internal hook (era rotation / im-online analog): an
        authority that produced no heartbeat all era."""
        if self.state.contains(PALLET, "reported", offender, ("era", era)):
            return
        self.state.put(PALLET, "reported", offender, ("era", era), "system")
        slashed = self.staking.slash_fraction(
            offender, LIVENESS_SLASH_PERMILL, era=era)
        self.state.deposit_event(PALLET, "LivenessFault", offender=offender,
                                 era=era, slashed=slashed)
