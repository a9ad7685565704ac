"""RRSC consensus: VRF slot lottery + credit-weighted election.

The reference's RRSC ("Random Rotational Selection Consensus") is a
BABE fork: primary slots are claimed by validators whose VRF output on
(epoch randomness, slot) falls under c = 1/4, with deterministic
secondary slots so every slot has an author; the validator set is
elected per era by a VrfSolver weighted by scheduler credit over a
stake floor (SURVEY.md §2.3 forked-Substrate row;
runtime/src/lib.rs:181-185,240-241,764-786).

Epoch randomness follows BABE: R_{e+1} = H(R_e || e || vrf outputs of
epoch e) — bias-resistant enough for the framework's purposes and
fully deterministic for replay.
"""
from __future__ import annotations

import dataclasses
import hashlib

from .. import codec, constants
from ..crypto import ed25519
from ..crypto.vrf import VrfProof, output_below, vrf_sign, vrf_verify


@codec.register
@dataclasses.dataclass(frozen=True)
class SlotClaim:
    slot: int
    authority: str
    vrf: VrfProof | None      # None => secondary (fallback) claim


class Rrsc:
    def __init__(self, epoch_blocks: int = constants.EPOCH_DURATION_BLOCKS,
                 c=(constants.RRSC_C_NUM, constants.RRSC_C_DEN)):
        self.epoch_blocks = epoch_blocks
        self.c = c
        self.randomness: dict[int, bytes] = {0: b"genesis-randomness"}
        self._epoch_vrf: dict[int, list[bytes]] = {}
        # epoch numbering is ANCHORED at the chain's first block slot
        # (BABE records the genesis slot the same way): wall-clock slot
        # numbers are huge (unix_time / slot_time), so absolute-slot
        # epochs would be astronomically distant from epoch 0. The node
        # pins this from block #1's claim; until then it floats with
        # the trial slot so every pre-genesis claim sits in epoch 0.
        self.genesis_slot: int | None = None

    # -- epochs ---------------------------------------------------------------
    def epoch_of(self, slot: int) -> int:
        return max(0, slot - (self.genesis_slot or 0)) // self.epoch_blocks

    def epoch_randomness(self, epoch: int) -> bytes:
        """Randomness for an epoch; derived lazily (and iteratively —
        never recursion-bound) from collected VRF outputs of epoch-1
        (deterministic chain if none collected)."""
        if epoch not in self.randomness:
            start = epoch
            while start not in self.randomness:
                start -= 1
            for e in range(start + 1, epoch + 1):
                outs = b"".join(sorted(self._epoch_vrf.get(e - 1, [])))
                self.randomness[e] = hashlib.sha256(
                    self.randomness[e - 1] + e.to_bytes(8, "little")
                    + outs).digest()
        return self.randomness[epoch]

    def note_vrf(self, slot: int, output: bytes) -> None:
        self._epoch_vrf.setdefault(self.epoch_of(slot), []).append(output)

    # -- slot claims ------------------------------------------------------------
    def _slot_input(self, slot: int) -> bytes:
        r = self.epoch_randomness(self.epoch_of(slot))
        return r + slot.to_bytes(8, "little")

    def claim_slot(self, slot: int, authority: str,
                   key: ed25519.SigningKey,
                   authorities: tuple[str, ...]) -> SlotClaim | None:
        """Primary claim if the VRF lottery hits; else secondary if this
        authority is the round-robin fallback for the slot."""
        if authority not in authorities:
            return None
        proof = vrf_sign(key, self._slot_input(slot))
        if output_below(proof.output, *self.c):
            return SlotClaim(slot=slot, authority=authority, vrf=proof)
        if self.secondary_author(slot, authorities) == authority:
            return SlotClaim(slot=slot, authority=authority, vrf=None)
        return None

    def secondary_author(self, slot: int, authorities: tuple[str, ...]) -> str:
        """PrimaryAndSecondaryVRFSlots fallback: deterministic from the
        epoch randomness (every slot has an author)."""
        h = hashlib.sha256(self._slot_input(slot) + b"secondary").digest()
        return authorities[int.from_bytes(h[:4], "little") % len(authorities)]

    def verify_claim(self, claim: SlotClaim, public_key: bytes,
                     authorities: tuple[str, ...]) -> bool:
        if claim.authority not in authorities:
            return False
        if claim.vrf is None:
            return self.secondary_author(claim.slot, authorities) \
                == claim.authority
        return vrf_verify(public_key, self._slot_input(claim.slot), claim.vrf) \
            and output_below(claim.vrf.output, *self.c)

    def block_randomness(self, claim: SlotClaim) -> bytes:
        """Per-block randomness for the runtime (ParentBlockRandomness):
        the VRF output, or a derived value for secondary slots."""
        if claim.vrf is not None:
            return claim.vrf.output
        return hashlib.sha256(self._slot_input(claim.slot)
                              + claim.authority.encode()).digest()


def elect_validators(candidates: dict[str, int], credits: dict[str, int],
                     max_validators: int,
                     stake_floor: int = constants.MIN_ELECTABLE_STAKE
                     ) -> tuple[str, ...]:
    """The VrfSolver election: stake floor filter, then scheduler-credit
    weighting (higher credit wins; stake tie-breaks)
    (runtime/src/lib.rs:764-786)."""
    eligible = [(v, s) for v, s in candidates.items() if s >= stake_floor]
    ranked = sorted(eligible,
                    key=lambda vs: (-credits.get(vs[0], 0), -vs[1], vs[0]))
    return tuple(v for v, _ in ranked[:max_validators])
