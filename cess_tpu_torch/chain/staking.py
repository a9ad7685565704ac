"""Staking with CESS economics (reference: c-pallets/cess-staking).

The reference forks Substrate pallet-staking, changing the reward
schedule to a fixed yearly issuance split validator/sminer
(238.5M / 477M DOLLARS year 1, x0.841 per year for 30 years) with the
sminer share pushed into the sminer reward pool each era, and adding
``slash_scheduler`` = 5% of MinValidatorBond for TEE punishment.
Mirrors c-pallets/staking/src/: reward schedule
pallet/impls.rs:452-474, end_era sminer issuance :430-449,
slash_scheduler slashing.rs:694-705, config runtime/src/lib.rs:585-589.

Nominators: the CESS runtime pins ``MaxNominations = 1``
(runtime/src/lib.rs:378), so a nominator backs exactly one validator
with their whole bond. Era exposure (own + nominator bonds) is
captured at era START and drives both the era payout split (validator
commission off the top, remainder exposure-pro-rata,
pallet/impls.rs era payout) and offence slashing (validator AND
exposed nominators slashed at the offence fraction). The election
itself is credit-weighted and lives in node/consensus.py
(the reference's VrfSolver).
"""
from __future__ import annotations

import dataclasses

from .. import codec, constants
from .balances import Balances
from .sminer import REWARD_POOL
from .state import DispatchError, State

PALLET = "staking"
TREASURY = "treasury"

MIN_VALIDATOR_BOND = 1_000_000 * constants.DOLLARS   # runtime :585-589
MIN_NOMINATOR_BOND = 1_000 * constants.DOLLARS       # genesis min_nominator_bond analog (pallet/mod.rs:313,638)
ERAS_PER_YEAR = 365 * 4   # 6-hour eras (1h epochs x 6 sessions)
BONDING_DURATION_ERAS = 4 * 28    # 28 days (runtime/src/lib.rs:562)
MAX_UNLOCKING_CHUNKS = 32
# the reference defers offence slashes by 28 eras so governance can
# cancel wrongful ones (SlashDeferDuration = 4 * 7, runtime :563);
# configurable here — 0 applies immediately
SLASH_DEFER_ERAS_REF = 4 * 7


@codec.register
@dataclasses.dataclass(frozen=True)
class Exposure:
    """Who backs a validator for one era (Substrate's Exposure)."""

    own: int
    nominators: tuple[tuple[str, int], ...]
    total: int


class Staking:
    def __init__(self, state: State, balances: Balances,
                 slash_defer_eras: int = 0):
        if not 0 <= slash_defer_eras < BONDING_DURATION_ERAS:
            # a deferral >= the bonding duration would let an offender
            # withdraw the whole ledger before the slash ever applies
            # (the reference enforces the same: pallet/mod.rs:828)
            raise ValueError(
                f"slash_defer_eras {slash_defer_eras} must be < "
                f"BONDING_DURATION_ERAS {BONDING_DURATION_ERAS}")
        self.state = state
        self.balances = balances
        self.slash_defer_eras = slash_defer_eras

    # -- bonding --------------------------------------------------------------
    def bond(self, who: str, amount: int) -> None:
        if amount <= 0:
            raise DispatchError("staking.InvalidAmount")
        self.balances.reserve(who, amount)
        self.state.put(PALLET, "bond", who, self.bonded(who) + amount)
        self._bags_update(who)
        self.state.deposit_event(PALLET, "Bonded", who=who, amount=amount)

    def unbond(self, who: str, amount: int) -> None:
        """Active bond -> an unlocking chunk released BondingDuration
        eras later by withdraw_unbonded (ref BondingDuration = 112
        eras, runtime/src/lib.rs:562; MaxUnlockingChunks cap). Funds
        stay reserved — and slashable — until withdrawn."""
        b = self.bonded(who)
        if not isinstance(amount, int) or amount <= 0 or amount > b:
            raise DispatchError("staking.InvalidAmount")
        if who in self.validators() and b - amount < MIN_VALIDATOR_BOND:
            raise DispatchError("staking.InsufficientBond",
                                "would fall below MinValidatorBond")
        chunks = self.state.get(PALLET, "unlocking", who, default=())
        unlock_era = self.current_era() + BONDING_DURATION_ERAS
        if chunks and chunks[-1][1] == unlock_era:
            # merge same-era unbonds into one chunk (Substrate does;
            # otherwise repeated small unbonds exhaust the chunk cap)
            chunks = chunks[:-1] + ((chunks[-1][0] + amount, unlock_era),)
        elif len(chunks) >= MAX_UNLOCKING_CHUNKS:
            raise DispatchError("staking.NoMoreChunks")
        else:
            chunks = chunks + ((amount, unlock_era),)
        self.state.put(PALLET, "unlocking", who, chunks)
        self.state.put(PALLET, "bond", who, b - amount)
        self._bags_update(who)
        self.state.deposit_event(PALLET, "Unbonded", who=who,
                                 amount=amount, unlock_era=unlock_era)

    def withdraw_unbonded(self, who: str) -> int:
        """Release every unlocking chunk whose era has passed
        (withdraw_unbonded, pallet/mod.rs:716). Returns the amount."""
        chunks = self.state.get(PALLET, "unlocking", who, default=())
        if not chunks:
            raise DispatchError("staking.NoUnlockChunk", who)
        era = self.current_era()
        due = sum(a for a, e in chunks if e <= era)
        left = tuple((a, e) for a, e in chunks if e > era)
        if due:
            self.balances.unreserve(who, due)
        if left:
            self.state.put(PALLET, "unlocking", who, left)
        else:
            self.state.delete(PALLET, "unlocking", who)
        if due:
            self.state.deposit_event(PALLET, "Withdrawn", who=who,
                                     amount=due)
        return due

    def unlocking(self, who: str) -> tuple:
        return self.state.get(PALLET, "unlocking", who, default=())

    def bonded(self, who: str) -> int:
        return self.state.get(PALLET, "bond", who, default=0)

    def validate(self, who: str, commission_permill: int = 0) -> None:
        """Declare validator intent (needs MinValidatorBond) with
        commission prefs (ValidatorPrefs, pallet/mod.rs:1111-1137)."""
        if self.bonded(who) < MIN_VALIDATOR_BOND:
            raise DispatchError("staking.InsufficientBond")
        if not isinstance(commission_permill, int) \
                or not 0 <= commission_permill <= 1000:
            raise DispatchError("staking.InvalidCommission")
        self.state.put(PALLET, "prefs", who, commission_permill)
        # a validator cannot simultaneously nominate: its bond would be
        # exposed twice (own + as someone's backer)
        self.state.delete(PALLET, "nomination", who)
        vals = self.validators()
        if who not in vals:
            self.state.put(PALLET, "validators", vals + (who,))
        self._bags_update(who)

    def commission(self, who: str) -> int:
        return self.state.get(PALLET, "prefs", who, default=0)

    def chill(self, who: str) -> None:
        """Drop validator intent AND any nomination (Substrate chill)."""
        vals = self.validators()
        if who in vals:
            self.state.put(PALLET, "validators",
                           tuple(v for v in vals if v != who))
            self._bags_update(who)
        self.state.delete(PALLET, "nomination", who)

    def validators(self) -> tuple[str, ...]:
        return self.state.get(PALLET, "validators", default=())

    # -- VoterList (bags-list) analog -----------------------------------------
    # The reference keeps a semi-sorted on-chain voter index
    # (pallet_bags_list as VoterList, runtime/src/lib.rs:1512) so the
    # election snapshot never scans every account. Same structure
    # here: validators live in log2-stake BAGS — ("bag", b) holds an
    # insertion-ordered tuple, ("bag_of", who) its index — updated
    # incrementally on every bond/unbond/slash/validate/chill, and the
    # election snapshot walks bags from the heaviest down
    # (top_stakers), stopping at its bound instead of scoring the full
    # candidate set.

    @staticmethod
    def bag_index(stake: int) -> int:
        return stake.bit_length()        # log2 buckets, exact enough

    def _bags_update(self, who: str) -> None:
        """Re-place ``who`` in the stake-ordered index. Call after any
        change to its bond or validator-set membership; no-op when the
        bag is already right (same-bag bond moves keep position, like
        the reference's lazy rebag)."""
        cur = self.state.get(PALLET, "bag_of", who)
        want = self.bag_index(self.bonded(who)) \
            if who in self.validators() else None
        if cur == want:
            return
        if cur is not None:
            members = tuple(m for m in self.state.get(
                PALLET, "bag", cur, default=()) if m != who)
            if members:
                self.state.put(PALLET, "bag", cur, members)
            else:
                self.state.delete(PALLET, "bag", cur)
        count = self.state.get(PALLET, "bag_count", default=0)
        if want is None:
            self.state.delete(PALLET, "bag_of", who)
            self.state.put(PALLET, "bag_count", count - 1)
        else:
            self.state.put(PALLET, "bag", want, self.state.get(
                PALLET, "bag", want, default=()) + (who,))
            self.state.put(PALLET, "bag_of", who, want)
            if cur is None:
                self.state.put(PALLET, "bag_count", count + 1)

    def top_stakers(self, limit: int) -> list[str]:
        """Up to ``limit`` validators, heaviest bags first (within a
        bag: insertion order — semi-sorted, like the reference's
        VoterList). A PARTIAL index (an old snapshot before the
        staking-v3 migration ran — even one where post-restart staking
        ops already indexed a few validators) falls back to the plain
        set: the bag_count counter vs the roster length detects it in
        O(1), so an un-upgraded restart can never hide incumbents from
        the election snapshot (review-caught on the empty-only check)."""
        vals = self.validators()
        if self.state.get(PALLET, "bag_count", default=0) != len(vals):
            # pre-migration fallback must still rank by stake — a
            # registration-order truncation would hide whales from the
            # snapshot (review-caught); O(V log V) only in this window
            return sorted(vals, key=lambda v: (-self.bonded(v), v))[:limit]
        bags = sorted(((k[0], v) for k, v in
                       self.state.iter_prefix(PALLET, "bag")),
                      reverse=True)
        out: list[str] = []
        for _, members in bags:
            for who in members:
                out.append(who)
                if len(out) >= limit:
                    return out
        return out

    # -- nominations (MaxNominations = 1, runtime/src/lib.rs:378) ---------------
    def nominate(self, who: str, target: str) -> None:
        if self.bonded(who) < MIN_NOMINATOR_BOND:
            raise DispatchError("staking.InsufficientBond",
                                "below MinNominatorBond")
        if target not in self.validators():
            raise DispatchError("staking.NotValidator", target)
        if who in self.validators():
            raise DispatchError("staking.AlreadyValidating", who)
        self.state.put(PALLET, "nomination", who, target)
        self.state.deposit_event(PALLET, "Nominated", who=who,
                                 target=target)

    def nomination(self, who: str) -> str | None:
        return self.state.get(PALLET, "nomination", who)

    def nominators_of(self, target: str) -> list[tuple[str, int]]:
        return sorted((n[0], self.bonded(n[0]))
                      for n, t in self.state.iter_prefix(PALLET,
                                                         "nomination")
                      if t == target)

    # -- era exposure -----------------------------------------------------------
    def capture_exposures(self, era: int) -> None:
        """Era start: freeze who backs whom with how much; the era's
        payout and any offence slashing use THIS snapshot, immune to
        post-hoc bond shuffling (ErasStakers, pallet/mod.rs:344-460)."""
        for v in (self.electable() or list(self.validators())):
            noms = tuple(self.nominators_of(v))
            own = self.bonded(v)
            self.state.put(PALLET, "exposure", era, v, Exposure(
                own=own, nominators=noms,
                total=own + sum(a for _, a in noms)))

    def exposure(self, era: int, validator: str) -> Exposure | None:
        return self.state.get(PALLET, "exposure", era, validator)

    def era_validators(self, era: int) -> list[str]:
        return [k[0] for k, _ in self.state.iter_prefix(PALLET,
                                                        "exposure", era)]

    def electable(self) -> list[str]:
        """Stake floor for election: MIN_ELECTABLE_STAKE = 3M DOLLARS
        (runtime/src/lib.rs:764-772)."""
        return [v for v in self.validators()
                if self.bonded(v) >= constants.MIN_ELECTABLE_STAKE]

    # -- era rewards (impls.rs:430-474) -----------------------------------------
    @staticmethod
    def rewards_in_year(year: int) -> tuple[int, int]:
        """(validator_total, sminer_total) issued across that year's
        eras; x0.841 decay, 30-year horizon."""
        if year >= constants.REWARD_YEARS:
            return 0, 0
        v = constants.VALIDATOR_REWARD_YEAR1
        s = constants.SMINER_REWARD_YEAR1
        for _ in range(year):
            v = v * constants.REWARD_DECAY_NUM // constants.REWARD_DECAY_DEN
            s = s * constants.REWARD_DECAY_NUM // constants.REWARD_DECAY_DEN
        return v, s

    def end_era(self, era_index: int) -> None:
        """Mint the era's issuance: validator share split by era
        exposure (commission off the top, remainder exposure-pro-rata
        across own + nominator stakes — Substrate's payout shape),
        sminer share into the reward pool."""
        year = era_index // ERAS_PER_YEAR
        v_year, s_year = self.rewards_in_year(year)
        v_era = v_year // ERAS_PER_YEAR
        s_era = s_year // ERAS_PER_YEAR
        self.balances.mint(REWARD_POOL, s_era)
        exposed = self.era_validators(era_index)
        if exposed:
            stakes = {v: self.exposure(era_index, v) for v in exposed}
            grand = sum(e.total for e in stakes.values())
            for v in sorted(exposed):
                e = stakes[v]
                if grand <= 0 or e.total <= 0:
                    continue
                pot = v_era * e.total // grand
                fee = pot * self.commission(v) // 1000
                rest = pot - fee
                self.balances.mint(v, fee + rest * e.own // e.total)
                for nom, amount in e.nominators:
                    self.balances.mint(nom, rest * amount // e.total)
        else:
            # genesis era: no exposure snapshot yet; split by own bond
            active = self.electable() or list(self.validators())
            total_bond = sum(self.bonded(v) for v in active)
            if total_bond > 0:
                for v in active:
                    self.balances.mint(v, v_era * self.bonded(v)
                                       // total_bond)
        # exposures are retained long enough for deferred slashes to
        # still see the offence era (HistoryDepth analog)
        retention = max(1, self.slash_defer_eras)
        for (e, v), _ in list(self.state.iter_prefix(PALLET, "exposure")):
            if e < era_index - retention:
                self.state.delete(PALLET, "exposure", e, v)
        self.state.put(PALLET, "era", era_index + 1)
        self.state.deposit_event(PALLET, "EraPaid", era=era_index,
                                 validator_payout=v_era, sminer_payout=s_era)

    def current_era(self) -> int:
        return self.state.get(PALLET, "era", default=0)

    # -- offence slashing ---------------------------------------------------------
    def _drain(self, who: str, amount: int) -> int:
        """Take up to ``amount`` from active bond first, then from
        unlocking chunks oldest-first (Substrate slashes the ledger
        including unlocking — queued withdrawals stay liable)."""
        taken = 0
        b = self.bonded(who)
        from_bond = min(b, amount)
        if from_bond:
            self.state.put(PALLET, "bond", who, b - from_bond)
            taken += from_bond
        if taken < amount:
            chunks = list(self.state.get(PALLET, "unlocking", who,
                                         default=()))
            kept = []
            for a, e in chunks:
                cut = min(a, amount - taken)
                taken += cut
                if a - cut:
                    kept.append((a - cut, e))
            if kept:
                self.state.put(PALLET, "unlocking", who, tuple(kept))
            else:
                self.state.delete(PALLET, "unlocking", who)
        if taken:
            self.balances.slash_reserved(who, taken, TREASURY)
            self._bags_update(who)
        return taken

    def _slash_one(self, who: str, permill: int) -> int:
        want = (self.bonded(who)
                + sum(a for a, _ in self.unlocking(who))) * permill // 1000
        taken = self._drain(who, want)
        self.state.deposit_event(PALLET, "Slashed", who=who, amount=taken,
                                 permill=permill)
        return taken

    def _slash_amount(self, who: str, amount: int) -> int:
        """Take up to ``amount`` from active bond + unlocking chunks
        (exposure-based slash: the EXPOSED stake is liable, wherever
        it currently sits in the ledger)."""
        taken = self._drain(who, amount)
        self.state.deposit_event(PALLET, "Slashed", who=who, amount=taken,
                                 permill=0)
        return taken

    def slash_fraction(self, who: str, permill: int,
                       era: int | None = None) -> int:
        if self.slash_defer_eras:
            # deferred application (SlashDeferDuration): queue now,
            # apply at era + defer unless governance cancels
            offence_era = self.current_era() if era is None else era
            apply_era = self.current_era() + self.slash_defer_eras
            sid = self.state.get(PALLET, "next_unapplied", default=0)
            self.state.put(PALLET, "next_unapplied", sid + 1)
            self.state.put(PALLET, "unapplied", sid,
                           (who, permill, offence_era, apply_era))
            self.state.deposit_event(PALLET, "SlashDeferred", id=sid,
                                     who=who, permill=permill,
                                     apply_era=apply_era)
            return 0
        return self._slash_now(who, permill, era)

    def cancel_deferred_slash(self, sid: int) -> None:
        """COUNCIL-ONLY (via motion): drop a queued slash before it
        applies (the reference's governance cancel path)."""
        if not self.state.contains(PALLET, "unapplied", sid):
            raise DispatchError("staking.NoSuchSlash", str(sid))
        self.state.delete(PALLET, "unapplied", sid)
        self.state.deposit_event(PALLET, "SlashCancelled", id=sid)

    def apply_due_slashes(self) -> None:
        """Era hook: apply queued slashes whose deferral elapsed."""
        now = self.current_era()
        for (sid,), (who, permill, offence_era, apply_era) in sorted(
                self.state.iter_prefix(PALLET, "unapplied")):
            if apply_era <= now:
                self.state.delete(PALLET, "unapplied", sid)
                self._slash_now(who, permill, offence_era)

    def _slash_now(self, who: str, permill: int,
                   era: int | None = None) -> int:
        """Slash ``permill``/1000 of the offender's exposure in the
        OFFENCE era (``era``; defaults to the current one) — own stake
        and every exposed nominator (Substrate slashes the offending
        era's exposure, so post-offence unbonding cannot dodge it
        beyond what already left the bond). Falls back to the live
        bond when no exposure snapshot exists (pruned or genesis).
        Returns the total taken."""
        e = self.exposure(self.current_era() if era is None else era, who)
        if e is None:
            taken = self._slash_one(who, permill)
            for nom, _ in self.nominators_of(who):
                # fraction of the nominator's WHOLE ledger (active +
                # unlocking): queued withdrawals stay liable here too
                taken += self._slash_one(nom, permill)
            return taken
        taken = self._slash_amount(who, e.own * permill // 1000)
        for nom, amount in e.nominators:
            taken += self._slash_amount(nom, amount * permill // 1000)
        return taken

    # -- scheduler slash (slashing.rs:694-705) ------------------------------------
    def slash_scheduler(self, stash: str) -> None:
        """5% of MinValidatorBond from the stash's ledger (active bond
        first, then unlocking chunks — unbonding does not shelter a
        misbehaving scheduler's stake) -> treasury."""
        amount = MIN_VALIDATOR_BOND * constants.SCHEDULER_SLASH_PERMILL // 1000
        taken = self._drain(stash, amount)
        self.state.deposit_event(PALLET, "SchedulerSlashed", stash=stash,
                                 amount=taken)
