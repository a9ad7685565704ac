"""Multi-phase validator election (ElectionProviderMultiPhase analog).

The reference elects validators through ElectionProviderMultiPhase:
during a signed submission window, anyone may submit a pre-computed
election solution with a claimed score and a deposit; solutions are
feasibility-checked on admission, the best claim wins, false claims
are slashed, and an on-chain solver is the fallback when the phase
closes empty (runtime/src/lib.rs:613,834-863). The
solver objective here is the credit-weighted VrfSolver ranking
(node/consensus.py:elect_validators; runtime lib.rs:764-786).

Flow per era:
- the SIGNED PHASE is the ``signed_phase_blocks`` window before the
  unsigned phase; ``submit_solution(validators, claimed_score)``
  reserves a deposit, cheap-checks feasibility (distinct bonded
  validators over the stake floor, within max size), and keeps only
  the highest claimed score;
- the UNSIGNED PHASE is the last ``unsigned_phase_blocks`` of the era
  (the reference's unsigned submission window, lib.rs:834-863):
  validator OCWs mine a solution locally and submit it FEELESS and
  deposit-free via ``submit_unsigned`` — evidence-carrying, like
  audit.save_challenge_info: the payload is signed by the submitting
  validator's SESSION key and fully verified on admission (phase,
  eligibility, and the claimed score recomputed exactly — cheap at
  this scale, where the reference defers to validate_unsigned), so a
  forged or mis-scored submission can never occupy the queue;
- at the era boundary ``resolve`` (called INSIDE block execution by
  the runtime's era hook, so deposit moves and the queue sweep are
  covered by the block's undo log — a reorg rewinds them) re-scores
  the stored solution against CURRENT stakes/credits: an OVERCLAIM
  (actual < claimed on a feasible solution) is provably false and
  slashes the whole deposit to the treasury; a solution that merely
  went infeasible through third-party stake churn is refunded and
  discarded (honest submission must not be griefable); an honest
  solution scoring at least the on-chain solver's is adopted and
  refunded; otherwise the solver result stands (fallback). The node's
  session-rotation hook only READS the stored result.

Scoring: score(set) = sum over members of (credit * 2^40 + stake in
DOLLARS) — an additive objective whose optimum is exactly the
top-max_validators of the solver's (credit, stake) ranking, so the
solver is simultaneously the fallback and the honest best response.
"""
from __future__ import annotations

from .. import constants
from .state import DispatchError, State

PALLET = "election"
TREASURY_ACCOUNT = "treasury"

SIGNED_PHASE_BLOCKS = 10          # submission window before the unsigned one
UNSIGNED_PHASE_BLOCKS = 5         # OCW window ending each era
SOLUTION_DEPOSIT = 100 * constants.DOLLARS
CREDIT_WEIGHT = 1 << 40           # credit dominates stake in the score
UNSIGNED_SIGNING_CONTEXT = b"cess-election-unsigned-v1:"


def score_of(validators, stakes: dict[str, int],
             credits: dict[str, int]) -> int:
    return sum(credits.get(v, 0) * CREDIT_WEIGHT
               + stakes.get(v, 0) // constants.DOLLARS
               for v in validators)


class Election:
    def __init__(self, state: State, balances, staking, credit,
                 era_blocks: int,
                 signed_phase_blocks: int = SIGNED_PHASE_BLOCKS,
                 unsigned_phase_blocks: int = UNSIGNED_PHASE_BLOCKS,
                 max_validators: int = 0):
        self.state = state
        self.balances = balances
        self.staking = staking
        self.credit = credit
        self.era_blocks = era_blocks
        self.unsigned_phase_blocks = min(unsigned_phase_blocks,
                                         era_blocks - 1)
        self.signed_phase_blocks = min(
            signed_phase_blocks,
            era_blocks - 1 - self.unsigned_phase_blocks)
        self.max_validators = max_validators   # 0 -> caller supplies

    # -- phase ----------------------------------------------------------------
    def in_signed_phase(self) -> bool:
        pos = self.state.block % self.era_blocks
        start = self.era_blocks - self.signed_phase_blocks \
            - self.unsigned_phase_blocks
        return start <= pos < self.era_blocks - self.unsigned_phase_blocks

    def in_unsigned_phase(self) -> bool:
        pos = self.state.block % self.era_blocks
        return pos >= self.era_blocks - self.unsigned_phase_blocks

    # election snapshot bound: how many candidates (heaviest-stake
    # first, via the staking bags index) get scored per era — the
    # VoterList role (ref runtime/src/lib.rs:1512): snapshots stop
    # scanning the whole candidate set
    SNAPSHOT_FACTOR = 4
    SNAPSHOT_MIN = 64

    def _candidates(self) -> dict[str, int]:
        if self.max_validators:
            limit = max(self.max_validators * self.SNAPSHOT_FACTOR,
                        self.SNAPSHOT_MIN)
            members = self.staking.top_stakers(limit)
        else:
            members = self.staking.validators()
        return {v: self.staking.bonded(v) for v in members}

    # -- dispatchable ---------------------------------------------------------
    def submit_solution(self, who: str, validators: tuple,
                        claimed_score: int) -> None:
        """Signed-phase solution submission (reference's signed
        submissions, lib.rs:834-863). Cheap feasibility on admission;
        the full re-score happens at the era boundary where a false
        claim costs the deposit."""
        if not self.in_signed_phase():
            raise DispatchError("election.NotInSignedPhase")
        if not (isinstance(validators, tuple) and validators
                and all(isinstance(v, str) for v in validators)
                and len(set(validators)) == len(validators)):
            raise DispatchError("election.MalformedSolution")
        if self.max_validators and len(validators) > self.max_validators:
            raise DispatchError("election.SolutionTooLarge")
        if not isinstance(claimed_score, int) or claimed_score < 0:
            raise DispatchError("election.MalformedSolution")
        stakes = self._candidates()
        for v in validators:
            if stakes.get(v, 0) < constants.MIN_ELECTABLE_STAKE:
                raise DispatchError("election.IneligibleCandidate", v)
        best = self.state.get(PALLET, "best", default=None)
        if best is not None and best[2] >= claimed_score:
            raise DispatchError("election.WeakerThanQueued")
        self.balances.reserve(who, SOLUTION_DEPOSIT)
        if best is not None:
            # replaced submitter gets their deposit back immediately
            self.balances.unreserve(best[0], SOLUTION_DEPOSIT)
        self.state.put(PALLET, "best",
                       (who, tuple(validators), claimed_score))
        self.state.deposit_event(PALLET, "SolutionQueued", who=who,
                                 size=len(validators),
                                 claimed_score=claimed_score)

    def unsigned_payload(self, validators: tuple, claimed_score: int,
                         signer: str) -> bytes:
        """What the OCW's SESSION key signs: genesis-domain-separated
        so submissions cannot replay across chains, era-stamped so
        they cannot replay across eras."""
        from .. import codec

        genesis = self.state.get("system", "genesis", default=b"\0" * 32)
        era = self.state.block // self.era_blocks
        return UNSIGNED_SIGNING_CONTEXT + codec.encode(
            (genesis, era, signer, tuple(validators), claimed_score))

    def submit_unsigned(self, who: str, validators: tuple,
                        claimed_score: int, signature: bytes) -> None:
        """Unsigned-phase OCW submission (reference's mined unsigned
        solutions + validate_unsigned, lib.rs:834-863): feeless and
        deposit-free, so admission is FULL verification — registered
        validator, session signature over the era-stamped payload, and
        the claimed score recomputed exactly against current state."""
        from ..crypto import ed25519

        if not self.in_unsigned_phase():
            raise DispatchError("election.NotInUnsignedPhase")
        if not (isinstance(validators, tuple) and validators
                and all(isinstance(v, str) for v in validators)
                and len(set(validators)) == len(validators)
                and isinstance(claimed_score, int)
                and isinstance(signature, bytes)):
            raise DispatchError("election.MalformedSolution")
        if self.max_validators and len(validators) > self.max_validators:
            raise DispatchError("election.SolutionTooLarge")
        if who not in self.staking.validators():
            raise DispatchError("election.NotValidator", who)
        session_pub = self.state.get("system", "session_key", who)
        if session_pub is None or not ed25519.verify(
                session_pub,
                self.unsigned_payload(validators, claimed_score, who),
                signature):
            raise DispatchError("election.BadSessionSignature", who)
        stakes = self._candidates()
        for v in validators:
            if stakes.get(v, 0) < constants.MIN_ELECTABLE_STAKE:
                raise DispatchError("election.IneligibleCandidate", v)
        actual = score_of(validators, stakes, self.credit.credits())
        if claimed_score != actual:
            # a mis-scored unsigned solution is rejected outright —
            # with no deposit at stake there is nothing to slash later
            raise DispatchError("election.FalseScore",
                                f"{claimed_score} != {actual}")
        queued = self.state.get(PALLET, "best_unsigned", default=None)
        if queued is not None and queued[2] >= actual:
            raise DispatchError("election.WeakerThanQueued")
        self.state.put(PALLET, "best_unsigned",
                       (who, tuple(validators), actual))
        self.state.deposit_event(PALLET, "UnsignedQueued", who=who,
                                 size=len(validators), score=actual)

    # -- era boundary ---------------------------------------------------------
    def resolve(self, max_validators: int) -> tuple[str, ...]:
        """Resolve the election and store the result in state:
        verified queued solution if it beats the on-chain solver, else
        the solver result (fallback). MUST run inside block execution
        (the runtime era hook) — it moves deposits and sweeps the
        queue, which the block's undo log has to cover."""
        from ..node.consensus import elect_validators

        stakes = self._candidates()
        credits = self.credit.credits()
        fallback = elect_validators(stakes, credits, max_validators)
        fb_score = score_of(fallback, stakes, credits)

        def boundary_check(validators):
            """(feasible, actual) under the BOUNDARY's stakes —
            admission-time checks guard the queue, this guards the
            result against stake churn since admission."""
            feasible = (len(validators) <= max_validators
                        and all(stakes.get(v, 0)
                                >= constants.MIN_ELECTABLE_STAKE
                                for v in validators))
            return feasible, (score_of(validators, stakes, credits)
                              if feasible else -1)

        # SIGNED queue: deposit settlement happens regardless of who
        # wins (overclaim slash / honest refund semantics unchanged)
        signed_entry = None            # (who, validators, actual)
        best = self.state.get(PALLET, "best", default=None)
        if best is not None:
            self.state.delete(PALLET, "best")
            who, validators, claimed = best
            feasible, actual = boundary_check(validators)
            if feasible and actual < claimed:
                # OVERCLAIM: provably false — the whole deposit goes to
                # the treasury (the reference's defensive slash for bad
                # signed solutions). An underclaim (stake grew since
                # submission) and infeasibility through third-party
                # churn are NOT the submitter's fault: refund.
                self.balances.slash_reserved(who, SOLUTION_DEPOSIT,
                                             TREASURY_ACCOUNT)
                self.state.deposit_event(PALLET, "SolutionSlashed",
                                         who=who, claimed=claimed,
                                         actual=actual)
            else:
                self.balances.unreserve(who, SOLUTION_DEPOSIT)
                if feasible:
                    signed_entry = (who, tuple(validators), actual)

        # UNSIGNED queue (the OCW-mined solution, lib.rs:834-863):
        # fully verified at admission; boundary re-check only
        unsigned_entry = None
        unsigned = self.state.get(PALLET, "best_unsigned", default=None)
        if unsigned is not None:
            self.state.delete(PALLET, "best_unsigned")
            u_who, u_validators, _ = unsigned
            feasible, u_actual = boundary_check(u_validators)
            if feasible:
                unsigned_entry = (u_who, tuple(u_validators), u_actual)

        # pick ONE winner: the highest-scoring queued solution at or
        # above the fallback's score (a queued solution beats the
        # fallback on ties — the point of mining it); the unsigned
        # entry wins signed-vs-unsigned ties (it was fully verified)
        winner, win_event = fallback, None
        best_score = fb_score - 1
        if signed_entry is not None and signed_entry[2] > best_score:
            winner = signed_entry[1]
            win_event = ("SolutionElected", signed_entry[0],
                         signed_entry[2])
            best_score = signed_entry[2]
        if unsigned_entry is not None and unsigned_entry[2] >= fb_score \
                and unsigned_entry[2] >= best_score:
            winner = unsigned_entry[1]
            win_event = ("UnsignedElected", unsigned_entry[0],
                         unsigned_entry[2])
        if win_event is not None:
            name, who, sc = win_event
            self.state.deposit_event(PALLET, name, who=who, score=sc)
        elif fallback:
            self.state.deposit_event(PALLET, "FallbackElected",
                                     size=len(fallback))
        self.state.put(PALLET, "result", winner)
        return winner

    def result(self) -> tuple[str, ...]:
        """The last resolved authority set (what the node's session
        rotation reads; empty before the first era boundary)."""
        return self.state.get(PALLET, "result", default=())
