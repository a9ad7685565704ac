"""Vote-based finality: signed vote exchange, 2/3 counting,
equivocation detection, persisted justifications.

The reference runs a GRANDPA voter loop gossiping signed votes per
round and importing justifications
(the reference's node/src/service.rs:556-580). This gadget is the
framework-native equivalent, round-simplified: round r finalizes at
most one block; every authority votes for its best chain's block at
height r (GRANDPA's "ghost of the best chain" collapsed to the head
ancestor at that height); 2/3 distinct signed votes for the same hash
form a justification that finalizes the block and all ancestors.

Safety properties kept from GRANDPA:
- a vote is a SIGNED, self-contained statement (chain/offences.py
  Vote) — replicas verify against the on-chain session-key registry;
- two votes by one voter in one round for different hashes are
  cryptographic proof of equivocation, reportable on chain
  (offences.report_equivocation) where staking slashes + chills;
- finality never reverts: justified blocks bound fork choice (a node
  never reorgs below its finalized height), and a justification on a
  side branch FORCES the node onto that branch.
"""
from __future__ import annotations

import dataclasses

from .. import codec
from ..chain.offences import Vote, sign_vote
from ..obs import flight as _flight


@codec.register
@dataclasses.dataclass(frozen=True)
class Justification:
    """Proof of finality for (target_hash, round): >= 2/3 of the
    authority set's signed votes. Persisted with the chain so a
    restarted/syncing node can verify finality without replaying the
    vote exchange (the reference persists GRANDPA justifications in
    the block store)."""

    round: int
    target_hash: bytes
    target_number: int
    votes: tuple[Vote, ...]


class FinalityGadget:
    """Per-node vote tracker. The node feeds it local keys + incoming
    votes; it emits outgoing votes, detects equivocations, and
    surfaces justifications when a target reaches 2/3."""

    def __init__(self, node):
        self.node = node
        # round -> target_hash -> {voter: Vote}
        self._tally: dict[int, dict[bytes, dict[str, Vote]]] = {}
        # round -> voter -> first-seen Vote (for equivocation detection)
        self._first: dict[int, dict[str, Vote]] = {}
        # (round, voter) pairs handed out by vote_jobs but not yet
        # ingested — prevents a concurrent collector from double-
        # signing the same round (self-equivocation)
        self._signing: set[tuple[int, str]] = set()
        # accounts observed locked by vote_jobs' last pass — the edge
        # detector behind the flight journal's lock-acquire/release
        # entries (an own-vote lock engaging is exactly the "finality
        # stall" moment a postmortem needs on its timeline)
        self._lock_active: set[str] = set()
        self.equivocations: list[tuple[Vote, Vote]] = []
        self.justifications: dict[int, Justification] = {}

    # -- outgoing ----------------------------------------------------------
    # sync batches can advance the head many blocks at once; voting
    # only the head round would skip the intermediate rounds entirely
    # and starve them of this voter forever (each voter votes a round
    # at most once). Vote a bounded tail of rounds instead.
    VOTE_TAIL = 32
    # own-vote lock liveness backstop: a voter locked to a reorged-away
    # branch (see _locked) abstains at most this many rounds before
    # resuming — healing re-gossip normally releases it much sooner by
    # proving the old target can no longer reach 2/3
    LOCK_HORIZON = 32

    def _quorum_impossible(self, rnd: int, target_hash: bytes) -> bool:
        """True when ``target_hash`` can provably never reach 2/3 in
        round ``rnd``: enough OTHER signed round-``rnd`` votes have
        been observed that the remaining voters cannot complete a
        quorum. Votes are one-per-voter-per-round (equivocations are
        slashable evidence, not counted), so observed contrary votes
        bound the target's possible support globally, not just in our
        view — the GRANDPA release argument."""
        node = self.node
        others = sum(len(votes) for h, votes
                     in self._tally.get(rnd, {}).items()
                     if h != target_hash)
        n_auth = len(node.authorities)
        return 3 * (n_auth - others) < 2 * n_auth

    def _locked(self, account: str, head_number: int) -> bool:
        """The GRANDPA-style own-vote lock: having voted round r for a
        block we since reorged AWAY from, we must not vote later
        rounds on the new branch while that old vote could still
        complete a 2/3 quorum elsewhere — two conflicting
        justifications assembled from partial vote views are exactly
        how replicas diverge irrecoverably (the one-phase gadget's
        unsafe window; root cause of the chain-topology discovery
        flake). The lock releases when the old vote finalizes, its
        branch regains canonicity, a quorum on it becomes provably
        impossible (healing re-gossip supplies the contrary votes), or
        the LOCK_HORIZON liveness backstop passes."""
        return bool(self.locked_rounds(account, head_number))

    def locked_rounds(self, account: str,
                      head_number: int) -> tuple[int, ...]:
        """The rounds whose own-votes currently lock ``account`` (see
        :meth:`_locked` for the lock rationale). Exposed so external
        auditors — the sim invariant checkers (cess_tpu_torch/sim) — can
        assert no lock ever names a round older than LOCK_HORIZON,
        instead of re-deriving the lock rule from ``_first``."""
        node = self.node
        rounds = []
        for rnd, votes in self._first.items():
            v = votes.get(account)
            if v is None or rnd <= node.finalized:
                continue
            if node._is_canonical(v.target_hash):
                continue
            if head_number - rnd > self.LOCK_HORIZON:
                continue
            if not self._quorum_impossible(rnd, v.target_hash):
                rounds.append(rnd)
        return tuple(sorted(rounds))

    def vote_jobs(self) -> list[tuple]:
        """Collect the (account, key, round, target_hash) tuples this
        node should sign: every unvoted round up to the current HEAD
        (round = block height; the round target is the canonical block
        at that height). Voting the whole unfinalized tail keeps
        liveness for straggler nodes whose head jumps in sync batches,
        and across reorgs: a voter that committed to a dead branch at
        height h can never re-vote round h (that would be
        equivocation), but the chain outgrows h and a fresh round
        finalizes past it.

        Caller holds the node lock. Collected rounds are marked
        in-flight so a concurrent collector cannot double-sign them
        (self-equivocation); ingest_own clears the marks."""
        node = self.node
        jobs = []
        head = node.chain[-1]
        if head.number <= node.finalized:
            return jobs
        lo = max(node.finalized + 1, head.number - self.VOTE_TAIL + 1)
        voters = []
        locked_now = set()
        for a, k in node.keystore.items():
            if a not in node.authorities:
                continue
            if self._locked(a, head.number):
                locked_now.add(a)
            else:
                voters.append((a, k))
        # journal lock EDGES (under the node lock the caller holds —
        # safe: finality entries never trigger bundle builds)
        if locked_now != self._lock_active:
            for a in sorted(locked_now - self._lock_active):
                _flight.note("finality", "lock-acquire", account=a,
                             head=head.number)
            for a in sorted(self._lock_active - locked_now):
                _flight.note("finality", "lock-release", account=a,
                             head=head.number)
            self._lock_active = locked_now
        for rnd in range(lo, head.number + 1):
            target = node.chain[rnd]
            for account, key in voters:
                if account in self._first.get(rnd, {}) \
                        or (rnd, account) in self._signing:
                    continue   # never double-vote (that's equivocation)
                self._signing.add((rnd, account))
                jobs.append((account, key, rnd, target.hash()))
        return jobs

    def sign_jobs(self, jobs: list[tuple]) -> list[Vote]:
        """ed25519-sign collected jobs — ~6 ms each in pure python, so
        callers run this OUTSIDE the node lock (the TCP service would
        otherwise stall recv/RPC/authoring for a whole sync batch)."""
        gh = self.node.runtime.genesis_hash()
        return [sign_vote(key, gh, account, rnd, th, rnd)
                for (account, key, rnd, th) in jobs]

    def ingest_own(self, votes: list[Vote]) -> None:
        """Tally self-signed votes (caller holds the lock). Signature
        verification is skipped — we just produced them."""
        node = self.node
        for v in votes:
            self._signing.discard((v.round, v.voter))
            if v.round <= node.finalized:
                continue
            first = self._first.setdefault(v.round, {})
            if v.voter in first:
                continue
            first[v.voter] = v
            self._tally.setdefault(v.round, {}).setdefault(
                v.target_hash, {})[v.voter] = v
            self._try_finalize(v.round, v.target_hash)

    def cast_votes(self) -> list[Vote]:
        """Single-threaded convenience (the in-process Network driver):
        collect + sign + tally in one call."""
        votes = self.sign_jobs(self.vote_jobs())
        self.ingest_own(votes)
        return votes

    # -- healing -----------------------------------------------------------
    # Gossip is fire-and-forget and sync re-fetches BLOCKS, never
    # votes: a vote relayed into a partially-formed mesh is lost
    # forever, which both stalls finality and (combined with reorgs)
    # opens the conflicting-quorum window _locked guards against. The
    # transports therefore re-offer this state every round; receivers
    # dedup, so repetition costs bytes, not correctness.
    def own_unfinalized_votes(self, limit: int = 8) -> list[Vote]:
        """This node's own signed votes for the newest ``limit``
        unfinalized rounds — the re-gossip set. Caller holds the node
        lock."""
        node = self.node
        out: list[Vote] = []
        for rnd in sorted(self._first, reverse=True):
            if rnd <= node.finalized:
                continue
            for account in node.keystore:
                v = self._first[rnd].get(account)
                if v is not None:
                    out.append(v)
            if len(out) >= limit:
                break
        return out

    def newest_justification(self) -> Justification | None:
        """The highest-round justification held (older rounds are
        pruned — finality is ancestor-transitive)."""
        if not self.justifications:
            return None
        return self.justifications[max(self.justifications)]

    def apply_pending(self) -> None:
        """Re-apply stored justifications whose target block has since
        been imported. A justification can arrive BEFORE its block:
        on_justification skips unknown headers, and _try_finalize's
        round-dedup then never re-fires for that round — without this
        sweep the node holds a valid proof of finality it never acts
        on. Caller holds the node lock.

        Also prunes superseded rounds afterwards: peer-sync nodes
        accumulate justifications through the "just" handler without
        ever reaching _try_finalize's prune (they assemble no local
        quorum), and finality is ancestor-transitive, so only the
        newest round needs retaining — the same O(1) retention the
        vote path keeps."""
        for rnd in sorted(self.justifications):
            j = self.justifications[rnd]
            if j.target_number > self.node.finalized \
                    and j.target_hash in self.node.headers:
                self.node.on_justification(j)
        if self.justifications:
            newest = max(self.justifications)
            for r in [r for r in self.justifications if r < newest]:
                del self.justifications[r]

    # -- incoming ----------------------------------------------------------
    def on_vote(self, vote: Vote) -> None:
        """Tally a (possibly remote) vote. Invalid signatures are
        dropped; equivocations are recorded as evidence and the vote
        is NOT counted (first vote stands, GRANDPA-style)."""
        from ..crypto import ed25519

        node = self.node
        if vote.voter not in node.authorities:
            return
        if vote.round <= node.finalized:
            return   # stale round
        pub = node.runtime.state.get("system", "session_key", vote.voter)
        if pub is None or not ed25519.verify(
                pub, vote.signing_payload(node.runtime.genesis_hash()),
                vote.signature):
            return
        first = self._first.setdefault(vote.round, {})
        prev = first.get(vote.voter)
        if prev is not None:
            if prev.target_hash != vote.target_hash:
                self.equivocations.append((prev, vote))
            return
        first[vote.voter] = vote
        self._tally.setdefault(vote.round, {}).setdefault(
            vote.target_hash, {})[vote.voter] = vote
        self._try_finalize(vote.round, vote.target_hash)

    def _try_finalize(self, rnd: int, target_hash: bytes) -> None:
        node = self.node
        votes = self._tally.get(rnd, {}).get(target_hash, {})
        n_auth = len(node.authorities)
        if 3 * len(votes) < 2 * n_auth or rnd in self.justifications:
            return
        just = Justification(round=rnd, target_hash=target_hash,
                             target_number=rnd,
                             votes=tuple(votes[v]
                                         for v in sorted(votes)))
        self.justifications[rnd] = just
        node.on_justification(just)
        # rounds below the justified height are settled; older
        # justifications are implied by the newest (finality is
        # ancestor-transitive), so retention stays O(1)
        for r in [r for r in self._tally if r < rnd]:
            self._tally.pop(r, None)
            self._first.pop(r, None)
        for r in [r for r in self.justifications if r < rnd]:
            del self.justifications[r]

    # -- evidence ----------------------------------------------------------
    def take_equivocations(self) -> list[tuple[Vote, Vote]]:
        evs, self.equivocations = self.equivocations, []
        return evs

    def verify_justification(self, just: Justification) -> bool:
        """Check a peer-supplied justification: 2/3 distinct authority
        votes, all validly signed over the claimed target (used when
        syncing finality without having seen the votes live)."""
        from ..crypto import ed25519

        node = self.node
        # judge against the authority set in force AT the target (era
        # rotation makes the set height-dependent); falls back to the
        # current set for targets we have not yet imported
        target = node.headers.get(just.target_hash)
        authorities = node.authorities_at(target.parent) \
            if target is not None else node.authorities
        seen = set()
        for v in just.votes:
            if not isinstance(v, Vote) or v.voter in seen:
                return False
            if v.round != just.round or v.target_hash != just.target_hash \
                    or v.target_number != just.target_number:
                return False
            if v.voter not in authorities:
                return False
            pub = node.runtime.state.get("system", "session_key", v.voter)
            if pub is None or not ed25519.verify(
                    pub, v.signing_payload(node.runtime.genesis_hash()),
                    v.signature):
                return False
            seen.add(v.voter)
        return 3 * len(seen) >= 2 * len(authorities)
