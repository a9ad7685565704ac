"""Block production, tree-based import, fork choice, reorg, finality.

The reference's node assembles libp2p gossip + RRSC authoring + a
GRANDPA voter loop (SURVEY.md §3.1, §3.4;
the reference's node/src/service.rs:448-506,556-580); multi-node
behavior is only exercised on live testnets. Here the same roles with
a real block TREE:

- every Node owns a full Runtime replica and imports blocks onto any
  known parent (side branches included), re-executing and verifying
  VRF claim + state root only when a branch becomes canonical;
- fork choice: heaviest chain by (height, cumulative primary-slot
  count); reorgs rewind per-block state undo logs (O(changes), the
  role of Substrate's tree-backed storage) and replay the winning
  branch;
- finality is a vote exchange (cess_tpu_torch/node/finality.py): signed
  votes, 2/3 justifications, equivocation evidence reportable on
  chain. Finalized blocks bound fork choice; a justification on a
  side branch forces the node onto it.

The in-process Network driver at the bottom synchronizes slots across
nodes — the socket transport (cess_tpu_torch/node/net.py) runs the same Node
between OS processes.
"""
from __future__ import annotations

import dataclasses
import hashlib

from .. import codec
from ..chain.extrinsic import SignedExtrinsic, sign_extrinsic
from ..chain.state import DispatchError
from ..obs import trace
from .chain_spec import ChainSpec
from .consensus import Rrsc, SlotClaim
from .finality import FinalityGadget, Justification


@codec.register
@dataclasses.dataclass(frozen=True)
class Header:
    number: int
    parent: bytes
    state_root: bytes
    author: str
    claim: SlotClaim | None    # None only for genesis

    def hash(self) -> bytes:
        # codec-canonical (NOT repr): identical bytes on every process
        # and across the disk/gossip wire. Memoized — hashing is on the
        # fork-choice/finality hot path (not a codec field, so encoding
        # and equality are unaffected).
        h = self.__dict__.get("_hash")
        if h is None:
            h = hashlib.sha256(codec.encode(self)).digest()
            object.__setattr__(self, "_hash", h)
        return h


@codec.register
@dataclasses.dataclass(frozen=True)
class Block:
    header: Header
    extrinsics: tuple  # (SignedExtrinsic, ...)


@dataclasses.dataclass
class _UndoRec:
    """Everything needed to rewind one canonical block in a reorg."""

    state_undo: list
    block_before: int
    events_before: list
    authorities_before: tuple[str, ...]
    vrf_note: tuple[int, bytes] | None   # (epoch, output) if primary


class Node:
    def __init__(self, spec: ChainSpec, name: str,
                 keystore: dict[str, object] | None = None,
                 base_path: str | None = None,
                 snapshot_interval: int = 50):
        self.spec = spec
        self.name = name
        # dev keystore: session keys for the accounts this node runs
        self.keystore = keystore if keystore is not None else {}
        self.runtime = spec.build_runtime()
        self.rrsc = Rrsc(spec.epoch_blocks)
        self.authorities = tuple(v.account for v in spec.validators)
        genesis = Header(number=0, parent=b"\0" * 32,
                         state_root=self.runtime.state.state_root(),
                         author="", claim=None)
        self.chain: list[Header] = [genesis]
        # block tree: all known headers/bodies by hash; side branches
        # are stored unexecuted until fork choice adopts them
        gh = genesis.hash()
        self.headers: dict[bytes, Header] = {gh: genesis}
        self.bodies: dict[bytes, Block] = {}
        self._primaries: dict[bytes, int] = {gh: 0}
        self._undo: dict[bytes, _UndoRec] = {}
        # authority set AFTER applying each executed block (era
        # rotation makes the set branch-dependent)
        self._authset: dict[bytes, tuple[str, ...]] = {gh: self.authorities}
        self.tx_pool: list[SignedExtrinsic] = []
        self.offchain_agents: list = []
        self.finalized: int = 0
        self.finality = FinalityGadget(self)
        self._proposal: tuple | None = None
        # canonical bodies by number, kept for serving peer sync
        self.block_bodies: dict[int, Block] = {}
        self.base_path = base_path
        self.snapshot_interval = snapshot_interval
        self.store = None
        if base_path:
            import os

            from . import store as _store

            os.makedirs(base_path, exist_ok=True)
            # fast path: state checkpoint, then replay the block tail
            _store.load_snapshot(base_path, self)
            self.store = _store.BlockStore(
                os.path.join(base_path, _store.BLOCKS_FILE))
            for block in self.store:
                try:
                    self.import_block(block, _persist=False)
                except ValueError:
                    continue   # dead fork below finality, duplicates

    # -- tree bookkeeping -----------------------------------------------------
    def head(self) -> Header:
        return self.chain[-1]

    def _index_header(self, header: Header) -> None:
        h = header.hash()
        self.headers[h] = header
        self._primaries[h] = self._primaries[header.parent] \
            + (1 if header.claim and header.claim.vrf is not None else 0)

    def _weight(self, tip_hash: bytes) -> tuple[int, int]:
        """Fork-choice weight: (height, cumulative primary slots).
        Strictly-greater wins; ties keep the incumbent (deterministic
        per node; the vote exchange settles cross-node ties)."""
        return (self.headers[tip_hash].number, self._primaries[tip_hash])

    def _is_canonical(self, h: bytes) -> bool:
        header = self.headers.get(h)
        return (header is not None and header.number < len(self.chain)
                and self.chain[header.number].hash() == h)

    def authorities_at(self, block_hash: bytes) -> tuple[str, ...]:
        """The authority set in force for a child of ``block_hash``:
        the set after applying that block, or (for stored-unexecuted
        side-branch ancestors) the deepest executed ancestor's set.
        Era rotation makes this branch-dependent — verifying a fork
        block against the head's set would reject valid forks."""
        cur = block_hash
        while cur in self.headers:
            got = self._authset.get(cur)
            if got is not None:
                return got
            cur = self.headers[cur].parent
        return self.authorities

    def _persist_block(self, block: Block) -> None:
        self.block_bodies[block.header.number] = block
        if self.store is not None:
            self.store.append(block)
            if self.snapshot_interval \
                    and block.header.number % self.snapshot_interval == 0:
                from . import store as _store

                _store.write_snapshot(self.base_path, self)

    # -- sync -----------------------------------------------------------------
    def sync_from(self, peer: "Node") -> int:
        """Catch up from a peer's canonical chain (the restart/warp
        sync path, ref service.rs:259-274). Finds the highest common
        block, imports the peer's tail (fork choice decides whether to
        adopt), then verifies + adopts the peer's justifications.
        Returns the number of blocks imported."""
        if self.chain[0].hash() != peer.chain[0].hash():
            return 0   # different genesis: not our chain, refuse cleanly
        common = min(self.head().number, peer.head().number)
        while self.chain[common].hash() != peer.chain[common].hash():
            common -= 1
        imported = 0
        for n in range(common + 1, peer.head().number + 1):
            body = peer.block_bodies.get(n)
            if body is None:
                break
            try:
                self.import_block(body)
            except ValueError:
                break
            imported += 1
        if peer.finality.justifications:
            # adopt the peer's newest justification (older rounds are
            # implied: finalizing a block finalizes its ancestors)
            rnd = max(peer.finality.justifications)
            just = peer.finality.justifications[rnd]
            if rnd > self.finalized \
                    and self.finality.verify_justification(just):
                self.finality.justifications[rnd] = just
                self.on_justification(just)
        return imported

    def warp_sync_from(self, peer: "Node") -> bool:
        """Checkpoint (warp) sync: adopt the peer's state snapshot
        WITHOUT replaying the chain — the reference's warp-sync role
        (service.rs:259-263), shaped like production checkpoint sync.

        Trust model: store.verify_and_adopt_warp — the ONE shared
        verification path (genesis-derived authority set, never the
        snapshot's own; genesis-anchored parent-linked header chain;
        state-root-proven KV; justification targeting that chain),
        also used by the TCP transport (net.NodeService._try_warp)."""
        from . import store as _store

        if not peer.finality.justifications:
            return False
        rnd = max(peer.finality.justifications)
        just = peer.finality.justifications[rnd]
        return _store.verify_and_adopt_warp(
            self, _store.snapshot_payload(peer), just,
            lambda: Node(self.spec, f"{self.name}-warp", {}))

    # -- tx pool ---------------------------------------------------------------
    def queue_heartbeats(self) -> list[SignedExtrinsic]:
        """im-online OCW analog shared by both network drivers: queue
        one heartbeat per era for each local authority key not yet
        beaten/pending. Returns the newly queued txs (the TCP service
        gossips them — authoring a block is not guaranteed per era)."""
        era = self.runtime.staking.current_era()
        new = []
        staking = self.runtime.staking
        for account in self.keystore:
            # gate matches im_online admission: EXPOSED validators must
            # beat even when not in the elected author set (the
            # max_validators cap), else they are liveness-slashed while
            # fully online
            is_authority = account in self.authorities \
                or account in staking.validators() \
                or account in staking.era_validators(era)
            if not is_authority \
                    or self.runtime.im_online.has_beat(era, account) \
                    or any(t.call == "im_online.heartbeat"
                           and t.signer == account for t in self.tx_pool):
                continue
            try:
                self.submit_extrinsic(account, "im_online.heartbeat")
                new.append(self.tx_pool[-1])
            except DispatchError:
                pass
        return new

    def submit_extrinsic(self, origin: str, call: str, *args, **kwargs) -> None:
        """Dev-mode convenience: sign with the spec-derived account key
        (the //Alice pattern) and submit. ``origin="root"`` signs as
        the chain's sudo account. Production clients build a
        SignedExtrinsic themselves and use :meth:`submit_signed`."""
        if origin == "root":
            sudo = self.runtime.system.sudo()
            if sudo is None:
                raise DispatchError("system.BadOrigin", call)
            origin = sudo
        key = self.spec.account_key(origin)
        nonce = self.runtime.system.nonce(origin) \
            + sum(1 for xt in self.tx_pool if xt.signer == origin)
        self.submit_signed(sign_extrinsic(
            key, self.runtime.genesis_hash(), origin, nonce, call, args,
            kwargs))

    def submit_signed(self, xt: SignedExtrinsic) -> None:
        """Pool admission: full SignedExtra validation (signature,
        binding, sequential nonce, fee affordability) before the tx is
        gossiped. Raises DispatchError when invalid."""
        pending = sum(1 for t in self.tx_pool if t.signer == xt.signer)
        self.runtime.validate_signed(xt, pending_from_signer=pending)
        self.tx_pool.append(xt)

    # -- authoring ---------------------------------------------------------------
    def try_author(self, slot: int,
                   extrinsics: tuple | None = None) -> Block | None:
        """Claim the slot with any local authority key and build a block
        on the current best head as an OPEN PROPOSAL — the caller must
        commit_proposal() or abort_proposal() (fork choice may prefer a
        peer's block).

        ``extrinsics``: the tx set to include (the Network hands every
        proposer the same gossip snapshot); standalone nodes default to
        draining their own pool."""
        assert self._proposal is None, "previous proposal not resolved"
        for account, key in self.keystore.items():
            if account not in self.authorities:
                continue
            if self.head().number == 0:
                # pre-genesis: the epoch anchor floats with the trial
                # slot; it pins permanently at block #1 (import/adopt)
                self.rrsc.genesis_slot = slot
            claim = self.rrsc.claim_slot(slot, account, key, self.authorities)
            if claim is None:
                continue
            if extrinsics is None:
                extrinsics = tuple(self.tx_pool)
                self.tx_pool.clear()
            snapshot = (self.runtime.state.block,
                        list(self.runtime.state.events))
            self.runtime.state.begin_tx()
            self._execute(claim, extrinsics)
            header = Header(number=len(self.chain),
                            parent=self.head().hash(),
                            state_root=self.runtime.state.state_root(),
                            author=account, claim=claim)
            self._proposal = (header, extrinsics, snapshot)
            return Block(header=header, extrinsics=extrinsics)
        return None

    def commit_proposal(self) -> None:
        header, extrinsics, (block0, events0) = self._proposal
        if header.number == 1:
            self.rrsc.genesis_slot = header.claim.slot
        undo = self.runtime.state.commit_tx_undo()
        self._proposal = None
        self._adopt_block(Block(header=header, extrinsics=extrinsics),
                          undo, block0, events0, persist=True)

    def abort_proposal(self, requeue: bool = True) -> None:
        """Fork choice lost: roll the whole block back; re-queue txs
        unless the caller owns tx distribution (Network does)."""
        _, extrinsics, (block0, events0) = self._proposal
        self.runtime.state.rollback_tx()
        self.runtime.state.block = block0
        # the aborted block's archive stamped everything with block0
        self.runtime.state.truncate_history(block0)
        self.runtime.state.events[:] = events0
        self._proposal = None
        if requeue:
            self.tx_pool[:0] = list(extrinsics)

    def _execute(self, claim: SlotClaim, extrinsics: tuple) -> None:
        self.runtime.init_block(self.rrsc.block_randomness(claim),
                                author=claim.authority)
        for xt in extrinsics:
            # deterministic across replicas: every node skips the same
            # invalid tx with the same event, and records the same
            # eth-visible receipt (runtime.apply_in_block)
            self.runtime.apply_in_block(xt)

    def _adopt_block(self, block: Block, undo: list, block0: int,
                     events0: list, persist: bool,
                     fire_agents: bool = True) -> None:
        """Append an EXECUTED block to the canonical chain, recording
        its undo + consensus side effects for possible rewind."""
        header = block.header
        claim = header.claim
        vrf_note = None
        if claim.vrf is not None:
            epoch = self.rrsc.epoch_of(claim.slot)
            self.rrsc.note_vrf(claim.slot, claim.vrf.output)
            vrf_note = (epoch, claim.vrf.output)
        auth_before = self.authorities
        self.chain.append(header)
        self._index_header(header)
        self.bodies[header.hash()] = block
        self._undo[header.hash()] = _UndoRec(
            state_undo=undo, block_before=block0, events_before=events0,
            authorities_before=auth_before, vrf_note=vrf_note)
        self._maybe_rotate_session()
        self._authset[header.hash()] = self.authorities
        if persist:
            self._persist_block(block)
        else:
            self.block_bodies[header.number] = block
        if fire_agents:
            for agent in self.offchain_agents:
                agent.on_block(self)

    def _maybe_rotate_session(self) -> None:
        """Era boundary: READ the multi-phase election result that the
        runtime's era hook resolved inside block execution (verified
        signed solution if one beat the solver, else the on-chain
        credit-weighted fallback) and refresh the authority set
        (reference §3.5; runtime/src/lib.rs:613,834-863). Resolution
        itself lives in the runtime so deposits/queue sweeps are
        covered by the block undo log."""
        if self.runtime.state.block % self.spec.era_blocks:
            return
        elected = self.runtime.election.result()
        if elected:
            self.authorities = elected

    # -- import -------------------------------------------------------------------
    def import_block(self, block: Block, _persist: bool = True) -> None:
        """Tree import: verify the claim; execute (re-deriving the
        state root) when the block extends the best chain, store
        side-branch blocks and reorg when their branch outweighs."""
        header = block.header
        h = header.hash()
        if h in self.headers:
            # duplicate (idempotent: gossip redelivers); re-register the
            # body if we only held the header (snapshot-restored chain)
            if h not in self.bodies:
                self.bodies[h] = block
                if self._is_canonical(h):
                    self.block_bodies.setdefault(header.number, block)
            return
        parent = self.headers.get(header.parent)
        if parent is None:
            raise ValueError(f"{self.name}: unknown parent for "
                             f"#{header.number}")
        if header.number != parent.number + 1:
            raise ValueError(f"{self.name}: number {header.number} does "
                             f"not follow parent {parent.number}")
        if header.number <= self.finalized:
            raise ValueError(f"{self.name}: #{header.number} conflicts "
                             f"with finality at #{self.finalized}")
        public = self.spec.session_key(header.author).public
        authorities = self.authorities_at(header.parent)
        if header.number == 1 and self.rrsc.genesis_slot is None:
            # epoch numbering anchors at the chain's first slot; pin it
            # BEFORE verification so author and importers agree. Only
            # an UNPINNED node pins here — a competing block #1 on a
            # progressed node must not re-anchor epochs (that would
            # poison every later claim); restore on verify failure so
            # a junk claim cannot pin garbage
            self.rrsc.genesis_slot = header.claim.slot
            if not self.rrsc.verify_claim(header.claim, public,
                                          authorities):
                self.rrsc.genesis_slot = None
                raise ValueError(f"{self.name}: bad slot claim")
        elif not self.rrsc.verify_claim(header.claim, public, authorities):
            raise ValueError(f"{self.name}: bad slot claim")
        if header.parent == self.head().hash():
            self._apply_to_head(block, persist=_persist)
            return
        # side branch: store, reorg if the branch now outweighs
        self._index_header(header)
        self.bodies[h] = block
        if self._weight(h) > self._weight(self.head().hash()):
            self._reorg_to(h, persist=_persist)

    def _apply_to_head(self, block: Block, persist: bool,
                       fire_agents: bool = True) -> None:
        """Execute a block extending the current head; raises (with
        full rollback) on state-root mismatch."""
        state = self.runtime.state
        snapshot = (state.block, list(state.events))
        state.begin_tx()
        try:
            self._execute(block.header.claim, block.extrinsics)
            got = state.state_root()
            if got != block.header.state_root:
                raise ValueError(
                    f"{self.name}: state root mismatch at "
                    f"#{block.header.number} — replicas diverged")
        except Exception:
            state.rollback_tx()
            state.block = snapshot[0]
            state.truncate_history(snapshot[0])
            state.events[:] = snapshot[1]
            raise
        undo = state.commit_tx_undo()
        self._adopt_block(block, undo, snapshot[0], snapshot[1],
                          persist=persist, fire_agents=fire_agents)

    # -- reorg --------------------------------------------------------------------
    def _can_rewind_to(self, fork_number: int) -> bool:
        """Every canonical block above the fork point must carry an
        undo log (snapshot-restored blocks do not) — checked BEFORE
        any rewind so a refused reorg leaves the node untouched."""
        return all(self.chain[n].hash() in self._undo
                   for n in range(fork_number + 1, len(self.chain)))

    def _rewind_one(self) -> None:
        head = self.chain[-1]
        rec = self._undo.pop(head.hash(), None)
        if rec is None:
            # blocks restored from a snapshot carry no undo log —
            # they are effectively final for this node
            raise ValueError(f"{self.name}: cannot rewind #{head.number} "
                             "(no undo log; snapshot-restored)")
        self.chain.pop()
        self._authset.pop(head.hash(), None)
        state = self.runtime.state
        state.apply_undo(rec.state_undo)
        state.block = rec.block_before
        state.truncate_history(rec.block_before)
        state.events[:] = rec.events_before
        self.authorities = rec.authorities_before
        if head.number == 1:
            self.rrsc.genesis_slot = None   # re-pins with the next block 1
        if rec.vrf_note is not None:
            epoch, output = rec.vrf_note
            outs = self.rrsc._epoch_vrf.get(epoch, [])
            if output in outs:
                outs.remove(output)
            # later epoch randomness derived from these outputs is stale
            for e in [e for e in self.rrsc.randomness if e > epoch]:
                del self.rrsc.randomness[e]
        self.block_bodies.pop(head.number, None)

    def _branch_path(self, tip_hash: bytes) -> tuple[int, list[bytes]]:
        """(fork_number, path tip->..->child-of-fork) back to the
        canonical chain."""
        path = []
        cur = tip_hash
        while not self._is_canonical(cur):
            path.append(cur)
            cur = self.headers[cur].parent
        return self.headers[cur].number, path

    def _reorg_to(self, tip_hash: bytes, persist: bool = True) -> None:
        fork_number, path = self._branch_path(tip_hash)
        if fork_number < self.finalized:
            raise ValueError(f"{self.name}: reorg below finalized "
                             f"#{self.finalized}")
        if not self._can_rewind_to(fork_number):
            raise ValueError(f"{self.name}: reorg to fork at "
                             f"#{fork_number} crosses a snapshot "
                             "boundary (no undo logs)")
        old_tail = [self.block_bodies[n]
                    for n in range(fork_number + 1, len(self.chain))]
        while self.head().number > fork_number:
            self._rewind_one()
        try:
            for i, h in enumerate(reversed(path)):
                if self.bodies[h].header.number == 1:
                    # adopting a different block #1: re-anchor epochs
                    self.rrsc.genesis_slot = \
                        self.bodies[h].header.claim.slot
                # agents fire once, on the new head, not per replayed block
                self._apply_to_head(self.bodies[h], persist=persist,
                                    fire_agents=(i == len(path) - 1))
        except ValueError:
            # losing branch was invalid after all: restore the old chain
            while self.head().number > fork_number:
                self._rewind_one()
            for i, body in enumerate(old_tail):
                self._apply_to_head(body, persist=False,
                                    fire_agents=(i == len(old_tail) - 1))
            raise
        if old_tail:
            self.tx_pool[:0] = [
                xt for b in old_tail for xt in b.extrinsics
                if not any(xt == kept
                           for h2 in path
                           for kept in self.bodies[h2].extrinsics)]

    # -- finality -----------------------------------------------------------------
    def on_justification(self, just: Justification) -> None:
        """2/3 votes assembled (locally or from a peer): finalize —
        forcing a reorg if the justified block is on a side branch."""
        num = just.target_number
        if num <= self.finalized:
            return
        if not self._is_canonical(just.target_hash):
            if just.target_hash not in self.headers:
                return   # unknown block; sync will fetch + re-apply
            try:
                self._reorg_to(just.target_hash)
            except ValueError:
                # pinned (snapshot boundary) or invalid branch: stay
                # put; catch-up sync re-delivers once resolvable
                return
        prev = self.finalized
        self.finalized = num
        # undo logs at/below finality can never rewind: drop them
        # (O(newly finalized), not O(chain))
        for n in range(prev + 1, min(num + 1, len(self.chain))):
            self._undo.pop(self.chain[n].hash(), None)


def author_race(candidates: "list[tuple[Node, Block]]"):
    """Rank an authoring race: primary claims beat secondary, lowest
    VRF output breaks ties. Returns ``(winner_node, winner_block,
    losers)`` with losers as ``(node, block)`` pairs in rank order, or
    ``(None, None, ())`` for an empty race. Shared by the in-process
    :class:`Network` driver and the discrete-event simulation
    (cess_tpu_torch/sim) so both worlds apply the identical fork-choice at
    the authoring seam."""
    ranked = []
    for node, blk in candidates:
        claim = blk.header.claim
        prio = 0 if claim.vrf is not None else 1
        tiebreak = claim.vrf.output if claim.vrf else b"\xff" * 32
        ranked.append((prio, tiebreak, node, blk))
    if not ranked:
        return None, None, ()
    ranked.sort(key=lambda c: (c[0], c[1]))
    _, _, winner, best = ranked[0]
    return winner, best, tuple((n, b) for _, _, n, b in ranked[1:])


class Network:
    """Drives slots across nodes: fork choice (primary beats secondary,
    lowest VRF output wins ties), broadcast, vote-based finality."""

    def __init__(self, nodes: list[Node]):
        self.nodes = nodes
        # tx gossip: one shared mempool (instant propagation); dedupe
        # by identity — nodes re-networked after a peer restart may
        # already share one pool object. The socket transport
        # (node/net.py) replaces this with real per-process pools.
        shared: list[SignedExtrinsic] = []
        seen: set[int] = set()
        for node in nodes:
            for tx in node.tx_pool:
                if id(tx) not in seen:
                    seen.add(id(tx))
                    shared.append(tx)
        for node in nodes:
            node.tx_pool = shared

    def _queue_heartbeats(self) -> None:
        """Each node queues heartbeats (a node that is down queues
        nothing and is reported at era end)."""
        for node in self.nodes:
            node.queue_heartbeats()

    def run_slot(self, slot: int) -> Block | None:
        """Authors race; fork choice = primary beats secondary, then
        lowest VRF output; losers roll back and re-import the winner."""
        self._queue_heartbeats()
        txs = tuple(self.nodes[0].tx_pool)   # one gossip snapshot for all
        candidates: list[tuple[Node, Block]] = []
        for node in self.nodes:
            blk = node.try_author(slot, extrinsics=txs)
            if blk is not None:
                candidates.append((node, blk))
        author_node, best, losers = author_race(candidates)
        if author_node is None:
            return None
        for loser, _ in losers:
            loser.abort_proposal(requeue=False)
        # drop included txs from the shared pool BEFORE _post_block
        # fires the offchain agents: their new submissions compute
        # nonces as on-chain + pending, and the included txs' nonces
        # are already consumed on chain — counting them again would
        # assign too-high nonces that fail at execution (BadNonce)
        pool = self.nodes[0].tx_pool
        included = {id(tx) for tx in best.extrinsics}
        pool[:] = [tx for tx in pool if id(tx) not in included]
        author_node.commit_proposal()
        for node in self.nodes:
            if node is not author_node:
                # the in-process gossip hop: one delivery span per peer
                # import (the socket transport's envelope analog, so an
                # armed tracer sees the same net-hop stage here as the
                # TCP service's net.send/net.recv spans record)
                with trace.span("net.deliver", sys="net",
                                block=best.header.number, to=node.name):
                    node.import_block(best)
        self.exchange_votes()
        return best

    def exchange_votes(self) -> None:
        """The GRANDPA-gossip analog: every node casts signed votes
        for its best chain and every vote reaches every node; each
        node tallies + finalizes independently.

        Each node also RE-SHARES its own unfinalized votes (receivers
        dedup first-seen): nodes re-joined after a partition would
        otherwise never learn the other side's round votes, leaving
        own-vote locks (finality._locked) un-releasable and finality
        needlessly stalled until the lock horizon."""
        votes = []
        for node in self.nodes:
            votes.extend(node.finality.cast_votes())
            votes.extend(node.finality.own_unfinalized_votes())
        for node in self.nodes:
            for v in votes:
                node.finality.on_vote(v)

    def run_slots(self, count: int) -> None:
        start = max(len(n.chain) for n in self.nodes)
        produced = 0
        slot = start
        while produced < count:
            if self.run_slot(slot) is not None:
                produced += 1
            slot += 1
