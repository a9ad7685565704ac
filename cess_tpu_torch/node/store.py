"""On-disk persistence: append-only block store + state snapshots.

The reference persists chain state in RocksDB via the Substrate
backend and resumes/warp-syncs on restart
(the reference's node/src/service.rs:259-274). Here the same
capability with the framework's own canonical codec:

- ``BlockStore``: an append-only log of length-prefixed codec-encoded
  blocks (bodies included — the node serves sync from it). Torn tail
  writes from a crash are detected and truncated on open.
- ``Snapshot``: periodic full-state checkpoint (headers, KV state,
  consensus randomness, authorities, finality mark) so restart cost is
  O(blocks since snapshot), not O(chain length). The restored KV is
  integrity-checked against the stored head's state root before use.

A restarted node replays its own stored blocks through the normal
import path (claims re-verified, state re-executed) and then catches
up missed blocks from peers (Node.sync_from).
"""
from __future__ import annotations

import os
import struct
from typing import Iterator

from .. import codec

_LEN = struct.Struct("<I")
_MAGIC = b"CTPU"


class BlockStore:
    """Append-only block log: [4-byte magic] then per record
    [4-byte LE length][codec bytes]."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        valid = self._scan_valid_length()
        if valid is None:
            with open(path, "wb") as f:
                f.write(_MAGIC)
        elif valid < os.path.getsize(path):
            # torn tail from a crash: truncate to the last whole record
            with open(path, "r+b") as f:
                f.truncate(valid)
        self._f = open(path, "ab")

    def _scan_valid_length(self) -> int | None:
        if not os.path.exists(self.path):
            return None
        size = os.path.getsize(self.path)
        if size < len(_MAGIC):
            return None
        with open(self.path, "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                return None
            pos = len(_MAGIC)
            while pos + _LEN.size <= size:
                (n,) = _LEN.unpack(f.read(_LEN.size))
                if pos + _LEN.size + n > size:
                    break
                f.seek(n, 1)
                pos += _LEN.size + n
            return pos

    def append(self, block) -> None:
        raw = codec.encode(block)
        self._f.write(_LEN.pack(len(raw)) + raw)
        self._f.flush()
        os.fsync(self._f.fileno())

    def __iter__(self) -> Iterator:
        with open(self.path, "rb") as f:
            f.read(len(_MAGIC))
            while True:
                head = f.read(_LEN.size)
                if len(head) < _LEN.size:
                    return
                (n,) = _LEN.unpack(head)
                raw = f.read(n)
                if len(raw) < n:
                    return
                try:
                    yield codec.decode(raw)
                except codec.CodecError:
                    return

    def close(self) -> None:
        self._f.close()


SNAPSHOT_FILE = "snapshot.bin"
BLOCKS_FILE = "blocks.bin"


def snapshot_payload(node) -> bytes:
    """The checkpoint wire/disk payload (shared by on-disk snapshots
    and warp sync)."""
    return codec.encode((
        tuple(node.chain),
        node.runtime.state.kv,
        node.runtime.state.block,
        node.rrsc.randomness,
        node.rrsc._epoch_vrf,
        tuple(node.authorities),
        node.finalized,
        dict(node.finality.justifications),
        node.rrsc.genesis_slot,
    ))


def write_snapshot(base_path: str, node) -> None:
    """Atomic full-node checkpoint (tmp + rename)."""
    payload = snapshot_payload(node)
    tmp = os.path.join(base_path, SNAPSHOT_FILE + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC + payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(base_path, SNAPSHOT_FILE))


def load_snapshot(base_path: str, node) -> bool:
    """Restore a checkpoint into ``node``; returns True on success.
    The restored KV must re-derive the stored head's state root —
    a corrupt/tampered snapshot is rejected."""
    path = os.path.join(base_path, SNAPSHOT_FILE)
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(_MAGIC):
        return False
    return restore_snapshot_payload(node, raw[len(_MAGIC):])


def verify_and_adopt_warp(node, snap_bytes: bytes, just,
                          make_probe) -> bool:
    """The ONE warp-sync trust path, shared by the in-process
    Node.warp_sync_from and the TCP NodeService._try_warp.

    Verified before adoption, in this order:
    1. the justification carries >= 2/3 valid signatures from the
       authority set + session keys of the node's OWN (genesis) state —
       the trusted base derived from the chain spec, NEVER material
       carried by the snapshot being judged (else any attacker snapshot
       naming its own authorities would self-verify). If the set has
       legitimately rotated since genesis this fails closed and the
       caller falls back to full replay sync (the reference instead
       follows authority-set handoff proofs from genesis);
    2. the snapshot's header chain starts at the node's locally
       computed genesis and is parent-linked with consecutive numbers;
    3. the snapshot KV re-derives the head's state root
       (restore_snapshot_payload enforces this) and the justification
       targets a block ON that chain.
    Skipped (the warp trade-off, same as the reference's): per-block
    claim verification and execution. Only meaningful on a fresh node.

    ``make_probe()`` builds a throwaway same-spec node used to decode
    the snapshot without touching ``node`` until every check passes.
    """
    if node.head().number != 0:
        return False
    if not (0 < just.target_number
            and node.finality.verify_justification(just)):
        return False
    probe = make_probe()
    if not restore_snapshot_payload(probe, snap_bytes):
        return False
    chain = probe.chain
    if chain[0].hash() != node.chain[0].hash():
        return False
    for parent, child in zip(chain, chain[1:]):
        if child.parent != parent.hash() \
                or child.number != parent.number + 1:
            return False
    if not (just.target_number < len(chain)
            and chain[just.target_number].hash() == just.target_hash):
        return False
    if not restore_snapshot_payload(node, snap_bytes):
        return False
    node.finality.justifications[just.round] = just
    node.finalized = max(node.finalized, just.target_number)
    if node.store is not None:
        write_snapshot(node.base_path, node)
    return True


def restore_snapshot_payload(node, payload: bytes) -> bool:
    """Decode + integrity-check a checkpoint payload into ``node``."""
    try:
        (chain, kv, block, randomness, epoch_vrf, authorities,
         finalized, justifications,
         genesis_slot) = codec.decode(payload)
    except (codec.CodecError, ValueError):
        return False
    if not chain or chain[0].hash() != node.chain[0].hash():
        # empty chain (head() would explode later) or a different
        # genesis than our spec-derived one: refuse before touching
        # any node state
        return False
    state = node.runtime.state
    prev_kv, prev_block = state.kv, state.block
    state.kv = dict(kv)
    state.block = block
    state.rebuild_root_cache()
    if chain and state.state_root() != chain[-1].state_root:
        # Corrupt-but-decodable snapshot: restore the pristine state
        # and report failure so the caller falls back to replaying
        # blocks.bin — bricking startup here would make a recoverable
        # corruption fatal.
        state.kv, state.block = prev_kv, prev_block
        state.rebuild_root_cache()
        return False
    node.chain = list(chain)
    # rebuild the block-tree index for the canonical chain (bodies are
    # re-registered when the block-log replay re-imports them); no undo
    # logs survive a restart, so snapshot blocks cannot be rewound.
    # Pre-restore tree state (headers/bodies/authsets from any chain
    # built before this restore) must not survive — stale entries
    # would mix two histories.
    node.headers = {}
    node.bodies = {}
    node.block_bodies = {}
    node._primaries = {}
    node._undo = {}
    node._authset = {}
    prev_primaries = 0
    for hd in node.chain:
        h = hd.hash()
        node.headers[h] = hd
        prev_primaries += 1 if (hd.claim and hd.claim.vrf) else 0
        node._primaries[h] = prev_primaries
    # Historical per-block authority sets are not in the snapshot.
    # Stamp genesis with the spec-derived set and the head (+ its
    # parent, which is what a head-targeting justification verifies
    # against) with the restored set; justification verification for
    # intermediate heights falls back to the genesis set — i.e. only
    # checkpoint-head justifications are verified against the exact
    # set; deeper history is conservative (fails closed on rotation).
    node._authset[node.chain[0].hash()] = tuple(
        v.account for v in node.spec.validators)
    node._authset[node.chain[-1].hash()] = tuple(authorities)
    if len(node.chain) > 1:
        node._authset[node.chain[-2].hash()] = tuple(authorities)
    node.rrsc.randomness = {int(k): v for k, v in randomness.items()}
    node.rrsc._epoch_vrf = {int(k): list(v) for k, v in epoch_vrf.items()}
    node.authorities = tuple(authorities)
    node.finalized = finalized
    node.finality.justifications = {int(k): v
                                    for k, v in justifications.items()}
    node.rrsc.genesis_slot = genesis_slot
    return True
