"""Merkle Mountain Range over block headers (the pallet-mmr role,
the reference's runtime/src/lib.rs:1270-1274,1492 with LeafData =
ParentNumberAndHash, served over the node's Mmr RPC,
the reference's node/src/rpc.rs namespace list).

An MMR commits to every header ever produced with one root that only
ever APPENDS: a light client holding the current root can check an
inclusion proof for any historical header without replaying the chain
— the complement to warp sync (which discards old bodies). Leaves are
(number, header_hash); interior nodes / roots are domain-tagged
SHA-256, and the root binds the leaf count so a truncated forest
cannot masquerade as a smaller valid one.

Design notes (redesigned native, not a port): positions use the
standard 0-based MMR numbering (parent immediately follows its right
child); proofs carry the climb path as (sibling_hash, sibling_is_right)
plus the other peaks split around the leaf's peak, so verification is
a single fold with no position arithmetic on the verifier side.
The node keeps an incrementally-extended instance per canonical chain
(rebuilt from headers after a reorg — headers are always retained,
even by warp sync)."""
from __future__ import annotations

import dataclasses
import hashlib

from .. import codec

_LEAF = b"cess-mmr-leaf:"
_NODE = b"cess-mmr-node:"
_ROOT = b"cess-mmr-root:"


def leaf_hash(number: int, header_hash: bytes) -> bytes:
    return hashlib.sha256(_LEAF + number.to_bytes(8, "little")
                          + header_hash).digest()


def _node_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(_NODE + left + right).digest()


def _root_hash(leaf_count: int, peaks: list[bytes]) -> bytes:
    return hashlib.sha256(_ROOT + leaf_count.to_bytes(8, "little")
                          + b"".join(peaks)).digest()


def _pos_height(pos: int) -> int:
    """Height of the node at 0-based position ``pos``: jump left
    across perfect subtrees until the 1-based index is all-ones."""
    p = pos + 1
    while p & (p + 1):
        p -= (1 << (p.bit_length() - 1)) - 1
    return p.bit_length() - 1


def _leaf_pos(i: int) -> int:
    """Position of leaf i: 2*i minus the perfect-tree parents skipped."""
    return 2 * i - bin(i).count("1")


def _peak_positions(size: int) -> list[int]:
    """Peak positions of an MMR with ``size`` nodes (greedy largest
    perfect subtrees, left to right)."""
    out, pos, left = [], 0, size
    while left > 0:
        h = (left + 1).bit_length() - 1
        tree = (1 << h) - 1
        out.append(pos + tree - 1)
        pos += tree
        left -= tree
    return out


@codec.register
@dataclasses.dataclass(frozen=True)
class MmrProof:
    leaf_index: int
    leaf_count: int
    # climb path bottom-up: (sibling hash, sibling-is-right-child)
    path: tuple
    peaks_left: tuple      # peak hashes left of the leaf's peak
    peaks_right: tuple     # ...and right of it


class Mmr:
    """Append-only forest; nodes held in a flat positional list."""

    def __init__(self):
        self.nodes: list[bytes] = []
        self.leaf_count = 0

    def append(self, number: int, header_hash: bytes) -> None:
        self.nodes.append(leaf_hash(number, header_hash))
        self.leaf_count += 1
        # merge equal-height subtrees while the new position closes one
        h = 0
        while _pos_height(len(self.nodes)) > h:
            right = self.nodes[-1]
            left = self.nodes[len(self.nodes) - (2 << h)]
            self.nodes.append(_node_hash(left, right))
            h += 1

    def root(self) -> bytes:
        peaks = [self.nodes[p] for p in _peak_positions(len(self.nodes))]
        return _root_hash(self.leaf_count, peaks)

    def proof(self, leaf_index: int) -> MmrProof:
        if not 0 <= leaf_index < self.leaf_count:
            raise IndexError(f"leaf {leaf_index} of {self.leaf_count}")
        peaks = _peak_positions(len(self.nodes))
        pos, h, path = _leaf_pos(leaf_index), 0, []
        while pos not in peaks:
            if _pos_height(pos + 1) == h + 1:
                # pos is a right child; left sibling precedes the tree
                sib = pos - ((2 << h) - 1)
                path.append((self.nodes[sib], False))
                pos += 1
            else:
                sib = pos + ((2 << h) - 1)
                path.append((self.nodes[sib], True))
                pos = sib + 1
            h += 1
        k = peaks.index(pos)
        return MmrProof(
            leaf_index=leaf_index, leaf_count=self.leaf_count,
            path=tuple(path),
            peaks_left=tuple(self.nodes[p] for p in peaks[:k]),
            peaks_right=tuple(self.nodes[p] for p in peaks[k + 1:]))


def verify_proof(root: bytes, number: int, header_hash: bytes,
                 proof: MmrProof) -> bool:
    """Check a header's inclusion against an MMR root — pure function,
    no chain access (the light-client half)."""
    try:   # EVERY check inside: crafted inputs fail closed, never raise
        if not isinstance(proof, MmrProof) \
                or not isinstance(proof.leaf_count, int) \
                or isinstance(proof.leaf_count, bool) \
                or not 0 < proof.leaf_count < 1 << 63 \
                or not isinstance(number, int) \
                or isinstance(number, bool) \
                or not 0 <= number < 1 << 63 \
                or not isinstance(header_hash, bytes) \
                or not all(isinstance(pk, bytes) for pk in
                           tuple(proof.peaks_left)
                           + tuple(proof.peaks_right)):
            return False
        acc = leaf_hash(number, header_hash)
        for item in proof.path:
            if not (isinstance(item, tuple) and len(item) == 2
                    and isinstance(item[0], bytes)):
                return False
            sib, right = item
            acc = _node_hash(acc, sib) if right else _node_hash(sib, acc)
        peaks = list(proof.peaks_left) + [acc] + list(proof.peaks_right)
        return _root_hash(proof.leaf_count, peaks) == root
    except (TypeError, ValueError, OverflowError):
        return False   # belt-and-braces: the contract is bool, not raise


class HeaderMmr:
    """Node-side cache: tracks the canonical chain, extending
    incrementally and rebuilding after a reorg (header lists are
    always retained — warp sync prunes bodies, not headers)."""

    def __init__(self):
        self._mmr = Mmr()
        self._hashes: list[bytes] = []   # header hash per appended leaf

    def sync(self, chain) -> Mmr:
        """Bring the MMR in line with ``chain`` (list of headers)."""
        n = len(self._hashes)
        if n > len(chain) or any(
                self._hashes[i] != chain[i].hash()
                for i in (n - 1, n // 2, 0) if 0 <= i < n):
            # reorg (spot-checked at three depths): rebuild
            self._mmr = Mmr()
            self._hashes = []
            n = 0
        for i in range(n, len(chain)):
            h = chain[i].hash()
            self._mmr.append(chain[i].number, h)
            self._hashes.append(h)
        return self._mmr
