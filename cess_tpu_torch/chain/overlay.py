"""Frame-chained overlays: the one commit discipline both execution
layers (evm.py worlds, contracts.py sessions) share.

Each call frame holds an overlay chained over its PARENT frame's
overlay; the root falls through to chain state. A frame that succeeds
commits into its parent — so when an intermediate frame later reverts,
its whole subtree's writes vanish with it (call-chain transactionality;
a direct-to-chain commit let a reverted frame's grandchildren persist,
review-confirmed in both VMs before this was factored out). Chained
reads also give re-entered frames a consistent view of ancestors'
pending writes. The root commits to chain only when the TOP frame
succeeds; read-only queries simply never commit their root.
"""
from __future__ import annotations


class ChainedOverlay:
    """Key/value overlay chain; ``root_get(key)`` / ``root_put(key, v)``
    bridge the root frame to real storage. Subclasses add frame-local
    extras (e.g. pending events) by extending ``commit``."""

    def __init__(self, root_get, root_put, parent=None):
        self.root_get = root_get
        self.root_put = root_put
        self.parent = parent
        self.over: dict = {}

    def get(self, key):
        frame = self
        while frame is not None:
            if key in frame.over:
                return frame.over[key]
            frame = frame.parent
        return self.root_get(key)

    def put(self, key, value) -> None:
        self.over[key] = value

    def commit(self) -> None:
        """Into the parent frame; at the root, into real storage."""
        if self.parent is not None:
            self.parent.over.update(self.over)
        else:
            for key, value in sorted(self.over.items(),
                                     key=lambda kv: repr(kv[0])):
                self.root_put(key, value)
