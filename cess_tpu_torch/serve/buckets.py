"""Shape buckets and the program cache of the engine.

The port's copy of ``cess_tpu/serve/buckets.py``. A coalesced batch's
row axis is padded up to a power of two, so each op sees O(log rows)
distinct shapes, and the bound callable that serves a (op, bucket shape,
aux key) is memoized in :class:`ProgramCache`. Here a "program" is a
Python callable over tensors: the codec's bound method, a closure over
a challenge round's staged tensors, or, for a warmed repair pattern, the
codec's CUDA-graph replay (``TorchCodec.warm_reconstruct``), which
replays only for the exact input shape it was captured at. That is why
the power-of-two buckets stay: like an XLA program, a CUDA graph is
reused only when the shape recurs.

Padding is with zero rows, sliced off after the op; every engine op is
row-independent, so padded results equal unpadded ones.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable


def bucket_rows(n: int) -> int:
    """Smallest power of two >= n. A single request past the policy's
    row budget still pads to the next power of two rather than getting
    an exact-size one-off program."""
    if n < 1:
        raise ValueError(f"bucket for {n} rows")
    b = 1
    while b < n:
        b <<= 1
    return b


class ProgramCache:
    """(op, bucket shape, aux key) -> bound callable, LRU.

    Bounded: prove/verify keys embed the challenge round's digest, so a
    long-running engine sees keys that are hot for one round and dead
    afterwards; LRU with a generous capacity keeps every live round's
    programs while dead rounds fall out."""

    CAPACITY = 256

    def __init__(self, stats=None, capacity: int = CAPACITY):
        self._programs: "collections.OrderedDict[tuple, Callable]" = \
            collections.OrderedDict()
        self._stats = stats
        self.capacity = capacity
        # the engine's obs.profile.ProfilePlane when it has one: every
        # MISS lands in its CompileLedger with the key and the build's
        # wall time (hits never get there)
        self.profile = None
        # the batcher thread owns steady-state lookups, but warm-path
        # callers (SubmissionEngine.warm_repair) fill it from their own
        # thread
        self._mu = threading.Lock()

    def __len__(self) -> int:
        with self._mu:
            return len(self._programs)

    def keys(self) -> list[tuple]:
        """The cached keys, least recently used first: which (op, bucket
        shape) programs the engine has served."""
        with self._mu:
            return list(self._programs)

    def get(self, key: tuple, build: Callable[[], Callable]) -> Callable:
        with self._mu:
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                if self._stats is not None:
                    self._stats.programs_reused += 1
                return prog
        # build OUTSIDE the lock: a build stages tables and matrices on
        # the device and must not serialize against concurrent hits
        prof = self.profile
        if prof is None:
            prog = build()
        else:
            t0 = time.perf_counter()
            prog = build()
            prof.compile_event(key, time.perf_counter() - t0)
        with self._mu:
            if key not in self._programs:
                self._programs[key] = prog
                if self._stats is not None:
                    self._stats.programs_built += 1
                while len(self._programs) > self.capacity:
                    self._programs.popitem(last=False)
            else:
                prog = self._programs[key]
        return prog
