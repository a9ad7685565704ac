"""Virtual time: the clock and the seeded event queue under every
simulated world (cess_tpu_torch/sim).

The live stack waits with ``time.sleep`` / ``threading.Event.wait``;
the simulation replaces both with seams that ADVANCE a monotonic
virtual clock instead of blocking, so a thousand-node world runs as
fast as its events execute and two runs of the same seed see the same
timeline down to the microsecond.

Determinism contract (the same one :class:`resilience.FaultPlan`
makes): event order is a pure function of (seed, schedule). Ties at
the same virtual microsecond are broken by a SHA-256 counter stream
over the seed — not by insertion order the caller happened to use, so
reordering *independent* ``push`` calls in the driver cannot silently
change the world's behavior; the witness (:meth:`EventQueue.fired_log`)
would move and the replay test would catch it.

No wall clock, no ``random``: everything in this package is derived
from hashes over the seed (enforced by the ``sim-determinism``
cesslint family).
"""
from __future__ import annotations

import hashlib
import heapq

US = 1_000_000          # microseconds per virtual second


class SimClock:
    """Monotonic virtual time in integer microseconds.

    The three seams mirror the wall-clock idioms the serving stack
    uses, but advance virtual time instead of blocking:

    - :meth:`sleep` — ``time.sleep`` shape (injectable into
      :class:`~cess_tpu_torch.resilience.faults.FaultPlan` and agent retry
      backoff);
    - :meth:`wait` — ``threading.Event.wait`` shape: consumes the
      timeout, returns ``False`` (a virtual wait never observes the
      event firing mid-wait — the event queue owns interleaving);
    - :meth:`deadline` — ``now + seconds`` arithmetic for timeout
      bookkeeping.
    """

    def __init__(self, start_us: int = 0):
        self._now_us = int(start_us)

    def now_us(self) -> int:
        return self._now_us

    def now(self) -> float:
        """Virtual seconds since the epoch of this world."""
        return self._now_us / US

    def advance_to_us(self, t_us: int) -> None:
        if t_us < self._now_us:
            raise ValueError(
                f"virtual time is monotonic: {t_us} < {self._now_us}")
        self._now_us = int(t_us)

    def sleep(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot sleep {seconds!r}s")
        self._now_us += int(round(seconds * US))

    def wait(self, timeout: float) -> bool:
        self.sleep(timeout)
        return False

    def deadline(self, seconds: float) -> float:
        return self.now() + seconds


class EventQueue:
    """Seeded discrete-event queue over a :class:`SimClock`.

    Events are ``(virtual time, name, thunk)``; :meth:`run_until_us`
    pops them in ``(time, sha256(seed, counter))`` order, advances the
    clock to each event's timestamp, and appends ``(time_us, name)``
    to the fired log — the replayable, diffable witness of the whole
    world's timeline.
    """

    def __init__(self, seed, clock: SimClock | None = None):
        self.seed = seed if isinstance(seed, bytes) else str(seed).encode()
        self.clock = clock if clock is not None else SimClock()
        # heap entries: (time_us, tiebreak, seq, name, fn) — seq makes
        # the order total even on a (practically impossible) hash tie
        # and never compares the un-orderable thunks
        self._heap: list[tuple[int, bytes, int, str, object]] = []
        self._seq = 0
        self._log: list[tuple[int, str]] = []

    def _tiebreak(self, seq: int) -> bytes:
        return hashlib.sha256(b"cess-sim:" + self.seed + b"|"
                              + seq.to_bytes(8, "little")).digest()[:8]

    def push(self, delay_s: float, name: str, fn) -> None:
        """Schedule ``fn`` at ``now + delay_s`` (virtual)."""
        self.push_at_us(self.clock.now_us() + int(round(delay_s * US)),
                        name, fn)

    def push_at_us(self, at_us: int, name: str, fn) -> None:
        if at_us < self.clock.now_us():
            raise ValueError(f"cannot schedule {name!r} in the past "
                             f"({at_us} < {self.clock.now_us()})")
        heapq.heappush(
            self._heap,
            (int(at_us), self._tiebreak(self._seq), self._seq, name, fn))
        self._seq += 1

    def mark(self, name: str) -> None:
        """Append a synthetic entry to the fired log — for actions the
        driver performs at slot boundaries (authoring, churn, heal)
        that are part of the witness but not queue events."""
        self._log.append((self.clock.now_us(), name))

    def run_until_us(self, t_us: int) -> int:
        """Fire every event scheduled strictly before ``t_us`` (events
        pushed while draining included), then advance the clock to
        ``t_us``. Returns the number of events fired."""
        fired = 0
        while self._heap and self._heap[0][0] < t_us:
            at, _, _, name, fn = heapq.heappop(self._heap)
            self.clock.advance_to_us(at)
            self._log.append((at, name))
            fn()
            fired += 1
        if t_us > self.clock.now_us():
            self.clock.advance_to_us(t_us)
        return fired

    def drain(self, max_events: int = 1_000_000) -> int:
        """Fire everything left, in order; guard against runaway
        self-scheduling loops."""
        fired = 0
        while self._heap:
            if fired >= max_events:
                raise RuntimeError(f"event queue did not drain within "
                                   f"{max_events} events")
            at, _, _, name, fn = heapq.heappop(self._heap)
            self.clock.advance_to_us(at)
            self._log.append((at, name))
            fn()
            fired += 1
        return fired

    def fired_log(self) -> tuple[tuple[int, str], ...]:
        """(time_us, name) per fired event/mark, in firing order — the
        replay-determinism witness (same seed => bit-identical log)."""
        return tuple(self._log)

    def __len__(self) -> int:
        return len(self._heap)
