"""Retry / timeout / backoff policies with deadline-budget propagation.

The port's own copy of ``cess_tpu/resilience/retry.py``. The engine's
backpressure contract (serve/policy.py) puts the retry decision on the
caller: ``EngineSaturated`` means "come back with jitter or shed". This
module is the one place that decision is implemented, so every caller
retries the same way:

- exponential backoff, capped, with DETERMINISTIC jitter — the jitter
  fraction is a SHA-256 function of (token, attempt), so two runs of
  the same workload back off identically (chaos tests replay
  bit-exactly) while different tokens decorrelate concurrent callers
  exactly like random jitter would;
- deadline-budget propagation — a :class:`Budget` is created once per
  logical request; every attempt's timeout is the budget's REMAINING
  time, never the original timeout again, and a backoff that would
  outlive the budget abandons instead of sleeping through it.

Per-class retry/abandon counters land in the engine's
:class:`~.stats.ResilienceStats` and export as ``cess_resilience_*``
gauges next to the ``cess_engine_*`` family.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

from ..obs import trace as _trace


class Budget:
    """A request's remaining wall-clock allowance, shared across retry
    attempts. ``None`` seconds = unbounded (remaining() is None)."""

    __slots__ = ("deadline",)

    def __init__(self, seconds: float | None):
        self.deadline = None if seconds is None \
            else time.monotonic() + seconds

    def remaining(self) -> float | None:
        if self.deadline is None:
            return None
        return max(self.deadline - time.monotonic(), 0.0)

    def expired(self) -> bool:
        return self.deadline is not None \
            and time.monotonic() >= self.deadline


def _jitter_frac(token, attempt: int) -> float:
    tok = token if isinstance(token, bytes) else str(token).encode()
    h = hashlib.sha256(b"cess-retry:" + tok + b"|"
                       + attempt.to_bytes(4, "little")).digest()
    return int.from_bytes(h[:8], "little") / 2 ** 64


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """max_attempts: total tries (1 = no retry). base_delay_s grows by
    ``multiplier`` per attempt, capped at max_delay_s, then stretched
    by up to ``jitter_frac`` of itself (deterministic, see module
    doc)."""

    max_attempts: int = 4
    base_delay_s: float = 0.005
    multiplier: float = 2.0
    max_delay_s: float = 0.25
    jitter_frac: float = 0.5

    def __post_init__(self):
        if self.max_attempts < 1 or self.base_delay_s < 0 \
                or self.multiplier < 1 or self.max_delay_s < 0 \
                or not 0 <= self.jitter_frac <= 1:
            raise ValueError("invalid retry policy bounds")

    def delay_for(self, attempt: int, token="") -> float:
        """Backoff before attempt ``attempt + 1`` (attempt counts from
        1). Pure in (self, attempt, token)."""
        base = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                   self.max_delay_s)
        if not self.jitter_frac:
            return base
        return base * (1.0 + self.jitter_frac
                       * _jitter_frac(token, attempt))

    def call(self, fn, *, retry_on=(Exception,),
             budget: Budget | None = None, token="",
             stats=None, cls: str = "", sleep=time.sleep):
        """Run ``fn(budget)`` with bounded retries on ``retry_on``.

        fn receives the shared Budget so each attempt can size its own
        timeout from ``budget.remaining()``. Exhausted attempts or an
        expired/insufficient budget re-raise the last error (counted
        as an abandon); every successful back-off is counted as a
        retry. ``stats``/``cls`` route the counters (None = uncounted).
        """
        if budget is None:
            budget = Budget(None)
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(budget)
            except retry_on:
                if attempt >= self.max_attempts or budget.expired():
                    if stats is not None:
                        stats.note_abandoned(cls)
                    _trace.event("retry.abandon", cls=cls,
                                 attempt=attempt)
                    raise
                delay = self.delay_for(attempt, token)
                left = budget.remaining()
                if left is not None and left <= delay:
                    # sleeping through the rest of the budget would
                    # guarantee an EngineTimeout: abandon now instead
                    if stats is not None:
                        stats.note_abandoned(cls)
                    _trace.event("retry.abandon", cls=cls,
                                 attempt=attempt, budget=True)
                    raise
                if stats is not None:
                    stats.note_retry(cls)
                # retries annotate the active span (obs/trace.py), so
                # a traced request shows every backoff it paid
                _trace.event("retry", cls=cls, attempt=attempt,
                             delay_s=round(delay, 6))
                sleep(delay)
