"""Health-gated degradation: sliding-window backend health + a circuit
breaker that falls the engine back from the card to a CPU reference.

The port's own copy of ``cess_tpu/resilience/health.py``. The engine's
card backends (``TorchCodec``, ``RegenCodec``, the card's
``AuditBackend``) and its CPU references (``rs_ref.ReferenceCodec``,
``regen.RegenReference``, a CPU ``AuditBackend``) compute IDENTICAL
bytes, the determinism every parity test of the port pins. That makes
degradation free of protocol risk: when a backend's error rate trips
the breaker, serving the same batches on the CPU reference changes
latency, never results.

:class:`HealthMonitor` is deliberately COUNT-based, not wall-clock
based: the breaker trips after an observed error fraction over a
sliding outcome window, and while open it converts every
``probe_every``-th admission request into a recovery probe (one in
flight at a time). No timers means deterministic, schedulable tests —
the same sequence of outcomes always produces the same state
transitions (the same seam discipline as resilience/faults.py).

Touched from both the engine's submitter threads and the batcher
(admission and outcome recording), so every attribute is guarded by the
one internal lock.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import typing

from ..obs import flight as _flight
from .retry import RetryPolicy
from .stats import ResilienceStats


class HealthMonitor:
    """Per-backend sliding-window health + breaker.

    window:           outcomes retained for the error-rate estimate.
    error_threshold:  observed error fraction that trips the breaker.
    min_samples:      outcomes required before tripping is possible
                      (one unlucky first call must not open it).
    probe_every:      while open, every Nth allow() becomes a recovery
                      probe (at most one in flight); a probe success
                      closes the breaker, a failure re-arms the count.
    """

    def __init__(self, window: int = 32, error_threshold: float = 0.5,
                 min_samples: int = 4, probe_every: int = 8):
        if window < 1 or not 0 < error_threshold <= 1 \
                or min_samples < 1 or probe_every < 1:
            raise ValueError("invalid health monitor bounds")
        self.window = window
        self.error_threshold = error_threshold
        self.min_samples = min_samples
        self.probe_every = probe_every
        # journal identity: the engine names its monitors ("codec",
        # "audit") at registration, so breaker journal entries say
        # WHICH breaker moved
        self.name = ""
        self._mu = threading.Lock()
        self._outcomes: collections.deque = \
            collections.deque(maxlen=window)      # (ok, latency_s)
        self._state = "closed"
        self._denied = 0           # opens since the last probe
        self._probe_inflight = False
        self._trips = 0
        self._probes = 0
        self._recoveries = 0
        # external latch (an admission controller's "SLO at risk"
        # degrade): while held, the breaker is open with NO recovery
        # probes: the device is not broken, it is being vacated, and
        # only the holder may reopen it
        self._held = False
        self._hold_reason = ""
        self._holds = 0

    # -- gating -------------------------------------------------------------
    def allow(self) -> bool:
        """May the next dispatch use the monitored backend? While the
        breaker is open, every ``probe_every``-th call is admitted as
        a recovery probe (its outcome decides the state) — unless the
        open is an external HOLD, which admits nothing until
        released (probing a healthy device the SLO controller is
        deliberately vacating would defeat the vacating)."""
        with self._mu:
            if self._held:
                return False
            if self._state == "closed":
                return True
            if self._probe_inflight:
                return False
            self._denied += 1
            if self._denied >= self.probe_every:
                self._denied = 0
                self._probes += 1
                self._probe_inflight = True
                return True
            return False

    # -- outcomes -----------------------------------------------------------
    def record_success(self, latency_s: float = 0.0) -> None:
        recovered = False
        with self._mu:
            self._outcomes.append((True, latency_s))
            # only an ADMITTED probe's success closes the breaker: an
            # incidental success on a non-representative shape (e.g. a
            # 1-row salvage re-run while big coalesced batches still
            # die) must not flap the engine back onto a bad device
            if self._state == "open" and self._probe_inflight:
                self._state = "closed"
                self._recoveries += 1
                self._outcomes.clear()     # fresh window post-recovery
                recovered = True
            self._probe_inflight = False
        if recovered:
            # journal notes ALWAYS run with self._mu released: the
            # incident listener snapshots this very monitor
            _flight.note("breaker", "recover", name=self.name)

    def record_error(self) -> None:
        tripped = False
        with self._mu:
            self._outcomes.append((False, 0.0))
            self._probe_inflight = False
            if self._state != "closed":
                return                     # failed probe: stay open
            n = len(self._outcomes)
            errs = sum(1 for ok, _ in self._outcomes if not ok)
            if n >= self.min_samples \
                    and errs >= self.error_threshold * n:
                self._trip_locked()
                tripped = True
        if tripped:
            _flight.note("breaker", "trip", name=self.name,
                         reason="error-window")

    def _trip_locked(self) -> None:
        self._state = "open"
        self._trips += 1
        self._denied = 0
        self._outcomes.clear()

    # -- external latch (SLO-gated degradation) -----------------------------
    def hold_open(self, reason: str = "held") -> None:
        """Latch the breaker open under an external controller: every
        dispatch degrades (no probes, no window-driven recovery) until
        :meth:`release`. "Device broken" extended to "SLO at risk": the
        device stays healthy, the monitored backend is being vacated for
        higher-priority traffic. Idempotent; a hold over an
        already-tripped breaker just layers the latch (the trip's own
        recovery resumes on release)."""
        latched = False
        with self._mu:
            if not self._held:
                self._held = True
                self._holds += 1
                latched = True
            self._hold_reason = reason
        if latched:
            _flight.note("breaker", "hold", name=self.name,
                         reason=reason)

    def release(self) -> None:
        """Drop the external latch. A breaker that was ALSO tripped by
        its error window stays open and probes its way back (the hold
        never masks a real failure); one opened purely by the hold
        returns to closed with a fresh window."""
        with self._mu:
            if not self._held:
                return
            self._held = False
            self._hold_reason = ""
            if self._state == "closed":
                self._outcomes.clear()
                self._denied = 0
                self._probe_inflight = False
        _flight.note("breaker", "release", name=self.name)

    # -- manual control (benchmarks, tests, operators) ----------------------
    def force_open(self) -> None:
        """Trip the breaker unconditionally (the bench's degraded-mode
        assertion, operator kill switches)."""
        tripped = False
        with self._mu:
            if self._state == "closed":
                self._trip_locked()
                tripped = True
        if tripped:
            _flight.note("breaker", "trip", name=self.name,
                         reason="forced")

    def force_close(self) -> None:
        with self._mu:
            self._held = False
            self._hold_reason = ""
            if self._state == "open":
                self._state = "closed"
                self._denied = 0
                self._probe_inflight = False
                self._outcomes.clear()

    # -- introspection ------------------------------------------------------
    @property
    def state(self) -> str:
        """"closed" / "open" (window-tripped) / "held" (external
        latch): a held breaker reports held even if its window also
        tripped, since only release() can admit traffic again."""
        with self._mu:
            return "held" if self._held else self._state

    def snapshot(self) -> dict:
        with self._mu:
            n = len(self._outcomes)
            errs = sum(1 for ok, _ in self._outcomes if not ok)
            lats = [t for ok, t in self._outcomes if ok]
            return {
                "state": "held" if self._held else self._state,
                "held_reason": self._hold_reason,
                "holds": self._holds,
                "trips": self._trips,
                "probes": self._probes,
                "recoveries": self._recoveries,
                "window_samples": n,
                "error_rate": round(errs / n, 4) if n else 0.0,
                "mean_latency_s":
                    round(sum(lats) / len(lats), 6) if lats else 0.0,
            }


@dataclasses.dataclass
class ResilienceConfig:
    """Everything the engine needs to serve through failure: the retry
    policy for saturation backoff, a monitor factory (one breaker per
    backend: "codec", "audit"), whether a tripped breaker may fall
    back to the CPU reference backend, and the shared counter sink.

    ``fallback=False`` keeps the isolation/retry machinery but lets
    device failures surface after it (for deployments where silently
    absorbing a device loss is worse than failing loudly)."""

    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    monitor: typing.Callable[[], HealthMonitor] = HealthMonitor
    fallback: bool = True
    stats: ResilienceStats = \
        dataclasses.field(default_factory=ResilienceStats)
