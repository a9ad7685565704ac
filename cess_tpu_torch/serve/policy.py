"""Admission control for the submission engine.

The port's own copy of ``cess_tpu/serve/policy.py``. The engine's
contract with its callers is explicit about overload:

- every op class has a bounded queue; a submit against a full queue
  raises :class:`EngineSaturated` immediately (backpressure the caller
  can act on: retry, shed, or route to the direct path);
- every request may carry a deadline; a request still queued when its
  deadline passes is cancelled with :class:`EngineTimeout` (a proof
  delivered after the round closes is worthless, so the engine never
  spends device time on it);
- classes drain in fixed priority order: challenge verification
  preempts bulk encode (a missed verify window slashes a miner; a
  delayed upload just waits).
"""
from __future__ import annotations

import dataclasses


class EngineError(Exception):
    """Base class for submission-engine errors."""


class EngineSaturated(EngineError):
    """The op class's bounded queue is full: explicit backpressure.

    Callers choose the response (retry with jitter, shed load, or fall
    back to the direct synchronous path): the engine never queues
    unboundedly and never drops silently.
    """


class EngineTimeout(EngineError):
    """The request's deadline expired before its batch ran."""


class EngineShed(EngineError):
    """The request was rejected by SLO-gated admission control. Distinct
    from :class:`EngineSaturated` on purpose: a saturated queue wants a
    backoff-retry, shed load wants the caller to STOP offering. The port
    has no admission controller yet, so nothing raises it; it is kept so
    that callers can name the full set of engine errors."""


class EngineClosed(EngineError):
    """Submit against an engine that has been shut down."""


# Drain order: lower drains first. Verification answers a live audit
# round (missing the window slashes a miner); proving races the same
# challenge_deadline; tagging gates uploads becoming chargeable;
# repair restores redundancy; bulk encode has no deadline at all.
CLASS_PRIORITY: dict[str, int] = {
    "verify": 0,
    "prove": 1,
    "tag": 2,
    "repair": 3,
    "encode": 4,
}

CLASSES = tuple(sorted(CLASS_PRIORITY, key=CLASS_PRIORITY.__getitem__))


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Per-class bounds + batching trigger knobs.

    queue_cap:          max queued requests per class (EngineSaturated
                        beyond it).
    max_batch_requests: size trigger: a class with this many queued
                        coalescible requests drains immediately.
    max_batch_rows:     row budget per device batch (padding bucket
                        ceiling; requests beyond it wait for the next
                        batch).
    max_delay:          deadline trigger, seconds: the oldest queued
                        request never waits longer than this for
                        companions before its batch launches.
    default_timeout:    deadline applied to requests submitted without
                        one (None = no deadline).
    """

    queue_cap: int = 256
    max_batch_requests: int = 32
    max_batch_rows: int = 512
    max_delay: float = 0.002
    default_timeout: float | None = None

    def __post_init__(self):
        if self.queue_cap < 1 or self.max_batch_requests < 1 \
                or self.max_batch_rows < 1 or self.max_delay < 0:
            raise ValueError("invalid admission policy bounds")
