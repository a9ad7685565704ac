"""cess_tpu_torch.serve: the submission engine and the streaming ingest.

The port of ``cess_tpu/serve``'s single-device serving plane.
``engine.py``: bounded per-class queues, a size-or-delay batcher that
coalesces requests into power-of-two row buckets of the codec and audit
gates, explicit backpressure, and the ``cess_engine_*`` counters
(``stats.py``); batches run on the engine device's default stream and
synchronize before their futures resolve. ``stream.py``: the
double-buffered ingest of host segments through the pipeline's fused
encode + tag, staged through pinned host buffers on a side copy stream.
``pool.py``: the multi-device serving plane, a ``DevicePool`` of
per-device worker lanes the engine spreads its batches over
(``make_engine(pool=...)``), and the lanes' mesh for the stream
(``StreamingIngest(pool=...)``). ``adaptive.py``: per-class batching
knobs tuned from the live latency signal (``AdaptiveBatchPolicy``) and
SLO-gated, deadline-aware admission (``AdmissionController``) over an
``obs.SloBoard`` (``make_engine(slo=..., adaptive=..., admission=...)``).
``remediate.py``: the ``RemediationPlane``, a count-sequenced policy
engine over the detectors' flight-note edges that holds and releases the
engine's and the pool lanes' breakers (``bind_engine``).
The direct synchronous path stays the default wherever no engine is
configured.
"""
from .adaptive import AdaptiveBatchPolicy, AdmissionController
from .engine import EngineFuture, SubmissionEngine, make_engine
from .policy import (CLASS_PRIORITY, CLASSES, AdmissionPolicy, EngineClosed,
                     EngineError, EngineSaturated, EngineShed, EngineTimeout,
                     EngineUnavailable)
from .pool import DeviceLane, DevicePool
from .remediate import Policy, RemediationPlane, default_policies
from .stats import EngineStats, StreamStats
from .stream import StreamingIngest

__all__ = [
    "AdaptiveBatchPolicy",
    "AdmissionController",
    "AdmissionPolicy",
    "CLASSES",
    "CLASS_PRIORITY",
    "DeviceLane",
    "DevicePool",
    "EngineClosed",
    "EngineError",
    "EngineFuture",
    "EngineSaturated",
    "EngineShed",
    "EngineStats",
    "EngineTimeout",
    "EngineUnavailable",
    "Policy",
    "RemediationPlane",
    "StreamStats",
    "StreamingIngest",
    "SubmissionEngine",
    "default_policies",
    "make_engine",
]
