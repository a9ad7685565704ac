"""cess_tpu_torch.serve: the submission engine and the streaming ingest.

The port of ``cess_tpu/serve``'s single-device serving plane.
``engine.py``: bounded per-class queues, a size-or-delay batcher that
coalesces requests into power-of-two row buckets of the codec and audit
gates, explicit backpressure, and the ``cess_engine_*`` counters
(``stats.py``); batches run on the engine device's default stream and
synchronize before their futures resolve. ``stream.py``: the
double-buffered ingest of host segments through the pipeline's fused
encode + tag, staged through pinned host buffers on a side copy stream.
The direct synchronous path stays the default wherever no engine is
configured.
"""
from .engine import EngineFuture, SubmissionEngine, make_engine
from .policy import (CLASS_PRIORITY, CLASSES, AdmissionPolicy, EngineClosed,
                     EngineError, EngineSaturated, EngineShed, EngineTimeout,
                     EngineUnavailable)
from .stats import EngineStats, StreamStats
from .stream import StreamingIngest

__all__ = [
    "AdmissionPolicy",
    "CLASSES",
    "CLASS_PRIORITY",
    "EngineClosed",
    "EngineError",
    "EngineFuture",
    "EngineSaturated",
    "EngineShed",
    "EngineStats",
    "EngineTimeout",
    "EngineUnavailable",
    "StreamStats",
    "StreamingIngest",
    "SubmissionEngine",
    "make_engine",
]
