"""Engine counters: queue depth, batch occupancy, pad waste, latency.

The port's copy of ``cess_tpu/serve/stats.py`` under the same
``cess_engine_*`` names, with the resilience attachment (its snapshot
under ``"resilience"``, its ``cess_resilience_*`` gauges merged into the
metrics) and without the attachments of the planes the port does not
have yet (SLO, adaptive control, device pool, profiling) or the
``shed`` counter that only SLO-gated admission increments.

Everything here is updated under the engine lock (the batcher and the
submitters hold it at every recording site), so the counters need no
lock of their own; the histograms carry theirs.
"""
from __future__ import annotations

import collections

from ..obs import prom
from . import policy

LATENCY_WINDOW = 512     # per-class sliding window for percentiles


class ClassStats:
    __slots__ = ("submitted", "completed", "failed", "timeouts",
                 "saturated", "batches", "batched_requests", "rows",
                 "padded_rows", "latencies", "hist")

    def __init__(self):
        self.submitted = 0          # requests admitted to the queue
        self.completed = 0          # futures resolved with a result
        self.failed = 0             # futures resolved with an op error
        self.timeouts = 0           # cancelled: deadline expired queued
        self.saturated = 0          # rejected at submit: queue full
        self.batches = 0            # device batches launched
        self.batched_requests = 0   # requests across those batches
        self.rows = 0               # real rows across those batches
        self.padded_rows = 0        # pad rows added to reach buckets
        self.latencies = collections.deque(maxlen=LATENCY_WINDOW)
        # the same submit->resolve latencies as a mergeable histogram
        self.hist = prom.Histogram(prom.LATENCY_BUCKETS_S)

    @property
    def occupancy(self) -> float:
        """Mean requests coalesced per device batch."""
        return self.batched_requests / self.batches if self.batches else 0.0

    @property
    def pad_waste(self) -> float:
        """Fraction of device rows that were padding."""
        total = self.rows + self.padded_rows
        return self.padded_rows / total if total else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 1] over the sliding submit->resolve latency window."""
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        return xs[min(len(xs) - 1, int(q * len(xs)))]


class StreamStats:
    """Per-stage counters of one streaming ingest (serve/stream.py);
    attached to an engine (``SubmissionEngine.attach_stream``) they
    export as ``cess_engine_stream_*``.

    - ``stall_s``: host time blocked on device results (the in-flight
      window and the final drain); a high share means the device (the
      copy or the kernels) is the limit.
    - ``h2d_s``: host time staging bytes (the copy into a pinned buffer
      and the enqueue of the host-to-device copy); a high share with
      little stall means the host cannot keep the card fed. On the card
      the copy over the bus runs asynchronously, so its time is not
      here: it lands in ``stall_s``.
    """

    _COUNTERS = ("batches", "segments", "padded_segments", "bytes_in",
                 "h2d_s", "dispatch_s", "stall_s", "wall_s")
    __slots__ = _COUNTERS + ("hist",)

    def __init__(self):
        self.batches = 0           # device batches dispatched
        self.segments = 0          # real segments ingested
        self.padded_segments = 0   # zero rows added to the ragged tail
        self.bytes_in = 0          # host bytes staged (real, not pad)
        self.h2d_s = 0.0           # host time staging
        self.dispatch_s = 0.0      # host time dispatching the program
        self.stall_s = 0.0         # host time blocked on device results
        self.wall_s = 0.0          # wall time of completed run() calls
        # per-batch host time (staging + dispatch)
        self.hist = prom.Histogram(prom.LATENCY_BUCKETS_S)

    def raw(self) -> dict:
        return {name: getattr(self, name) for name in self._COUNTERS}

    def snapshot(self) -> dict:
        return stream_gauges(self.raw())

    def metrics(self) -> dict[str, float]:
        return {f"cess_engine_stream_{k}": float(v)
                for k, v in self.snapshot().items()}


def stream_gauges(raw: dict) -> dict:
    """Derived per-stage gauges from raw StreamStats counters (shared
    by a single stream's snapshot and the engine's cross-stream sum)."""
    out = dict(raw)
    wall = raw["wall_s"]
    out["stall_frac"] = round(raw["stall_s"] / wall, 4) if wall else 0.0
    out["h2d_frac"] = round(raw["h2d_s"] / wall, 4) if wall else 0.0
    for k in ("h2d_s", "dispatch_s", "stall_s", "wall_s"):
        out[k] = round(out[k], 6)
    return out


class EngineStats:
    """One ClassStats per op class, the program-cache counts, and any
    attached streaming ingests' stage counters."""

    def __init__(self):
        self.classes = {c: ClassStats() for c in policy.CLASSES}
        self.programs_built = 0     # program-cache misses
        self.programs_reused = 0    # program-cache hits
        self.streams: list[StreamStats] = []   # attached streaming ingests
        # the engine's resilience.ResilienceStats when it has a
        # ResilienceConfig: duck-typed (snapshot()/metrics())
        self.resilience = None

    def snapshot(self, queue_depths: dict[str, int] | None = None) -> dict:
        """JSON-shaped dump."""
        depths = queue_depths or {}
        out: dict = {"programs_built": self.programs_built,
                     "programs_reused": self.programs_reused,
                     "classes": {}}
        for cls, st in self.classes.items():
            out["classes"][cls] = {
                "queue_depth": depths.get(cls, 0),
                "submitted": st.submitted,
                "completed": st.completed,
                "failed": st.failed,
                "timeouts": st.timeouts,
                "saturated": st.saturated,
                "batches": st.batches,
                "batch_occupancy": round(st.occupancy, 4),
                "pad_waste": round(st.pad_waste, 4),
                "latency_p50": round(st.percentile(0.50), 6),
                "latency_p99": round(st.percentile(0.99), 6),
            }
        if self.streams:
            out["streams"] = [s.snapshot() for s in self.streams]
        if self.resilience is not None:
            out["resilience"] = self.resilience.snapshot()
        return out

    def metrics(self, queue_depths: dict[str, int] | None = None
                ) -> dict[str, float]:
        """Flat Prometheus-style gauges."""
        snap = self.snapshot(queue_depths)
        out = {"cess_engine_programs_built": snap["programs_built"],
               "cess_engine_programs_reused": snap["programs_reused"]}
        for cls, st in snap["classes"].items():
            for name, val in st.items():
                out[f"cess_engine_{cls}_{name}"] = val
        if self.streams:
            # sum RAW counters across attached streams, then derive:
            # adding per-stream fractions would be meaningless
            totals = self.streams[0].raw()
            for s in self.streams[1:]:
                for k, v in s.raw().items():
                    totals[k] += v
            for name, val in stream_gauges(totals).items():
                out[f"cess_engine_stream_{name}"] = float(val)
        if self.resilience is not None:
            out.update(self.resilience.metrics())
        return out

    def histograms(self) -> dict[str, prom.Histogram]:
        """One submit->resolve latency family per op class, plus the
        summed per-batch stream staging+dispatch family when streams are
        attached (same bounds, so the merge is exact)."""
        out = {f"cess_engine_{cls}_latency_seconds": st.hist
               for cls, st in self.classes.items()}
        if self.streams:
            merged = prom.Histogram(prom.LATENCY_BUCKETS_S)
            for s in self.streams:
                merged.merge(s.hist)
            out["cess_engine_stream_batch_seconds"] = merged
        return out
