"""cess_tpu_torch.obs: tracing, the flight recorder and the histograms
of the serving plane.

The port's own copies of ``cess_tpu/obs``'s modules that the port's
serving plane uses (one contract: zero-cost when off, deterministic when
on):

- trace.py   Tracer/Span: counter-based span ids, contextvars
             current-span propagation, a bounded ring of finished spans,
             Chrome trace-event export; with no tracer armed every hook
             returns the NOOP_SPAN singleton.
- flight.py  FlightRecorder: tail-sampled trace pinning (anomalies and a
             seeded baseline, bounded, anomaly-first retention) and the
             count-sequenced journal subsystems note into.
- prom.py    the mergeable latency histograms behind the engine's and
             the stream's ``cess_engine_*`` histogram families.

The TPU package's SLO board, incident reporter and profile plane are
not ported yet.

Wire-up: ``serve.make_engine(tracer=...)`` or ``trace.arm(tracer)``;
``tracer.attach_flight(recorder)`` and ``flight.arm(recorder)``.
"""
from .flight import FlightRecorder
from .prom import LATENCY_BUCKETS_S, Histogram
from .trace import (NOOP_SPAN, Span, Tracer, arm, armed, armed_tracer,
                    context, current_span, disarm, event, span)

__all__ = [
    "FlightRecorder",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "NOOP_SPAN",
    "Span",
    "Tracer",
    "arm",
    "armed",
    "armed_tracer",
    "context",
    "current_span",
    "disarm",
    "event",
    "span",
]
