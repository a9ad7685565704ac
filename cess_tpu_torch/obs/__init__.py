"""cess_tpu_torch.obs: tracing, the flight recorder, the histograms, and
the control planes' observers of the serving plane.

The port's own copies of ``cess_tpu/obs``'s modules that the port's
serving plane uses (one contract: zero-cost when off, deterministic when
on):

- trace.py    Tracer/Span: counter-based span ids, contextvars
              current-span propagation, a bounded ring of finished
              spans, Chrome trace-event export; with no tracer armed
              every hook returns the NOOP_SPAN singleton.
- flight.py   FlightRecorder: tail-sampled trace pinning (anomalies and
              a seeded baseline, bounded, anomaly-first retention) and
              the count-sequenced journal subsystems note into.
- prom.py     the mergeable latency histograms behind the engine's and
              the stream's ``cess_engine_*`` histogram families, their
              wire form and the exposition's label escaping.
- slo.py      SloBoard: SloTarget objectives evaluated with
              observation-count multi-window burn rates, per-tenant x
              per-class accounting, and the transition listeners the
              admission controller (serve/adaptive.py) acts on.
- profile.py  ProfilePlane: per-(class, bucket, lane) dispatch
              accounts, the pad and compile ledgers, and a throughput
              watchdog anchored on a baseline measured on the card.
- incident.py IncidentReporter: notable journal entries (SLO burning,
              breaker trips and holds, shed storms, thread escapes,
              perf regressions) into rate-limited, deduplicated
              postmortem bundles with a replay witness.
- fleet.py    FleetPlane: metric federation across nodes, the global
              SLO view, cross-node trace stitching and the MAD
              straggler detector (``("fleet", "outlier")`` edges).
- chainwatch.py ChainWatch: consensus health, the storage-market
              ledger and the chain anomaly detector (``("chain",
              "anomaly")`` edges), over duck-typed chain objects.
- custody.py  CustodyPlane: per-fragment custody lineage, erasure
              margins and the at-risk detector (``("custody",
              "at_risk")`` edges).

``serve/remediate.py`` acts on the detectors' edges.

Wire-up: ``serve.make_engine(tracer=..., slo=..., profile=...)`` or
``trace.arm(tracer)``; ``tracer.attach_flight(recorder)``,
``flight.arm(recorder)`` and ``IncidentReporter(recorder, engine=eng)``.
"""
from .flight import FlightRecorder
from .incident import IncidentReporter
from .profile import ProfilePlane
from .prom import (LATENCY_BUCKETS_S, Histogram, escape_label,
                   format_labels, format_le, render_histogram)
from .slo import DEFAULT_TARGETS, SloBoard, SloTarget, parse_targets
from .trace import (NOOP_SPAN, Span, Tracer, arm, armed, armed_tracer,
                    context, current_span, disarm, event, span)

__all__ = [
    "DEFAULT_TARGETS",
    "FlightRecorder",
    "Histogram",
    "IncidentReporter",
    "LATENCY_BUCKETS_S",
    "NOOP_SPAN",
    "ProfilePlane",
    "SloBoard",
    "SloTarget",
    "Span",
    "Tracer",
    "arm",
    "armed",
    "armed_tracer",
    "context",
    "current_span",
    "disarm",
    "escape_label",
    "event",
    "format_labels",
    "format_le",
    "parse_targets",
    "render_histogram",
    "span",
]
