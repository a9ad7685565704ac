"""Incident postmortems: journal triggers -> self-contained bundles.

The port's own copy of ``cess_tpu/obs/incident.py``: the same triggers,
rate limit, dedup, bundle sections and canon, so one journal note
sequence gives byte-equal :meth:`IncidentReporter.witness` in both
packages. An :class:`IncidentReporter` listens on a
:class:`~.flight.FlightRecorder`'s journal and, at the moment of a
trigger, snapshots everything a postmortem needs into one bundle:

==================  ========================================================
trigger class       journal entry (subsystem, kind)
==================  ========================================================
``slo-burning``     ``("slo", "transition")`` with ``to == "burning"``
``breaker-trip``    ``("breaker", "trip")`` (incl. ``force_open``)
``breaker-hold``    ``("breaker", "hold")`` (the admission controller's
                    latch, serve/adaptive.py)
``shed-storm``      ``shed_storm`` consecutive ``("engine", "shed")``
``thread-escape``   ``("engine"|"stream", "escape")``: an exception
                    escaping the batcher or the stream driver
``perf-regression`` ``("perf", "regression")`` with ``to ==
                    "regressed"``: the profile plane's watchdog
                    (obs/profile.py); the bundle embeds the pad and
                    compile ledgers
``repair-degraded`` ``repair_degraded`` consecutive ``("repair",
                    "fallback")`` notes
==================  ========================================================

The TPU package's other triggers keep their note handlers here as they
are there (``invariant`` on ``("sim", "invariant")``, ``fleet-outlier``,
the chain anomaly classes, ``remediation-flap``, ``custody-at-risk`` and
``custody-lost``), and so do the optional attachments those read
(``stitcher``, ``chainwatch``, ``remediation``, ``custody``): duck-typed,
``None`` until the port has those planes.

Each bundle holds the pinned traces, the journal tail, metric deltas
since the previous bundle, the breaker / SLO / adaptive / admission
snapshots, the profile's ledgers, the fault plan's ``fired_log`` and
what a ``context`` callable adds. Bundles are **rate-limited per
trigger class** (``max_per_class``, count-based so replays agree) and
**deduplicated** (a trigger repeating its class's previous key is
dropped).

Determinism: every bundle carries a ``canon`` section, the replay-stable
view (trigger, key, journal entries of deterministic subsystems, the
recorder's retention witness, the fired-fault log);
:meth:`IncidentReporter.witness` serializes the canon sequence, so two
same-seed runs give the same bytes. Host timings (span durations,
latency metrics, the ``adaptive`` journal) ride in the bundle for people
and never in ``canon``.
"""
from __future__ import annotations

import collections
import json
import threading

from .trace import _json_safe

# journal subsystems whose entries are replay-stable (the ``adaptive``
# journal reacts to host-timed p99 estimates, so it is evidence, not
# witness)
_CANON_SYS = frozenset(("slo", "breaker", "engine", "stream", "sim",
                        "custody",
                        "finality", "flight", "fleet", "perf", "chain",
                        "repair", "remediation"))

# the chain anomaly classes obs/chainwatch.py announces; the journal
# detail's ``cls`` IS the trigger class (one note kind, four triggers)
_CHAIN_TRIGGERS = frozenset(("finality-stall", "deep-reorg",
                             "equivocation", "audit-failure-spike"))


def _sanitize(value):
    """JSON-safe deep copy (dicts included — trace._json_safe handles
    the scalar/bytes/sequence cases)."""
    if isinstance(value, dict):
        return {str(k): _sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_sanitize(v) for v in value]
    return _json_safe(value)


def _flatten(prefix: str, value, out: dict) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif isinstance(value, bool):
        pass
    elif isinstance(value, (int, float)):
        out[prefix] = float(value)


class IncidentReporter:
    """Turn notable journal entries into bounded, deduplicated,
    rate-limited incident bundles.

    recorder:      the FlightRecorder to listen on (evidence source).
    engine:        optional SubmissionEngine — supplies breaker / SLO /
                   adaptive / admission snapshots and the metric
                   counters bundles diff.
    board:         optional SloBoard when there is no engine (sim).
    plan:          optional FaultPlan whose ``fired_log`` each bundle
                   embeds (falls back to the process-armed plan).
    stitcher:      optional obs/fleet.py TraceStitcher — bundles gain
                   a ``stitched`` section (the cross-node trace view
                   at trigger time) and canon gains its replay-stable
                   witness, so a multi-host incident's postmortem
                   holds ONE connected trace instead of N fragments.
    profile:       optional obs/profile.py ProfilePlane — bundles gain
                   a ``profile`` snapshot section (both ledgers);
                   falls back to ``engine.profile`` when the engine
                   carries one.
    chainwatch:    optional obs/chainwatch.py ChainWatch — bundles
                   gain a ``chain`` snapshot section (consensus views,
                   equivocation evidence, the market ledger), the
                   chain-anomaly postmortem's health truth source.
    remediation:   optional serve/remediate.py RemediationPlane —
                   bundles gain a ``remediation`` snapshot section
                   (policy table, engagements, the action journal
                   tail): what the autopilot was doing at trigger
                   time.
    custody:       optional obs/custody.py CustodyPlane — bundles gain
                   a ``custody`` snapshot section (margins, histogram,
                   detector state), and a custody-triggered bundle
                   embeds the at-risk segment's full per-fragment
                   timeline.
    context:       optional callable returning a dict merged into each
                   bundle — sim runs supply the scenario seed +
                   witness needed to replay the episode.
    max_per_class: bundles per trigger class (count-based rate limit).
    shed_storm:    consecutive engine sheds that constitute a storm.
    repair_degraded: symbol-repair fallbacks (node/offchain.py journal
                   notes ("repair", "fallback")) that constitute a
                   degraded repair plane — the regenerating path has
                   stopped engaging and every repair is paying the
                   whole-fragment bandwidth bill.
    """

    def __init__(self, recorder, *, engine=None, board=None, plan=None,
                 stitcher=None, profile=None, chainwatch=None,
                 remediation=None, custody=None, context=None,
                 max_per_class: int = 4,
                 max_bundles: int = 32, shed_storm: int = 8,
                 repair_degraded: int = 8,
                 journal_tail: int = 64):
        if max_per_class < 1 or max_bundles < 1 or shed_storm < 1 \
                or repair_degraded < 1:
            raise ValueError("incident reporter bounds must be >= 1")
        self.recorder = recorder
        self.engine = engine
        self.board = board if board is not None \
            else getattr(engine, "slo", None)
        self.plan = plan
        self.stitcher = stitcher
        self.profile = profile if profile is not None \
            else getattr(engine, "profile", None)
        self.chainwatch = chainwatch
        self.remediation = remediation
        self.custody = custody
        self.context = context
        self.max_per_class = max_per_class
        self.shed_storm = shed_storm
        self.repair_degraded = repair_degraded
        self.journal_tail = journal_tail
        self._mu = threading.Lock()
        self._bundles: collections.deque = collections.deque(
            maxlen=max_bundles)
        self._per_class: dict = {}
        self._last_key: dict = {}
        self._shed_run = 0
        self._repair_run = 0
        self._seq = 0
        self._last_metrics: dict = {}
        self.rate_limited = 0
        self.deduplicated = 0
        recorder.add_listener(self._on_note)

    # -- the journal listener ------------------------------------------------
    def _on_note(self, seq, subsystem, kind, detail) -> None:
        if subsystem == "engine" and kind == "shed":
            with self._mu:
                self._shed_run += 1
                storm = self._shed_run >= self.shed_storm
                if storm:
                    self._shed_run = 0
            if storm:
                self.trigger("shed-storm",
                             key=f"{detail.get('cls')}:"
                                 f"{detail.get('reason')}",
                             detail=dict(detail,
                                         storm=self.shed_storm))
            return
        if subsystem == "repair" and kind == "fallback":
            # symbol-chain repairs falling back to whole-fragment
            # fetch: each one is routine, a RUN of them means the
            # regenerating plane is degraded (same accumulation shape
            # as shed-storm)
            with self._mu:
                self._repair_run += 1
                degraded = self._repair_run >= self.repair_degraded
                if degraded:
                    self._repair_run = 0
            if degraded:
                self.trigger("repair-degraded",
                             key=str(detail.get("miner")),
                             detail=dict(detail,
                                         run=self.repair_degraded))
            return
        if subsystem == "slo" and kind == "transition":
            if detail.get("to") != "burning":
                return
            self.trigger("slo-burning", key=str(detail.get("cls")),
                         detail=detail)
        elif subsystem == "breaker" and kind in ("trip", "hold"):
            self.trigger(f"breaker-{kind}",
                         key=f"{detail.get('name')}:"
                             f"{detail.get('reason', '')}",
                         detail=detail)
        elif subsystem == "sim" and kind == "invariant":
            self.trigger("invariant", key=str(detail.get("context")),
                         detail=detail)
        elif kind == "escape" and subsystem in ("engine", "stream"):
            self.trigger("thread-escape",
                         key=f"{subsystem}:{detail.get('error')}",
                         detail=dict(detail, thread=subsystem))
        elif subsystem == "fleet" and kind == "outlier":
            self.trigger("fleet-outlier",
                         key=f"{detail.get('instance')}:"
                             f"{detail.get('metric')}",
                         detail=detail)
        elif subsystem == "perf" and kind == "regression":
            # edge-triggered both ways by the watchdog; only the
            # ok->regressed edge is an incident (recovery is good news)
            if detail.get("to") != "regressed":
                return
            self.trigger("perf-regression",
                         key=str(detail.get("metric")), detail=detail)
        elif subsystem == "remediation" and kind == "flap":
            self.trigger("remediation-flap",
                         key=f"{detail.get('policy')}:"
                             f"{detail.get('key')}",
                         detail=detail)
        elif subsystem == "custody" and kind in ("at_risk", "lost"):
            # the durability detector announces edge-triggered both
            # ways; only the ok->bad edge is an incident
            if detail.get("to") != "bad":
                return
            self.trigger("custody-at-risk" if kind == "at_risk"
                         else "custody-lost",
                         key=str(detail.get("key")), detail=detail)
        elif subsystem == "chain" and kind == "anomaly":
            # edge-triggered both ways by the detector; only the
            # ok->bad edge is an incident, and the detail's cls must
            # name a known trigger class (a skewed peer's journal
            # entry must not mint arbitrary classes)
            cls = detail.get("cls")
            if detail.get("to") != "bad" or cls not in _CHAIN_TRIGGERS:
                return
            self.trigger(cls, key=str(detail.get("key")),
                         detail=detail)

    # -- triggering ----------------------------------------------------------
    def trigger(self, cls: str, key: str, detail: dict) -> dict | None:
        """Snapshot a bundle for trigger class ``cls`` unless the
        class is rate-limited or ``key`` repeats the class's previous
        trigger (dedup). Returns the bundle, or None when dropped."""
        with self._mu:
            if self._last_key.get(cls) == key:
                self.deduplicated += 1
                return None
            if self._per_class.get(cls, 0) >= self.max_per_class:
                self.rate_limited += 1
                return None
            self._per_class[cls] = self._per_class.get(cls, 0) + 1
            self._last_key[cls] = key
            self._seq += 1
            seq = self._seq
        # snapshot OUTSIDE self._mu: bundle assembly reads the
        # recorder / board / breaker locks and must never nest them
        # under the reporter's
        bundle = self._build(seq, cls, key, detail)
        with self._mu:
            self._bundles.append(bundle)
        return bundle

    def _build(self, seq: int, cls: str, key: str, detail: dict) -> dict:
        rec = self.recorder
        journal = rec.journal_tail(limit=self.journal_tail)
        pinned = rec.pinned()
        plan = self.plan
        if plan is None:
            from ..resilience import faults as _faults
            plan = _faults.armed_plan()
        fired = [] if plan is None else [list(f) for f in plan.fired_log()]
        snapshots: dict = {"flight": rec.snapshot()}
        metrics: dict = {}
        engine = self.engine
        if engine is not None:
            stats = engine.stats_snapshot()
            _flatten("engine", stats, metrics)
            snapshots["engine"] = stats
            snapshots["breakers"] = {
                name: mon.snapshot()
                for name, mon in sorted(engine.monitors.items())}
        elif self.board is not None:
            _flatten("slo", self.board.snapshot(), metrics)
        if self.board is not None:
            snapshots["slo"] = self.board.snapshot()
        adaptive = getattr(engine, "adaptive", None)
        if adaptive is not None:
            snapshots["adaptive"] = adaptive.snapshot()
        admission = getattr(engine, "admission", None)
        if admission is not None:
            snapshots["admission"] = admission.snapshot()
        profile = self.profile
        if profile is not None:
            # both ledgers (pads + compiles) ride every bundle — the
            # perf-regression postmortem's "where did the time go".
            # Evidence-side only: compile wall times are host timings
            # and must never reach canon
            snapshots["profile"] = profile.ledgers()
        chainwatch = self.chainwatch
        if chainwatch is not None:
            # the chain-health truth source rides every bundle — the
            # chain-anomaly postmortem's consensus views, equivocation
            # evidence and market ledger at trigger time
            snapshots["chain"] = chainwatch.snapshot()
        remediation = self.remediation
        if remediation is not None:
            # what the autopilot was doing at trigger time: the policy
            # table, live engagements, and the action journal tail.
            # The journal is count-sequenced and replay-stable, but it
            # rides evidence-side here — the plane has its own witness
            snap = remediation.snapshot()
            snap["journal"] = snap["journal"][-self.journal_tail:]
            snapshots["remediation"] = snap
        custody = self.custody
        if custody is not None:
            # the durability truth source rides every bundle (margins,
            # histogram, detector state; timelines stay out — they are
            # per-segment evidence), and a custody trigger embeds the
            # at-risk segment's FULL per-fragment timeline: fragment
            # F's whole history from dispatch to the edge
            snap = custody.snapshot()
            snap.pop("timelines", None)
            snapshots["custody"] = snap
            if cls.startswith("custody-"):
                snapshots["custody_timeline"] = \
                    custody.segment_timeline(key)
        stitcher = self.stitcher
        stitched = [] if stitcher is None else stitcher.traces()
        with self._mu:
            delta = {k: round(v - self._last_metrics.get(k, 0.0), 6)
                     for k, v in metrics.items()
                     if v != self._last_metrics.get(k, 0.0)}
            self._last_metrics = metrics
        context = {}
        if self.context is not None:
            context = _sanitize(self.context())
        canon = {
            "trigger": cls,
            "key": key,
            "detail": {k: repr(_json_safe(v))
                       for k, v in sorted(detail.items())},
            "journal": [[e["sys"], e["kind"],
                         sorted((k, repr(v))
                                for k, v in e["detail"].items())]
                        for e in journal if e["sys"] in _CANON_SYS],
            "pins": _sanitize(rec.witness()),
            "faults": _sanitize(fired),
            "context": context,
        }
        if stitcher is not None:
            # structure only (uids, parent edges, truncation marks):
            # the stitched WITNESS is replay-stable; the full traces
            # carry host timings and stay evidence-side below
            canon["stitched"] = _sanitize(stitcher.witness())
        return {
            "seq": seq,
            "trigger": cls,
            "key": key,
            "detail": _sanitize(detail),
            "journal": _sanitize(journal),
            "pinned": _sanitize(pinned),
            "stitched": _sanitize(stitched),
            "metrics_delta": delta,
            "snapshots": _sanitize(snapshots),
            "faults": _sanitize(fired),
            "context": context,
            "canon": canon,
        }

    # -- introspection -------------------------------------------------------
    def bundles(self) -> list[dict]:
        with self._mu:
            return list(self._bundles)

    def witness(self) -> bytes:
        """The replay witness: every retained bundle's ``canon``
        section, serialized deterministically. Two same-seed runs of
        the same episode must return identical bytes."""
        with self._mu:
            canons = [b["canon"] for b in self._bundles]
        return json.dumps(canons, sort_keys=True,
                          separators=(",", ":")).encode()

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "bundles": len(self._bundles),
                "triggers": dict(sorted(self._per_class.items())),
                "rate_limited": self.rate_limited,
                "deduplicated": self.deduplicated,
            }

    def dump(self, limit: int | None = None) -> dict:
        """Everything for a dump: reporter counters,
        the recorder snapshot, and the newest ``limit`` bundles."""
        bundles = self.bundles()
        if limit is not None:
            bundles = bundles[-limit:]
        return {
            "reporter": self.snapshot(),
            "recorder": self.recorder.snapshot(),
            "bundles": bundles,
        }
