"""Flight recorder: tail-sampled trace retention + black-box journals.

The port's own copy of ``cess_tpu/obs/flight.py``: the same pin policy,
the same seeded draws and the same replay witness, so one offered span
and note sequence gives byte-equal witnesses in both packages. The
tracer keeps finished spans in a bounded ring, the store that wraps
under the heavy traffic that causes incidents. A
:class:`FlightRecorder` watches every finished span through a zero-cost
seam in ``trace.Span.finish`` and, when a request's ROOT span finishes,
decides deterministically whether to *pin* the whole trace into its
own bounded store, exempt from ring eviction.

Pin policy (tail sampling: the decision runs after the outcome is
known):

- **always** pin a trace containing an error / shed / saturated /
  timeout outcome, a ``degraded`` (CPU-fallback) batch, or a fault
  firing (the ``fault`` span event resilience/faults.py emits);
- pin a trace whose root class ran **over its latency objective**
  (``objectives`` maps op class -> seconds; host timing, so these pins
  are excluded from the replay witness);
- pin a seeded **baseline fraction** of normal traffic: the draw is
  ``sha256(seed | trace_id | root_span_id)`` against ``baseline_rate``
  (the ``FaultPlan.seeded`` discipline: no ``random``, no clock), so
  two same-seed replays retain the same trace sets.

The pin store is budgeted in SPANS (``pin_budget``) with
anomaly-first retention: baseline pins evict oldest-first before any
anomalous pin is touched.

The second half is the black box: a bounded, COUNT-sequenced journal
of notable events per subsystem (engine saturation, breaker trips,
holds and recoveries, stream escapes). Entries carry a sequence
number, never a timestamp, so the journal replays byte-identically
under a seeded run; listeners receive each entry in order.

Zero-cost when off: the module hook :func:`note` is one global load +
``None`` check when no recorder is armed, and the pin seam in
``trace.Span.finish`` is one attribute load + ``None`` check when no
recorder is attached.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import threading

_SCALE = float(2 ** 64)

# outcomes that mark a span anomalous (every non-"ok" outcome the
# engine resolves with; see serve/engine.py)
_BAD_OUTCOMES = ("error", "timeout", "saturated", "shed", "closed")

# span attrs stable across same-seed replays — the only attrs the
# retention witness may include (latency_s / occupancy-style numbers
# depend on host timing and batch composition). The set is the TPU
# package's, so witnesses compare across the packages ("device" is its
# device pool's lane index, deterministic over a deterministic offered
# sequence).
_CANON_ATTRS = frozenset(("outcome", "cls", "op", "rows", "degraded",
                          "tenant", "reason", "scenario", "round",
                          "error", "device"))


def _pin_draw(seed: bytes, trace_id: int, root_span_id: int) -> float:
    """Uniform [0, 1) from a SHA-256 stream over (seed, trace identity)
    — the FaultPlan.seeded idiom: same seed, same trace => same draw."""
    h = hashlib.sha256(b"cess-flight:" + seed + b"|"
                       + str(trace_id).encode() + b"|"
                       + str(root_span_id).encode()).digest()
    return int.from_bytes(h[:8], "big") / _SCALE


class _Pin:
    """One retained trace: the root span plus every descendant the
    recorder saw, with the union of their anomaly reasons."""

    __slots__ = ("seq", "trace_id", "root_id", "root_name", "reasons",
                 "spans")

    def __init__(self, seq: int, trace_id: int, root_id: int,
                 root_name: str, reasons: tuple, spans: list):
        self.seq = seq
        self.trace_id = trace_id
        self.root_id = root_id
        self.root_name = root_name
        self.reasons = reasons
        self.spans = spans

    @property
    def anomalous(self) -> bool:
        return any(r != "baseline" for r in self.reasons)


class FlightRecorder:
    """Tail-sampled trace retention + the per-subsystem journal.

    seed:           the deterministic-sampling seed (bytes).
    baseline_rate:  fraction of non-anomalous traces pinned as the
                    healthy-traffic baseline (seeded draw, see module
                    doc); 0 disables baseline pinning.
    objectives:     op class -> latency objective seconds; a root
                    whose class objective its duration exceeds pins as
                    ``over-objective`` (host timing — excluded from
                    :meth:`witness`).
    pin_budget:     max total pinned SPANS; baseline pins evict
                    oldest-first before any anomalous pin.
    pending_cap:    finished non-root spans held awaiting their root's
                    decision (oldest evicted past the cap).
    journal_cap:    entries retained per journal subsystem.
    """

    def __init__(self, seed: bytes = b"", *, baseline_rate: float = 0.0,
                 objectives: dict | None = None, pin_budget: int = 4096,
                 pending_cap: int = 4096, journal_cap: int = 256):
        if not 0.0 <= baseline_rate <= 1.0:
            raise ValueError(f"baseline_rate {baseline_rate} not in [0, 1]")
        if pin_budget < 1 or pending_cap < 1 or journal_cap < 1:
            raise ValueError("flight recorder bounds must be >= 1")
        self.seed = seed if isinstance(seed, bytes) else str(seed).encode()
        self.baseline_rate = float(baseline_rate)
        self.objectives = dict(objectives or {})
        self.pin_budget = pin_budget
        self.pending_cap = pending_cap
        self.journal_cap = journal_cap
        self._mu = threading.Lock()
        # journal delivery serialization (the SloBoard announce
        # pattern): entries are ENQUEUED under _mu, DELIVERED in
        # sequence order under _deliver_mu with _mu released, so a
        # listener may read any snapshot without a lock cycle.
        # Lock order: _deliver_mu > _mu (never take _deliver_mu while
        # holding _mu).
        self._deliver_mu = threading.RLock()
        self._pending_notes: collections.deque = collections.deque()
        # finished non-root spans awaiting their root, span_id ->
        # (span, reasons); insertion order = eviction order
        self._pending: dict = {}
        self._children: dict = {}          # parent_id -> [span_id]
        self._pins: dict = {}              # root_id -> _Pin (pin order)
        self._pin_index: dict = {}         # span_id -> root_id
        self._pinned_spans = 0
        self._pin_seq = 0
        self._journals: dict = {}          # subsystem -> deque
        self._seq = 0
        self._listeners: list = []
        self.offered = 0
        self.roots_seen = 0
        self.baseline_pins = 0
        self.anomaly_pins = 0
        self.pin_evictions = 0
        self.pending_evictions = 0

    # -- the pin seam (trace.Span.finish calls this) -------------------------
    def offer(self, span) -> None:
        """A finished span. Non-roots are held (bounded) until their
        root's decision — or appended directly when their parent chain
        already resolved to a pinned trace; a root triggers the
        pin/drop decision for its whole held subtree."""
        reasons = self._span_reasons(span)
        with self._mu:
            self.offered += 1
            is_root = span.parent_id == 0 or span.remote_parent
            if not is_root:
                root_id = self._pin_index.get(span.parent_id)
                if root_id is not None:
                    # late arrival: its trace was already pinned
                    pin = self._pins[root_id]
                    pin.spans.append(span)
                    if reasons:
                        pin.reasons = tuple(sorted(
                            set(pin.reasons) | set(reasons)))
                    self._pin_index[span.span_id] = root_id
                    self._pinned_spans += 1
                    self._enforce_budget_locked()
                    return
                self._pending[span.span_id] = (span, tuple(reasons))
                self._children.setdefault(span.parent_id,
                                          []).append(span.span_id)
                while len(self._pending) > self.pending_cap:
                    evicted = next(iter(self._pending))
                    sp, _ = self._pending.pop(evicted)
                    sibs = self._children.get(sp.parent_id)
                    if sibs is not None:
                        sibs.remove(evicted)
                        if not sibs:
                            del self._children[sp.parent_id]
                    self.pending_evictions += 1
                return
            self.roots_seen += 1
            self._decide_locked(span, reasons)

    def _span_reasons(self, span) -> list:
        a = span.attrs
        reasons = []
        outcome = a.get("outcome")
        if outcome is not None and outcome != "ok":
            if outcome in _BAD_OUTCOMES:
                reasons.append(str(outcome))
        elif "error" in a:
            reasons.append("error")
        if a.get("degraded"):
            reasons.append("degraded")
        if any(name == "fault" for _, name, _ in list(span.events)):
            reasons.append("fault")
        cls = a.get("cls")
        if cls is not None:
            objective = self.objectives.get(cls)
            if objective is not None and span.dur_s > objective:
                reasons.append("over-objective")
        return reasons

    def _decide_locked(self, root, root_reasons: list) -> None:
        # gather the held subtree (children finished before the root)
        members: list = []
        reasons = set(root_reasons)
        frontier = [root.span_id]
        while frontier:
            pid = frontier.pop()
            for sid in self._children.pop(pid, ()):
                span, span_reasons = self._pending.pop(sid)
                members.append(span)
                reasons.update(span_reasons)
                frontier.append(sid)
        if not reasons and self.baseline_rate > 0.0 \
                and _pin_draw(self.seed, root.trace_id,
                              root.span_id) < self.baseline_rate:
            reasons.add("baseline")
        if not reasons:
            return                         # unpinned: the ring's problem
        self._pin_seq += 1
        # span order inside a pin is by id (creation order) — finish
        # order races across threads, creation order replays
        members.sort(key=lambda s: s.span_id)
        pin = _Pin(self._pin_seq, root.trace_id, root.span_id,
                   root.name, tuple(sorted(reasons)), [root] + members)
        self._pins[root.span_id] = pin
        for span in pin.spans:
            self._pin_index[span.span_id] = root.span_id
        self._pinned_spans += len(pin.spans)
        if pin.anomalous:
            self.anomaly_pins += 1
        else:
            self.baseline_pins += 1
        self._enforce_budget_locked()

    def _enforce_budget_locked(self) -> None:
        # anomaly-first RETENTION: evict oldest baseline pins first;
        # only when none remain do anomalous pins age out. A single
        # over-budget trace is kept whole (the budget bounds the
        # store, never truncates a trace).
        while self._pinned_spans > self.pin_budget and len(self._pins) > 1:
            victim = None
            for root_id, pin in self._pins.items():
                if not pin.anomalous:
                    victim = root_id
                    break
            if victim is None:
                victim = next(iter(self._pins))
            pin = self._pins.pop(victim)
            for span in pin.spans:
                self._pin_index.pop(span.span_id, None)
            self._pinned_spans -= len(pin.spans)
            self.pin_evictions += 1

    # -- pinned-trace export -------------------------------------------------
    def pinned(self) -> list[dict]:
        """Pinned traces (pin order) as self-contained dicts — full
        span records via the owning tracer's serializer."""
        with self._mu:
            pins = list(self._pins.values())
        return [{
            "seq": p.seq,
            "trace_id": p.trace_id,
            "root_span_id": p.root_id,
            "root": p.root_name,
            "reasons": list(p.reasons),
            "anomalous": p.anomalous,
            "spans": [s.tracer._span_dict(s) for s in p.spans],
        } for p in pins]

    def witness(self) -> tuple:
        """The deterministic retention witness (the ``fired_log``
        analog): every pin whose reasons survive with host-timing
        pins (``over-objective``-only) removed, reduced to
        replay-stable fields. Two same-seed runs must produce
        identical tuples."""
        from .trace import _json_safe
        with self._mu:
            pins = list(self._pins.values())
        out = []
        for p in pins:
            reasons = tuple(r for r in p.reasons if r != "over-objective")
            if not reasons:
                continue
            spans = tuple(sorted(
                (s.span_id, s.parent_id, s.name, s.sys,
                 tuple(sorted((k, repr(_json_safe(v)))
                              for k, v in dict(s.attrs).items()
                              if k in _CANON_ATTRS)))
                for s in p.spans))
            out.append((p.trace_id, p.root_id, p.root_name, reasons,
                        spans))
        return tuple(out)

    # -- the black-box journal -----------------------------------------------
    def note(self, subsystem: str, kind: str, **detail) -> None:
        """Append one count-sequenced journal entry and deliver it to
        listeners (outside the recorder lock, in sequence order)."""
        with self._mu:
            self._seq += 1
            entry = (self._seq, subsystem, kind, detail)
            journal = self._journals.get(subsystem)
            if journal is None:
                journal = self._journals[subsystem] = collections.deque(
                    maxlen=self.journal_cap)
            journal.append(entry)
            if self._listeners:
                self._pending_notes.append(entry)
            else:
                return
        self._deliver()

    def add_listener(self, fn) -> None:
        """``fn(seq, subsystem, kind, detail)`` per journal entry,
        delivered outside the recorder lock on the noting thread (the
        seam an incident reporter listens on)."""
        with self._mu:
            self._listeners.append(fn)

    def _deliver(self) -> None:
        with self._deliver_mu:
            while True:
                with self._mu:
                    if not self._pending_notes:
                        return
                    entry = self._pending_notes.popleft()
                    fns = list(self._listeners)
                for fn in fns:
                    fn(*entry)

    def journal_tail(self, subsystem: str | None = None,
                     limit: int | None = None) -> list[dict]:
        """Newest journal entries (merged across subsystems by
        sequence number when ``subsystem`` is None)."""
        with self._mu:
            if subsystem is not None:
                entries = list(self._journals.get(subsystem, ()))
            else:
                entries = sorted(
                    (e for j in self._journals.values() for e in j))
        if limit is not None:
            entries = entries[-limit:]
        return [{"seq": seq, "sys": sys_, "kind": kind,
                 "detail": dict(detail)}
                for seq, sys_, kind, detail in entries]

    def snapshot(self) -> dict:
        with self._mu:
            pins = list(self._pins.values())
            journals = {s: len(j) for s, j in sorted(self._journals.items())}
            return {
                "offered": self.offered,
                "roots_seen": self.roots_seen,
                "pins": len(pins),
                "pinned_spans": self._pinned_spans,
                "anomaly_pins": self.anomaly_pins,
                "baseline_pins": self.baseline_pins,
                "pin_evictions": self.pin_evictions,
                "pending": len(self._pending),
                "pending_evictions": self.pending_evictions,
                "pin_budget": self.pin_budget,
                "journal_entries": self._seq,
                "journals": journals,
            }


# -- arming (the resilience.faults / obs.trace pattern) ----------------------
_MU = threading.Lock()
_RECORDER: FlightRecorder | None = None


def arm(recorder: FlightRecorder) -> FlightRecorder:
    """Install ``recorder`` as the process-wide armed flight recorder
    (the :func:`note` hook's target)."""
    global _RECORDER
    with _MU:
        _RECORDER = recorder
    return recorder


def disarm() -> None:
    global _RECORDER
    with _MU:
        _RECORDER = None


def armed_recorder() -> FlightRecorder | None:
    return _RECORDER


@contextlib.contextmanager
def armed(recorder: FlightRecorder):
    """``with flight.armed(r): ...`` — arm for the block, always
    disarm after (tests must never leak a recorder into neighbors)."""
    arm(recorder)
    try:
        yield recorder
    finally:
        disarm()


def note(subsystem: str, kind: str, **detail) -> None:
    """The journal hook production code calls: one module-global load
    + ``None`` check when disarmed. Call sites sit on anomaly paths
    (saturation, trip, escape), never inside a lock whose holder a
    listener might need to read."""
    rec = _RECORDER
    if rec is None:
        return
    rec.note(subsystem, kind, **detail)
