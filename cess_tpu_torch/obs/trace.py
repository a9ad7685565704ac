"""Request-scoped tracing for the serving data plane.

The port's own copy of ``cess_tpu/obs/trace.py``: the same span ids,
span records and Chrome export, so one span sequence exports the same
trace from both packages. Flat gauges say whether the plane is healthy;
a trace says where THIS upload's 40 ms went. A :class:`Tracer` collects
:class:`Span` records threaded through the data-plane seams
(``StoragePipeline`` encode/tag/forward, engine request -> batch ->
device dispatch -> resolve, stream run/batch/stall, resilience retries,
faults and fallbacks), so one trace shows one request's whole path.

Contracts, in priority order:

- **Zero-cost when off** (the ``resilience.faults`` contract): with no
  tracer armed every hook is one module-global load and a ``None``
  check, and returns the process-wide :data:`NOOP_SPAN` singleton; no
  span object, dict or clock read is allocated on the disabled path.
- **Deterministic span ids**: ids come from a per-tracer counter and a
  trace id is fixed at construction (no clock, no randomness in
  identities), so two replays of one workload under one seeded
  FaultPlan give correlatable traces (timings differ, the span graph
  does not).
- **Context propagation**: the current span lives in a
  ``contextvars.ContextVar``. ``span(...)`` (the ``with``-style hook)
  makes its span current for the block; children started inside
  inherit it as parent. Contexts do NOT cross threads: code that hands
  work to another thread (the engine's batcher) carries the span object
  explicitly, and code that crosses processes carries ``context()`` =
  ``(trace_id, span_id)`` and rebuilds with ``remote=``.
- **Bounded memory**: finished spans land in a thread-safe ring buffer
  (``capacity`` newest kept); an unfinished span is absent from
  exports, never a leak.

Export: :meth:`Tracer.export_chrome` gives Chrome trace-event JSON (one
``"X"`` complete event per span; load it in Perfetto or
chrome://tracing).

``Tracer(device_annotations=True)`` additionally wraps each engine batch
dispatch in ``torch.profiler.record_function("cess:<op>")`` and each
streamed batch's dispatch in ``record_function("cess_stream#<n>")``, so
a ``torch.profiler`` trace taken during the run lines up with the
framework's spans.

Host stages. :class:`stage` clocks one stage of a host path into a dict
of seconds (``Upload.seconds`` of ``node/offchain.upload_batch``) and,
only while someone looks, makes it a child span of the current span (a
tracer armed) and a ``torch.profiler`` range of the same name (the
profiler recording), so the device trace names the idle gaps the stage
leaves. :func:`profiler_range` is the one place where the port's
program ranges enter the profiler: the stages, the engine's and the
stream's annotations.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import os
import sys
import threading
import time

MAX_EVENTS = 64           # per-span event cap (bounds a hot loop)

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "cess_current_span", default=None)


class _NoopSpan:
    """The process-wide no-op span: every disabled hook returns THIS
    object (singleton — the zero-allocation disabled-path witness),
    and every method on it is an attribute-free no-op that returns
    ``self`` so call chains and ``with`` blocks work unchanged."""

    __slots__ = ()
    span_id = 0
    trace_id = 0

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        return self

    def finish(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __bool__(self):
        return False


NOOP_SPAN = _NoopSpan()


def _json_safe(value):
    """Attrs ride into JSON exports: coerce the common non-JSON guests
    (bytes, numpy scalars) instead of failing the whole dump."""
    if isinstance(value, (bytes, bytearray)):
        return value.hex()
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    item = getattr(value, "item", None)     # numpy scalar
    if callable(item):
        try:
            return _json_safe(item())
        except (TypeError, ValueError):
            pass
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    return repr(value)


class Span:
    """One timed unit of work. Identity (span_id/trace_id/parent_id)
    is fixed at start; timing is monotonic-clock; ``attrs`` and
    ``events`` accumulate under the owning tracer's lock (spans cross
    threads: the engine submitter starts one, the batcher annotates
    and finishes it)."""

    __slots__ = ("tracer", "name", "sys", "span_id", "parent_id",
                 "trace_id", "remote_parent", "t0", "dur_s", "attrs",
                 "events", "tid", "_token", "_finished")

    def __init__(self, tracer: "Tracer", name: str, sys: str,
                 span_id: int, parent_id: int, trace_id: int,
                 remote_parent: bool, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.sys = sys
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.remote_parent = remote_parent
        self.t0 = time.monotonic()
        self.dur_s = 0.0
        self.attrs = attrs
        self.events: list[tuple[float, str, dict]] = []
        self.tid = threading.get_ident()
        self._token = None
        self._finished = False

    def set(self, **attrs) -> "Span":
        """Merge attributes (last write wins)."""
        with self.tracer._mu:
            self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> "Span":
        """Append a point-in-time annotation (retry fired, fault
        injected, batch joined); capped at MAX_EVENTS per span."""
        t = time.monotonic() - self.t0
        with self.tracer._mu:
            if len(self.events) < MAX_EVENTS:
                self.events.append((t, name, attrs))
        return self

    def finish(self, **attrs) -> "Span":
        """Close the span: record duration, push it into the tracer's
        ring buffer, restore the previous current span (if this one
        was made current in this context). Idempotent."""
        dur = time.monotonic() - self.t0
        token = None
        with self.tracer._mu:
            if self._finished:
                return self
            self._finished = True
            self.dur_s = dur
            if attrs:
                self.attrs.update(attrs)
            if len(self.tracer._spans) >= self.tracer.capacity:
                # the bounded ring is about to evict its oldest
                # finished span — count it (a silent wrap used to look
                # identical to a quiet run in every export)
                self.tracer._dropped += 1
            self.tracer._spans.append(self)
            token, self._token = self._token, None
        if token is not None:
            try:
                _CURRENT.reset(token)
            except ValueError:
                pass   # finished from another thread/context: fine
        # the flight-recorder pin seam: one attribute load + None check
        # when no recorder is attached (the zero-cost contract). Runs
        # after _mu is released: the
        # recorder takes its own lock. The idempotence guard above
        # means a double finish() never reaches here twice.
        fl = self.tracer.flight
        if fl is not None:
            fl.offer(self)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.set(error=repr(exc))
        self.finish()
        return False


class Tracer:
    """One trace session: a deterministic span-id counter, a fixed
    trace id, and a bounded ring buffer of finished spans.

    capacity:           finished spans kept (oldest evicted).
    trace_id:           the session identity every root span carries;
                        spans started from a remote ``context()`` adopt
                        the sender's instead (distributed traces).
    device_annotations: engine and stream batch dispatches additionally
                        open a ``torch.profiler.record_function`` scope,
                        so a profiler trace lines up with framework spans.
    """

    def __init__(self, capacity: int = 4096, trace_id: int = 1,
                 device_annotations: bool = False):
        if capacity < 1:
            raise ValueError(f"tracer capacity {capacity} < 1")
        self._mu = threading.Lock()
        self._next_id = 1
        self.trace_id = int(trace_id)
        self.capacity = capacity
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=capacity)
        self.device_annotations = device_annotations
        self.origin = time.monotonic()   # ts origin for exports
        self.pid = os.getpid()
        self.started = 0                 # spans started (ever)
        self._dropped = 0                # finished spans the ring evicted
        # optional obs.flight.FlightRecorder offered every finished
        # span (tail-sampled retention); None = seam disabled
        self.flight = None

    def attach_flight(self, recorder) -> None:
        """Attach an ``obs.flight.FlightRecorder``: every span finished
        on this tracer is offered for tail-sampled retention (pinned
        traces survive ring eviction in the recorder's own bounded
        store). Pass None to detach."""
        self.flight = recorder

    @property
    def dropped(self) -> int:
        """Finished spans evicted by the bounded ring (capacity
        overflow). A nonzero value means exports are a WINDOW, not the
        whole run."""
        with self._mu:
            return self._dropped

    # -- span creation -------------------------------------------------------
    def start(self, name: str, *, sys: str = "", parent=None,
              remote: tuple | None = None, current: bool = False,
              **attrs) -> Span:
        """Start a span. MUST be balanced with ``finish()`` — use it as
        a context manager or close it in a ``finally``; an unclosed
        span never reaches the ring buffer and orphans its children.

        parent:  explicit parent Span; default inherits the context's
                 current span; NOOP_SPAN/absent current = root.
        remote:  ``(trace_id, span_id)`` from a peer's ``context()`` —
                 joins the sender's distributed trace.
        current: make this span the context's current span until
                 finish (same-thread ``with`` usage).
        """
        if parent is None and remote is None:
            parent = _CURRENT.get()
        remote_parent = False
        if remote is not None:
            trace_id, parent_id = int(remote[0]), int(remote[1])
            remote_parent = parent_id != 0
        elif isinstance(parent, Span):
            parent_id, trace_id = parent.span_id, parent.trace_id
        else:
            parent_id, trace_id = 0, self.trace_id
        with self._mu:
            span_id = self._next_id
            self._next_id += 1
            self.started += 1
        span = Span(self, name, sys, span_id, parent_id, trace_id,
                    remote_parent, dict(attrs))
        if current:
            span._token = _CURRENT.set(span)
        return span

    # -- export --------------------------------------------------------------
    def finished(self) -> list[dict]:
        """Finished spans (newest-capacity window) as plain dicts, in
        finish order."""
        with self._mu:
            spans = list(self._spans)
        return [self._span_dict(s) for s in spans]

    def _span_dict(self, s: Span) -> dict:
        return {
            "name": s.name, "sys": s.sys, "span_id": s.span_id,
            "parent_id": s.parent_id, "trace_id": s.trace_id,
            "remote_parent": s.remote_parent, "tid": s.tid,
            "ts_s": round(s.t0 - self.origin, 6),
            "dur_s": round(s.dur_s, 6),
            "attrs": {k: _json_safe(v) for k, v in s.attrs.items()},
            "events": [{"t_s": round(t, 6), "name": n,
                        "attrs": {k: _json_safe(v)
                                  for k, v in a.items()}}
                       for t, n, a in s.events],
        }

    def export_chrome(self, trace_id: int | None = None,
                      limit: int | None = None) -> dict:
        """Chrome trace-event JSON (the ``{"traceEvents": [...]}``
        object form): one complete (``"ph": "X"``) event per finished
        span, microsecond timestamps relative to the tracer's origin.
        Write it to a file and open in Perfetto (ui.perfetto.dev) or
        chrome://tracing; span attrs + events ride in ``args``.

        trace_id: only spans of that trace (a distributed tracer may
                  hold several); limit: newest ``limit`` spans after
                  the filter — both optional, default = whole ring.

        A span whose parent the bounded ring already evicted would
        render as a dangling edge; such spans are re-parented to the
        trace root (``"parent": 0``) with a synthetic
        ``"truncated_parent": true`` arg so a wrapped ring stays
        loadable in Perfetto and the truncation is visible per
        span."""
        spans = self.finished()
        if trace_id is not None:
            spans = [s for s in spans if s["trace_id"] == trace_id]
        if limit is not None:
            spans = spans[-limit:]
        present = {s["span_id"] for s in spans}
        events = []
        for s in spans:
            args = {
                "span_id": s["span_id"],
                "parent": s["parent_id"],
                "trace_id": s["trace_id"],
                "remote_parent": s["remote_parent"],
                "sys": s["sys"],
                "events": s["events"],
                **s["attrs"],
            }
            if s["parent_id"] != 0 and not s["remote_parent"] \
                    and s["parent_id"] not in present:
                args["parent"] = 0
                args["truncated_parent"] = True
            events.append({
                "name": s["name"],
                "cat": s["sys"] or "span",
                "ph": "X",
                "ts": round(s["ts_s"] * 1e6, 3),
                "dur": round(s["dur_s"] * 1e6, 3),
                "pid": self.pid,
                "tid": s["tid"],
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- arming ------------------------------------------------------------------
_MU = threading.Lock()
_TRACER: Tracer | None = None


def arm(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process-wide armed tracer."""
    global _TRACER
    with _MU:
        _TRACER = tracer
    return tracer


def disarm() -> None:
    global _TRACER
    with _MU:
        _TRACER = None


def armed_tracer() -> Tracer | None:
    return _TRACER


@contextlib.contextmanager
def armed(tracer: Tracer):
    """``with trace.armed(t): ...`` — arm for the block, always disarm
    after (tests must never leak a tracer into their neighbors)."""
    arm(tracer)
    try:
        yield tracer
    finally:
        disarm()


# -- hooks (the only calls production code makes) ----------------------------
def span(name: str, *, sys: str = "", **attrs):
    """The ``with``-style hook: a current-context span on the armed
    tracer, or :data:`NOOP_SPAN` (the singleton) when none is armed —
    one global load, one ``None`` check, nothing allocated."""
    tracer = _TRACER
    if tracer is None:
        return NOOP_SPAN
    return tracer.start(name, sys=sys, current=True, **attrs)


def current_span():
    """The context's active span, or :data:`NOOP_SPAN`."""
    if _TRACER is None:
        return NOOP_SPAN
    return _CURRENT.get() or NOOP_SPAN


def event(name: str, **attrs) -> None:
    """Annotate the active span (no-op without one) — the seam the
    fault injector and retry policies use."""
    sp = _CURRENT.get()
    if sp is not None:
        sp.event(name, **attrs)


def context() -> tuple[int, int] | None:
    """The ``(trace_id, span_id)`` pair a message envelope carries
    (span_id 0 = no active span), or None when no tracer is armed —
    the sender side of the distributed-trace contract; the receiver
    passes it to ``Tracer.start(remote=...)``. The trace id is the
    CURRENT SPAN's, not the local tracer's: a node relaying a message
    it handled under a remote-joined ``net.recv`` span must propagate
    the ORIGINATOR's trace id, or a multi-hop round would fracture
    into per-node trace ids with dangling parents."""
    tracer = _TRACER
    if tracer is None:
        return None
    sp = _CURRENT.get()
    if isinstance(sp, Span):
        return (sp.trace_id, sp.span_id)
    return (tracer.trace_id, 0)


# -- host stages and profiler ranges ------------------------------------------
def profiler_range(name: str):
    """``torch.profiler.record_function(name)``: a range that a recording
    ``torch.profiler`` shows as a ``user_annotation`` event. The port's
    only call site of it."""
    import torch

    return torch.profiler.record_function(name)


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records: the flag torch keeps for
    every profiler it starts. ``torch.autograd._profiler_enabled()`` reads
    only the calling thread's state, which a profiler started for all
    threads (``profile_all_threads``) leaves unset. False while torch is
    not even loaded (this module imports none of it)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd.profiler._is_profiler_enabled


class stage:
    """``with stage(name, clocks, key):`` adds the ``perf_counter``
    seconds of the block to ``clocks[key]``. A key ``<stage>.<part>``
    adds them to ``clocks[<stage>]`` as well, so a stage opened with
    ``key=None`` holds exactly the sum of its parts.

    While the block runs, and only then: with a tracer armed, ``name`` is
    a current child span of the current span; with ``torch.profiler``
    recording, ``name`` is a profiler range. Off, the block costs two
    clock reads and one profiler check: no span, no range. ``with`` gives
    the span, or :data:`NOOP_SPAN`."""

    __slots__ = ("name", "clocks", "key", "_t0", "_span", "_range")

    def __init__(self, name: str, clocks: dict, key: str | None = None):
        self.name = name
        self.clocks = clocks
        self.key = key
        self._span = self._range = None

    def __enter__(self):
        tracer = _TRACER
        if tracer is not None:
            self._span = tracer.start(self.name, current=True)
        if _profiling():
            self._range = profiler_range(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return NOOP_SPAN if self._span is None else self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        dt = time.perf_counter() - self._t0
        key, clocks = self.key, self.clocks
        if key is not None:
            clocks[key] = clocks.get(key, 0.0) + dt
            dot = key.rfind(".")
            if dot > 0:
                parent = key[:dot]
                clocks[parent] = clocks.get(parent, 0.0) + dt
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if self._span is not None:
            self._span.__exit__(exc_type, exc, tb)
        return False
