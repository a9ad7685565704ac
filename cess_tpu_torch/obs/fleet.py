"""Fleet observability plane: metric federation, cross-node trace
stitching, a global SLO view and straggler detection.

The port's own copy of ``cess_tpu/obs/fleet.py`` (it imports the port's
``obs/flight``, ``obs/trace`` and ``obs/prom``, never the JAX package),
the layer above one process's tracer, SLO board and flight recorder:

- :class:`MetricFederator` ingests text-format Prometheus expositions
  from N instances, adds an ``instance`` label, clamps counter resets
  of restarted nodes (:func:`~cess_tpu_torch.obs.prom.counter_delta`)
  and merges histogram families across instances by rebuilding each
  node's cumulative buckets (``Histogram.from_cumulative``) and
  reusing ``Histogram.merge``.
- :class:`FleetBoard` aggregates per-node ``SloBoard.snapshot()`` dicts
  into global per-class burn state, ``worst`` (any node burning: the
  paging view) and ``quorum`` (a strict majority: the admission view,
  what ``serve.adaptive.AdmissionController.attach_fleet`` listens
  on). Transitions append to a deterministic log and announce like the
  per-node board: a ``fleet.transition`` span, a ``("fleet",
  "transition")`` flight note, then the listeners, FIFO outside the
  board lock.
- :class:`TraceStitcher` merges trace dumps of several nodes into
  connected cross-node traces, keying each span ``instance/span_id``
  (span ids are unique per tracer only) and resolving a
  ``remote_parent`` against other instances' spans of the same trace;
  a parent no dump retains is marked ``remote_truncated``.
- :class:`StragglerDetector`: median-absolute-deviation outliers over
  count-sequenced per-node windows; a node whose window median leaves
  the fleet median by more than ``k`` MAD fires one ``("fleet",
  "outlier")`` note (edge-triggered), the edge the remediation plane's
  ``straggler-quarantine`` policy acts on.

:class:`FleetPlane` composes the four behind one scrape-round API.

Zero cost when off: the module installs no hooks; a feeder holds one
attribute and skips on None.

Determinism: no wallclock, no entropy. Rounds, scans and transition
logs are sequenced by internal counters, and the medians, MADs and
quantiles are the reference's Python float operations in the
reference's order, so :meth:`FleetPlane.witness` (the federated
snapshot, the board's transition log and the stitched trace set as
canonical JSON bytes) equals the JAX package's on the same inputs.
"""
from __future__ import annotations

import collections
import json
import math
import threading

from . import flight as _flight
from . import prom
from . import trace as _trace

STATES = ("ok", "warn", "burning")
_SEVERITY = {"ok": 0, "warn": 1, "burning": 2}


# -- exposition parsing ------------------------------------------------------

def _parse_labels(body: str) -> tuple:
    """``k="v",...`` (the inside of a label brace pair) as a tuple of
    ``(key, value)`` pairs, unescaping the format-0.0.4 sequences
    prom.escape_label produces. Raises ValueError on malformed input
    (truncated value, missing ``=``)."""
    out = []
    i = 0
    n = len(body)
    while i < n:
        eq = body.index("=", i)
        key = body[i:eq].strip()
        if body[eq + 1] != '"':
            raise ValueError(f"unquoted label value in {body!r}")
        j = eq + 2
        buf = []
        while body[j] != '"':           # IndexError => ValueError below
            ch = body[j]
            if ch == "\\":
                nxt = body[j + 1]
                buf.append({"n": "\n"}.get(nxt, nxt))
                j += 2
            else:
                buf.append(ch)
                j += 1
        out.append((key, "".join(buf)))
        i = j + 1
        if i < n and body[i] == ",":
            i += 1
    return tuple(out)


def parse_exposition(text: str) -> dict:
    """Parse a text-format 0.0.4 exposition (``render_metrics``
    output) into ``{"types": {family: kind}, "samples": [(name,
    labels, value), ...]}`` with labels as ``(key, value)`` tuples.
    Unparseable sample lines are skipped (a federator must survive a
    half-written scrape), malformed label bodies included."""
    types: dict[str, str] = {}
    samples: list[tuple] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        head, _, value_s = line.rpartition(" ")
        if not head:
            continue
        try:
            value = float(value_s)
        except ValueError:
            continue
        if "{" in head:
            name, _, rest = head.partition("{")
            rest = rest.rstrip()
            if not rest.endswith("}"):
                continue
            try:
                labels = _parse_labels(rest[:-1])
            except (ValueError, IndexError):
                continue
        else:
            name, labels = head, ()
        samples.append((name, labels, value))
    return {"types": types, "samples": samples}


def _hist_part(name: str, bases: set) -> tuple:
    """(family, part) when ``name`` is a histogram component sample
    (``_bucket``/``_sum``/``_count`` of a declared histogram family),
    else (None, None)."""
    for suffix, part in (("_bucket", "bucket"), ("_sum", "sum"),
                         ("_count", "count")):
        if name.endswith(suffix) and name[:-len(suffix)] in bases:
            return name[:-len(suffix)], part
    return None, None


def _le_value(le: str) -> float:
    return math.inf if le == "+Inf" else float(le)


# -- metric federation -------------------------------------------------------

class MetricFederator:
    """Federate per-node expositions into one fleet-wide metric view.

    Per series (``(name, labels)`` with the ``instance`` dimension
    added at ingest):

    - counters accumulate CLAMPED deltas: a restarted node's counter
      going backwards contributes ``cur`` (what accumulated after the
      restart), never a negative delta (prom.counter_delta) — so the
      federated total stays monotonic across node restarts;
    - gauges keep the latest scraped value per instance;
    - histograms keep the latest cumulative bucket vector per instance
      and merge across instances on demand (Histogram.from_cumulative
      + merge), giving the FleetBoard a real fleet-wide quantile.

    ``scrape_round`` is the only mutator; rounds are count-sequenced
    (no wallclock) so sim replays federate bit-identically. Instances
    are sorted before ingestion — the same set of expositions yields
    the same federated state regardless of dict order."""

    def __init__(self):
        self._mu = threading.Lock()
        self._round = 0
        self._instances: set[str] = set()
        self._types: dict[str, str] = {}
        # (name, labels) -> {instance: [last_raw, clamped_cumulative]}
        self._counters: dict = {}
        # (name, labels) -> {instance: value}
        self._gauges: dict = {}
        # (name, labels) -> {instance: (cumulative_buckets, sum)}
        self._hists: dict = {}

    def scrape_round(self, expositions: dict) -> int:
        """Ingest one scrape round: ``{instance: exposition_text}``.
        Returns the (count-sequenced) round number just sealed."""
        parsed = [(str(inst), parse_exposition(expositions[inst]))
                  for inst in sorted(expositions)]
        with self._mu:
            self._round += 1
            rnd = self._round
            for inst, p in parsed:
                self._instances.add(inst)
                self._types.update(p["types"])
                self._ingest_locked(inst, p)
        return rnd

    def _ingest_locked(self, inst: str, parsed: dict) -> None:
        hist_bases = {n for n, k in self._types.items()
                      if k == "histogram"}
        partial: dict = {}      # (family, labels) -> {"buckets": ...}
        for name, labels, value in parsed["samples"]:
            base, part = _hist_part(name, hist_bases)
            if base is not None:
                key = (base, tuple(sorted(
                    (k, v) for k, v in labels if k != "le")))
                ent = partial.setdefault(key, {})
                if part == "bucket":
                    le = dict(labels).get("le")
                    if le is None:
                        continue
                    try:
                        bound = _le_value(le)
                    except ValueError:
                        continue
                    ent.setdefault("buckets", []).append((bound, value))
                else:
                    ent[part] = value
                continue
            labels = tuple(sorted(labels))
            kind = self._types.get(name) or (
                "counter" if name.endswith("_total") else "gauge")
            if kind == "counter":
                per = self._counters.setdefault((name, labels), {})
                st = per.get(inst)
                if st is None:
                    per[inst] = [value, value]
                else:
                    st[1] += prom.counter_delta(st[0], value)
                    st[0] = value
            else:
                self._gauges.setdefault((name, labels), {})[inst] = value
        for (family, labels), ent in partial.items():
            buckets = tuple(sorted(ent.get("buckets", ())))
            if not buckets:
                continue
            self._hists.setdefault((family, labels), {})[inst] = (
                buckets, float(ent.get("sum", 0.0)))

    # -- reading -------------------------------------------------------------
    @property
    def round(self) -> int:
        with self._mu:
            return self._round

    def merged_histogram(self, name: str, labels=()):
        """Fleet-wide :class:`~cess_tpu_torch.obs.prom.Histogram` for one
        family across every instance (None when the family is unknown
        or no instance's buckets parse). Merge order is sorted by
        instance — deterministic, and merge is commutative anyway.
        Instances whose bucket grids disagree (version skew, a hostile
        peer) cannot merge — only the grid MOST instances agree on is
        merged (ties break to the smaller grid: deterministic), the
        rest are skipped, never fatal."""
        with self._mu:
            per = dict(self._hists.get((name, tuple(sorted(labels))), {}))
        grids: dict = {}        # bounds tuple -> [Histogram...]
        for inst in sorted(per):
            buckets, total_sum = per[inst]
            try:
                h = prom.Histogram.from_cumulative(buckets, total_sum)
            except ValueError:
                continue            # malformed node scrape: skip it
            grids.setdefault(tuple(h.bounds), []).append(h)
        if not grids:
            return None
        majority = max(sorted(grids), key=lambda b: len(grids[b]))
        merged = None
        for h in grids[majority]:
            merged = h if merged is None else merged.merge(h)
        return merged

    def snapshot(self) -> dict:
        """Deterministic federated view: every series keyed by
        ``name{labels-with-instance}``, plus the merged per-family
        histograms. JSON-safe; sorted at every level."""
        with self._mu:
            rnd = self._round
            instances = sorted(self._instances)
            counters = {k: {i: list(v) for i, v in per.items()}
                        for k, per in self._counters.items()}
            gauges = {k: dict(per) for k, per in self._gauges.items()}
            hist_keys = sorted(self._hists)
        out_counters = {}
        for (name, labels), per in sorted(counters.items()):
            for inst in sorted(per):
                key = name + prom.format_labels(
                    dict(labels, instance=inst))
                out_counters[key] = per[inst][1]
        out_gauges = {}
        for (name, labels), per in sorted(gauges.items()):
            for inst in sorted(per):
                key = name + prom.format_labels(
                    dict(labels, instance=inst))
                out_gauges[key] = per[inst]
        out_hists = {}
        for name, labels in hist_keys:
            merged = self.merged_histogram(name, labels)
            if merged is None:
                continue
            snap = merged.snapshot()
            key = name + prom.format_labels(dict(labels))
            out_hists[key] = {
                "buckets": [[prom.format_le(b), n]
                            for b, n in snap["buckets"]],
                "sum": round(snap["sum"], 9),
                "count": snap["count"],
            }
        return {"round": rnd, "instances": instances,
                "counters": out_counters, "gauges": out_gauges,
                "histograms": out_hists}

    def render(self) -> str:
        """The federated exposition: every instance's counter and gauge
        series re-emitted with the ``instance`` label, histogram
        families re-emitted MERGED across instances (one fleet-wide
        grid per family — per-instance vectors live in ``snapshot``),
        one TYPE line per family, sorted — what a fleet-level scrape
        endpoint would serve."""
        snap = self.snapshot()
        with self._mu:
            hist_keys = sorted(self._hists)
        lines = []
        declared: set[str] = set()
        for key in sorted(snap["counters"]):
            self._declare(key, "counter", declared, lines)
            lines.append(f"{key} {snap['counters'][key]}")
        for key in sorted(snap["gauges"]):
            self._declare(key, "gauge", declared, lines)
            lines.append(f"{key} {snap['gauges'][key]}")
        for name, labels in hist_keys:
            merged = self.merged_histogram(name, labels)
            if merged is None:
                continue
            lines.extend(prom.render_histogram(
                name, merged, labels=dict(labels),
                type_line=name not in declared))
            declared.add(name)
        return "\n".join(lines) + "\n"

    @staticmethod
    def _declare(key: str, kind: str, declared: set, lines: list) -> None:
        family = key.partition("{")[0]
        if family not in declared:
            declared.add(family)
            lines.append(f"# TYPE {family} {kind}")

    def witness(self) -> bytes:
        """Canonical bytes of the federated snapshot — one third of
        the fleet replay witness."""
        return json.dumps(self.snapshot(), sort_keys=True,
                          separators=(",", ":")).encode()


# -- global SLO view ---------------------------------------------------------

def _quorum_state(states: list) -> str:
    """The most severe state a STRICT MAJORITY of reporting nodes is
    at-or-beyond. One burning node in a ten-node fleet leaves the
    quorum view ok (that node is the straggler detector's problem);
    six burning nodes flip it."""
    n = len(states)
    for name in ("burning", "warn"):
        k = sum(1 for s in states
                if _SEVERITY.get(s, 0) >= _SEVERITY[name])
        if 2 * k > n:
            return name
    return "ok"


class FleetBoard:
    """Global per-class burn state aggregated from per-node
    ``SloBoard.snapshot()`` dicts — the seam a multi-host admission
    controller plugs into.

    Two views per class, updated every scrape round:

    - ``worst``: the most severe state ANY reporting node is in — the
      paging view (someone's budget is burning somewhere);
    - ``quorum``: the most severe state a strict majority agrees on —
      the admission view (global throttling must not be hostage to
      one sick node).

    Transitions of either view append ``(cls, view, old, new, round)``
    to a bounded deterministic log and announce exactly like the
    per-node SloBoard: enqueued under the same ``_mu`` hold that
    recorded them, delivered FIFO under ``_announce_mu`` OUTSIDE the
    board lock — a ``fleet.transition`` span on the armed tracer, a
    ``("fleet", "transition")`` flight note, then listener callbacks.
    """

    def __init__(self, *, max_transitions: int = 256):
        if max_transitions < 1:
            raise ValueError("max_transitions must be >= 1")
        self._mu = threading.Lock()
        self._round = 0
        self._nodes: dict = {}          # instance -> {cls: state}
        self._views: dict = {}          # cls -> {"worst": s, "quorum": s}
        self._p99: dict = {}            # cls -> fleet p99 seconds
        self._transitions: collections.deque = collections.deque(
            maxlen=max_transitions)
        self._listeners: list = []
        # same serialization contract as SloBoard: FIFO delivery,
        # whichever thread holds the announce lock drains everything
        self._announce_mu = threading.RLock()
        self._pending_announce: collections.deque = collections.deque()

    def add_listener(self, fn) -> None:
        """Register ``fn(cls, view, old, new)`` — called on every
        global transition, outside the board lock."""
        with self._mu:
            self._listeners.append(fn)

    def scrape_round(self, snapshots: dict, p99_s: dict | None = None) -> int:
        """Ingest one round of per-node SLO snapshots:
        ``{instance: SloBoard.snapshot()}`` (an instance absent this
        round keeps its last reported states — a crashed node's last
        word stands until it reports again). ``p99_s`` optionally
        carries fleet-wide quantiles (from the federator's merged
        histograms) for the snapshot. Returns the round number."""
        fired = False
        with self._mu:
            self._round += 1
            rnd = self._round
            for inst in sorted(snapshots):
                snap = snapshots[inst]
                targets = snap.get("targets") \
                    if isinstance(snap, dict) else None
                if not isinstance(targets, dict):
                    targets = {}
                # per-class entries that are not dicts are skipped, not
                # fatal — a malformed snapshot must not wedge the board
                self._nodes[str(inst)] = {
                    str(cls): str(d.get("state", "ok"))
                    for cls, d in sorted(targets.items(),
                                         key=lambda kv: str(kv[0]))
                    if isinstance(d, dict)}
            if p99_s:
                for cls in sorted(p99_s):
                    self._p99[str(cls)] = round(float(p99_s[cls]), 9)
            classes = sorted({c for states in self._nodes.values()
                              for c in states})
            for cls in classes:
                reporting = [self._nodes[i][cls]
                             for i in sorted(self._nodes)
                             if cls in self._nodes[i]]
                worst = max(reporting,
                            key=lambda s: _SEVERITY.get(s, 0))
                quorum = _quorum_state(reporting)
                views = self._views.setdefault(
                    cls, {"worst": "ok", "quorum": "ok"})
                for view, new in (("worst", worst), ("quorum", quorum)):
                    old = views[view]
                    if new != old:
                        views[view] = new
                        self._transitions.append(
                            (cls, view, old, new, rnd))
                        self._pending_announce.append(
                            (cls, view, old, new, rnd))
                        fired = True
        if fired:
            self._drain_announcements()
        return rnd

    def _drain_announcements(self) -> None:
        with self._announce_mu:
            while True:
                with self._mu:
                    if not self._pending_announce:
                        return
                    item = self._pending_announce.popleft()
                self._announce(*item)

    def _announce(self, cls: str, view: str, old: str, new: str,
                  rnd: int) -> None:
        # observable exactly like a per-node SLO transition: a span on
        # the armed tracer (WHEN the fleet flipped, relative to faults
        # and stitched cross-node spans), a journal note (the round is
        # count-sequenced, so it is replay-canonical), a callback
        with _trace.span("fleet.transition", sys="fleet", cls=cls,
                         view=view, frm=old, to=new, round=rnd):
            pass
        _flight.note("fleet", "transition", cls=cls, view=view,
                     frm=old, to=new, round=rnd)
        with self._mu:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(cls, view, old, new)

    # -- introspection -------------------------------------------------------
    def state(self, cls: str, view: str = "quorum") -> str:
        with self._mu:
            return self._views.get(cls, {}).get(view, "ok")

    def burning(self, view: str = "worst") -> bool:
        with self._mu:
            return any(v.get(view) == "burning"
                       for v in self._views.values())

    def transition_log(self) -> tuple:
        """(cls, view, from, to, round) per transition, in firing
        order — one third of the fleet replay witness."""
        with self._mu:
            return tuple(self._transitions)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "round": self._round,
                "classes": {
                    cls: {
                        "worst": v["worst"],
                        "quorum": v["quorum"],
                        "p99_s": self._p99.get(cls),
                        "nodes": {i: states[cls]
                                  for i, states in
                                  sorted(self._nodes.items())
                                  if cls in states},
                    }
                    for cls, v in sorted(self._views.items())},
                "transitions": [list(t) for t in self._transitions],
            }


# -- cross-node trace stitching ----------------------------------------------

class TraceStitcher:
    """Merge per-node trace dumps into connected cross-node traces.

    Input spans are ``Tracer.finished()`` dicts. Within one instance,
    duplicate ``(trace_id, span_id)`` pairs dedup first-wins (a trace
    dump and a flight pin of the same episode overlap). Across
    instances, span ids are NOT unique (each tracer counts from 1), so
    every stitched span gets a fleet-unique ``uid`` =
    ``instance/span_id`` and parent references resolve to
    ``parent_uid``:

    - a local parent resolves within the same instance;
    - a ``remote_parent`` reference resolves against OTHER instances'
      spans carrying the same ``(trace_id, span_id)`` — the sender's
      side of a net envelope hop. Span ids are per-tracer
      counters, so MULTIPLE other instances can match within one
      trace; resolution picks the lexicographically-first instance
      (deterministic) and marks the span ``ambiguous_parent`` so a
      postmortem reader knows the sender attribution is a guess, not
      a fact (exact resolution needs the sender identity in the net
      envelope, a wire change);
    - a parent no retained dump contains is marked
      ``remote_truncated`` (ring-buffer eviction, a crashed node) and
      the span becomes a visible truncation point, never a silent
      orphan.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._spans: dict = {}    # (instance, trace_id, span_id) -> span
        self._dumps = 0

    def add_dump(self, instance: str, spans) -> int:
        """Ingest one node's span dicts; returns how many were new
        (the rest deduplicated)."""
        instance = str(instance)
        added = 0
        with self._mu:
            self._dumps += 1
            for s in spans:
                if not isinstance(s, dict) or "span_id" not in s:
                    continue
                key = (instance, s.get("trace_id"), s["span_id"])
                if key in self._spans:
                    continue
                self._spans[key] = dict(s)
                added += 1
        return added

    def add_pins(self, instance: str, pins) -> int:
        """Ingest ``FlightRecorder.pinned()`` output (each pin holds a
        ``spans`` list)."""
        added = 0
        for pin in pins:
            if isinstance(pin, dict):
                added += self.add_dump(instance, pin.get("spans", ()))
        return added

    # -- stitching -----------------------------------------------------------
    def traces(self) -> list:
        """The stitched view: one dict per trace id, spans annotated
        with ``instance``/``uid``/``parent_uid``/``remote_truncated``,
        deterministically ordered (trace id, then instance, then span
        id). Pure function of the ingested spans."""
        with self._mu:
            spans = {k: dict(v) for k, v in self._spans.items()}
        local: dict = {}          # (instance, span_id) -> key
        cross: dict = {}          # (trace_id, span_id) -> [instance...]
        for (inst, tid, sid) in spans:
            local[(inst, sid)] = (inst, tid, sid)
            cross.setdefault((tid, sid), []).append(inst)
        by_trace: dict = {}
        for key in sorted(spans, key=lambda k: (str(k[0]), k[2])):
            inst, tid, sid = key
            s = spans[key]
            s["instance"] = inst
            s["uid"] = f"{inst}/{sid}"
            s["remote_truncated"] = False
            s["ambiguous_parent"] = False
            parent = s.get("parent_id") or 0
            if not parent:
                s["parent_uid"] = None
            elif s.get("remote_parent"):
                others = sorted(i for i in cross.get((tid, parent), ())
                                if i != inst)
                if others:
                    s["parent_uid"] = f"{others[0]}/{parent}"
                    # >1 candidate sender: per-tracer span ids collide
                    # across instances — flag, don't pick silently
                    s["ambiguous_parent"] = len(others) > 1
                elif (inst, parent) in local:
                    # loopback hop: the remote parent is local after all
                    s["parent_uid"] = f"{inst}/{parent}"
                else:
                    s["parent_uid"] = None
                    s["remote_truncated"] = True
            else:
                pkey = local.get((inst, parent))
                if pkey is not None and pkey[1] == tid:
                    s["parent_uid"] = f"{inst}/{parent}"
                else:
                    s["parent_uid"] = None
                    s["remote_truncated"] = True
            by_trace.setdefault(tid, []).append(s)
        out = []
        for tid in sorted(by_trace, key=lambda t: (str(type(t)), str(t))):
            tr = by_trace[tid]
            out.append({
                "trace_id": tid,
                "instances": sorted({s["instance"] for s in tr}),
                "spans": tr,
                "roots": [s["uid"] for s in tr
                          if s["parent_uid"] is None
                          and not s["remote_truncated"]],
                "truncated": [s["uid"] for s in tr
                              if s["remote_truncated"]],
                "ambiguous": [s["uid"] for s in tr
                              if s["ambiguous_parent"]],
            })
        return out

    def witness(self) -> tuple:
        """The replay-stable reduction of the stitched trace set —
        structure only (uids, names, parent edges, truncation marks),
        no host timings. One third of the fleet replay witness."""
        out = []
        for t in self.traces():
            out.append((t["trace_id"], tuple(
                (s["uid"], s.get("name", ""), s.get("sys", ""),
                 s["parent_uid"] or "", bool(s.get("remote_parent")),
                 s["remote_truncated"], s["ambiguous_parent"])
                for s in t["spans"])))
        return tuple(out)

    def snapshot(self) -> dict:
        """JSON-safe summary (a ``cess_fleetStatus`` payload)."""
        traces = self.traces()
        with self._mu:
            dumps, total = self._dumps, len(self._spans)
        return {
            "dumps": dumps,
            "spans": total,
            "traces": [{
                "trace_id": t["trace_id"],
                "instances": t["instances"],
                "n_spans": len(t["spans"]),
                "roots": t["roots"],
                "truncated": t["truncated"],
                "ambiguous": t["ambiguous"],
            } for t in traces],
        }


# -- straggler detection -----------------------------------------------------

def _median(values: list) -> float:
    vs = sorted(values)
    n = len(vs)
    mid = n // 2
    if n % 2:
        return float(vs[mid])
    return (vs[mid - 1] + vs[mid]) / 2.0


class StragglerDetector:
    """Median-absolute-deviation outlier detection over
    count-sequenced per-node windows.

    ``observe(instance, metric, value)`` appends to that node's
    bounded window; ``scan()`` reduces each node to its window median,
    takes the fleet median and MAD across nodes, and flags any node
    whose median deviates by more than ``k``·MAD (MAD floored at
    ``min_mad`` so an otherwise-identical fleet still flags the one
    deviant). Firing is EDGE-triggered — a ``("fleet", "outlier")``
    flight note (the ``fleet-outlier`` incident trigger) plus a
    ``fleet.outlier`` span when a node BECOMES an outlier, nothing
    while it stays one, re-armed once it rejoins the pack.

    Staleness: a window with no fresh sample for ``stale_scans``
    consecutive scans belongs to a node that stopped reporting
    (crashed, partitioned) — it is evicted so dead nodes neither skew
    the fleet median nor stay flagged forever; and any flag a scan
    can no longer derive (the window evicted, the metric's reporting
    count below ``min_nodes``) is dropped with it. If the evidence
    returns, the edge trigger re-fires.

    Determinism: windows, scans and staleness are count-sequenced;
    scans iterate instances and metrics sorted. No wallclock
    anywhere."""

    def __init__(self, *, window: int = 16, k: float = 4.0,
                 min_nodes: int = 4, min_mad: float = 1e-9,
                 stale_scans: int = 8):
        if window < 1 or min_nodes < 2 or k <= 0 or min_mad <= 0 \
                or stale_scans < 1:
            raise ValueError("invalid straggler detector bounds")
        self.window = int(window)
        self.k = float(k)
        self.min_nodes = int(min_nodes)
        self.min_mad = float(min_mad)
        self.stale_scans = int(stale_scans)
        self._mu = threading.Lock()
        self._windows: dict = {}    # (instance, metric) -> deque
        self._flagged: dict = {}    # (instance, metric) -> bool
        self._dirty: set = set()    # keys observed since the last scan
        self._last_obs: dict = {}   # key -> scan seq last seen fresh
        self._scans = 0

    def observe(self, instance: str, metric: str, value: float) -> None:
        key = (str(instance), str(metric))
        with self._mu:
            dq = self._windows.get(key)
            if dq is None:
                dq = self._windows[key] = collections.deque(
                    maxlen=self.window)
            dq.append(float(value))
            self._dirty.add(key)

    def scan(self) -> list:
        """One count-sequenced outlier scan; returns the NEW outliers
        as ``(instance, metric, value, median, mad, scan)`` tuples
        (and fires their notes/spans, outside the lock)."""
        fired = []
        with self._mu:
            self._scans += 1
            seq = self._scans
            for key in self._dirty:
                self._last_obs[key] = seq
            self._dirty.clear()
            stale = [k for k in self._windows
                     if seq - self._last_obs.get(k, seq)
                     >= self.stale_scans]
            for key in stale:
                del self._windows[key]
                self._last_obs.pop(key, None)
            by_metric: dict = {}
            for (inst, metric), dq in sorted(self._windows.items()):
                if dq:
                    by_metric.setdefault(metric, []).append(
                        (inst, _median(list(dq))))
            evaluated: set = set()
            for metric in sorted(by_metric):
                rows = by_metric[metric]
                if len(rows) < self.min_nodes:
                    continue
                med = _median([v for _, v in rows])
                mad = max(_median([abs(v - med) for _, v in rows]),
                          self.min_mad)
                for inst, v in rows:
                    is_out = abs(v - med) > self.k * mad
                    key = (inst, metric)
                    evaluated.add(key)
                    if is_out and not self._flagged.get(key, False):
                        fired.append((inst, metric, round(v, 9),
                                      round(med, 9), round(mad, 9),
                                      seq))
                    self._flagged[key] = is_out
            # a flag this scan could NOT re-derive (the metric fell
            # below min_nodes, the instance went silent) is stale —
            # drop it so snapshot()['outliers'] reflects only current
            # state; if the evidence returns, the edge re-fires
            self._flagged = {k: v for k, v in self._flagged.items()
                             if k in evaluated}
        for inst, metric, v, med, mad, sq in fired:
            with _trace.span("fleet.outlier", sys="fleet",
                             instance=inst, metric=metric):
                pass
            _flight.note("fleet", "outlier", instance=inst,
                         metric=metric, value=v, median=med,
                         mad=mad, scan=sq)
        return fired

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "scans": self._scans,
                "windows": len(self._windows),
                "outliers": sorted(f"{i}/{m}"
                                   for (i, m), on in
                                   self._flagged.items() if on),
            }


# -- the composite plane -----------------------------------------------------

class FleetPlane:
    """MetricFederator + FleetBoard + TraceStitcher +
    StragglerDetector behind one scrape-round API — the object that
    gets armed as ``node.fleet`` (live) or ``world.fleet`` (sim).

    The ingest/seal split matches how contributions actually arrive:
    ``ingest(...)`` buffers one node's exposition + SLO snapshot (net
    recv threads for peers, the local tick for self, the sim round
    loop for everyone) and ``seal_round()`` closes one count-sequenced
    round — federates buffered expositions, feeds the FleetBoard
    (with fleet-wide p99s from the merged ``latency_families``
    histograms) and runs a straggler scan. Straggler samples go
    straight to ``stragglers.observe`` (they are count-sequenced
    windows of their own).

    Zero-cost-when-off: nothing here hooks anything. Hot paths hold
    ONE attribute (``node.fleet`` / ``world.fleet``) and skip on None.
    """

    def __init__(self, instance: str, *, latency_families: dict | None
                 = None, straggler_window: int = 16,
                 straggler_k: float = 4.0, min_nodes: int = 4):
        self.instance = str(instance)
        # {slo_class: histogram_family} — which federated latency
        # family backs each class's fleet-wide p99
        self.latency_families = dict(latency_families or {})
        self.federator = MetricFederator()
        self.board = FleetBoard()
        self.stitcher = TraceStitcher()
        self.stragglers = StragglerDetector(
            window=straggler_window, k=straggler_k, min_nodes=min_nodes)
        self._mu = threading.Lock()
        self._pending: dict = {}    # instance -> (exposition, slo)
        self._rounds = 0
        self._source = None         # callable -> (exposition, slo)

    def attach_source(self, fn) -> None:
        """Register the SELF scrape source: a callable returning
        ``(exposition_text, slo_snapshot_dict_or_None)``."""
        with self._mu:
            self._source = fn

    # -- ingestion -----------------------------------------------------------
    def ingest(self, instance: str, exposition: str | None = None,
               slo: dict | None = None) -> None:
        """Buffer one node's contribution for the next seal. Called
        from net recv threads (peers) and the local tick (self); a
        node reporting twice in one round keeps its latest."""
        with self._mu:
            self._pending[str(instance)] = (exposition, slo)

    def ingest_frame(self, frame) -> None:
        """The ``("fleet", frame)`` gossip payload: ``(instance,
        exposition_text, slo_snapshot_json)``. Malformed frames are
        dropped — a peer must not be able to wedge the plane."""
        try:
            inst, expo, slo_json = frame
        except (TypeError, ValueError):
            return
        if not isinstance(inst, str) or not isinstance(expo, str):
            return
        slo = None
        if slo_json:
            try:
                slo = json.loads(slo_json)
            except (TypeError, ValueError):
                return
            if not isinstance(slo, dict):
                return
            # nested shape too: "targets" must be a dict of dicts —
            # ('{"targets": 123}', '{"targets": {"c": "burning"}}')
            # must not reach the FleetBoard and raise out of a seal
            targets = slo.get("targets")
            if targets is not None and (
                    not isinstance(targets, dict)
                    or any(not isinstance(d, dict)
                           for d in targets.values())):
                return
        self.ingest(inst, exposition=expo or None, slo=slo)

    def self_frame(self):
        """The gossip frame advertising THIS node's scrape, or None
        when no source is attached."""
        with self._mu:
            src = self._source
        if src is None:
            return None
        expo, slo = src()
        return (self.instance, expo or "",
                "" if slo is None else json.dumps(slo, sort_keys=True))

    # -- sealing -------------------------------------------------------------
    def seal_round(self) -> int:
        """Close one scrape round over everything buffered since the
        last seal. Sub-planes are fed OUTSIDE the plane lock — their
        announce paths reach the tracer and flight recorder and must
        never nest under it."""
        with self._mu:
            pending, self._pending = self._pending, {}
            self._rounds += 1
            rnd = self._rounds
        expositions = {i: e for i, (e, _) in pending.items() if e}
        if expositions:
            self.federator.scrape_round(expositions)
        slos = {i: s for i, (_, s) in pending.items() if s is not None}
        if slos:
            p99 = {}
            for cls in sorted(self.latency_families):
                merged = self.federator.merged_histogram(
                    self.latency_families[cls])
                if merged is not None and merged.count:
                    p99[cls] = merged.quantile(0.99)
            self.board.scrape_round(slos, p99_s=p99 or None)
        self.stragglers.scan()
        return rnd

    def tick(self) -> int:
        """One live scrape round: scrape self (if a source is
        attached), then seal whatever peers gossiped in since the last
        tick. The net author loop calls this every few slots."""
        frame = self.self_frame()
        if frame is not None:
            self.ingest_frame(frame)
        return self.seal_round()

    # -- introspection -------------------------------------------------------
    @property
    def rounds(self) -> int:
        with self._mu:
            return self._rounds

    def snapshot(self) -> dict:
        """The ``cess_fleetStatus`` payload."""
        with self._mu:
            rounds = self._rounds
        return {
            "instance": self.instance,
            "rounds": rounds,
            "federation": self.federator.snapshot(),
            "board": self.board.snapshot(),
            "stitch": self.stitcher.snapshot(),
            "stragglers": self.stragglers.snapshot(),
        }

    def witness(self) -> bytes:
        """THE fleet replay witness: federated snapshot + FleetBoard
        transition log + stitched trace set, canonical JSON bytes.
        Two same-seed sim runs must return identical bytes."""
        canon = {
            "federation": self.federator.snapshot(),
            "transitions": [list(t)
                            for t in self.board.transition_log()],
            "stitched": [[tid, [list(s) for s in spans]]
                         for tid, spans in self.stitcher.witness()],
        }
        return json.dumps(canon, sort_keys=True,
                          separators=(",", ":")).encode()
