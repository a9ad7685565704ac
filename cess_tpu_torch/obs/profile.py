"""Continuous profiling: per-shape dispatch accounts, the pad and
compile ledgers, and a throughput watchdog.

The port's own copy of ``cess_tpu/obs/profile.py``: the same accounts,
ledgers, canon, watchdog windows and transition log, so the same
observation sequence gives byte-equal :meth:`ProfilePlane.witness` in
both packages.

- :class:`OpProfiler`: per-(class, bucket rows, device lane) accounting
  of every engine dispatch (batches, requests, served and padded rows,
  bytes) with the caller's stage timings (queue-wait, h2d, dispatch,
  sync) and a count-windowed throughput gauge per class. Fed by
  ``SubmissionEngine._account_batch`` (a pool lane's index rides the
  account key) and by ``StreamingIngest`` under the class ``stream``.
- :class:`PadLedger`: padded-row accounts per class x bucket, split by
  source (``engine`` bucket coalescing, ``stream`` ragged tails), so
  :meth:`PadLedger.total` is the end-to-end pad bill.
- :class:`CompileLedger`: program-cache builds (a miss runs the build
  closure: staging a codec's tables, a challenge round's tensors) with
  canonical keys and the build's wall time.
- :class:`PerfWatchdog`: per tracked metric, (bytes, busy seconds)
  accumulate over observation-COUNT windows; a closed window below
  ``guard`` x the baseline steps the metric's ok <-> regressed state,
  edge-triggered, announced outside the watchdog lock as a
  ``perf.regression`` span and a ``("perf", "regression")`` flight note
  (the ``perf-regression`` incident trigger, whose bundle embeds both
  ledgers; ``obs/incident.py``).

The watchdog's anchor. A baseline is a measurement of the hardware the
engine runs on. The loaders (:func:`parse_bench_record`,
:func:`load_baseline`, :func:`latest_bench_baseline`) keep the TPU
package's semantics so that records parse alike in both packages, but
the ``BENCH_r*.json`` records of this repository were taken on a TPU and
are no yardstick for a card: no path of the port calls
:func:`latest_bench_baseline`, and a watchdog on the card is anchored
only on a baseline measured on that card (``chip_smoke.py``'s phase
``slo`` measures the engine's encode GiB/s over fault-free windows and
anchors a second plane on it). Without a baseline the watchdog is
``None``: profiling without judging.

Timings on the card. The engine's ``dispatch_s`` runs from the batch's
start to its completion (the batch is synchronized before its futures
resolve); the stream's ``h2d_s`` and ``dispatch_s`` are taken when the
batch's completion event is reached, not when its copy and kernels were
enqueued (serve/stream.py). So a GiB/s here is bytes over time until
done.

Zero-cost when off: this module installs no hook; the feeds gate on one
attribute load and a ``None`` check. Determinism: no clock and no
entropy here; every timing is measured by the caller and passed in, and
the host timings ride snapshots for people but stay out of
:meth:`ProfilePlane.witness`, so two same-seed replays whose timings
stay on the same side of the guard give byte-equal witnesses.
"""
from __future__ import annotations

import collections
import glob
import json
import os
import re
import threading

from . import flight as _flight
from . import trace as _trace

_GIB = float(1 << 30)

STATES = ("ok", "regressed")

#: engine request class -> the bench metric its throughput is judged
#: against. The stream driver reports under the pseudo-class
#: ``stream``; everything unlisted is profiled but not watched.
TRACKED_DEFAULT = {
    "encode": "rs_4p8_encode_GiBps_per_chip",
    "stream": "stream_encode_tag_GiBps",
}

_ROUND_RE = re.compile(r"BENCH_r0*(\d+)\.json$")


# -- baseline loading --------------------------------------------------------

def _rows_of(text: str) -> dict:
    """``{metric: value}`` from bench.py JSONL output (one JSON object
    per line; non-JSON lines and rows without a finite value skipped —
    a truncated tail must not wedge the watchdog)."""
    out: dict = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln.startswith("{"):
            continue
        try:
            row = json.loads(ln)
        except ValueError:
            continue
        if not isinstance(row, dict) or "metric" not in row:
            continue
        try:
            val = float(row.get("value"))
        except (TypeError, ValueError):
            continue
        if val == val:                          # NaN never baselines
            out[str(row["metric"])] = val
    return out


def parse_bench_record(path: str) -> dict:
    """``{metric: value}`` from one bench record — either the round
    wrapper ``{"n":..,"cmd":..,"rc":..,"tail": "<JSONL>"}`` the repo
    checks in as ``BENCH_r*.json``, or raw bench.py JSONL."""
    with open(path) as f:
        text = f.read()
    try:
        payload = json.loads(text)
    except ValueError:
        payload = None
    if isinstance(payload, dict) and isinstance(payload.get("tail"), str):
        return _rows_of(payload["tail"])
    return _rows_of(text)


def load_baseline(path: str) -> dict:
    """``{metric: value}`` from a baseline artifact, the TPU package's
    ``bench_diff --baseline-out`` form (``{"source":.., "round":..,
    "metrics": {m: {"value": v, ...}}}``). Raises ValueError when the file is not one."""
    with open(path) as f:
        payload = json.load(f)
    metrics = payload.get("metrics") if isinstance(payload, dict) else None
    if not isinstance(metrics, dict):
        raise ValueError(f"{path}: not a bench baseline artifact")
    out: dict = {}
    for name in sorted(metrics):
        entry = metrics[name]
        val = entry.get("value") if isinstance(entry, dict) else entry
        out[str(name)] = float(val)
    return out


def latest_bench_baseline(root: str = ".") -> dict:
    """``{metric: value}`` from the newest-round ``BENCH_r*.json``
    under ``root`` (the watchdog's default anchor). ``{}`` when the
    directory holds no bench records — an unanchored watchdog stays
    inert rather than guessing."""
    best, best_rnd = None, -1
    for path in glob.glob(os.path.join(root, "BENCH_r*.json")):
        m = _ROUND_RE.search(os.path.basename(path))
        if m and int(m.group(1)) > best_rnd:
            best_rnd, best = int(m.group(1)), path
    return {} if best is None else parse_bench_record(best)


# -- stage-level accounting --------------------------------------------------

def _new_account() -> dict:
    return {"batches": 0, "requests": 0, "rows": 0, "padded_rows": 0,
            "bytes": 0, "queue_s": 0.0, "h2d_s": 0.0, "dispatch_s": 0.0,
            "sync_s": 0.0}


class OpProfiler:
    """Per-(class, bucket-shape, device) dispatch accounting.

    One account per distinct (request class, bucket row count, device
    lane) triple: batch/request/row/byte counters plus the host-side
    stage breakdown the caller measured (queue-wait, h2d copy,
    dispatch, sync). A per-class deque of the last ``window``
    (bytes, busy-seconds) observations backs the windowed-throughput
    gauge. Counters are replay-deterministic and form the ops third
    of the witness; the ``*_s`` stage sums are host timings and stay
    out of it.
    """

    def __init__(self, *, window: int = 8):
        if window < 1:
            raise ValueError("window must be >= 1")
        self._mu = threading.Lock()
        self._window = window
        self._seq = 0
        self._accounts: dict = {}       # (cls, bucket, device) -> account
        self._recent: dict = {}         # cls -> deque[(bytes, busy_s)]

    def observe(self, cls: str, bucket: int, device: int, *,
                rows: int = 0, padded: int = 0, requests: int = 0,
                nbytes: int = 0, queue_s: float = 0.0,
                h2d_s: float = 0.0, dispatch_s: float = 0.0,
                sync_s: float = 0.0) -> int:
        """Record one dispatch; returns the observation sequence
        number. All timings were measured by the caller."""
        key = (str(cls), int(bucket), int(device))
        with self._mu:
            self._seq += 1
            acct = self._accounts.get(key)
            if acct is None:
                acct = self._accounts[key] = _new_account()
            acct["batches"] += 1
            acct["requests"] += int(requests)
            acct["rows"] += int(rows)
            acct["padded_rows"] += int(padded)
            acct["bytes"] += int(nbytes)
            acct["queue_s"] += float(queue_s)
            acct["h2d_s"] += float(h2d_s)
            acct["dispatch_s"] += float(dispatch_s)
            acct["sync_s"] += float(sync_s)
            recent = self._recent.get(key[0])
            if recent is None:
                recent = self._recent[key[0]] = collections.deque(
                    maxlen=self._window)
            recent.append((int(nbytes),
                           float(h2d_s) + float(dispatch_s)
                           + float(sync_s)))
            return self._seq

    def observations(self) -> int:
        with self._mu:
            return self._seq

    def windowed_gibps(self) -> dict:
        """``{cls: GiB/s over the last window}`` (None while a class's
        busy time is still zero) — the live gauge, not the witness."""
        with self._mu:
            out = {}
            for cls in sorted(self._recent):
                nbytes = sum(b for b, _ in self._recent[cls])
                busy = sum(s for _, s in self._recent[cls])
                out[cls] = None if busy <= 0.0 \
                    else round(nbytes / _GIB / busy, 6)
            return out

    def snapshot(self) -> dict:
        with self._mu:
            accounts = []
            for key in sorted(self._accounts):
                cls, bucket, device = key
                acct = self._accounts[key]
                entry = {"cls": cls, "bucket": bucket, "device": device}
                for field in ("batches", "requests", "rows",
                              "padded_rows", "bytes"):
                    entry[field] = acct[field]
                for field in ("queue_s", "h2d_s", "dispatch_s",
                              "sync_s"):
                    entry[field] = round(acct[field], 6)
                accounts.append(entry)
            snap = {"observations": self._seq, "window": self._window,
                    "accounts": accounts}
        snap["windowed_GiBps"] = self.windowed_gibps()
        return snap

    def canon(self) -> dict:
        """Replay-deterministic view: counters only, every host
        timing excluded."""
        with self._mu:
            return {
                "observations": self._seq,
                "accounts": {
                    f"{cls}|{bucket}|d{device}": {
                        field: self._accounts[(cls, bucket, device)][field]
                        for field in ("batches", "requests", "rows",
                                      "padded_rows", "bytes")}
                    for cls, bucket, device in sorted(self._accounts)},
            }


class PadLedger:
    """Ranked padded-row accounts per class×bucket, split by source.

    The engine's bucket coalescing (``engine``) and the stream
    driver's ragged tails (``stream``) feed the SAME ledger, so
    ``total()`` is the end-to-end pad bill. Fully count-based —
    the ledger is entirely inside the witness.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._accounts: dict = {}       # (cls, bucket) -> account

    def add(self, cls: str, bucket: int, served: int, padded: int, *,
            source: str = "engine") -> None:
        key = (str(cls), int(bucket))
        with self._mu:
            acct = self._accounts.get(key)
            if acct is None:
                acct = self._accounts[key] = {
                    "batches": 0, "served": 0, "padded": 0,
                    "sources": {}}
            acct["batches"] += 1
            acct["served"] += int(served)
            acct["padded"] += int(padded)
            src = str(source)
            acct["sources"][src] = acct["sources"].get(src, 0) \
                + int(padded)

    def ranked(self) -> tuple:
        """((cls, bucket, account), ...) worst pad bill first; ties
        break on the key so the ranking replays bit-identically."""
        with self._mu:
            items = [(cls, bucket, dict(acct, sources=dict(
                acct["sources"])))
                for (cls, bucket), acct in self._accounts.items()]
        items.sort(key=lambda it: (-it[2]["padded"], it[0], it[1]))
        return tuple(items)

    def total(self) -> dict:
        """End-to-end pad bill: served/padded row totals plus the
        per-source padded split."""
        with self._mu:
            out = {"served": 0, "padded": 0, "sources": {}}
            for acct in self._accounts.values():
                out["served"] += acct["served"]
                out["padded"] += acct["padded"]
                for src, n in acct["sources"].items():
                    out["sources"][src] = out["sources"].get(src, 0) + n
            return out

    def snapshot(self) -> dict:
        ranked = self.ranked()
        return {
            "total": self.total(),
            "ranked": [{"cls": cls, "bucket": bucket, **acct}
                       for cls, bucket, acct in ranked],
        }

    def canon(self) -> dict:
        with self._mu:
            return {f"{cls}|{bucket}": {
                "batches": acct["batches"], "served": acct["served"],
                "padded": acct["padded"],
                "sources": dict(sorted(acct["sources"].items()))}
                for (cls, bucket), acct in sorted(self._accounts.items())}


def _keystr(key) -> str:
    """Canonical text for a program-cache key (nested tuples of
    strs/ints/bools/bytes) — stable across replays, JSON-safe."""
    if isinstance(key, (tuple, list)):
        return "(" + ",".join(_keystr(k) for k in key) + ")"
    if isinstance(key, bytes):
        return key.hex()
    if isinstance(key, str):
        return key
    return repr(key)


class CompileLedger:
    """Program-cache compile events: canonicalized shape keys, build
    counts, compile wall time. Build counts replay identically (cache
    behavior is deterministic) and go in the witness; wall times are
    host timings and do not."""

    def __init__(self, *, max_events: int = 256):
        self._mu = threading.Lock()
        self._seq = 0
        self._accounts: dict = {}       # keystr -> {builds, wall_s}
        self._events: collections.deque = collections.deque(
            maxlen=max_events)

    def record(self, key, wall_s: float) -> None:
        ks = _keystr(key)
        with self._mu:
            self._seq += 1
            acct = self._accounts.get(ks)
            if acct is None:
                acct = self._accounts[ks] = {"builds": 0, "wall_s": 0.0}
            acct["builds"] += 1
            acct["wall_s"] += float(wall_s)
            self._events.append((self._seq, ks, round(float(wall_s), 6)))

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "builds": self._seq,
                "programs": {ks: {"builds": acct["builds"],
                                  "wall_s": round(acct["wall_s"], 6)}
                             for ks, acct in sorted(
                                 self._accounts.items())},
                "events": list(self._events),
            }

    def canon(self) -> dict:
        with self._mu:
            return {"builds": self._seq,
                    "programs": {ks: self._accounts[ks]["builds"]
                                 for ks in sorted(self._accounts)}}


# -- the watchdog ------------------------------------------------------------

class PerfWatchdog:
    """Bench-anchored regression watchdog.

    Per tracked metric, (bytes, busy-seconds) accumulate over
    observation-COUNT windows; when a window closes, its GiB/s is
    compared against ``guard`` × the bench baseline and the metric's
    ok↔regressed state machine steps EDGE-TRIGGERED — a persistent
    regression yields one transition, not one per window.

    Transitions append ``(seq, metric, from, to, window)`` to a
    bounded deterministic log and announce exactly like FleetBoard's:
    enqueued under the same ``_mu`` hold that recorded them,
    delivered FIFO under ``_announce_mu`` OUTSIDE the watchdog lock —
    a ``perf.regression`` span on the armed tracer, a ``("perf",
    "regression")`` flight note (the ``perf-regression`` incident
    trigger), then listener callbacks. The log carries counts only:
    the measured GiB/s is a host timing and never enters the witness.
    """

    def __init__(self, baseline: dict, *, guard: float = 0.5,
                 window: int = 8, max_transitions: int = 256):
        if not 0.0 < guard <= 1.0:
            raise ValueError("guard must be in (0, 1]")
        if window < 1:
            raise ValueError("window must be >= 1")
        if max_transitions < 1:
            raise ValueError("max_transitions must be >= 1")
        self._mu = threading.Lock()
        self._guard = float(guard)
        self._window = int(window)
        self._baseline = {str(k): float(v)
                          for k, v in sorted(dict(baseline).items())}
        self._seq = 0
        self._acc: dict = {}            # metric -> {n, bytes, secs}
        self._windows: dict = {}        # metric -> closed-window count
        self._state: dict = {}          # metric -> "ok" | "regressed"
        self._last: dict = {}           # metric -> last window GiB/s
        self._regressions = 0
        self._transitions: collections.deque = collections.deque(
            maxlen=max_transitions)
        self._listeners: list = []
        # same serialization contract as FleetBoard: FIFO delivery,
        # whichever thread holds the announce lock drains everything
        self._announce_mu = threading.RLock()
        self._pending_announce: collections.deque = collections.deque()

    def add_listener(self, fn) -> None:
        """Register ``fn(metric, old, new, window)`` — called on
        every transition, outside the watchdog lock."""
        with self._mu:
            self._listeners.append(fn)

    def observe(self, metric: str, nbytes: int, busy_s: float) -> None:
        """Fold one observation into ``metric``'s open window. A
        metric with no baseline is ignored — the watchdog only judges
        what the bench record anchors."""
        metric = str(metric)
        base = self._baseline.get(metric)
        if base is None:
            return
        fired = False
        with self._mu:
            self._seq += 1
            acc = self._acc.get(metric)
            if acc is None:
                acc = self._acc[metric] = {"n": 0, "bytes": 0,
                                           "secs": 0.0}
            acc["n"] += 1
            acc["bytes"] += int(nbytes)
            acc["secs"] += float(busy_s)
            if acc["n"] < self._window:
                return
            widx = self._windows[metric] = \
                self._windows.get(metric, 0) + 1
            value = None if acc["secs"] <= 0.0 \
                else acc["bytes"] / _GIB / acc["secs"]
            self._acc[metric] = {"n": 0, "bytes": 0, "secs": 0.0}
            self._last[metric] = value
            # zero busy time means the device never blocked: that is
            # "fast", not a regression
            new = "regressed" if value is not None \
                and value < self._guard * base else "ok"
            old = self._state.get(metric, "ok")
            if new != old:
                self._state[metric] = new
                if new == "regressed":
                    self._regressions += 1
                self._transitions.append(
                    (self._seq, metric, old, new, widx))
                self._pending_announce.append((metric, old, new, widx))
                fired = True
        if fired:
            self._drain_announcements()

    def _drain_announcements(self) -> None:
        with self._announce_mu:
            while True:
                with self._mu:
                    if not self._pending_announce:
                        return
                    item = self._pending_announce.popleft()
                self._announce(*item)

    def _announce(self, metric: str, old: str, new: str,
                  widx: int) -> None:
        # observable like a board transition: a span on the
        # armed tracer (WHEN throughput collapsed, relative to faults
        # and breaker trips), a journal note (window index is
        # count-sequenced, so it is replay-canonical), a callback
        with _trace.span("perf.regression", sys="perf", metric=metric,
                         frm=old, to=new, window=widx):
            pass
        _flight.note("perf", "regression", metric=metric, frm=old,
                     to=new, window=widx)
        with self._mu:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(metric, old, new, widx)

    # -- introspection -------------------------------------------------------
    def state(self, metric: str) -> str:
        with self._mu:
            return self._state.get(str(metric), "ok")

    def regressed(self) -> bool:
        with self._mu:
            return any(s == "regressed" for s in self._state.values())

    def transition_log(self) -> tuple:
        """(seq, metric, from, to, window) per transition, in firing
        order — the watchdog's share of the replay witness."""
        with self._mu:
            return tuple(self._transitions)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "guard": self._guard,
                "window": self._window,
                "observations": self._seq,
                "baseline": dict(self._baseline),
                "states": {m: self._state.get(m, "ok")
                           for m in sorted(self._baseline)},
                "windows": dict(sorted(self._windows.items())),
                "last_GiBps": {m: None if v is None else round(v, 6)
                               for m, v in sorted(self._last.items())},
                "regressions": self._regressions,
                "transitions": list(self._transitions),
            }

    def canon(self) -> dict:
        with self._mu:
            return {"observations": self._seq,
                    "windows": dict(sorted(self._windows.items())),
                    "transitions": list(self._transitions)}


# -- composition -------------------------------------------------------------

class ProfilePlane:
    """Everything above behind one seam.

    ``make_engine(..., profile=ProfilePlane(...))`` arms it: the
    engine feeds :meth:`on_batch` from ``_account_batch``, the stream
    driver feeds :meth:`on_stream`, the program cache feeds
    :meth:`compile_event`. Without a ``baseline`` the watchdog is
    None — profiling without judging is valid (a simulated world has no
    hardware to hold to a bench number).
    """

    def __init__(self, *, baseline: dict | None = None,
                 guard: float = 0.5, window: int = 8,
                 tracked: dict | None = None):
        self.ops = OpProfiler(window=window)
        self.pads = PadLedger()
        self.compiles = CompileLedger()
        self.tracked = dict(TRACKED_DEFAULT if tracked is None
                            else tracked)
        self.watchdog = None if not baseline else PerfWatchdog(
            baseline, guard=guard, window=window)

    # -- feeds (each a single seam the serve layer None-checks) --------------
    def on_batch(self, cls: str, bucket: int, device: int, *,
                 rows: int, padded: int, requests: int = 1,
                 nbytes: int = 0, queue_s: float = 0.0,
                 dispatch_s: float = 0.0, sync_s: float = 0.0) -> None:
        """One engine dispatch: ``bucket`` is the padded device row
        count, ``rows`` the real rows served, timings measured by the
        engine."""
        cls = str(cls)
        self.ops.observe(cls, bucket, device, rows=rows, padded=padded,
                         requests=requests, nbytes=nbytes,
                         queue_s=queue_s, dispatch_s=dispatch_s,
                         sync_s=sync_s)
        self.pads.add(cls, bucket, rows, padded, source="engine")
        wd = self.watchdog
        if wd is not None:
            metric = self.tracked.get(cls)
            if metric is not None:
                wd.observe(metric, nbytes, dispatch_s + sync_s)

    def on_stream(self, *, batch: int, rows: int, nbytes: int = 0,
                  device: int = 0, h2d_s: float = 0.0,
                  dispatch_s: float = 0.0) -> None:
        """One StreamingIngest drive step: ``batch`` segments
        submitted of which ``rows`` are real (the rest is the ragged
        tail's padding) — the stream side of the unified pad bill."""
        padded = max(int(batch) - int(rows), 0)
        self.ops.observe("stream", batch, device, rows=rows,
                         padded=padded, requests=1, nbytes=nbytes,
                         h2d_s=h2d_s, dispatch_s=dispatch_s)
        self.pads.add("stream", batch, rows, padded, source="stream")
        wd = self.watchdog
        if wd is not None:
            metric = self.tracked.get("stream")
            if metric is not None:
                wd.observe(metric, nbytes, h2d_s + dispatch_s)

    def compile_event(self, key, wall_s: float) -> None:
        """One program-cache build (a cache MISS — hits never get
        here); ``wall_s`` measured by the cache."""
        self.compiles.record(key, wall_s)

    # -- surfaces ------------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``cess_profileDump`` payload: everything, host timings
        included (they are for humans; the witness excludes them)."""
        wd = self.watchdog
        return {
            "ops": self.ops.snapshot(),
            "pads": self.pads.snapshot(),
            "compiles": self.compiles.snapshot(),
            "tracked": dict(sorted(self.tracked.items())),
            "watchdog": None if wd is None else wd.snapshot(),
        }

    def ledgers(self) -> dict:
        """The two ledgers an incident bundle embeds."""
        return {"pads": self.pads.snapshot(),
                "compiles": self.compiles.snapshot()}

    def metrics(self) -> dict:
        """Flat ``cess_profile_*`` gauges for GET /metrics."""
        pads = self.pads.total()
        compiles = self.compiles.canon()
        out = {
            "cess_profile_observations": self.ops.observations(),
            "cess_profile_served_rows_total": pads["served"],
            "cess_profile_pad_rows_total": pads["padded"],
            "cess_profile_compile_builds": compiles["builds"],
        }
        for src in sorted(pads["sources"]):
            out[f"cess_profile_pad_rows_{src}"] = pads["sources"][src]
        wd = self.watchdog
        out["cess_profile_watchdog_armed"] = 0 if wd is None else 1
        if wd is not None:
            snap = wd.snapshot()
            out["cess_profile_regressions_total"] = snap["regressions"]
            out["cess_profile_regressed"] = sum(
                1 for s in snap["states"].values() if s == "regressed")
        return out

    def witness(self) -> bytes:
        """Canonical bytes of the replay-deterministic view: counter
        accounts, the full pad ledger, compile build counts and the
        watchdog transition log — every host timing excluded. Two
        same-seed runs must agree byte-for-byte."""
        wd = self.watchdog
        canon = {
            "ops": self.ops.canon(),
            "pads": self.pads.canon(),
            "compiles": self.compiles.canon(),
            "watchdog": None if wd is None else wd.canon(),
        }
        return json.dumps(canon, sort_keys=True,
                          separators=(",", ":")).encode()
