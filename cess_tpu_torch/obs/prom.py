"""Prometheus histograms and the text exposition's helpers.

The port's own copy of ``cess_tpu/obs/prom.py``: fixed bucket bounds,
cumulative ``(le, count)`` snapshots, ``_sum`` and ``_count``, an exact
merge of same-bound histograms (the engine sums its attached streams'
histograms into one family) and its inverse of the wire form
(``Histogram.from_cumulative``, what a federator parses back out of
``_bucket{le=...}`` samples); the counter-reset clamp a federator
applies between scrapes (``counter_delta``); and the exposition's
label escaping and histogram rendering, byte for byte the reference's.
Observations come from the batcher and ingest threads while a reader
snapshots, so every access takes the histogram's own lock.
"""
from __future__ import annotations

import bisect
import math
import threading

# engine/stream latency bounds (seconds): sub-ms device dispatches up
# through multi-second backpressure tails
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Fixed-bound histogram: ``observe`` is O(log buckets), snapshots
    are consistent (taken under the lock), same-bound histograms merge."""

    __slots__ = ("bounds", "_counts", "_sum", "_count", "_mu")

    def __init__(self, bounds=LATENCY_BUCKETS_S):
        bs = tuple(float(b) for b in bounds)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])) \
                or not all(math.isfinite(b) for b in bs):
            raise ValueError(f"bucket bounds must be finite and "
                             f"strictly increasing, got {bounds!r}")
        self.bounds = bs
        self._counts = [0] * (len(bs) + 1)   # last = above every bound
        self._sum = 0.0
        self._count = 0
        self._mu = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        # Prometheus le is inclusive: first bound >= value
        i = bisect.bisect_left(self.bounds, value)
        with self._mu:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Add ``other``'s observations into this histogram (bounds
        must match exactly)."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different "
                             f"bounds: {self.bounds} vs {other.bounds}")
        with other._mu:
            counts = list(other._counts)
            total_sum, total_n = other._sum, other._count
        with self._mu:
            for i, n in enumerate(counts):
                self._counts[i] += n
            self._sum += total_sum
            self._count += total_n
        return self

    @property
    def count(self) -> int:
        with self._mu:
            return self._count

    @classmethod
    def from_cumulative(cls, buckets, total_sum: float) -> "Histogram":
        """Rebuild a histogram from its wire form, the CUMULATIVE
        ``[(le_bound, count_le)...]`` list :meth:`snapshot` produces; the
        last entry must be the ``+Inf`` bucket and counts must be
        nondecreasing. Inverse of :meth:`snapshot`, so a federator can
        reuse :meth:`merge` across nodes."""
        pairs = [(float(b), int(n)) for b, n in buckets]
        if len(pairs) < 2 or not math.isinf(pairs[-1][0]):
            raise ValueError("cumulative buckets must end with +Inf")
        if any(n2 < n1 for (_, n1), (_, n2) in zip(pairs, pairs[1:])):
            raise ValueError("cumulative bucket counts must be "
                             "nondecreasing")
        h = cls(tuple(b for b, _ in pairs[:-1]))
        prev = 0
        with h._mu:
            for i, (_, acc) in enumerate(pairs):
                h._counts[i] = acc - prev
                prev = acc
            h._count = pairs[-1][1]
            h._sum = float(total_sum)
        return h

    def quantile(self, q: float) -> float:
        """The q-quantile (0 <= q <= 1) by linear interpolation inside
        the owning bucket, as ``histogram_quantile`` computes it; above
        the last finite bound it clamps to that bound, and an empty
        histogram reports 0.0."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q!r}")
        snap = self.snapshot()
        total = snap["count"]
        if total == 0:
            return 0.0
        target = q * total
        lo, prev_acc = 0.0, 0
        for bound, acc in snap["buckets"]:
            if acc >= target and acc > prev_acc:
                if math.isinf(bound):
                    return lo
                frac = (target - prev_acc) / (acc - prev_acc)
                return lo + (bound - lo) * frac
            if not math.isinf(bound):
                lo = bound
            prev_acc = acc
        return lo

    def snapshot(self) -> dict:
        """``buckets``: the CUMULATIVE ``[(le_bound, count_le)...]`` list
        ending with ``(inf, count)``; ``sum``; ``count``."""
        with self._mu:
            counts = list(self._counts)
            total_sum, total_n = self._sum, self._count
        buckets, acc = [], 0
        for bound, n in zip(self.bounds, counts):
            acc += n
            buckets.append((bound, acc))
        buckets.append((math.inf, acc + counts[-1]))
        return {"buckets": buckets, "sum": total_sum, "count": total_n}


def counter_delta(prev: float, cur: float) -> float:
    """The increment between two scrapes of a MONOTONIC counter, clamped
    for restarts: a counter moves backwards only because its process
    restarted at zero, so the increment since the previous scrape is at
    least ``cur``, never the negative ``cur - prev``."""
    prev, cur = float(prev), float(cur)
    if cur >= prev:
        return cur - prev
    return cur


def format_le(bound: float) -> str:
    """Prometheus ``le`` label value: ``+Inf`` for the overflow bucket,
    shortest exact decimal otherwise."""
    if math.isinf(bound):
        return "+Inf"
    return f"{bound:g}"


def escape_label(value: str) -> str:
    """Exposition-format (0.0.4) label-value escaping: backslash,
    double quote and newline. An unescaped ``"`` in a caller-supplied
    value would truncate the label and corrupt every later sample."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_labels(labels: dict | None) -> str:
    """``{k="v",...}`` with escaped values, sorted by key (a
    deterministic exposition), or ``""`` for an unlabeled sample."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_histogram(name: str, hist: Histogram,
                     labels: dict | None = None,
                     type_line: bool = True) -> list[str]:
    """Text-exposition lines for one histogram family: the TYPE line,
    cumulative buckets, ``_sum`` and ``_count``. ``labels`` ride every
    sample (``le`` merged in on the bucket lines); ``type_line=False``
    skips the TYPE line, which the format allows once a family, for a
    labeled family's later label sets."""
    snap = hist.snapshot()
    base = dict(labels or {})
    lines = [f"# TYPE {name} histogram"] if type_line else []
    for bound, n in snap["buckets"]:
        lines.append(f"{name}_bucket"
                     f"{format_labels({**base, 'le': format_le(bound)})}"
                     f" {n}")
    tail = format_labels(base)
    lines.append(f"{name}_sum{tail} {snap['sum']}")
    lines.append(f"{name}_count{tail} {snap['count']}")
    return lines
