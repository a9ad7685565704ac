"""SLO monitors and per-tenant accounting over the engine's observations.

The port's own copy of ``cess_tpu/obs/slo.py``: the same targets, burn
rates, windows, state machine, tenant cap and exposition families, so the
same observation sequence gives equal transition logs, snapshots, series
and tenant histograms in both packages. A :class:`SloBoard` holds
declarative :class:`SloTarget` objectives (op class -> p99 latency bound
and error-rate budget) and evaluates them over rolling windows of the
engine's resolved requests with multi-window burn-rate detection (a fast
window that confirms the problem is happening now, a slow window that
confirms it is significant), plus per-tenant x per-class accounting that
the engine's weighted-fair drain (serve/engine.py) and the admission
controller (serve/adaptive.py) act on.

- **Deterministic**: windows advance on OBSERVATION COUNT, never on a
  clock: a class is (re)evaluated every ``eval_every``-th observation,
  so two replays of one workload under one seeded FaultPlan give the
  same transition log.
- **Zero-cost when off**: nothing here is consulted unless an engine
  was built with a board (``make_engine(slo=...)``); the disabled engine
  path is one attribute load and a ``None`` check and allocates no SLO
  or tenant object.
- **Bounded**: tenant cardinality is capped (``max_tenants``; overflow
  aggregates under ``~other``) and the transition log is a bounded deque.

Burn rate: an observation *breaches* its target when it failed or
exceeded the p99 bound. The error budget is ``0.01 + error_rate`` (a p99
objective concedes 1% above the bound; ``error_rate`` concedes outright
failures on top), and ``burn = breach_fraction / budget`` over a window.
**burning** when the fast-window burn clears ``page_burn`` AND the slow
window confirms (>= ``warn_burn``); **warn** when the slow window alone
burns >= ``warn_burn``; **ok** otherwise.

Every transition is announced outside the board lock, in log order: a
``slo.transition`` span on the armed tracer, a ``("slo", "transition")``
note in the flight journal (``obs/flight.py``; ok -> burning is an
incident trigger, ``obs/incident.py``) and a callback to the registered
listeners, the admission controller's seam.

On the card the latencies the engine feeds are submit to completion: an
engine batch is synchronized before its futures resolve, and a stream
batch is observed when its completion event is reached
(serve/stream.py).

Exposition: :meth:`SloBoard.series` yields labeled families
(``cess_slo_*`` gauges with a ``class`` label, ``state`` in the enum
pattern, and ``cess_tenant_*_total`` counters labeled
``tenant``/``class``); :meth:`tenant_histograms` the per-tenant latency
histograms.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

from . import flight as _flight
from . import prom
from . import trace as _trace

STATES = ("ok", "warn", "burning")

# the tenant bucket unattributed requests land in, and the overflow
# bucket once max_tenants distinct names have been seen ("~" sorts
# after every printable tenant name and cannot collide with an
# account id in this codebase)
UNTAGGED = "-"
OVERFLOW = "~other"


@dataclasses.dataclass(frozen=True)
class SloTarget:
    """One objective: requests of op class ``cls`` should complete
    within ``p99_s`` seconds at the 99th percentile, with at most
    ``error_rate`` of them failing outright."""

    cls: str
    p99_s: float
    error_rate: float = 0.0

    def __post_init__(self):
        if not self.cls:
            raise ValueError("SloTarget needs an op class")
        if not self.p99_s > 0:
            raise ValueError(f"p99 objective must be > 0, got "
                             f"{self.p99_s!r}")
        if not 0 <= self.error_rate < 1:
            raise ValueError(f"error-rate objective must be in [0, 1), "
                             f"got {self.error_rate!r}")

    @property
    def budget(self) -> float:
        """Tolerated breach fraction: the 1% the p99 bound concedes by
        definition, plus the explicit failure allowance."""
        return 0.01 + self.error_rate


def _seconds(text: str) -> float:
    text = text.strip().lower()
    if text.endswith("ms"):
        return float(text[:-2]) / 1000.0
    if text.endswith("s"):
        return float(text[:-1])
    return float(text)


def _fraction(text: str) -> float:
    text = text.strip()
    if text.endswith("%"):
        return float(text[:-1]) / 100.0
    return float(text)


def parse_targets(spec: str) -> tuple[SloTarget, ...]:
    """The ``--slo`` CLI syntax: ``;``-separated targets, each
    ``<class>:p99=<dur>[,err=<frac>]`` where durations take an ``ms``
    or ``s`` suffix (bare numbers are seconds) and error rates take a
    ``%`` suffix (bare numbers are fractions).

        verify:p99=50ms,err=1%;encode:p99=2s

    An empty spec yields :data:`DEFAULT_TARGETS`.
    """
    spec = spec.strip()
    if not spec:
        return DEFAULT_TARGETS
    out = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        cls, sep, body = entry.partition(":")
        if not sep or not body:
            raise ValueError(f"bad SLO target {entry!r}: expected "
                             "<class>:p99=<duration>[,err=<rate>]")
        p99 = None
        err = 0.0
        for kv in body.split(","):
            key, sep, val = kv.partition("=")
            key = key.strip()
            if not sep:
                raise ValueError(f"bad SLO parameter {kv!r} in {entry!r}")
            if key == "p99":
                p99 = _seconds(val)
            elif key == "err":
                err = _fraction(val)
            else:
                raise ValueError(f"unknown SLO parameter {key!r} in "
                                 f"{entry!r} (p99/err)")
        if p99 is None:
            raise ValueError(f"SLO target {entry!r} needs p99=<duration>")
        out.append(SloTarget(cls.strip(), p99, err))
    return tuple(out)


# the --slo defaults: protect the audit-critical verify class tightly
# (a missed verify window slashes a miner), give proving the same
# round deadline pressure, and let bulk encode ride a loose bound
DEFAULT_TARGETS = (
    SloTarget("verify", p99_s=0.050, error_rate=0.01),
    SloTarget("prove", p99_s=0.100, error_rate=0.01),
    SloTarget("encode", p99_s=1.000, error_rate=0.05),
)


class _TenantStats:
    """Per (tenant, class) accounting: request/failure/shed counters,
    SERVED device rows (failed/expired work never counts), and the
    mergeable latency histogram."""

    __slots__ = ("requests", "failed", "shed", "rows", "hist")

    def __init__(self):
        self.requests = 0
        self.failed = 0
        self.shed = 0
        self.rows = 0
        self.hist = prom.Histogram(prom.LATENCY_BUCKETS_S)


class _TargetState:
    """Rolling-window burn-rate state for one target (board-lock
    guarded, like every mutable field on the board)."""

    __slots__ = ("target", "fast", "slow", "count", "state",
                 "fast_burn", "slow_burn")

    def __init__(self, target: SloTarget, fast_window: int,
                 slow_window: int):
        self.target = target
        self.fast: collections.deque = collections.deque(
            maxlen=fast_window)
        self.slow: collections.deque = collections.deque(
            maxlen=slow_window)
        self.count = 0               # observations ever (eval clock)
        self.state = "ok"
        self.fast_burn = 0.0
        self.slow_burn = 0.0


def _burn(window, budget: float) -> float:
    if not window:
        return 0.0
    return (sum(window) / len(window)) / budget


class SloBoard:
    """See module doc. One board per engine (``make_engine(slo=...)``);
    observations arrive from the engine batcher/submitter threads and
    scrapes read concurrently, so every mutable field is guarded by
    the one internal lock. Listener callbacks and transition spans
    fire OUTSIDE the lock (they touch other subsystems' locks — the
    health breaker — and must never nest under this one)."""

    def __init__(self, targets=DEFAULT_TARGETS, *, fast_window: int = 32,
                 slow_window: int = 256, eval_every: int = 8,
                 warn_burn: float = 1.0, page_burn: float = 6.0,
                 max_tenants: int = 64, max_transitions: int = 256):
        if fast_window < 1 or slow_window < fast_window \
                or eval_every < 1 or max_tenants < 1:
            raise ValueError("invalid SLO board bounds")
        if not 0 < warn_burn <= page_burn:
            raise ValueError(f"need 0 < warn_burn <= page_burn, got "
                             f"{warn_burn}/{page_burn}")
        targets = tuple(targets)
        if len({t.cls for t in targets}) != len(targets):
            raise ValueError("duplicate SLO target class")
        self.fast_window = fast_window
        self.slow_window = slow_window
        self.eval_every = eval_every
        self.warn_burn = warn_burn
        self.page_burn = page_burn
        self.max_tenants = max_tenants
        self._mu = threading.Lock()
        self._states = {t.cls: _TargetState(t, fast_window, slow_window)
                        for t in targets}
        self._tenants: dict[tuple[str, str], _TenantStats] = {}
        self._tenant_names: set[str] = set()
        self._transitions: collections.deque = collections.deque(
            maxlen=max_transitions)
        self._transitions_total: dict[str, int] = {t.cls: 0
                                                   for t in targets}
        self._listeners: list = []
        # announcement serialization: transitions are ENQUEUED under
        # the same _mu hold that recorded them and DELIVERED under
        # this lock, FIFO — with concurrent observers (two stream
        # threads feeding one class), per-thread delivery could
        # otherwise reorder ok->burning after burning->ok and leave a
        # listener (the admission controller) engaged forever against
        # a board that reads ok. RLock: a listener that re-enters
        # observe() must not self-deadlock.
        self._announce_mu = threading.RLock()
        self._pending_announce: collections.deque = collections.deque()

    @property
    def targets(self) -> tuple[SloTarget, ...]:
        return tuple(st.target for st in self._states.values())

    def add_listener(self, fn) -> None:
        """Register ``fn(cls, old_state, new_state)`` — called on every
        state transition, outside the board lock, on the observing
        thread (the engine batcher in practice)."""
        with self._mu:
            self._listeners.append(fn)

    # -- recording -----------------------------------------------------------
    def observe(self, cls: str, latency_s: float, ok: bool = True,
                tenant: str | None = None, rows: int = 0) -> None:
        """One completed (or failed / timed-out) request: feeds the
        class's SLO windows and the tenant's accounting. The one hook
        the engine calls per resolved request."""
        fired = False
        with self._mu:
            ts = self._tenant_locked(tenant, cls)
            ts.requests += 1
            if ok:
                # SERVED device rows only — the same semantics as the
                # engine's fair-drain deficit counters, so per-tenant
                # throughput/billing never over-counts work that
                # failed or timed out before the device ran it
                ts.rows += rows
            else:
                ts.failed += 1
            ts.hist.observe(latency_s)
            st = self._states.get(cls)
            if st is not None:
                breach = (not ok) or latency_s > st.target.p99_s
                st.fast.append(breach)
                st.slow.append(breach)
                st.count += 1
                if st.count % self.eval_every == 0 \
                        and len(st.slow) >= self.fast_window:
                    ev = self._eval_locked(st)
                    if ev is not None:
                        # enqueue under THIS _mu hold: the log order
                        # and the announce order cannot diverge
                        self._pending_announce.append(ev)
                        fired = True
        if fired:
            self._drain_announcements()

    def _drain_announcements(self) -> None:
        """Deliver queued transitions in transition-log order (spans +
        listeners), outside the board lock. Whichever thread holds the
        announce lock drains EVERYTHING pending, so a descheduled
        observer can never deliver its older transition late."""
        with self._announce_mu:
            while True:
                with self._mu:
                    if not self._pending_announce:
                        return
                    item = self._pending_announce.popleft()
                self._announce(*item)

    def note_shed(self, cls: str, tenant: str | None = None) -> None:
        """A request rejected at admission (serve/adaptive.py): counted
        against the tenant, never against the SLO windows — shed load
        is the mechanism PROTECTING the objective, not a breach of it."""
        with self._mu:
            self._tenant_locked(tenant, cls).shed += 1

    def _tenant_locked(self, tenant: str | None, cls: str) -> _TenantStats:
        name = tenant or UNTAGGED
        if name not in self._tenant_names:
            if len(self._tenant_names) >= self.max_tenants:
                name = OVERFLOW
            self._tenant_names.add(name)
        key = (name, cls)
        ts = self._tenants.get(key)
        if ts is None:
            ts = self._tenants[key] = _TenantStats()
        return ts

    # -- evaluation ----------------------------------------------------------
    def _eval_locked(self, st: _TargetState):
        budget = st.target.budget
        st.fast_burn = _burn(st.fast, budget)
        st.slow_burn = _burn(st.slow, budget)
        if st.fast_burn >= self.page_burn \
                and st.slow_burn >= self.warn_burn:
            new = "burning"
        elif st.slow_burn >= self.warn_burn:
            new = "warn"
        else:
            new = "ok"
        if new == st.state:
            return None
        old, st.state = st.state, new
        self._transitions.append((st.target.cls, old, new, st.count))
        self._transitions_total[st.target.cls] += 1
        return (st.target.cls, old, new, st.fast_burn)

    def _announce(self, cls: str, old: str, new: str,
                  burn: float) -> None:
        # the transition is itself observable: a span on the armed
        # tracer (so a chaos drill's trace shows WHEN the SLO flipped
        # relative to the faults and the admission response) ...
        with _trace.span("slo.transition", sys="slo", cls=cls,
                         frm=old, to=new, burn=round(burn, 3)):
            pass
        # ... a black-box journal entry (ok->burning is an incident
        # trigger; burn is window-timing shaped, so it stays out of
        # the replay-canonical detail) ...
        _flight.note("slo", "transition", cls=cls, frm=old, to=new)
        # ... and a callback — the admission controller's seam
        with self._mu:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(cls, old, new)

    # -- introspection -------------------------------------------------------
    def state(self, cls: str) -> str:
        with self._mu:
            st = self._states.get(cls)
            return "ok" if st is None else st.state

    def burning(self) -> bool:
        with self._mu:
            return any(st.state == "burning"
                       for st in self._states.values())

    def transition_log(self) -> tuple:
        """(cls, from, to, observation_count) per transition, in firing
        order — the replay-determinism witness (the fired_log analog of
        resilience/faults.py)."""
        with self._mu:
            return tuple(self._transitions)

    def snapshot(self) -> dict:
        """JSON-shaped dump of targets, tenants and transitions."""
        with self._mu:
            targets = {}
            for cls, st in self._states.items():
                t = st.target
                targets[cls] = {
                    "p99_s": t.p99_s,
                    "error_rate": t.error_rate,
                    "state": st.state,
                    "fast_burn": round(st.fast_burn, 4),
                    "slow_burn": round(st.slow_burn, 4),
                    "budget_remaining": round(
                        max(0.0, 1.0 - _burn(st.slow, 1.0) / t.budget), 4),
                    "observations": st.count,
                    "transitions": self._transitions_total[cls],
                }
            tenants: dict = {}
            for (name, cls), ts in self._tenants.items():
                tenants.setdefault(name, {})[cls] = {
                    "requests": ts.requests,
                    "failed": ts.failed,
                    "shed": ts.shed,
                    "rows": ts.rows,
                }
            return {"targets": targets, "tenants": tenants,
                    "transitions": list(self._transitions)}

    def series(self) -> list[tuple[str, str, dict, float]]:
        """Labeled exposition series: ``(family, kind, labels, value)``
        tuples, deterministically ordered. ``cess_slo_state`` uses the
        Prometheus enum pattern (one series per state, the active one
        1.0) so dashboards can plot transitions without decoding a
        numeric code."""
        snap = self.snapshot()
        out: list[tuple[str, str, dict, float]] = []
        for cls in sorted(snap["targets"]):
            t = snap["targets"][cls]
            out.append(("cess_slo_budget_remaining", "gauge",
                        {"class": cls}, float(t["budget_remaining"])))
            out.append(("cess_slo_burn_rate", "gauge",
                        {"class": cls}, float(t["fast_burn"])))
            out.append(("cess_slo_slow_burn_rate", "gauge",
                        {"class": cls}, float(t["slow_burn"])))
            for state in STATES:
                out.append(("cess_slo_state", "gauge",
                            {"class": cls, "state": state},
                            1.0 if t["state"] == state else 0.0))
            out.append(("cess_slo_transitions_total", "counter",
                        {"class": cls}, float(t["transitions"])))
        for name in sorted(snap["tenants"]):
            for cls in sorted(snap["tenants"][name]):
                ts = snap["tenants"][name][cls]
                labels = {"tenant": name, "class": cls}
                out.append(("cess_tenant_requests_total", "counter",
                            labels, float(ts["requests"])))
                out.append(("cess_tenant_failed_total", "counter",
                            labels, float(ts["failed"])))
                out.append(("cess_tenant_shed_total", "counter",
                            labels, float(ts["shed"])))
                out.append(("cess_tenant_rows_total", "counter",
                            labels, float(ts["rows"])))
        return out

    def tenant_histograms(self) -> list[tuple[str, dict, prom.Histogram]]:
        """Per-tenant latency histogram families for the exposition:
        ``(family, labels, Histogram)`` — rendering snapshots each one
        consistently (prom.Histogram's own lock), so the board lock is
        only held to list them."""
        with self._mu:
            items = sorted(self._tenants.items())
        return [("cess_tenant_latency_seconds",
                 {"tenant": name, "class": cls}, ts.hist)
                for (name, cls), ts in items]
