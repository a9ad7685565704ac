"""Adaptive batching knobs and SLO-gated admission for the engine.

The port's own copy of ``cess_tpu/serve/adaptive.py``: the same knob
updates, adjustment log, shed reasons and hold/release sequence, so the
same observations and board transitions give equal logs and snapshots in
both packages.

- :class:`AdaptiveBatchPolicy` owns PER-CLASS batching knobs
  (max_delay / max_batch_requests / max_batch_rows) seeded from the
  static policy and adjusted AIMD-style from the live observations: when
  a class's p99 clears its target with headroom AND its batches run
  under-occupied, the coalescing delay grows; the moment p99 crosses the
  target the delay shrinks multiplicatively. Updates advance on
  observation count, never on a clock, so replayed workloads adapt alike
  given the same latencies. Each change is noted in the flight journal
  as ``("adaptive", "adjust")``.
- :class:`AdmissionController` extends the breaker from "device broken"
  to "SLO at risk": registered as a listener on the SLO board
  (``obs/slo.py``), a *protected* class entering ``burning`` makes it
  (a) SHED the sheddable classes' submits (``EngineShed``, explicit
  backpressure beside ``EngineSaturated``) and (b) latch the codec
  breaker open (``HealthMonitor.hold_open``). Both release when the
  protected class is back at ``ok`` (``warn`` keeps protection).
  Independent of burn state, admission is deadline-aware: a sheddable
  request whose deadline is below its class's live p99 estimate, with a
  backlog queued, is refused at submit instead of timing out in the
  queue. ``attach_fleet`` subscribes to any board with the fleet
  listener signature (``add_listener(fn(cls, view, old, new))``): a
  burning transition of the chosen view engages the same response.

Under a hold the port keeps its engine's rule that a card member is
never computed on the host: the held codec breaker serves the numpy
members of codec batches on the CPU reference (bytes equal to the
card's), and refuses a CUDA-tensor member with ``EngineUnavailable``
without launching a kernel (serve/engine.py). A ``KernelBuildError`` is
never shed, held or degraded.

Both objects are opt-in (``make_engine(slo=..., adaptive=...,
admission=...)``) and cost nothing when absent: the engine's disabled
paths are one attribute load and a ``None`` check.

Lock order: the engine lock may nest over this module's locks (knob
reads from the batcher, admission checks from submitters) and this
module's locks may nest over a HealthMonitor's, never the reverse. The
engine feeds the tuner and the board (and so the controller's listener)
with its own lock released, on the thread that ran the batch and before
the batch's futures resolve, so a submit that follows a resolved
request sees the board that request moved. That thread may hold the
batch's device lock; nothing reached from here waits for one (device
locks are taken only by the batcher, the lanes and ``warm_repair``,
never under the engine lock).
"""
from __future__ import annotations

import collections
import threading

from ..obs import flight as _flight
from .policy import AdmissionPolicy


class AdaptiveBatchPolicy:
    """Per-class batching knobs, latency/occupancy-tuned. See module
    doc.

    policy:        the static AdmissionPolicy supplying seeds + caps.
    board:         optional obs.SloBoard — classes with an SLO target
                   adapt toward (headroom * p99 objective); others
                   stay on the static constants.
    targets:       explicit {cls: p99_seconds} overrides (take
                   precedence over board targets).
    update_every:  observations of a class between knob updates.
    window:        latency/occupancy observations retained per class.
    min_delay_s:   floor the coalescing delay can shrink to.
    delay_cap_s:   ceiling it can grow to (default 8x the static).
    headroom:      fraction of the target the p99 estimate must stay
                   under before the delay may grow.
    occupancy_target: mean batch occupancy below which growing the
                   delay is worthwhile (more coalescing wanted).
    """

    def __init__(self, policy: AdmissionPolicy | None = None, *,
                 board=None, targets: dict | None = None,
                 update_every: int = 16, window: int = 128,
                 min_delay_s: float = 5e-4,
                 delay_cap_s: float | None = None,
                 shrink: float = 0.5, grow: float = 1.25,
                 headroom: float = 0.25, occupancy_target: float = 4.0,
                 min_rows: int = 8, max_adjustments: int = 256):
        if update_every < 1 or window < update_every:
            raise ValueError("invalid adaptive update bounds")
        if not 0 < shrink < 1 or grow <= 1 or not 0 < headroom < 1:
            raise ValueError("invalid adaptive gain bounds")
        self.policy = policy or AdmissionPolicy()
        self.board = board
        self.targets = dict(targets or {})
        self.update_every = update_every
        self.window = window
        self.min_delay_s = min_delay_s
        self.delay_cap_s = delay_cap_s \
            if delay_cap_s is not None else self.policy.max_delay * 8
        self.shrink = shrink
        self.grow = grow
        self.headroom = headroom
        self.occupancy_target = occupancy_target
        self.min_rows = min_rows
        self._mu = threading.Lock()
        self._classes: dict[str, dict] = {}
        self._adjustments: collections.deque = collections.deque(
            maxlen=max_adjustments)

    def target_for(self, cls: str) -> float | None:
        """The p99 objective steering this class, or None (static)."""
        if cls in self.targets:
            return self.targets[cls]
        if self.board is not None:
            for t in self.board.targets:
                if t.cls == cls:
                    return t.p99_s
        return None

    def _state_locked(self, cls: str) -> dict:
        st = self._classes.get(cls)
        if st is None:
            pol = self.policy
            st = self._classes[cls] = {
                "delay": pol.max_delay,
                "reqs": pol.max_batch_requests,
                "rows": pol.max_batch_rows,
                "lats": collections.deque(maxlen=self.window),
                "occs": collections.deque(maxlen=self.window),
                "count": 0,
                "p99": 0.0,
                "adjustments": 0,
            }
        return st

    # -- the engine's read side (batcher thread, under the engine lock) ------
    def knobs(self, cls: str) -> tuple[float, int, int]:
        """(max_delay, max_batch_requests, max_batch_rows) for this
        class right now."""
        with self._mu:
            st = self._state_locked(cls)
            return st["delay"], st["reqs"], st["rows"]

    def p99_est(self, cls: str) -> float:
        """Live p99 estimate from the class's window (0.0 until the
        first update) — the deadline-aware admission signal."""
        with self._mu:
            st = self._classes.get(cls)
            return 0.0 if st is None else st["p99"]

    # -- the engine's write side (batcher thread, outside the lock) ----------
    def note(self, cls: str, latency_s: float, occupancy: int = 1) -> None:
        """One resolved request's submit->resolve latency + its batch
        occupancy; every ``update_every``-th observation of a targeted
        class re-tunes the knobs."""
        adjusted = None
        with self._mu:
            st = self._state_locked(cls)
            st["lats"].append(latency_s)
            st["occs"].append(occupancy)
            st["count"] += 1
            if st["count"] % self.update_every:
                return
            lats = sorted(st["lats"])
            st["p99"] = lats[min(len(lats) - 1,
                                 int(0.99 * len(lats)))]
            target = self.target_for(cls)
            if target is None:
                return
            occ = sum(st["occs"]) / len(st["occs"])
            pol = self.policy
            delay, rows = st["delay"], st["rows"]
            if st["p99"] > target:
                # over target: multiplicative backoff — smaller
                # batches sooner beats fuller batches later
                delay = max(self.min_delay_s, delay * self.shrink)
                rows = max(self.min_rows, rows // 2)
            elif st["p99"] < target * (1.0 - self.headroom) \
                    and occ < self.occupancy_target:
                # comfortable headroom AND under-occupied batches:
                # trade some of the slack for coalescence
                delay = min(self.delay_cap_s, delay * self.grow)
                rows = min(pol.max_batch_rows, rows * 2)
            if (delay, rows) != (st["delay"], st["rows"]):
                st["delay"], st["rows"] = delay, rows
                st["adjustments"] += 1
                adjusted = (cls, st["count"], round(st["p99"], 6),
                            round(delay, 6), rows)
                self._adjustments.append(adjusted)
        if adjusted is not None:
            # journal the knob change OUTSIDE self._mu (listener
            # bundles read snapshot(), which takes it)
            _flight.note("adaptive", "adjust", cls=adjusted[0],
                         count=adjusted[1], p99=adjusted[2],
                         delay=adjusted[3], rows=adjusted[4])

    # -- introspection -------------------------------------------------------
    def adjustment_log(self) -> tuple:
        """(cls, observation_count, p99_est, new_delay, new_rows) per
        knob change, newest ``max_adjustments`` kept."""
        with self._mu:
            return tuple(self._adjustments)

    def snapshot(self) -> dict:
        with self._mu:
            out = {}
            for cls, st in self._classes.items():
                out[cls] = {
                    "delay_s": round(st["delay"], 6),
                    "max_batch_requests": st["reqs"],
                    "max_batch_rows": st["rows"],
                    "p99_est_s": round(st["p99"], 6),
                    "target_s": self.target_for(cls),
                    "observations": st["count"],
                    "adjustments": st["adjustments"],
                }
            return out

    def metrics(self) -> dict[str, float]:
        """Flat gauges merged into the cess_engine_* exposition."""
        out = {}
        for cls, st in self.snapshot().items():
            out[f"cess_adaptive_{cls}_delay_s"] = float(st["delay_s"])
            out[f"cess_adaptive_{cls}_max_batch_rows"] = \
                float(st["max_batch_rows"])
            out[f"cess_adaptive_{cls}_p99_est_s"] = \
                float(st["p99_est_s"])
            out[f"cess_adaptive_{cls}_adjustments_total"] = \
                float(st["adjustments"])
        return out


class AdmissionController:
    """SLO-gated, deadline-aware admission. See module doc.

    board:    the obs.SloBoard whose transitions drive protection.
    adaptive: optional AdaptiveBatchPolicy supplying the live p99
              estimate for the deadline check.
    protect:  classes whose ``burning`` state engages protection.
    shed:     classes rejected (EngineShed) while protection is
              engaged — bulk load the protected classes outrank.
    degrade:  latch the engine's codec breaker open while engaged
              (surviving sheddable batches serve on the bit-identical
              CPU reference), when the engine has one (resilience
              configured); shed-only otherwise.
    """

    def __init__(self, board, adaptive: AdaptiveBatchPolicy | None = None,
                 *, protect: tuple = ("verify",),
                 shed: tuple = ("encode",), degrade: bool = True):
        self.board = board
        self.adaptive = adaptive
        self.protect = tuple(protect)
        self.shed = tuple(shed)
        self.degrade = degrade
        self._mu = threading.Lock()
        self._burning: set[str] = set()
        self._engaged = False
        self._monitors: list = []
        self._holds = 0
        self._releases = 0
        self._sheds: dict[str, dict[str, int]] = {}
        self._fleet_view: str | None = None
        board.add_listener(self._on_transition)

    def attach_fleet(self, fleet_board, *, view: str = "quorum") -> None:
        """Extend protection fleet-wide: subscribe to a fleet board (any
        object with ``add_listener(fn(cls, view, old, new))``, as
        ``obs.fleet.FleetBoard``) so a ``burning``
        transition of the chosen
        global view (``quorum`` by default — a strict majority of nodes
        burning; ``worst`` for any single node) on a protected class
        engages the same shed/degrade response as a local transition.
        Fleet triggers are tracked as ``fleet:<cls>`` keys alongside the
        local ones, so protection releases only when BOTH the local
        board and the fleet view have recovered to ``ok``."""
        self._fleet_view = view
        fleet_board.add_listener(self._on_fleet_transition)

    def bind(self, engine) -> None:
        """Attach to an engine: grab the breakers the degrade response
        latches (the codec backend gates the sheddable bulk classes).
        Called by the engine constructor."""
        mon = engine.monitors.get("codec")
        self._monitors = [mon] if (self.degrade and mon is not None) \
            else []

    # -- the SLO board's listener seam ---------------------------------------
    def _on_transition(self, cls: str, old: str, new: str) -> None:
        if cls not in self.protect:
            return
        self._apply(cls, new, f"slo:{cls}")

    # -- the fleet board's listener seam (attach_fleet) ----------------------
    def _on_fleet_transition(self, cls: str, view: str, old: str,
                             new: str) -> None:
        if view != self._fleet_view or cls not in self.protect:
            return
        self._apply(f"fleet:{cls}", new, f"fleet:{cls}")

    def _apply(self, key: str, new: str, hold_reason: str) -> None:
        engage = release = False
        with self._mu:
            if new == "burning":
                self._burning.add(key)
                if not self._engaged:
                    self._engaged = engage = True
                    self._holds += 1
            elif new == "ok":
                self._burning.discard(key)
                if self._engaged and not self._burning:
                    self._engaged = False
                    release = True
                    self._releases += 1
        # breaker calls OUTSIDE this lock (lock order: controller ->
        # monitor, and never while more than one is held)
        if engage:
            for mon in self._monitors:
                mon.hold_open(hold_reason)
        if release:
            for mon in self._monitors:
                mon.release()

    # -- the engine's submit seam --------------------------------------------
    def admit(self, cls: str, timeout_s: float | None,
              tenant: str | None = None,
              queued: "int | None" = None) -> str | None:
        """None to admit, or the shed reason. Consulted by the engine
        before a sheddable request is queued. ``queued`` is the
        class's current backlog depth (None = unknown: assume one)."""
        if cls not in self.shed:
            return None
        reason = None
        with self._mu:
            if self._engaged:
                reason = "slo-burning"
        if reason is None and self.adaptive is not None \
                and timeout_s is not None \
                and (queued is None or queued > 0):
            # deadline-aware: the class's live p99 already exceeds
            # this request's whole budget — queueing it only converts
            # a fast rejection into a slow EngineTimeout. Only with a
            # BACKLOG, though: p99_est is refreshed by served requests
            # alone, so shedding on an idle class would let a stale
            # spike estimate reject everything forever (the served
            # request is also what ages the estimate back down)
            est = self.adaptive.p99_est(cls)
            if est > timeout_s:
                reason = "deadline-unmeetable"
        if reason is not None:
            with self._mu:
                per = self._sheds.setdefault(cls, {})
                per[reason] = per.get(reason, 0) + 1
            self.board.note_shed(cls, tenant)
        return reason

    @property
    def engaged(self) -> bool:
        with self._mu:
            return self._engaged

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "engaged": self._engaged,
                "burning": sorted(self._burning),
                "holds": self._holds,
                "releases": self._releases,
                "sheds": {cls: dict(r)
                          for cls, r in sorted(self._sheds.items())},
                "protect": list(self.protect),
                "shed_classes": list(self.shed),
                "degrade": bool(self._monitors),
                "fleet_view": self._fleet_view,
            }
