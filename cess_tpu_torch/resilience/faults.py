"""Deterministic fault injection for the serving data plane.

The port's own copy of ``cess_tpu/resilience/faults.py``: the same
sites, the same seeded schedules, the same firing log, so one plan
drives the same faults through both packages. A seeded
:class:`FaultPlan` maps injection *sites* (string names at the hot-path
seams: engine batch dispatch, streaming staging, the codec and audit
gates) to per-ordinal :class:`FaultSpec` actions, and three hooks
consult the armed plan:

- :func:`inject`: control seams (device dispatch, codec calls): a
  scheduled fault raises :class:`FaultInjected` or delays;
- :func:`allow`: messaging and transfer seams: ``False`` when a
  ``drop`` fires (the caller skips the send or treats the transfer as
  lost);
- :func:`corrupt`: data seams: returns the payload with its first byte
  flipped when a ``corrupt`` fires (bytes or a numpy array); integrity
  checks must catch it.

Determinism: a plan's schedule is a pure function of its seed
(:meth:`FaultPlan.seeded` derives firing ordinals from a SHA-256
counter stream: no ``random``, no clock), and ordinals count hook
crossings per site since arming. The same sequential workload under the
same plan fires the same faults at the same sites in the same order,
recorded in :meth:`FaultPlan.fired_log`.

Cost: with no plan armed every hook is one module-global load and a
``None`` check, so the seams stay in production code.

Threads: ordinal counters are lock-protected (hooks run on batcher,
submitter and stream threads), but the cross-thread firing ORDER is
whatever the schedule of the threads makes it; replay-exact runs drive
their workload sequentially (submit and wait).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time

import numpy as np

from ..obs import trace as _trace

KINDS = ("raise", "delay", "drop", "corrupt")


class FaultInjected(RuntimeError):
    """The error a ``raise`` FaultSpec throws at its site: a stand-in
    for a real device or transport failure, told apart from genuine
    errors so tests can assert which path failed."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault action. ``delay_s`` applies to every kind (a slow
    failure is the common production shape); ``xor`` is the byte mask
    a ``corrupt`` flips into the payload's first byte."""

    kind: str = "raise"
    message: str = ""
    delay_s: float = 0.0
    xor: int = 0xFF

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "delay" and self.delay_s <= 0:
            raise ValueError("delay fault needs delay_s > 0")
        if not 1 <= self.xor <= 0xFF:
            # xor=0 would be a corruption that fires, logs a witness,
            # and changes nothing — the silent-no-op shape the delay
            # check above also rejects
            raise ValueError(f"corrupt xor mask {self.xor!r} must be "
                             "a non-zero byte")


class FaultPlan:
    """site -> {ordinal -> FaultSpec}, plus the per-site crossing
    counters and the fired-fault log. Build explicitly from a schedule
    dict, or derive one from a seed with :meth:`seeded`."""

    def __init__(self, schedule: dict[str, dict[int, FaultSpec]],
                 seed: bytes = b"", clock=None):
        self.schedule = {site: dict(specs)
                         for site, specs in schedule.items()}
        self.seed = seed
        # ``clock`` is any object with a ``sleep(seconds)`` method;
        # ``None`` means the wall clock (time.sleep), the production
        # default. A sim world injects its SimClock so delay faults
        # advance virtual time instead of blocking the test runner.
        self.clock = clock
        self._mu = threading.Lock()
        self._counts: dict[str, int] = {}
        self._fired: list[tuple[str, int, str]] = []

    @classmethod
    def seeded(cls, seed, sites: dict[str, tuple[float, "FaultSpec | str"]],
               horizon: int = 64, clock=None) -> "FaultPlan":
        """Derive a schedule from a seed: for each site, each ordinal
        in ``[0, horizon)`` fires with the given rate, decided by a
        SHA-256 counter stream over (seed, site, ordinal). Same seed
        => byte-identical schedule, on every host, every run.

        sites: ``{site: (rate, spec_or_kind)}`` with rate in [0, 1].
        """
        seed_b = seed if isinstance(seed, bytes) else str(seed).encode()
        schedule: dict[str, dict[int, FaultSpec]] = {}
        for site in sorted(sites):
            rate, spec = sites[site]
            if isinstance(spec, str):
                spec = FaultSpec(kind=spec,
                                 delay_s=0.001 if spec == "delay" else 0.0)
            ordinals: dict[int, FaultSpec] = {}
            for i in range(horizon):
                h = hashlib.sha256(b"cess-fault:" + seed_b + b"|"
                                   + site.encode() + b"|"
                                   + i.to_bytes(4, "little")).digest()
                if int.from_bytes(h[:8], "little") < rate * 2 ** 64:
                    ordinals[i] = spec
            schedule[site] = ordinals
        return cls(schedule, seed=seed_b, clock=clock)

    # -- plan state ---------------------------------------------------------
    def _next(self, site: str) -> tuple[int, FaultSpec | None]:
        """Advance the site's ordinal; return (ordinal, due spec)."""
        with self._mu:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            spec = self.schedule.get(site, {}).get(n)
            if spec is not None:
                self._fired.append((site, n, spec.kind))
            return n, spec

    def fired_log(self) -> tuple[tuple[str, int, str], ...]:
        """(site, ordinal, kind) for every fault that fired, in firing
        order — the replay-determinism witness."""
        with self._mu:
            return tuple(self._fired)

    def counts(self) -> dict[str, int]:
        """Hook crossings per site (fired or not)."""
        with self._mu:
            return dict(self._counts)

    def reset(self) -> None:
        """Zero the ordinal counters and the fired log (fresh run of
        the same schedule)."""
        with self._mu:
            self._counts.clear()
            self._fired.clear()


# -- arming ------------------------------------------------------------------
_MU = threading.Lock()
_PLAN: FaultPlan | None = None


def arm(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` as the process-wide armed plan."""
    global _PLAN
    with _MU:
        _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    with _MU:
        _PLAN = None


def armed_plan() -> FaultPlan | None:
    return _PLAN


@contextlib.contextmanager
def armed(plan: FaultPlan):
    """``with faults.armed(plan): ...`` — arm for the block, always
    disarm after (chaos tests must never leak faults into their
    neighbors)."""
    arm(plan)
    try:
        yield plan
    finally:
        disarm()


# -- hooks (the only calls production code makes) ----------------------------
def _fire(site: str) -> FaultSpec | None:
    plan = _PLAN
    if plan is None:            # zero-cost no-op: one load, one check
        return None
    n, spec = plan._next(site)
    if spec is None:
        return None
    # fault firings annotate the active trace span (obs/trace.py):
    # a traced chaos run shows where each injected fault landed in the
    # request's path; a no-op without a current span
    _trace.event("fault", site=site, ordinal=n, kind=spec.kind)
    if spec.delay_s:            # sleep OUTSIDE the plan lock; the
        # plan's injected clock (if any) absorbs the delay as virtual
        # time — the wall clock only moves for unclocked plans
        (plan.clock or time).sleep(spec.delay_s)
    if spec.kind == "raise":
        detail = f": {spec.message}" if spec.message else ""
        raise FaultInjected(f"injected fault at {site}#{n}{detail}")
    return spec


def inject(site: str) -> None:
    """Control seam: a due ``raise`` throws, a ``delay`` sleeps;
    ``drop``/``corrupt`` specs are meaningless here and act as no-ops."""
    _fire(site)


def allow(site: str) -> bool:
    """Messaging/transfer seam: False when a ``drop`` fires (after any
    scheduled delay); a due ``raise`` still throws."""
    spec = _fire(site)
    return spec is None or spec.kind != "drop"


def corrupt(site: str, data):
    """Data seam: returns ``data`` with its first byte xor-flipped when
    a ``corrupt`` fires (bytes or uint8 ndarray), untouched otherwise."""
    spec = _fire(site)
    if spec is None or spec.kind != "corrupt":
        return data
    if isinstance(data, (bytes, bytearray)):
        out = bytearray(data)
        if out:
            out[0] ^= spec.xor
        return bytes(out)
    arr = np.array(data, copy=True)
    if arr.size:
        flat = arr.reshape(-1)
        flat[0] ^= np.asarray(spec.xor, dtype=arr.dtype)
    return arr
