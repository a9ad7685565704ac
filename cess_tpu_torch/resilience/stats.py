"""Resilience counters: retries, abandons, batch requeues, fallbacks,
breaker state: the ``cess_resilience_*`` gauge family.

The port's own copy of ``cess_tpu/resilience/stats.py``, under the same
names. An engine built with a :class:`~.health.ResilienceConfig` hangs
one of these off its ``serve.stats.EngineStats``, whose ``metrics``
merges :meth:`metrics` beside the ``cess_engine_*`` family and whose
``snapshot`` carries :meth:`snapshot` under ``"resilience"``.

Unlike EngineStats (mutated only under the engine lock), these
counters are hit from submitter threads (retry wrappers), the batcher
(salvage/fallback) and whoever scrapes metrics — so this class owns
its lock and every access goes through it.
"""
from __future__ import annotations

import threading


class ResilienceStats:
    def __init__(self):
        self._mu = threading.Lock()
        self._retries: dict[str, int] = {}      # per op class
        self._abandoned: dict[str, int] = {}    # per op class
        self._fallback: dict[str, int] = {}     # batches served on CPU
        self._degraded: dict[str, int] = {}     # breaker-open dispatches
        self._batch_requeues = 0                # members re-run solo
        self._monitors: dict[str, object] = {}  # backend -> HealthMonitor

    # -- recording ----------------------------------------------------------
    def note_retry(self, cls: str) -> None:
        with self._mu:
            self._retries[cls] = self._retries.get(cls, 0) + 1

    def note_abandoned(self, cls: str) -> None:
        with self._mu:
            self._abandoned[cls] = self._abandoned.get(cls, 0) + 1

    def note_fallback(self, cls: str) -> None:
        with self._mu:
            self._fallback[cls] = self._fallback.get(cls, 0) + 1

    def note_degraded(self, cls: str) -> None:
        with self._mu:
            self._degraded[cls] = self._degraded.get(cls, 0) + 1

    def note_batch_requeues(self, members: int) -> None:
        with self._mu:
            self._batch_requeues += members

    def register_monitor(self, backend: str, monitor) -> None:
        with self._mu:
            self._monitors[backend] = monitor

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._mu:
            out = {
                "batch_requeues": self._batch_requeues,
                "retries": dict(self._retries),
                "abandoned": dict(self._abandoned),
                "fallback_batches": dict(self._fallback),
                "degraded_batches": dict(self._degraded),
                "breakers": {name: mon.snapshot()
                             for name, mon in self._monitors.items()},
            }
        return out

    def metrics(self) -> dict[str, float]:
        """Flat gauges, merged by EngineStats.metrics into the
        ``cess_engine_*`` exposition."""
        snap = self.snapshot()
        out = {"cess_resilience_batch_requeues":
               float(snap["batch_requeues"])}
        for family in ("retries", "abandoned", "fallback_batches",
                       "degraded_batches"):
            for cls in sorted(snap[family]):
                out[f"cess_resilience_{cls}_{family}"] = \
                    float(snap[family][cls])
        for name in sorted(snap["breakers"]):
            b = snap["breakers"][name]
            # "held" (the SLO controller's external latch) is open for
            # traffic purposes: every dispatch degrades either way
            out[f"cess_resilience_breaker_{name}_open"] = \
                1.0 if b["state"] != "closed" else 0.0
            out[f"cess_resilience_breaker_{name}_held"] = \
                1.0 if b["state"] == "held" else 0.0
            for k in ("trips", "probes", "recoveries"):
                out[f"cess_resilience_breaker_{name}_{k}"] = float(b[k])
        return out
