"""cess_tpu_torch.resilience: fault tolerance for the serving data plane.

The port's own copy of ``cess_tpu/resilience`` (the port imports nothing
of that package); every name, site, schedule and counter is the same,
so one seeded plan drives the same faults through both packages:

- faults.py   deterministic fault injector: a seeded FaultPlan fires
              raise/delay/drop/corrupt actions at named sites on the
              hot-path seams (engine dispatch, stream staging, the codec
              and audit gates); no-ops when nothing is armed, and same
              seed => the same schedule.
- retry.py    RetryPolicy (exponential backoff + deterministic jitter)
              and Budget (each attempt spends from the request's ONE
              remaining-time pool).
- health.py   HealthMonitor (count-based error window, recovery probes)
              and ResilienceConfig, the engine's opt-in: a tripped
              breaker serves host members on the CPU reference, whose
              bytes equal the card's, so degradation changes latency
              only; card members are refused, never moved to the host.
- stats.py    the cess_resilience_* counters, merged into the engine's
              metrics beside cess_engine_*.

Wire-up: ``serve.make_engine(..., resilience=ResilienceConfig())``;
without a config the engine behaves exactly as before.
"""
from .faults import (FaultInjected, FaultPlan, FaultSpec, allow, arm,
                     armed, armed_plan, corrupt, disarm, inject)
from .health import HealthMonitor, ResilienceConfig
from .retry import Budget, RetryPolicy
from .stats import ResilienceStats

__all__ = [
    "Budget",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "HealthMonitor",
    "ResilienceConfig",
    "ResilienceStats",
    "RetryPolicy",
    "allow",
    "arm",
    "armed",
    "armed_plan",
    "corrupt",
    "disarm",
    "inject",
]
