"""Deterministic discrete-event simulation of the full CESS stack.

A seeded :class:`World` drives hundreds of real
:class:`~cess_tpu_torch.node.network.Node` replicas — consensus, finality,
the storage/audit pipeline and its offchain agents — over a virtual
clock and a SHA-256-tie-broken event queue: no threads, no sockets,
no wall-clock sleeps, and the same seed replays the same world
bit-identically (event log, finalized prefixes, SLO transitions,
fired faults). Scenarios live in :mod:`.scenarios` as data; the
per-round safety properties live in :mod:`.invariants`.
"""
from .clock import US, EventQueue, SimClock
from .invariants import CHECKERS, InvariantViolation, run_checks
from .scenarios import (SCENARIOS, Scenario, SimReport, resolve_ref,
                        run_scenario)
from .world import StorageProfile, World, topology_edges

__all__ = [
    "US", "EventQueue", "SimClock",
    "CHECKERS", "InvariantViolation", "run_checks",
    "SCENARIOS", "Scenario", "SimReport", "resolve_ref", "run_scenario",
    "StorageProfile", "World", "topology_edges",
]
