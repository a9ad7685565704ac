"""Run one scenario of the simulated network on both packages.

``run_both(name)`` runs ``SCENARIOS[name]`` at ``N_NODES`` nodes with the
seed ``SEED`` through the JAX package's ``cess_tpu.sim`` and through the
port's ``cess_tpu_torch.sim`` alone (its storage plane and pool engine on
``["cpu"] * len(jax.devices())``, the host devices the JAX run sees), and
asserts what a replay must reproduce equal (tolerance 0): the
``SimReport.witness()`` (event log, finalized prefixes, SLO transitions,
fired faults and the fleet, chain watch, remediation and custody
witnesses), the rounds run, the files that went active, the incident
reporter's witness, the pool snapshot and the profile plane's counts
(``timing_free``: its host timings aside). Both runs are strict: a failed
invariant raises.

``_one_thread`` is the autouse fixture the simulated-network test files
import: torch on one thread for each test, as ``tests/test_torch_sim.py``
runs it. ``_yield_cpu``, imported by the files whose tests read no wall
clock (the replays, the 100-node library, the lockstep), runs each test
at niceness 10 where the process may take its priority back afterwards
(as root): minutes of deterministic CPU work then yield the cores to the
wall-clock drills and TCP tests that other workers run beside them.
"""
from __future__ import annotations

import os

import pytest

SEED = b"port-sim"
N_NODES = 20


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _yield_cpu():
    if os.geteuid() != 0:
        yield
        return
    before = os.getpriority(os.PRIO_PROCESS, 0)
    os.setpriority(os.PRIO_PROCESS, 0, max(before, 10))
    yield
    os.setpriority(os.PRIO_PROCESS, 0, before)


def timing_free(snap: dict | None) -> dict | None:
    """A ProfilePlane snapshot without its host timings (None stays)."""
    from test_torch_sim import _timing_free

    return None if snap is None else _timing_free(snap)


def run_both(name: str):
    """The JAX package's report and the port's, compared; returns both."""
    import jax

    from cess_tpu.sim import SCENARIOS as JSCENARIOS
    from cess_tpu.sim import run_scenario as jrun
    from cess_tpu_torch.sim import SCENARIOS, run_scenario

    scenario = SCENARIOS[name]
    want = jrun(JSCENARIOS[name], SEED, n_nodes=N_NODES, strict=True)
    got = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True,
                       devices=["cpu"] * len(jax.devices()))
    assert got.witness() == want.witness()
    assert got.rounds_run == want.rounds_run == scenario.rounds
    assert got.uploads_active == want.uploads_active
    assert got.reporter.witness() == want.reporter.witness()
    assert got.pool == want.pool
    assert (got.pool is None) == (not scenario.pool)
    assert timing_free(got.profile) == timing_free(want.profile)
    assert (got.profile is None) == (not scenario.profile)
    return want, got
