"""The JAX package's simulated network with the port's detector and
control planes armed in place of its own.

Each scenario runs once with the JAX package alone and once with the
port's planes built by the scenario runner: ``run_scenario`` builds its
planes by late import (``from ..obs.fleet import FleetPlane`` and the
like), so setting the JAX module's attribute installs the port's class.
The seams crossed: the port planes' flight notes and spans go to the run's
armed JAX recorder and tracer (``cess_tpu_torch.obs.flight.note`` and
``cess_tpu_torch.obs.trace.span`` set to the JAX package's), so the JAX
incident reporter and the remediation plane see them as they see the JAX
planes'; the port engine's fault sites consult the run's JAX fault plan.
Both runs are strict (a failed invariant raises), and must give the same
``SimReport.witness()``, the same plane witnesses and the same incident
reporter witness.
"""
import jax
import pytest
import torch

from cess_tpu.obs import chainwatch as jchain
from cess_tpu.obs import custody as jcustody
from cess_tpu.obs import fleet as jfleet
from cess_tpu.obs import flight as jflight
from cess_tpu.obs import trace as jtrace
from cess_tpu.resilience import faults as jfaults
from cess_tpu.serve import remediate as jrem
from cess_tpu.sim import scenarios
from cess_tpu.sim.scenarios import SCENARIOS, run_scenario
from cess_tpu_torch.obs import chainwatch as tchain
from cess_tpu_torch.obs import custody as tcustody
from cess_tpu_torch.obs import fleet as tfleet
from cess_tpu_torch.obs import flight as tflight
from cess_tpu_torch.obs import trace as ttrace
from cess_tpu_torch.resilience import faults as tfaults
from cess_tpu_torch.serve import remediate as trem
from test_torch_sim import install_port

SEED = b"port-planes"
N_NODES = 20


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def route_to_jax(monkeypatch) -> None:
    """The port's notes, spans and fault sites go through the JAX
    package's armed recorder, tracer and plan."""
    monkeypatch.setattr(tflight, "note", jflight.note)
    monkeypatch.setattr(ttrace, "span", jtrace.span)
    monkeypatch.setattr(tfaults, "inject", jfaults.inject)


def planes(report) -> tuple:
    return tuple(None if p is None else p.witness() for p in (
        report.fleet, report.chainwatch, report.remediation,
        report.custody))


def assert_same_run(got, want, scenario) -> None:
    assert got.rounds_run == want.rounds_run == scenario.rounds
    assert got.witness() == want.witness()
    assert planes(got) == planes(want)
    assert got.reporter.witness() == want.reporter.witness()
    assert [(b["trigger"], b["key"]) for b in got.reporter.bundles()] \
        == [(b["trigger"], b["key"]) for b in want.reporter.bundles()]


def test_perf_regression_autopilot_on_the_port_pool_and_plane(monkeypatch):
    """``perf_regression_autopilot``: the scripted perf edges drive the
    port's ``RemediationPlane`` bound to a port engine over as many
    ``"cpu"`` lanes as the JAX run has devices. ``perf-pin`` holds the
    port engine's codec breaker (the reference pins the engine's own
    breaker, not the lanes'), the recovery edges release it, and the
    second regression's bundle carries the journal tail."""
    from cess_tpu_torch.ops import rs
    from cess_tpu_torch.ops.audit_backend import make_audit_backend
    from cess_tpu_torch.resilience import ResilienceConfig
    from cess_tpu_torch.serve import DevicePool, SubmissionEngine

    scenario = SCENARIOS["perf_regression_autopilot"]
    want = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    install_port(monkeypatch)
    route_to_jax(monkeypatch)
    monkeypatch.setattr(jrem, "RemediationPlane", trem.RemediationPlane)
    built = []

    def pool_engine(world, profile=False, regen=False, lanes=True):
        assert not profile and not regen and lanes is True
        cfg = world.pipeline.config
        eng = SubmissionEngine(
            rs.make_codec(cfg.k, cfg.m, "cpu"),
            make_audit_backend(world.pipeline.podr2_key, "cpu"),
            resilience=ResilienceConfig(),
            pool=DevicePool(["cpu"] * len(jax.devices())))
        built.append(eng)
        return eng

    monkeypatch.setattr(scenarios, "_pool_engine", pool_engine)
    got = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    assert_same_run(got, want, scenario)
    plane = got.remediation
    assert isinstance(plane, trem.RemediationPlane)
    (eng,) = built
    assert plane._engine is eng
    journal = plane.journal()
    assert journal == want.remediation.journal()
    fired = [(e["policy"], e["key"]) for e in journal
             if e["event"] == "fire"]
    assert ("perf-pin", "encode") in fired \
        and ("perf-pin", "decode") in fired
    assert all(e["applied"] for e in journal if e["event"] == "fire")
    holds = eng.stats_snapshot()["resilience"]["breakers"]["codec"]
    assert holds["holds"] == 2 and holds["state"] == "closed"
    assert got.pool == want.pool
    tails = [b["snapshots"]["remediation"]["journal"]
             for b in got.reporter.bundles()
             if "remediation" in b["snapshots"]]
    assert tails and any(tails)


def test_miner_attrition_on_the_port_custody_and_remediation(monkeypatch):
    """``miner_attrition`` under ``install_port``: the port's
    ``CustodyPlane`` folds the JAX agents' lineage notes into margins,
    its at-risk edges drive the port's ``RemediationPlane``, which files
    restoral orders on the JAX node and rebuilds through the JAX miners
    (their device work on the port)."""
    scenario = SCENARIOS["miner_attrition"]
    want = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    _, port, _ = install_port(monkeypatch)
    route_to_jax(monkeypatch)
    monkeypatch.setattr(jcustody, "CustodyPlane", tcustody.CustodyPlane)
    monkeypatch.setattr(jrem, "RemediationPlane", trem.RemediationPlane)
    got = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    assert_same_run(got, want, scenario)
    assert isinstance(got.custody, tcustody.CustodyPlane)
    assert isinstance(got.remediation, trem.RemediationPlane)
    log = got.custody.detector.transition_log()
    assert [(c, t) for _, c, _, _, t in log if t == "bad"] \
        == [("at_risk", "bad"), ("at_risk", "bad")]
    repairs = [e for e in got.remediation.journal()
               if e["policy"] == "custody-repair" and e["event"] == "fire"]
    assert repairs and all(e["applied"] for e in repairs)
    assert port["encode_step"] > 0


def test_gateway_hotspot_fleet_on_the_port_fleet_plane(monkeypatch):
    """``gateway_hotspot_fleet``: the port's ``FleetPlane`` federates the
    JAX nodes' expositions, folds their SLO snapshots into the worst and
    quorum views, flags the partition's laggards and stitches the run's
    traces (the tracer's ring and the recorder's pins)."""
    scenario = SCENARIOS["gateway_hotspot_fleet"]
    want = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True,
                        tracer=jtrace.Tracer())
    route_to_jax(monkeypatch)
    monkeypatch.setattr(jfleet, "FleetPlane", tfleet.FleetPlane)
    got = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True,
                       tracer=jtrace.Tracer())
    assert_same_run(got, want, scenario)
    plane = got.fleet
    assert isinstance(plane, tfleet.FleetPlane)
    assert plane.snapshot() == want.fleet.snapshot()
    assert plane.federator.render() == want.fleet.federator.render()
    views = {(c, v, t) for c, v, _, t, _ in plane.board.transition_log()}
    assert ("head", "worst", "warn") in views
    assert plane.stitcher.snapshot()["traces"]


def test_equivocating_validator_on_the_port_fleet_and_chain_watch(
        monkeypatch):
    """``equivocating_validator``: the port's ``ChainWatch`` (its
    ``node_state`` and ``market_state`` reading the JAX nodes) records
    the double-signer's evidence and the stall, folds finality lag into
    the port's ``FleetPlane``, whose quorum view flips and recovers."""
    scenario = SCENARIOS["equivocating_validator"]
    want = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    route_to_jax(monkeypatch)
    monkeypatch.setattr(jfleet, "FleetPlane", tfleet.FleetPlane)
    for name in ("ChainWatch", "node_state", "market_state", "lag_state"):
        monkeypatch.setattr(jchain, name, getattr(tchain, name))
    got = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    assert_same_run(got, want, scenario)
    watch = got.chainwatch
    assert isinstance(watch, tchain.ChainWatch)
    assert isinstance(got.fleet, tfleet.FleetPlane)
    assert watch.snapshot() == want.chainwatch.snapshot()
    active = {cls for _, cls, _, _, to in watch.anomalies.transition_log()
              if to == "bad"}
    assert {"equivocation", "finality-stall"} <= active
    assert ("finality_lag", "quorum", "ok", "warn") in {
        t[:4] for t in got.fleet.board.transition_log()}
