"""The port's durability plane (``cess_tpu_torch/obs/custody.py``) against
the JAX package's on the same lineage-note stream.

A seeded stream of the agents' ``("custody", ...)`` lineage notes
(dispatch, transfer, verdict, repair, with fragment hashes as bytes and
as hex), holder-liveness maps, open restoral orders and market
cross-checks goes through both packages' ``CustodyPlane``, each with its
own package's recorder and tracer armed: equal margins, repair targets,
timelines, transition logs, notes, spans, metrics, snapshots and
witnesses. Then a JAX ``miner_attrition`` run feeds a port plane beside
its own, round by round, from the same recorder.
"""
import numpy as np
import pytest

from cess_tpu.obs import custody as jcustody
from cess_tpu.obs import flight as jflight
from cess_tpu.obs import trace as jtrace
from cess_tpu_torch.obs import custody as tcustody
from cess_tpu_torch.obs import flight as tflight
from cess_tpu_torch.obs import trace as ttrace

PKGS = {"jax": (jcustody, jflight, jtrace),
        "port": (tcustody, tflight, ttrace)}
MINERS = tuple(f"m{i}" for i in range(6))


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    for _, flight, trace in PKGS.values():
        trace.disarm()
        flight.disarm()


def frag(rng) -> bytes:
    return bytes(rng.integers(0, 256, 32, dtype=np.uint8))


def stream(seed: int, files: int = 3, rounds: int = 10) -> list:
    """The seeded per-round inputs: notes, liveness, restorals, market."""
    rng = np.random.default_rng(seed)
    held: dict = {}                  # frag -> miner
    segs = []
    script = []
    for rnd in range(rounds):
        notes = []
        if rnd < files:
            k, m = (2, 2) if rnd % 2 == 0 else (2, 1)
            fh = frag(rng)
            seg_list = [(frag(rng), tuple(frag(rng) for _ in range(k + m)))
                        for _ in range(int(rng.integers(1, 3)))]
            notes.append(("dispatch", {
                "owner": "alice", "file": fh if rnd % 2 else fh.hex(),
                "k": k, "m": m, "segments": seg_list}))
            for row in range(k + m):
                miner = MINERS[int(rng.integers(0, len(MINERS)))]
                frs = tuple(s[1][row] for s in seg_list)
                for f in frs:
                    held[f] = miner
                notes.append(("transfer", {"miner": miner, "file": fh,
                                           "row": row, "frags": frs}))
                segs.append(frs)
        for miner in MINERS:
            if rng.random() < 0.5:
                mine = tuple(f for f, who in sorted(held.items())
                             if who == miner)
                notes.append(("verdict", {
                    "miner": miner, "round": rnd,
                    "service": bool(rng.random() < 0.8),
                    "idle": bool(rng.random() < 0.9),
                    "frags": mine + (frag(rng),)}))   # one foreign frag
        if held and rng.random() < 0.4:
            f = sorted(held)[int(rng.integers(0, len(held)))]
            rescuer = MINERS[int(rng.integers(0, len(MINERS)))]
            held[f] = rescuer
            notes.append(("repair", {
                "miner": rescuer, "frag": f,
                "mode": "symbols" if rng.random() < 0.5 else "fragments",
                "ingress": int(rng.integers(1, 1 << 20))}))
        # the planes' own announcements are custody notes too: ignored
        notes.append(("at_risk", {"key": "x", "frm": "ok", "to": "bad"}))
        alive = {m: bool(rng.random() < 0.8) for m in MINERS}
        lost = tuple(f for s in segs for f in s if rng.random() < 0.05)
        market = {"miners": {m: {"fake_capacity": bool(rng.random() < 0.3)}
                             for m in MINERS}}
        script.append((notes, alive, lost, market))
    return script


def drive(script, at_risk_margin: int):
    def fn(custody):
        plane = custody.CustodyPlane("probe", at_risk_margin=at_risk_margin,
                                     timeline_cap=8)
        margins, targets = [], []
        seq = 0
        for notes, alive, lost, market in script:
            for kind, detail in notes:
                seq += 1
                plane.on_note(seq, "custody", kind, dict(detail))
            plane.on_note(seq, "engine", "shed", {})      # not lineage
            plane.observe_alive(alive)
            plane.observe_restorals(lost)
            fold = plane.fold_margins()
            margins.append((fold, plane.seal_round()))
            plane.cross_check_market(market)
            targets.append({key: plane.repair_targets(key)
                            for key in sorted(fold)})
        keys = sorted(plane.margins())
        return {"witness": plane.witness(), "snapshot": plane.snapshot(),
                "metrics": plane.metrics(), "margins": margins,
                "targets": targets,
                "log": plane.detector.transition_log(),
                "detector": plane.detector.witness(),
                "active": plane.detector.active(),
                "ledger_log": plane.ledger.log(),
                "timelines": [plane.segment_timeline(k) for k in keys],
                "unknown": plane.repair_targets("nope"),
                "alive": [plane.holder_alive(m) for m in MINERS + ("?",)]}
    return fn


def both(fn):
    outs = []
    for pkg in ("jax", "port"):
        custody, flight, trace = PKGS[pkg]
        rec = flight.FlightRecorder(b"custody-parity")
        tracer = trace.Tracer()
        with flight.armed(rec), trace.armed(tracer):
            out = fn(custody)
        outs.append((out, rec.journal_tail(),
                     [(s["name"], s["attrs"]) for s in tracer.finished()]))
    want, got = outs
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[0] == want[0]
    return got


@pytest.mark.parametrize("seed,margin", [(0, 1), (1, 1), (2, 0), (3, 2)])
def test_custody_stream_equal_across_packages(seed, margin):
    out, notes, spans = both(drive(stream(seed), margin))
    kinds = {n["kind"] for n in notes}
    assert "at_risk" in kinds and "market-divergence" in kinds
    assert {s[0] for s in spans} <= {"custody.at_risk", "custody.lost",
                                     "custody.market-divergence"}
    assert any(t for rnd in out["targets"] for t in rnd.values())
    assert out["unknown"] == ()


def test_bounds_and_constants_equal():
    assert tcustody.AT_RISK_MARGIN == jcustody.AT_RISK_MARGIN
    assert tcustody.CustodyDetector.CLASSES \
        == jcustody.CustodyDetector.CLASSES
    for margins in ({}, {"a": -1, "b": 0, "c": 1, "d": 2, "e": 7}):
        assert tcustody.DurabilityScorer.histogram(margins) \
            == jcustody.DurabilityScorer.histogram(margins)

    def fn(custody):
        ledger = custody.CustodyLedger(timeline_cap=2, fragment_cap=3)
        frags = [bytes([i]) * 32 for i in range(5)]
        ledger.record_dispatch("alice", "ff", 2, 1, [(b"s", frags[:3]),
                                                     (b"t", frags[3:])])
        for f in frags:
            ledger.record_repair("m1", f, "symbols", 7)
        return ledger.sizes(), ledger.log(), [ledger.timeline(f)
                                              for f in frags]

    (sizes, _, timelines), _, _ = both(fn)
    assert sizes["fragments"] == 3 and all(len(t) <= 2 for t in timelines)


def test_miner_attrition_lineage_feeds_both_packages(monkeypatch):
    """A JAX ``miner_attrition`` run (silent miner deaths, the JAX custody
    and remediation planes armed): a port ``CustodyPlane`` listening on
    the run's recorder, fed the same liveness and restorals each round,
    seals the same margins as the scenario's plane every round and ends
    with the same witness, notes and repair targets."""
    from cess_tpu.sim import scenarios

    scenario = scenarios.SCENARIOS["miner_attrition"]
    seed = b"port-custody"
    port = tcustody.CustodyPlane("sim")
    rec = jflight.FlightRecorder(seed,
                                 baseline_rate=scenarios._BASELINE_RATE,
                                 objectives=dict(scenario.slo))
    rec.add_listener(port.on_note)
    orig = scenarios._custody_scrape
    sealed = []

    def tee(world, plane, rnd):
        orig(world, plane, rnd)
        homes = getattr(world, "role_homes", {})
        port.observe_alive({acct: bool(world.alive[idx])
                            for acct, idx in homes.items()})
        alive = [i for i in range(world.n) if world.alive[i]]
        st = world.nodes[alive[0]].runtime.state
        port.observe_restorals(tuple(
            f for (f,), _o in sorted(st.iter_prefix("file_bank",
                                                    "restoral"))))
        got = port.seal_round()
        assert got == plane.margins()
        assert port.detector.transition_log() \
            == plane.detector.transition_log()
        sealed.append(got)

    monkeypatch.setattr(scenarios, "_custody_scrape", tee)
    trec = tflight.FlightRecorder(b"port-custody")
    with tflight.armed(trec):
        report = scenarios.run_scenario(scenario, seed, n_nodes=16,
                                        strict=True, flight=rec)
    plane = report.custody
    assert len(sealed) == scenario.rounds
    assert port.witness() == plane.witness()
    assert port.snapshot() == plane.snapshot()
    assert port.metrics() == plane.metrics()
    for key in sorted(plane.margins()):
        assert port.repair_targets(key) == plane.repair_targets(key)
    want = [(e["kind"], e["detail"]) for e in rec.journal_tail("custody")
            if e["kind"] in jcustody.CustodyDetector.CLASSES]
    got = [(e["kind"], e["detail"]) for e in trec.journal_tail("custody")]
    assert got == want and ("at_risk", want[0][1]) == want[0]
