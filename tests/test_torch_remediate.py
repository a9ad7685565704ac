"""The port's remediation plane (``cess_tpu_torch/serve/remediate.py``)
against the JAX package's, each bound to its own package's engine.

Every drill runs one script of flight-note edges, plane ticks and engine
requests twice: a JAX plane bound to a JAX engine under the JAX
recorder, and a port plane bound to a port CPU engine under the port's
recorder. Journals (``applied`` included), witnesses, snapshots,
metrics, engagements, edge logs, the recorders' journals (the monitors'
hold and release notes), the monitor states after every step, the
encodes' bytes and the pools' placement logs must be equal, and the
holds must be visible on the port's monitors. The chain-half seams
(``bind_node``, ``bind_miners``, ``bind_custody``) are duck-typed and
are bound to the JAX package's ``Node`` or to stub miners in both runs.
"""
import dataclasses

import numpy as np
import pytest

from cess_tpu import constants
from cess_tpu import resilience as jres
from cess_tpu import serve as jserve
from cess_tpu.obs import flight as jflight
from cess_tpu.obs.profile import ProfilePlane as JProfile
from cess_tpu.serve import remediate as jrem
from cess_tpu_torch import resilience as tres
from cess_tpu_torch import serve as tserve
from cess_tpu_torch.obs import flight as tflight
from cess_tpu_torch.obs.profile import ProfilePlane as TProfile
from cess_tpu_torch.serve import remediate as trem

PERF_METRIC = "rs_4p8_encode_GiBps_per_chip"
DATA = np.random.default_rng(7).integers(0, 256, (1, 2, 1024),
                                         dtype=np.uint8)


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    jflight.disarm()
    tflight.disarm()


def engine(pkg: str, lanes: int = 0, profile: bool = False):
    if pkg == "jax":
        return jserve.make_engine(
            2, 1, rs_backend="jax", resilience=jres.ResilienceConfig(),
            pool=lanes or None, profile=JProfile() if profile else None)
    return tserve.make_engine(
        2, 1, rs_backend="cpu", resilience=tres.ResilienceConfig(),
        pool=tserve.DevicePool(["cpu"] * lanes) if lanes else None,
        profile=TProfile() if profile else None)


def monitors(eng) -> dict:
    mons = dict(eng.monitors)
    pool = getattr(eng, "pool", None)
    for lane in pool.lanes if pool is not None else ():
        for backend, mon in lane.monitors.items():
            mons[f"{backend}.d{lane.index}"] = mon
    return mons


class StubMiner:
    """The miner surface the plane touches, nothing else."""

    def __init__(self, account):
        self.account = account
        self.repair_mode = "symbols"
        self.repair_ingress_bytes = 0
        self.repair_recovered_bytes = 0
        self.modes = []

    def set_repair_mode(self, mode):
        self.repair_mode = mode
        self.modes.append(mode)


def run(pkg: str, script, *, lanes: int = 0, profile: bool = False,
        bind=None, **kw) -> dict:
    """One package's run of ``script``: steps ``("note", sys, kind,
    detail)`` (noted through the armed recorder the plane listens on),
    ``("tick",)``, ``("encode",)``, ``("ingress", acct, ingress,
    recovered)`` (a stub miner's counters grow). After each step: every
    monitor's state."""
    flight, rem = (jflight, jrem) if pkg == "jax" else (tflight, trem)
    plane = rem.RemediationPlane(b"port-remediate", **kw)
    rec = flight.FlightRecorder(b"port-remediate")
    rec.add_listener(plane.on_note)
    eng = engine(pkg, lanes, profile) if lanes is not None else None
    miners = {m: StubMiner(m) for m in ("m1", "m2")}
    if eng is not None:
        plane.bind_engine(eng)
    plane.bind_miners(list(miners.values()))
    if bind is not None:
        bind(plane)
    states, encoded = [], []
    try:
        with flight.armed(rec):
            for step in script:
                if step[0] == "note":
                    flight.note(step[1], step[2], **step[3])
                elif step[0] == "tick":
                    plane.tick()
                elif step[0] == "encode":
                    encoded.append(np.asarray(eng.encode(DATA, timeout=60)))
                elif step[0] == "ingress":
                    m = miners[step[1]]
                    m.repair_ingress_bytes += step[2]
                    m.repair_recovered_bytes += step[3]
                states.append({} if eng is None else {
                    n: m.state for n, m in sorted(monitors(eng).items())})
        pool = getattr(eng, "pool", None)
        out = {"journal": plane.journal(), "witness": plane.witness(),
               "snapshot": plane.snapshot(), "metrics": plane.metrics(),
               "engaged": plane.engagements(), "edges": plane.edge_log(),
               "tail": plane.journal(limit=3), "count": plane.count,
               "notes": rec.journal_tail(), "states": states,
               "modes": {a: (m.repair_mode, m.modes, plane.intended_mode(a))
                         for a, m in miners.items()},
               "encoded": encoded,
               "placements": None if pool is None else pool.placement_log(),
               "degraded": None if eng is None else eng.stats_snapshot()[
                   "resilience"]["degraded_batches"]}
    finally:
        if eng is not None:
            eng.close()
    return out


def both(script, **kw) -> dict:
    want = run("jax", script, **kw)
    got = run("port", script, **kw)
    for key in want:
        if key == "encoded":
            assert len(got[key]) == len(want[key])
            for a, b in zip(got[key], want[key]):
                assert np.array_equal(a, b)
        else:
            assert got[key] == want[key], key
    return got


def perf(metric: str, frm: str, to: str, window: int):
    return ("note", "perf", "regression",
            {"metric": metric, "frm": frm, "to": to, "window": window})


TICK = ("tick",)


def test_perf_pin_holds_and_recovery_releases():
    """A regression pins the class's codec breaker on the next tick: a
    numpy encode is then served by the CPU reference; the recovery edge
    releases it. The decode key and the watchdog's metric name (through
    the profile's tracked classes) resolve to the same breaker."""
    got = both([
        perf("encode", "ok", "regressed", 2), TICK, ("encode",),
        perf("encode", "regressed", "ok", 3), TICK, ("encode",),
        perf("decode", "ok", "regressed", 4), TICK,
        perf("decode", "regressed", "ok", 5), TICK,
        perf(PERF_METRIC, "ok", "regressed", 6), TICK,
        perf(PERF_METRIC, "regressed", "ok", 7), TICK,
    ], profile=True)
    states = got["states"]
    assert states[0] == {"codec": "closed"}
    assert states[1]["codec"] == "held" and states[4]["codec"] == "closed"
    assert states[7]["codec"] == "held" and states[11]["codec"] == "held"
    assert states[13]["codec"] == "closed"
    fires = [(e["key"], e["applied"]) for e in got["journal"]
             if e["event"] == "fire"]
    assert fires == [("encode", True), ("decode", True),
                     (PERF_METRIC, True)]
    assert got["degraded"] == {"encode": 1}
    assert [n["kind"] for n in got["notes"] if n["sys"] == "breaker"] \
        == ["hold", "release"] * 3


def test_cooldown_suppression_flap_and_reprobe():
    """Suppressed inside the fire cooldown, re-fired inside the release
    cooldown as a flap (journaled, noted), then released by the
    count-based re-probe."""
    script = [perf("encode", "ok", "regressed", 1), TICK,
              perf("encode", "regressed", "ok", 2), TICK,
              perf("encode", "ok", "regressed", 3), TICK, TICK, TICK,
              perf("encode", "ok", "regressed", 6), TICK] + [TICK] * 8
    got = both(script)
    events = [(e["event"], e["reason"]) for e in got["journal"]]
    assert events == [("fire", ""), ("release", "recovered"),
                      ("suppress", "cooldown"), ("fire", ""),
                      ("flap", "refire-inside-cooldown"),
                      ("release", "re-probe")]
    flaps = [n["detail"] for n in got["notes"]
             if n["sys"] == "remediation" and n["kind"] == "flap"]
    assert flaps == [{"policy": "perf-pin", "action": "pin-reference",
                      "key": "encode", "gap": 4}]
    assert got["states"][-1]["codec"] == "closed"


def test_dry_run_journals_identically_and_holds_nothing():
    script = [perf("encode", "ok", "regressed", 1), TICK,
              ("note", "breaker", "trip", {"name": "codec", "window": 5}),
              TICK, ("ingress", "m1", 4000, 1000), TICK,
              perf("encode", "regressed", "ok", 3)] + [TICK] * 12
    act = both(script)
    dry = both(script, dry_run=True)
    assert dry["witness"] == act["witness"]
    assert all(e["applied"] is False for e in dry["journal"])
    assert any(e["applied"] for e in act["journal"])
    assert all(s["codec"] != "held" for s in dry["states"])
    assert any(s["codec"] == "held" for s in act["states"])
    assert dry["modes"]["m1"] == ("symbols", [], "symbols")
    assert act["modes"]["m1"] == ("symbols", ["fragments", "symbols"],
                                  "symbols")


def test_quarantine_holds_every_breaker_on_the_lane():
    """A straggler edge naming lane 0 holds both of its breakers (the
    other lane's stay closed): the next encodes are placed on lane 1
    only, byte-equal; ``release_after`` ticks later lane 0 serves again.
    A key naming a foreign host is journaled, not applied."""
    script = [("encode",),
              ("note", "fleet", "outlier", {"instance": "cpu.d0",
                                            "metric": "encode_wall_s"}),
              TICK, ("encode",), ("encode",), ("encode",),
              ("note", "fleet", "outlier", {"instance": "otherhost",
                                            "metric": "encode_wall_s"}),
              TICK] + [TICK] * 15 + [("encode",)]
    got = both(script, lanes=2)
    held = got["states"][2]
    assert held["codec.d0"] == "held" and held["codec.d1"] == "closed"
    assert held["codec"] == "closed"
    lanes = [row[4] for row in got["placements"]]
    assert lanes == [0, 1, 1, 1, 0]
    assert got["states"][-1]["codec.d0"] == "closed"
    journal = got["journal"]
    assert [(e["event"], e["key"], e["applied"]) for e in journal] == [
        ("fire", "cpu.d0", True), ("fire", "otherhost", False),
        ("release", "cpu.d0", True)]
    assert list(got["engaged"]) == ["straggler-quarantine:otherhost"]
    assert all(np.array_equal(e, got["encoded"][0])
               for e in got["encoded"])


def test_perf_pin_under_a_pool_misses_the_lanes():
    """The reference's quirk, kept: ``perf-pin`` holds the engine's own
    codec breaker, while a pool engine gates each batch on its lane's
    breakers, so the pinned class still runs on the lanes undegraded.
    Both packages do the same."""
    got = both([perf("encode", "ok", "regressed", 1), TICK, ("encode",)],
               lanes=2)
    st = got["states"][-1]
    assert st["codec"] == "held"
    assert st["codec.d0"] == st["codec.d1"] == "closed"
    assert [row[4] for row in got["placements"]] == [0]
    assert got["degraded"] == {}


def test_breaker_trip_latch_and_lane_breaker_names():
    got = both([("note", "breaker", "trip", {"name": "codec.d1",
                                             "window": 5}), TICK,
                ("note", "breaker", "trip", {"name": "codec", "window": 5}),
                TICK] + [TICK] * 12, lanes=2)
    assert got["states"][1]["codec.d1"] == "held"
    assert got["states"][3]["codec"] == "held"
    assert got["states"][-1]["codec"] == got["states"][-1]["codec.d1"] \
        == "closed"
    assert [e["reason"] for e in got["journal"]
            if e["event"] == "release"] == ["re-probe", "re-probe"]


def test_rate_limit_engaged_disabled_and_custom_policies():
    """A custom table: a policy capped at 2 fires, one disabled (its
    edges recorded, never decided), guards that must match; the
    engaged suppression; snapshot and metrics equal."""
    def policies(rem):
        return (rem.Policy(name="pin-any", trigger=("perf", "regression"),
                           key_field="metric", action="pin-reference",
                           release_after=3, cooldown=0, max_fires=2),
                rem.Policy(name="off", trigger=("breaker", "trip"),
                           key_field="name", action="pin-reference",
                           enabled=False),
                rem.Policy(name="guarded", trigger=("chain", "anomaly"),
                           match=(("cls", "equivocation"),),
                           key_field="key", action="file-offence",
                           release_after=0))
    script = [perf("encode", "ok", "regressed", 1),
              perf("encode", "ok", "regressed", 1), TICK,
              ("note", "breaker", "trip", {"name": "codec"}), TICK,
              ("note", "chain", "anomaly", {"cls": "deep-reorg",
                                            "key": "n1"}),
              ("note", "chain", "anomaly", {"cls": "equivocation",
                                            "key": "v1@3", "x": 0.12345,
                                            "y": (1, 2)}), TICK,
              TICK, TICK, perf("decode", "ok", "regressed", 2),
              perf("repair", "ok", "regressed", 2), TICK]
    want = run("jax", script, policies=policies(jrem))
    got = run("port", script, policies=policies(trem))
    for key in ("journal", "witness", "snapshot", "metrics", "edges",
                "notes", "states", "engaged"):
        assert got[key] == want[key], key
    reasons = [e["reason"] for e in got["journal"] if e["event"]
               == "suppress"]
    assert reasons == ["engaged", "rate-limit"]
    assert any(e["policy"] == "off" for e in got["edges"])
    assert not any(e["policy"] == "off" for e in got["journal"])
    assert got["journal"][2]["detail"] == {"cls": "equivocation",
                                           "key": "v1@3", "x": 0.123,
                                           "y": "(1, 2)"}


def test_repair_ingress_flips_and_reprobe_flips_back():
    got = both([("ingress", "m1", 4000, 1000), TICK,
                ("ingress", "m2", 1100, 1000), TICK]
               + [TICK] * 12, lanes=None)
    assert got["modes"]["m1"] == ("symbols", ["fragments", "symbols"],
                                  "symbols")
    assert got["modes"]["m2"] == ("symbols", [], "symbols")
    assert got["journal"][0]["detail"] == {"bound": 1.5, "miner": "m1",
                                           "ratio": 4.0}


def test_policy_table_and_bounds_equal():
    assert trem.ACTIONS == jrem.ACTIONS
    assert [p.row() for p in trem.default_policies()] \
        == [p.row() for p in jrem.default_policies()]
    assert trem._CLASS_BACKEND == jrem._CLASS_BACKEND
    assert tserve.SubmissionEngine._BACKEND_OF \
        == jserve.SubmissionEngine._BACKEND_OF
    for rem in (jrem, trem):
        with pytest.raises(ValueError, match="unknown action"):
            rem.Policy(name="x", trigger=("a", "b"), action="reboot-it")
        with pytest.raises(ValueError, match="max_fires"):
            rem.Policy(name="x", trigger=("a", "b"),
                       action="pin-reference", max_fires=0)
        with pytest.raises(ValueError, match="duplicate"):
            p = rem.default_policies()
            rem.RemediationPlane(b"x", p + (p[0],))
        with pytest.raises(ValueError, match="journal_cap"):
            rem.RemediationPlane(b"x", journal_cap=0)


def test_equivocation_filed_on_a_jax_node():
    """``file-offence`` on the JAX package's node: the port plane, like
    the JAX one, matches the anomaly key against the node's own signed
    vote pair, submits ``offences.report_equivocation`` and the offender
    is slashed; a key without local evidence is journaled unapplied."""
    from cess_tpu.chain.offences import sign_vote
    from cess_tpu.node.chain_spec import ChainSpec, ValidatorGenesis
    from cess_tpu.node.network import Network, Node

    D = constants.DOLLARS
    results = {}
    for pkg in ("jax", "port"):
        spec = ChainSpec(
            name="t", chain_id="port-remediate-equiv",
            endowed=(("alice", 1_000_000_000 * D),),
            validators=tuple(ValidatorGenesis(f"v{i}", 4_000_000 * D)
                             for i in range(3)),
            era_blocks=1000, epoch_blocks=1000, sudo="alice")
        nodes = [Node(spec, f"node{i}", {f"v{i}": spec.session_key(f"v{i}")})
                 for i in range(3)]
        net = Network(nodes)
        net.run_slots(2)
        node, evil = nodes[0], "v2"
        key = spec.session_key(evil)
        g = node.runtime.genesis_hash()
        rnd = node.chain[-1].number + 50
        for target in (b"\xaa" * 32, b"\xbb" * 32):
            node.finality.on_vote(sign_vote(key, g, evil, rnd, target, rnd))
        bond0 = node.runtime.staking.bonded(evil)
        script = [("note", "chain", "anomaly", {
                       "cls": "equivocation", "key": f"{evil}@{rnd}",
                       "to": "bad"}), TICK,
                  ("note", "chain", "anomaly", {
                      "cls": "equivocation", "key": "v1@99", "to": "bad"}),
                  TICK,
                  ("note", "chain", "anomaly", {
                      "cls": "equivocation", "key": f"{evil}@{rnd}",
                      "to": "bad"}), TICK]
        out = run(pkg, script, lanes=None, reporter="alice",
                  bind=lambda plane: plane.bind_node(node))
        net.run_slots(1)
        out["bonds"] = [n.runtime.staking.bonded(evil) for n in nodes]
        out["bond0"] = bond0
        results[pkg] = out
    want, got = results["jax"], results["port"]
    for key in ("journal", "witness", "snapshot", "notes", "bonds"):
        assert got[key] == want[key], key
    assert [(e["event"], e["reason"], e["applied"])
            for e in got["journal"]] == [("fire", "", True),
                                         ("fire", "", False),
                                         ("suppress", "cooldown", False)]
    assert got["bonds"] == [got["bond0"] * 9 // 10] * 3


def test_proactive_repair_through_duck_typed_seams():
    """``custody-repair``: an at-risk edge makes the plane ask the bound
    custody plane for the segment's unhealthy fragments; with no
    restoral order open it files one from the last custodian, and once
    one is open a live rescuer that lacks the fragment repairs it in
    symbol mode. Stubs stand in for the node and the miners."""
    from types import SimpleNamespace

    from cess_tpu.obs import custody as jcustody
    from cess_tpu_torch.obs import custody as tcustody

    frag = bytes(range(32))
    results = {}
    for pkg, custody in (("jax", jcustody), ("port", tcustody)):
        plane_c = custody.CustodyPlane("probe")
        plane_c.ledger.record_dispatch("alice", "ff", 2, 1,
                                       [(b"s", (frag, b"\1" * 32,
                                                b"\2" * 32))])
        plane_c.ledger.record_transfer("m1", "ff", 0, (frag,))
        plane_c.observe_alive({"m1": False, "m2": True})
        orders = {}
        calls = []

        class Node:
            runtime = SimpleNamespace(file_bank=SimpleNamespace(
                restoral_order=lambda f: orders.get(f)))

            def submit_extrinsic(self, who, call, *args):
                calls.append((who, call, args))
                orders[args[1]] = "open"

        class Rescuer(StubMiner):
            store = {}

            def try_repair(self, f, miners):
                calls.append(("repair", self.account, f,
                              [m.account for m in miners]))
                return True

        m1, m2 = Rescuer("m1"), Rescuer("m2")
        m2.repair_mode = "fragments"

        def bind(plane, c=plane_c, miners=(m1, m2)):
            plane.bind_custody(c)
            plane.bind_node(Node())
            plane.bind_miners(list(miners))

        out = run(pkg, [("note", "custody", "at_risk", {
            "key": "ff:0", "frm": "ok", "to": "bad", "margin": 1}),
            TICK, TICK, ("note", "custody", "at_risk", {
                "key": "ff:0", "frm": "bad", "to": "ok", "margin": 2}),
            TICK], lanes=None, bind=bind)
        out["calls"] = calls
        out["m2"] = (m2.repair_mode, m2.modes)
        results[pkg] = out
    want, got = results["jax"], results["port"]
    for key in ("journal", "witness", "snapshot", "calls", "m2"):
        assert got[key] == want[key], key
    calls = got["calls"]
    assert calls[0][:2] == ("m1", "file_bank.generate_restoral_order")
    assert calls[1] == ("repair", "m2", frag, ["m1", "m2"])
    assert got["m2"] == ("symbols", ["symbols"])
    assert [e["event"] for e in got["journal"]] == ["fire", "release"]


def test_journal_and_edge_caps_bound_the_witness():
    script = [perf(f"c{i}", "ok", "regressed", i) for i in range(6)] \
        + [TICK] * 3
    got = both(script, lanes=None, journal_cap=4, edge_cap=3)
    assert len(got["journal"]) == 4 and len(got["edges"]) == 3
    assert got["snapshot"]["journal_total"] == 6
    assert dataclasses.asdict(trem.default_policies()[0]) \
        == dataclasses.asdict(jrem.default_policies()[0])


def test_quarantine_drains_a_placed_batch_to_a_sibling():
    """The port's lanes share a device lock (the JAX engine has none): a
    lane quarantined after a batch was placed on it, while the batch waits
    for that lock, finds its breaker held when it runs and hands the batch
    whole to the sibling (``DevicePool.requeue``); the hold came from the
    driver thread, outside the plane's lock, and the result is
    byte-equal."""
    import time

    import torch

    from cess_tpu_torch.ops.rs_ref import ReferenceCodec

    eng = tserve.make_engine(
        2, 1, rs_backend="cpu", resilience=tres.ResilienceConfig(),
        pool=tserve.DevicePool(["cpu"] * 2),
        policy=tserve.AdmissionPolicy(max_batch_requests=1))
    plane = trem.RemediationPlane(b"drain")
    rec = tflight.FlightRecorder(b"drain")
    rec.add_listener(plane.on_note)
    plane.bind_engine(eng)
    want = ReferenceCodec(2, 1).encode(DATA)
    try:
        with tflight.armed(rec):
            with eng._device_locks[torch.device("cpu")]:
                futs = [eng.submit_encode(DATA) for _ in range(2)]
                deadline = time.monotonic() + 30
                while len(eng.pool.placement_log()) < 2:
                    assert time.monotonic() < deadline
                    time.sleep(0.001)
                tflight.note("fleet", "outlier", instance="cpu.d1",
                             metric="encode_wall_s")
                plane.tick()
                assert eng.pool.lanes[1].monitors["codec"].state == "held"
            outs = [f.result(60) for f in futs]
        assert all(np.array_equal(o, want) for o in outs)
        log = eng.pool.placement_log()
        assert [(row[4], row[5]) for row in log] == [
            (0, "least-loaded"), (1, "least-loaded"), (0, "requeue")]
        snap = eng.pool.snapshot()
        assert [ln["batches"] for ln in snap["lanes"]] == [2, 0]
        assert snap["lanes"][0]["requeues"] == 1
        assert [n["detail"] for n in rec.journal_tail("pool")] == [
            {"op": "encode", "rows": 1, "src": 1, "dst": 0}]
        assert eng.stats_snapshot()["resilience"]["degraded_batches"] == {}
    finally:
        eng.close()
