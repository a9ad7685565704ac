"""The port's chain plane (``cess_tpu_torch/obs/chainwatch.py``) against
the JAX package's on the same inputs.

The port carries no chain: its ``node_state`` and ``market_state`` read
the JAX package's ``Node`` and runtime state duck-typed. Here they read
the same nodes as the JAX readers (a genesis node, and every node of an
``equivocating_validator`` run, round by round) and must build the same
dicts; fed the same dicts, both packages' ``ChainWatch`` must give the
same evidence, transition logs, notes, spans, metrics and witnesses.
"""
import json

import numpy as np
import pytest

from cess_tpu import constants
from cess_tpu.obs import chainwatch as jchain
from cess_tpu.obs import fleet as jfleet
from cess_tpu.obs import flight as jflight
from cess_tpu.obs import trace as jtrace
from cess_tpu_torch.obs import chainwatch as tchain
from cess_tpu_torch.obs import fleet as tfleet
from cess_tpu_torch.obs import flight as tflight
from cess_tpu_torch.obs import trace as ttrace

PKGS = {"jax": (jchain, jfleet, jflight, jtrace),
        "port": (tchain, tfleet, tflight, ttrace)}


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    for _, _, flight, trace in PKGS.values():
        trace.disarm()
        flight.disarm()


def both(fn):
    """``fn(chainwatch_module, fleet_module)`` under each package's armed
    recorder and tracer: equal results, notes and spans."""
    outs = []
    for pkg in ("jax", "port"):
        chain, fleet, flight, trace = PKGS[pkg]
        rec = flight.FlightRecorder(b"chain-parity")
        tracer = trace.Tracer()
        with flight.armed(rec), trace.armed(tracer):
            out = fn(chain, fleet)
        outs.append((out, rec.journal_tail(),
                     [(s["name"], s["attrs"]) for s in tracer.finished()]))
    want, got = outs
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[0] == want[0]
    return got


def states(seed: int, nodes: int = 5, scans: int = 10) -> list:
    """Seeded per-scan consensus states and markets: growing heads,
    stalls, reorgs (hashes below an old head rewritten), double-signed
    slots, conflicting votes, vote locks, audit verdict runs, declared
    capacity beyond what is audited, and some hostile entries."""
    rng = np.random.default_rng(seed)
    heads = [0] * nodes
    fins = [0] * nodes
    forks = [0] * nodes
    script = []
    for scan in range(scans):
        step = []
        for i in range(nodes):
            heads[i] += int(rng.integers(0, 3))
            if rng.random() < 0.6 or i == 0 and scan < 6:
                fins[i] = max(fins[i], heads[i] - int(rng.integers(0, 2)))
            if rng.random() < 0.2:
                forks[i] += int(rng.integers(1, 5))   # a reorg this deep
            tail = {str(n): f"h{n}" + ("x" * forks[i] if n > heads[i] - 4
                                       else "")
                    for n in range(max(0, heads[i] - 8), heads[i] + 1)}
            blocks = [[f"v{int(rng.integers(0, 3))}",
                       int(rng.integers(0, 6)),
                       f"{int(rng.integers(0, 4)):02x}"]
                      for _ in range(int(rng.integers(0, 4)))]
            votes = [[f"v{int(rng.integers(0, 3))}",
                      int(rng.integers(0, 4)), "aa", "bb"]
                     for _ in range(int(rng.random() < 0.2))]
            locks = [[f"v{i}", max(0, heads[i] - int(rng.integers(0, 9)))]
                     for _ in range(int(rng.integers(0, 3)))]
            step.append((f"n{i}", {
                "head": heads[i], "finalized": fins[i],
                "slot": heads[i] * 2, "era": heads[i] // 10,
                "forks": forks[i], "tail": tail, "blocks": blocks,
                "locks": locks, "vote_equivocations": votes}))
        step.append(("hostile", {"head": "x"}))
        step.append(("hostile", {"head": 3}))
        step.append(("hostile", [1, 2]))
        miners = {f"m{j}": {"idle": int(rng.integers(0, 100)),
                            "service": int(rng.integers(0, 100)),
                            "lock": int(rng.integers(0, 10)),
                            "state": "positive",
                            "audited": int(rng.integers(0, 100))}
                  for j in range(4)}
        market = {"miners": miners,
                  "verdicts": {f"m{j}": [int(rng.random() < 0.6 + j / 10)
                                         for _ in range(scan + 1)]
                               for j in range(4)},
                  "restoral": {k: int(rng.integers(0, 5)) for k in (
                      "open", "claimed", "generated", "claims",
                      "completed")}}
        script.append((step, market if scan != 4 else {"miners": 3}))
    return script


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chain_watch_equal_across_packages(seed):
    script = states(seed)

    def fn(chain, fleet):
        w = chain.ChainWatch("probe", stall_lag=3, deep_reorg=2,
                             spike_window=4, spike_fails=2)
        plane = fleet.FleetPlane("probe")
        w.attach_fleet(plane)
        for step, market in script:
            for inst, st in step:
                w.ingest_state(inst, st)
            w.ingest_market(market)
            w.ingest_frame(("n9", None, json.dumps({"chain": step[0][1]})))
            w.seal_round()
            plane.seal_round()
        return {"witness": w.witness(), "snapshot": w.snapshot(),
                "metrics": w.metrics(), "evidence": w.consensus.evidence(),
                "log": w.anomalies.transition_log(),
                "anomalies": w.anomalies.witness(),
                "spikes": w.market.spikes(),
                "stragglers": plane.stragglers.snapshot()}

    out, notes, spans = both(fn)
    assert out["evidence"] and out["log"]
    assert {cls for _, cls, _, _, _ in out["log"]} >= {
        "finality-stall", "equivocation", "audit-failure-spike"}
    assert {n["kind"] for n in notes if n["sys"] == "chain"} == {"anomaly"}
    assert {name for name, _ in spans} == {"chain.anomaly", "fleet.outlier"}


def test_lag_grading_and_hostile_frames_equal():
    for lag in range(0, 14):
        assert tchain.lag_state(lag) == jchain.lag_state(lag)
    frames = (None, 42, ("inst",), ("inst", None, "not-json"),
              ("inst", None, json.dumps(["not", "a", "dict"])),
              ("inst", None, json.dumps({"chain": "bogus"})),
              ("inst", None, json.dumps({"targets": {}})),
              ("inst", None, json.dumps({"chain": {"head": 1}})),
              ("n9", None, json.dumps({"chain": {
                  "head": 4, "finalized": 2,
                  "tail": {str(n): f"h{n}" for n in range(5)}}})))

    def fn(chain, fleet):
        w = chain.ChainWatch("probe")
        for frame in frames:
            w.ingest_frame(frame)
        w.seal_round()
        return w.snapshot(), w.witness()

    (snap, _), _, _ = both(fn)
    assert list(snap["consensus"]["nodes"]) == ["n9"]


def test_readers_equal_on_a_jax_node():
    """``node_state``, ``market_state``, ``self_slo`` and ``scan_node`` on
    a JAX genesis node, and on that node after it authored blocks."""
    from cess_tpu.node.chain_spec import ChainSpec, ValidatorGenesis
    from cess_tpu.node.network import Network, Node

    D = constants.DOLLARS
    spec = ChainSpec(
        name="t", chain_id="port-chainwatch",
        endowed=(("alice", 1_000_000_000 * D),),
        validators=tuple(ValidatorGenesis(f"v{i}", 4_000_000 * D)
                         for i in range(3)),
        era_blocks=1000, epoch_blocks=1000, sudo="alice")
    nodes = [Node(spec, f"node{i}", {f"v{i}": spec.session_key(f"v{i}")})
             for i in range(3)]
    net = Network(nodes)
    seen = []
    for slots in (0, 6):
        net.run_slots(slots)
        for node in nodes:
            st = node.runtime.state
            want = (jchain.node_state(node),
                    jchain.market_state(st, fragment_size=1 << 20))
            got = (tchain.node_state(node),
                   tchain.market_state(st, fragment_size=1 << 20))
            assert got == want
            assert tchain.ChainWatch("x").self_slo(node) \
                == jchain.ChainWatch("x").self_slo(node)
            seen.append(got[0]["head"])

    def fn(chain, fleet):
        w = chain.ChainWatch("node0", fragment_size=constants.FRAGMENT_SIZE)
        for node in nodes:
            w.scan_node(node, node.name)
        w.scan_node(nodes[0])
        w.seal_round()
        return w.witness(), w.metrics()

    both(fn)
    assert max(seen) > 0
    assert tchain.ChainWatch("x").fragment_size == constants.FRAGMENT_SIZE


def test_equivocating_validator_read_by_both_packages(monkeypatch):
    """Every round of a JAX ``equivocating_validator`` run, each alive
    node is read by both packages' ``node_state`` and the lowest alive
    node's runtime by both ``market_state``: equal dicts. A port
    ``ChainWatch`` fed the port's reads beside the scenario's JAX watch
    ends with the same witness, evidence and transition log, and notes
    the same anomalies into the port's recorder as the JAX watch did
    into the run's."""
    from cess_tpu.sim import scenarios

    port = tchain.ChainWatch("sim", fragment_size=constants.FRAGMENT_SIZE)
    reads = []
    orig = scenarios._chainwatch_scrape

    def tee(world, watch, rnd):
        alive = [i for i in range(world.n) if world.alive[i]]
        for i in alive:
            got = tchain.node_state(world.nodes[i])
            assert got == jchain.node_state(world.nodes[i])
            port.ingest_state(f"n{i:03d}", got)
        st = world.nodes[alive[0]].runtime.state
        got = tchain.market_state(st, fragment_size=port.fragment_size)
        assert got == jchain.market_state(st,
                                          fragment_size=port.fragment_size)
        port.ingest_market(got)
        port.seal_round()
        reads.append(len(alive))
        orig(world, watch, rnd)

    monkeypatch.setattr(scenarios, "_chainwatch_scrape", tee)
    rec = tflight.FlightRecorder(b"port-chain")
    with tflight.armed(rec):
        report = scenarios.run_scenario(
            scenarios.SCENARIOS["equivocating_validator"], b"port-chain",
            n_nodes=12, strict=True)
    watch = report.chainwatch
    assert len(reads) == 14
    assert port.witness() == watch.witness()
    assert port.consensus.evidence() == watch.consensus.evidence()
    assert port.anomalies.transition_log() \
        == watch.anomalies.transition_log()
    assert port.snapshot() == watch.snapshot()
    want = [(e["kind"], e["detail"])
            for e in report.recorder.journal_tail("chain")
            if e["kind"] == "anomaly"]
    assert [(e["kind"], e["detail"])
            for e in rec.journal_tail("chain")] == want
    classes = {d["cls"] for _, d in want}
    assert {"equivocation", "finality-stall"} <= classes
