"""The port's fleet plane (``cess_tpu_torch/obs/fleet.py``) and the prom
helpers it stands on, against the JAX package's on the same inputs.

Each test feeds one seeded episode (numpy draws made once, then handed to
both packages) through ``cess_tpu.obs.fleet`` and through the port, each
with its own package's flight recorder and tracer armed, and requires the
same bytes: ``witness()``, ``snapshot()``, the federated ``render()``, the
board's transition log, the stitched traces, the straggler edges, and the
notes and spans each plane announced. Floats are compared exactly: both
packages run the same Python float operations in the same order.
"""
import json
import math

import numpy as np
import pytest

from cess_tpu.obs import fleet as jfleet
from cess_tpu.obs import flight as jflight
from cess_tpu.obs import prom as jprom
from cess_tpu.obs import trace as jtrace
from cess_tpu_torch.obs import fleet as tfleet
from cess_tpu_torch.obs import flight as tflight
from cess_tpu_torch.obs import prom as tprom
from cess_tpu_torch.obs import trace as ttrace

PKGS = {"jax": (jfleet, jflight, jtrace, jprom),
        "port": (tfleet, tflight, ttrace, tprom)}
STATES = ("ok", "ok", "ok", "warn", "burning")
# label values an exposition must escape
TENANTS = ('plain', 'evil "quoted"', "multi\nline", "back\\slash")
GRID = (0.01, 0.05, 0.25, 1.0, 4.0)


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    for _, flight, trace, _ in PKGS.values():
        trace.disarm()
        flight.disarm()


def run_armed(pkg: str, fn):
    """Run ``fn(fleet_module, prom_module)`` with ``pkg``'s recorder and
    tracer armed; returns its result, the journal and the spans'
    (name, sys, attrs)."""
    fleet, flight, trace, prom = PKGS[pkg]
    rec = flight.FlightRecorder(b"fleet-parity")
    tracer = trace.Tracer()
    with flight.armed(rec), trace.armed(tracer):
        out = fn(fleet, prom)
    spans = [(s["name"], s["sys"], s["attrs"]) for s in tracer.finished()]
    return out, rec.journal_tail(), spans


def both(fn):
    """``fn`` through both packages: equal results, notes and spans."""
    want = run_armed("jax", fn)
    got = run_armed("port", fn)
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[0] == want[0]
    return got


def histogram_text(rng, prom, name: str, labels: dict | None = None,
                   grid=GRID, type_line: bool = True) -> list[str]:
    h = prom.Histogram(grid)
    for v in rng.gamma(1.5, 0.2, size=int(rng.integers(0, 40))):
        h.observe(float(v))
    return prom.render_histogram(name, h, labels=labels,
                                 type_line=type_line)


def exposition(rng, inst: int, rnd: int, frames: dict) -> str:
    """One node's scrape: a gauge, a declared counter (reset once by a
    restart), an undeclared ``_total`` counter, a labeled gauge family
    with hostile tenant names, two histogram families (one labeled, one
    on an alien grid for node 5) and, some rounds, malformed lines. The
    histograms are rendered with the JAX package's prom, after checking
    the port's renders the same lines from the same observations."""
    frames[inst] = 0 if rng.random() < 0.08 else \
        frames.get(inst, 0) + int(rng.integers(0, 50))
    lines = ["# TYPE cess_block_height gauge",
             f"cess_block_height {int(rng.integers(0, 100))}",
             "# TYPE cess_gossip_frames_total counter",
             f"cess_gossip_frames_total {frames[inst]}",
             f"cess_rpc_calls_total {rnd * 3 + inst}",
             "# TYPE cess_tenant_bytes gauge"]
    for t in TENANTS:
        lines.append("cess_tenant_bytes" + jprom.format_labels(
            {"tenant": t}) + f" {float(rng.random() * 1e6)}")
    grid = (0.5, 2.0) if inst == 5 else GRID
    state = rng.bit_generator.state
    want = histogram_text(rng, jprom, "cess_upload_seconds", grid=grid)
    rng.bit_generator.state = state
    assert histogram_text(rng, tprom, "cess_upload_seconds",
                          grid=grid) == want
    lines += want
    for i, t in enumerate(TENANTS[:2]):
        lines += histogram_text(rng, jprom, "cess_tenant_latency_seconds",
                                {"tenant": t}, type_line=i == 0)
    if rng.random() < 0.3:
        lines += ['bad_label{k=unquoted} 2', 'truncated{k="open 3',
                  "not_a_number abc", "trailing_garbage",
                  'cess_upload_seconds_bucket{le="x"} 1']
    return "\n".join(lines) + "\n"


def episode(seed: int, rounds: int = 8, n: int = 6):
    """The seeded inputs of one fleet episode, drawn once."""
    rng = np.random.default_rng(seed)
    frames: dict = {}
    script = []
    for rnd in range(rounds):
        step = {"ingest": [], "frames": [], "stragglers": [],
                "dump": None}
        for inst in range(n):
            if rng.random() < 0.15:
                continue                        # a silent node this round
            expo = exposition(rng, inst, rnd, frames) \
                if rng.random() < 0.7 else None
            slo = {"targets": {c: {"state": STATES[int(rng.integers(
                0, len(STATES)))]} for c in ("upload", "verify")}}
            if rng.random() < 0.3:
                step["frames"].append((f"n{inst}", expo or "",
                                       json.dumps(slo, sort_keys=True)))
            else:
                step["ingest"].append((f"n{inst}", expo, slo))
            lag = float(rng.normal(1.0, 0.1))
            if inst == 3 and rnd >= 3:
                lag += 20.0                       # the straggler
            step["stragglers"].append((f"n{inst}", "head_lag", lag))
        # hostile frames: each must be dropped whole
        step["frames"] += [None, ("a",), (7, "x", ""),
                           ("n9", "x", "{not json"),
                           ("n9", "x", '{"targets": 123}'),
                           ("n9", "x", '{"targets": {"c": "burning"}}')]
        if rnd % 3 == 2:
            spans = []
            for sid in range(1, 6):
                spans.append({"name": f"s{sid}", "sys": "t",
                              "span_id": sid,
                              "parent_id": int(rng.integers(0, sid)),
                              "trace_id": int(rng.integers(1, 3)),
                              "remote_parent": bool(rng.random() < 0.3)})
            step["dump"] = (f"n{int(rng.integers(0, n))}", spans)
        script.append(step)
    return script


def drive(script):
    def fn(fleet, prom):
        plane = fleet.FleetPlane("self", latency_families={
            "upload": "cess_upload_seconds"})
        edges = []
        plane.board.add_listener(lambda *a: edges.append(a))
        for step in script:
            for inst, expo, slo in step["ingest"]:
                plane.ingest(inst, exposition=expo, slo=slo)
            for frame in step["frames"]:
                plane.ingest_frame(frame)
            for inst, metric, v in step["stragglers"]:
                plane.stragglers.observe(inst, metric, v)
            if step["dump"] is not None:
                plane.stitcher.add_dump(*step["dump"])
            plane.seal_round()
        fed = plane.federator
        return {"witness": plane.witness(), "snapshot": plane.snapshot(),
                "render": fed.render(), "fed": fed.witness(),
                "log": plane.board.transition_log(), "edges": edges,
                "traces": plane.stitcher.traces(),
                "stitch": plane.stitcher.witness(),
                "merged": fed.merged_histogram(
                    "cess_upload_seconds").snapshot(),
                "p99": fed.merged_histogram(
                    "cess_upload_seconds").quantile(0.99)}
    return fn


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fleet_episode_equal_across_packages(seed):
    out, notes, spans = both(drive(episode(seed)))
    # the episode exercised what it is meant to
    snap = out["snapshot"]
    assert snap["rounds"] == 8 and out["log"]
    assert "n3/head_lag" in snap["stragglers"]["outliers"]
    assert any(n["sys"] == "fleet" and n["kind"] == "outlier"
               and n["detail"]["instance"] == "n3" for n in notes)
    assert any(name == "fleet.transition" for name, _, _ in spans)
    assert out["traces"] and snap["federation"]["histograms"]
    assert "n9" not in snap["federation"]["instances"]


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_prom_helpers_equal_across_packages(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        bounds = tuple(sorted({float(b) for b in rng.gamma(2.0, 0.5, 6)}))
        labels = {f"k{i}": TENANTS[int(rng.integers(0, len(TENANTS)))]
                  for i in range(int(rng.integers(0, 3)))}
        hs = [prom.Histogram(bounds) for prom in (jprom, tprom)]
        for v in rng.exponential(1.0, size=int(rng.integers(0, 30))):
            for h in hs:
                h.observe(float(v))
        want, got = hs
        snap = want.snapshot()
        assert got.snapshot() == snap
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert got.quantile(q) == want.quantile(q)
        for type_line in (True, False):
            assert tprom.render_histogram("m", got, labels, type_line) \
                == jprom.render_histogram("m", want, labels, type_line)
        back = [prom.Histogram.from_cumulative(snap["buckets"],
                                               snap["sum"])
                for prom in (jprom, tprom)]
        assert back[1].snapshot() == back[0].snapshot() == snap
        assert tprom.format_labels(labels) == jprom.format_labels(labels)
        for b in bounds + (math.inf,):
            assert tprom.format_le(b) == jprom.format_le(b)
        for t in TENANTS:
            assert tprom.escape_label(t) == jprom.escape_label(t)
        prev, cur = (float(x) for x in rng.integers(0, 100, 2))
        assert tprom.counter_delta(prev, cur) \
            == jprom.counter_delta(prev, cur) >= 0
    assert tprom.format_labels(None) == jprom.format_labels({}) == ""


@pytest.mark.parametrize("buckets", [
    [(1.0, 3)],                                   # no +Inf
    [(1.0, 3), (math.inf, 2)],                    # decreasing
    [(math.inf, 1)],                              # +Inf alone
])
def test_from_cumulative_refuses_what_the_reference_refuses(buckets):
    with pytest.raises(ValueError) as want:
        jprom.Histogram.from_cumulative(buckets, 1.0)
    with pytest.raises(ValueError) as got:
        tprom.Histogram.from_cumulative(buckets, 1.0)
    assert str(got.value) == str(want.value)


def test_parse_exposition_equal_on_hostile_text():
    text = ('ok_metric 1\nbad_label{k=unquoted} 2\n'
            'truncated{k="never-closed 3\nnot_a_number abc\n'
            'trailing_garbage\n# TYPE h histogram\n# junk comment\n'
            'm' + jprom.format_labels({"k": TENANTS[1], "z": TENANTS[2]})
            + ' 4\nspaced{a="1"} 5\n')
    want = jfleet.parse_exposition(text)
    assert tfleet.parse_exposition(text) == want
    assert [s[0] for s in want["samples"]] == ["ok_metric", "m", "spaced"]


def test_counter_resets_and_hostile_slo_snapshots():
    """A restarted node's counters clamp, a grid no majority shares is
    skipped, malformed SLO snapshots leave the board as they found it:
    the same in both packages."""
    def fn(fleet, prom):
        plane = fleet.FleetPlane("self")
        alien = ("# TYPE cess_upload_seconds histogram\n"
                 'cess_upload_seconds_bucket{le="0.25"} 1\n'
                 'cess_upload_seconds_bucket{le="+Inf"} 1\n'
                 "cess_upload_seconds_sum 0.1\n"
                 "cess_upload_seconds_count 1\n")
        good = ("# TYPE cess_upload_seconds histogram\n"
                'cess_upload_seconds_bucket{le="0.5"} 1\n'
                'cess_upload_seconds_bucket{le="2"} 2\n'
                'cess_upload_seconds_bucket{le="+Inf"} 2\n'
                "cess_upload_seconds_sum 1.0\n"
                "cess_upload_seconds_count 2\n")
        for frames in (5, 8, 2, 9):
            plane.ingest("a", exposition=good
                         + f"cess_gossip_frames_total {frames}\n",
                         slo={"targets": 123})
            plane.ingest("b", exposition=alien,
                         slo={"targets": {"u": "burning"}})
            plane.ingest("c", exposition=good, slo="junk")
            plane.seal_round()
        return plane.snapshot(), plane.witness(), plane.federator.render()

    (snap, _, render), _, _ = both(fn)
    fed = snap["federation"]
    assert fed["counters"]['cess_gossip_frames_total{instance="a"}'] \
        == 17.0                           # 5, +3, restart +2, +7
    assert fed["histograms"]["cess_upload_seconds"]["count"] == 4
    assert snap["board"]["classes"] == {}
    assert "cess_upload_seconds_count 4" in render


def test_straggler_edges_staleness_and_min_nodes():
    """Edge-triggered firing, re-arming when the node rejoins the pack,
    eviction of a silent window, and the flags a scan cannot re-derive
    dropped: the same scans, edges and notes in both packages."""
    def fn(fleet, prom):
        det = fleet.StragglerDetector(window=4, k=4.0, min_nodes=4,
                                      stale_scans=3)
        fired = []
        lags = {"n0": 1.0, "n1": 1.1, "n2": 0.9, "n3": 9.0, "n4": 1.05}
        for scan in range(12):
            for inst, v in sorted(lags.items()):
                if inst == "n4" and scan >= 4:
                    continue                  # n4 goes silent
                if inst == "n3" and 5 <= scan < 8:
                    v = 1.0                   # rejoins the pack
                det.observe(inst, "lag", v + scan * 1e-3)
            fired.append(det.scan())
            fired.append(det.snapshot())
        return fired

    out, notes, spans = both(fn)
    edges = [e for f in out[::2] for e in f]
    assert [e[0] for e in edges] == ["n3", "n3"]
    assert sum(1 for n in notes if n["kind"] == "outlier") == 2
    assert [s[0] for s in spans] == ["fleet.outlier"] * 2


def test_port_admission_attaches_to_the_port_fleet_board():
    """``AdmissionController.attach_fleet`` on the port's ``FleetBoard``:
    quorum burning engages shed and the codec hold, warn keeps it, ok
    releases it; the controller's snapshot equals the JAX controller's
    on the JAX board through the same rounds."""
    from cess_tpu.obs.slo import SloBoard as JBoard
    from cess_tpu.obs.slo import SloTarget as JTarget
    from cess_tpu.resilience import HealthMonitor as JMonitor
    from cess_tpu.serve import AdmissionController as JController
    from cess_tpu_torch.obs.slo import SloBoard, SloTarget
    from cess_tpu_torch.resilience import HealthMonitor
    from cess_tpu_torch.serve import AdmissionController

    def snap(state):
        return {"targets": {"verify": {"state": state}}}

    rounds = [("burning", "ok", "ok"), ("burning", "burning", "ok"),
              ("warn", "warn", "ok"), ("ok", "ok", "ok")]
    results = {}
    for pkg, board_t, target_t, mon_t, ctrl_t in (
            ("jax", JBoard, JTarget, JMonitor, JController),
            ("port", SloBoard, SloTarget, HealthMonitor,
             AdmissionController)):
        fleet, flight, _, _ = PKGS[pkg]
        local = board_t((target_t("verify", 0.02, 0.01),), fast_window=4,
                        slow_window=16, eval_every=4)
        ctrl = ctrl_t(local, protect=("verify",), shed=("encode",))

        class EngineLike:
            monitors = {"codec": mon_t()}

        eng = EngineLike()
        ctrl.bind(eng)
        fb = fleet.FleetBoard()
        ctrl.attach_fleet(fb)
        seen = []
        rec = flight.FlightRecorder(b"fleet-admission")
        with flight.armed(rec):
            for states in rounds:
                fb.scrape_round({f"n{i}": snap(s)
                                 for i, s in enumerate(states)})
                seen.append((ctrl.engaged, eng.monitors["codec"].state,
                             ctrl.admit("encode", 30.0)))
        results[pkg] = (seen, ctrl.snapshot(), fb.snapshot(),
                        rec.journal_tail())
    assert results["port"] == results["jax"]
    seen = results["port"][0]
    assert [s[0] for s in seen] == [False, True, True, False]
    assert seen[1][1:] == ("held", "slo-burning")
    assert seen[3][1:] == ("closed", None)
