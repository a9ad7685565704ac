"""The port's profile plane and incident reporter (cess_tpu_torch.obs.
profile, cess_tpu_torch.obs.incident) against the JAX package's on the
same seeded inputs, fed directly and through both packages' engines and
streaming ingests on the CPU.

Tolerance: exact for every canon, ledger, log and witness; the host
timings the planes carry are excluded, as in the JAX canon. The
``BENCH_r*.json`` records and ``tests/data/bench_baseline_r05.json``
were taken on a TPU: here they are parse fixtures for the loaders and
the perf drill's anchor on the CPU (the drill's faulted windows sit
orders of magnitude below any baseline), never a yardstick for a card.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from cess_tpu import serve as jserve
from cess_tpu.models import pipeline as jpipeline
from cess_tpu.obs import flight as jflight
from cess_tpu.obs import incident as jincident
from cess_tpu.obs import profile as jprofile
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.resilience import faults as jfaults
from cess_tpu_torch.convert import pipeline_from_arrays, podr2_key_from_arrays
from cess_tpu_torch.obs import flight, incident, profile
from cess_tpu_torch.resilience import faults
from cess_tpu_torch.serve import StreamingIngest, make_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "BENCH_r05.json")
FIXTURE = os.path.join(REPO, "tests", "data", "bench_baseline_r05.json")
ENCODE_METRIC = "rs_4p8_encode_GiBps_per_chip"
K, M = 2, 1
SEG = K * 512


@pytest.fixture(autouse=True)
def _one_thread_and_disarm():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    flight.disarm()
    faults.disarm()


def rnd(shape, seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)


# -- the loaders -------------------------------------------------------------------

def test_loaders_match_jax(tmp_path):
    assert profile.TRACKED_DEFAULT == jprofile.TRACKED_DEFAULT
    assert profile.STATES == jprofile.STATES
    got = profile.parse_bench_record(BENCH)
    assert got == jprofile.parse_bench_record(BENCH)
    assert got[ENCODE_METRIC] > 0
    assert profile.load_baseline(FIXTURE) == jprofile.load_baseline(FIXTURE)
    assert profile.latest_bench_baseline(REPO) == \
        jprofile.latest_bench_baseline(REPO)
    # raw JSONL with garbage, NaN and non-finite rows; the round ordering
    raw = tmp_path / "BENCH_r07.json"
    raw.write_text('noise\n{"metric": "a", "value": 1.5}\n{"metric": "b"}\n'
                   '{"metric": "c", "value": NaN}\n{broken\n'
                   '{"metric": "d", "value": "2"}\n[1, 2]\n')
    (tmp_path / "BENCH_r10.json").write_text(json.dumps(
        {"n": 10, "tail": '{"metric": "z", "value": 3}\n'}))
    (tmp_path / "BENCH_rx.json").write_text("{}")
    for fn, arg in ((profile.parse_bench_record, str(raw)),
                    (profile.latest_bench_baseline, str(tmp_path)),
                    (profile.latest_bench_baseline, str(tmp_path / "none"))):
        assert fn(arg) == getattr(jprofile, fn.__name__)(arg)
    assert profile.latest_bench_baseline(str(tmp_path)) == {"z": 3.0}
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"source": "x"}))
    for mod in (profile, jprofile):
        with pytest.raises(ValueError):
            mod.load_baseline(str(bad))


# -- the four parts, fed the same sequence -----------------------------------------

def _feed(mod, seed: int, baseline: dict | None):
    """A seeded sequence of engine dispatches, stream steps and compile
    events into a ProfilePlane of ``mod``; returns the plane."""
    plane = mod.ProfilePlane(baseline=baseline, guard=0.5, window=3)
    rng = np.random.default_rng(seed)
    for _ in range(60):
        kind = rng.choice(["batch", "stream", "compile"], p=[.6, .3, .1])
        if kind == "batch":
            bucket = int(2 ** rng.integers(0, 5))
            rows = int(rng.integers(1, bucket + 1))
            plane.on_batch(str(rng.choice(["encode", "tag", "verify"])),
                           bucket, int(rng.integers(0, 3)), rows=rows,
                           padded=bucket - rows,
                           requests=int(rng.integers(1, 4)),
                           nbytes=int(rng.integers(0, 1 << 20)),
                           queue_s=float(rng.random()),
                           dispatch_s=float(rng.exponential(1e-3)),
                           sync_s=float(rng.random() * 1e-4))
        elif kind == "stream":
            batch = int(rng.integers(1, 9))
            plane.on_stream(batch=batch, rows=int(rng.integers(1, batch + 1)),
                            nbytes=int(rng.integers(0, 1 << 24)),
                            device=int(rng.integers(0, 2)),
                            h2d_s=float(rng.random() * 1e-3),
                            dispatch_s=float(rng.exponential(1e-2)))
        else:
            plane.compile_event(("encode", int(rng.integers(0, 3)), (K, 64),
                                 b"\x01", True), float(rng.random()))
    return plane


def _snap_counts(snap: dict) -> dict:
    """A profile snapshot without its host timings."""
    out = json.loads(json.dumps(snap))
    for acct in out["ops"]["accounts"]:
        for k in ("queue_s", "h2d_s", "dispatch_s", "sync_s"):
            acct.pop(k)
    out["ops"].pop("windowed_GiBps")
    for prog in out["compiles"]["programs"].values():
        prog.pop("wall_s")
    out["compiles"].pop("events")
    if out["watchdog"] is not None:
        out["watchdog"].pop("last_GiBps")
    return out


def _ledger_counts(ledgers: dict) -> dict:
    """The two ledgers of an incident bundle without the build times."""
    return _snap_counts(dict(ledgers, watchdog=None, ops={
        "accounts": [], "windowed_GiBps": {}}))


@pytest.mark.parametrize("seed,baseline", [
    (1, None),
    (2, {ENCODE_METRIC: 0.5, "stream_encode_tag_GiBps": 0.05}),
    (3, {ENCODE_METRIC: 1e6}),
])
def test_plane_parts_match_jax(seed, baseline):
    plane = _feed(profile, seed, baseline)
    jplane = _feed(jprofile, seed, baseline)
    assert plane.witness() == jplane.witness()
    assert plane.ops.canon() == jplane.ops.canon()
    assert plane.pads.canon() == jplane.pads.canon()
    assert plane.pads.ranked() == jplane.pads.ranked()
    assert plane.pads.total() == jplane.pads.total()
    assert plane.compiles.canon() == jplane.compiles.canon()
    assert plane.ops.windowed_gibps() == jplane.ops.windowed_gibps()
    assert plane.metrics() == jplane.metrics()
    assert _snap_counts(plane.snapshot()) == _snap_counts(jplane.snapshot())
    assert _ledger_counts(plane.ledgers()) == \
        _ledger_counts(jplane.ledgers())
    if baseline:
        wd, jwd = plane.watchdog, jplane.watchdog
        assert wd.transition_log() == jwd.transition_log()
        assert wd.canon() == jwd.canon()
        assert wd.regressed() == jwd.regressed()
    else:
        assert plane.watchdog is None and jplane.watchdog is None


def test_watchdog_edges_and_announcements_match_jax():
    """Edge-triggered both ways, a zero-busy window counted fast, an
    unanchored metric ignored; the same listener calls, spans and
    journal entries in both packages."""
    from cess_tpu import obs as jobs
    from cess_tpu_torch import obs

    wd = profile.PerfWatchdog({"m": 1.0}, guard=0.5, window=2)
    jwd = jprofile.PerfWatchdog({"m": 1.0}, guard=0.5, window=2)
    calls, jcalls = [], []
    wd.add_listener(lambda *a: calls.append(a))
    jwd.add_listener(lambda *a: jcalls.append(a))
    tracer, jtracer = obs.Tracer(), jobs.Tracer()
    rec, jrec = flight.FlightRecorder(b"wd"), jflight.FlightRecorder(b"wd")
    gib = 1 << 30
    seq = [("m", gib, 10.0), ("m", gib, 10.0), ("x", 1, 1.0),
           ("m", gib, 0.1), ("m", gib, 0.1), ("m", 5, 0.0), ("m", 5, 0.0),
           ("m", gib, 8.0), ("m", gib, 8.0)]
    try:
        with obs.armed(tracer), flight.armed(rec), jobs.armed(jtracer), \
                jflight.armed(jrec):
            for args in seq:
                wd.observe(*args)
                jwd.observe(*args)
    finally:
        jobs.disarm()
        obs.disarm()
    assert calls == jcalls == [("m", "ok", "regressed", 1),
                               ("m", "regressed", "ok", 2),
                               ("m", "ok", "regressed", 4)]
    assert wd.transition_log() == jwd.transition_log()
    snap, jsnap = wd.snapshot(), jwd.snapshot()
    assert snap == jsnap
    assert [(s["name"], s["attrs"]) for s in tracer.finished()] == \
        [(s["name"], s["attrs"]) for s in jtracer.finished()]
    assert rec.journal_tail() == jrec.journal_tail()
    for kw in ({"guard": 0.0}, {"guard": 1.5}, {"window": 0},
               {"max_transitions": 0}):
        with pytest.raises(ValueError):
            profile.PerfWatchdog({"m": 1.0}, **kw)


# -- through the engines -----------------------------------------------------------

def _keys():
    jkey = jpodr2.Podr2Key.generate(21, jpodr2.Podr2Params(limbs=2))
    key = podr2_key_from_arrays(np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                "cpu")
    return jkey, key


def _engine_traffic(eng, ids, frags, idx, nu):
    """Sequential encodes (coalescing none, pad rows some), tags of u32
    ids, a verify of zero proofs and a repeat of a cached shape."""
    eng.encode(rnd((3, K, 64), 1), timeout=30)
    eng.encode(rnd((3, K, 64), 1), timeout=30)
    eng.encode(rnd((5, K, 64), 2), timeout=30)
    eng.reconstruct(rnd((2, 2, 64), 3), (0, 1), (2,), timeout=30)
    eng.tag_fragments(ids, frags, timeout=30)
    eng.verify_batch(ids, 2, idx, nu, np.zeros((3, jpodr2.SECTORS),
                                               np.uint32),
                     np.zeros((3, 2), np.uint32), timeout=30)


def test_engine_feed_matches_jax():
    """The same requests through both engines: the per-(class, bucket,
    lane) accounts, the pad ledger and the compile ledger are equal,
    bytes counted as the protocol carries them (a u32 word is 4 bytes
    in both packages)."""
    jkey, key = _keys()
    plane, jplane = profile.ProfilePlane(), jprofile.ProfilePlane()
    eng = make_engine(K, M, rs_backend="cpu", podr2_key=key,
                      audit_backend="cpu", profile=plane)
    jeng = jserve.make_engine(K, M, rs_backend="jax", podr2_key=jkey,
                              audit_backend="cpu", profile=jplane)
    ids = rnd((3, 2), 4, np.uint32)
    frags = rnd((3, 1024), 5)
    idx, nu = jpodr2.gen_challenge(b"prof", 2)
    idx, nu = np.asarray(idx), np.asarray(nu)
    try:
        _engine_traffic(eng, ids, frags, idx, nu)
        _engine_traffic(jeng, ids, frags, idx, nu)
        assert plane.witness() == jplane.witness()
        assert eng.stats_metrics()["cess_profile_pad_rows_total"] == \
            jeng.stats_metrics()["cess_profile_pad_rows_total"] > 0
        assert _snap_counts(eng.stats_snapshot()["profile"]) == \
            _snap_counts(jeng.stats_snapshot()["profile"])
        canon = json.loads(plane.witness())
        assert canon["ops"]["accounts"]["tag|4|d0"]["bytes"] == 3 * 8 + 3072
        assert canon["compiles"]["builds"] == 5
    finally:
        eng.close()
        jeng.close()


def test_stream_and_engine_pads_unify_as_in_jax():
    """A 7-row ragged stream (batches 4 + 3, the tail padded by 1) and
    the same rows through the engine (4 and 3 rows, the 3 padded to 4)
    land in one pad ledger, equal to the JAX package's."""
    jkey = jpodr2.Podr2Key.generate(31, jpodr2.Podr2Params(limbs=2))
    jpipe = jpipeline.StoragePipeline(
        jpipeline.PipelineConfig(k=K, m=M, segment_size=SEG), podr2_key=jkey)
    pipe = pipeline_from_arrays(K, M, SEG, jpodr2.SECTORS,
                                np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                device="cpu")
    plane, jplane = profile.ProfilePlane(), jprofile.ProfilePlane()
    eng = make_engine(K, M, rs_backend="cpu", profile=plane)
    jeng = jserve.make_engine(K, M, rs_backend="jax", profile=jplane)
    from cess_tpu.serve.stream import StreamingIngest as JStreamingIngest

    segs = rnd((7, SEG), 8)
    try:
        ing = StreamingIngest(pipe, 4, engine=eng)
        out = ing.ingest(segs)
        jout = JStreamingIngest(jpipe, 4, engine=jeng).ingest(segs)
        assert np.array_equal(out["fragments"].numpy(),
                              np.asarray(jout["fragments"]))
        for e in (eng, jeng):
            e.encode(rnd((4, K, 64), 9), timeout=30)
            e.encode(rnd((3, K, 64), 10), timeout=30)
    finally:
        eng.close()
        jeng.close()
    assert plane.pads.canon() == jplane.pads.canon()
    assert plane.ops.canon() == jplane.ops.canon()
    assert plane.pads.total()["sources"] == {"engine": 1, "stream": 1}
    by_key = {(c, b): a for c, b, a in plane.pads.ranked()}
    assert by_key[("stream", 4)]["padded"] == by_key[("encode", 4)]["padded"]\
        == 1
    # on the CPU the stream's batch is done when its program returns:
    # its busy time covers staging and the program, no more than the run
    acct = [a for a in plane.snapshot()["ops"]["accounts"]
            if a["cls"] == "stream"][0]
    assert 0 < acct["h2d_s"] + acct["dispatch_s"] <= ing.stats.wall_s


def test_program_cache_feeds_compiles_on_miss_only():
    plane = profile.ProfilePlane()
    eng = make_engine(K, M, rs_backend="cpu", profile=plane)
    try:
        data = rnd((1, K, 64), 4)
        eng.encode(data, timeout=30)
        assert plane.compiles.canon()["builds"] == 1
        eng.encode(data, timeout=30)                 # a hit
        assert plane.compiles.canon()["builds"] == 1
        eng.encode(rnd((3, K, 64), 4), timeout=30)   # a new bucket
        assert plane.compiles.canon() == {
            "builds": 2, "programs": {"(encode,2,64,1)": 1,
                                      "(encode,2,64,4)": 1}}
        m = eng.stats_metrics()
        assert m["cess_profile_compile_builds"] == 2
        assert m["cess_profile_watchdog_armed"] == 0
    finally:
        eng.close()


# -- the perf drill, replayed on the port ---------------------------------------------

DRILL_DELAY_S = 0.05
DRILL_WINDOW = 2


def _perf_drill(seed: bytes, port: bool):
    """tests/test_profile.py's drill: 4 sequential encodes through an
    engine whose dispatch a seeded plan delays, under an armed flight
    recorder with a profile-aware IncidentReporter, on ``port``'s
    objects or the JAX package's."""
    baseline = jprofile.latest_bench_baseline(REPO)
    prof, fl, inc, fa = (profile, flight, incident, faults) if port else \
        (jprofile, jflight, jincident, jfaults)
    plane = prof.ProfilePlane(baseline=baseline, window=DRILL_WINDOW)
    eng = make_engine(K, M, rs_backend="cpu", profile=plane) if port else \
        jserve.make_engine(K, M, profile=plane)
    rec = fl.FlightRecorder(seed)
    rep = inc.IncidentReporter(rec, engine=eng, profile=plane)
    plan = fa.FaultPlan.seeded(seed, {"engine.dispatch": (
        1.0, fa.FaultSpec(kind="delay", delay_s=DRILL_DELAY_S))}, horizon=16)
    data = rnd((1, K, 64), 7)
    try:
        with fl.armed(rec), fa.armed(plan):
            for _ in range(2 * DRILL_WINDOW):
                eng.encode(data, timeout=30)
    finally:
        eng.close()
    return plane, rep, plan


def test_perf_drill_replays_the_jax_witness():
    plane, rep, plan = _perf_drill(b"perf-drill", port=True)
    jplane, jrep, jplan = _perf_drill(b"perf-drill", port=False)
    assert plan.fired_log() == jplan.fired_log()
    assert [f[0] for f in plan.fired_log()] == ["engine.dispatch"] * 4
    wd = plane.watchdog
    assert wd.transition_log() == jplane.watchdog.transition_log() == (
        (DRILL_WINDOW, ENCODE_METRIC, "ok", "regressed", 1),)
    assert plane.witness() == jplane.witness()
    (b,), (jb,) = rep.bundles(), jrep.bundles()
    assert (b["trigger"], b["key"]) == ("perf-regression", ENCODE_METRIC)
    assert b["canon"] == jb["canon"]
    prof = b["snapshots"]["profile"]
    assert prof["pads"] == jb["snapshots"]["profile"]["pads"]
    assert prof["pads"]["total"]["served"] == 2
    assert prof["compiles"]["builds"] == 1
    m = plane.metrics()
    assert (m["cess_profile_regressions_total"], m["cess_profile_regressed"]) \
        == (1, 1)
    json.dumps(b)
    again, _, again_plan = _perf_drill(b"perf-drill", port=True)
    assert again.witness() == plane.witness()
    assert again_plan.fired_log() == plan.fired_log()


# -- the incident reporter ----------------------------------------------------------

NOTES = [
    ("engine", "saturated", {"cls": "encode"}),
    ("slo", "transition", {"cls": "verify", "frm": "ok", "to": "warn"}),
    ("slo", "transition", {"cls": "verify", "frm": "warn", "to": "burning"}),
    ("breaker", "hold", {"name": "codec", "reason": "slo:verify"}),
    ("breaker", "trip", {"name": "audit", "reason": ""}),
    ("adaptive", "adjust", {"cls": "verify", "count": 16, "p99": 0.3,
                            "delay": 0.001, "rows": 256}),
    *[("engine", "shed", {"cls": "encode", "reason": "slo-burning",
                          "tenant": "bulk"})] * 9,
    ("perf", "regression", {"metric": "m", "frm": "regressed", "to": "ok",
                            "window": 2}),
    ("perf", "regression", {"metric": "m", "frm": "ok", "to": "regressed",
                            "window": 3}),
    ("engine", "escape", {"error": "RuntimeError('x')"}),
    ("stream", "escape", {"error": "OSError('y')"}),
    ("slo", "transition", {"cls": "verify", "frm": "ok", "to": "burning"}),
    ("slo", "transition", {"cls": "prove", "frm": "ok", "to": "burning"}),
    *[("repair", "fallback", {"miner": "m1"})] * 3,
    ("sim", "invariant", {"context": "round3"}),
    ("fleet", "outlier", {"instance": "n2", "metric": "lag"}),
    ("chain", "anomaly", {"cls": "deep-reorg", "to": "bad", "key": "h9"}),
    ("chain", "anomaly", {"cls": "made-up", "to": "bad", "key": "h9"}),
    ("custody", "at_risk", {"key": "seg1", "to": "bad"}),
    ("remediation", "flap", {"policy": "p", "key": "k"}),
    ("breaker", "trip", {"name": "audit", "reason": ""}),
    ("breaker", "trip", {"name": "codec", "reason": ""}),
    ("breaker", "trip", {"name": "audit", "reason": "x"}),
]


def _reporter(mod, fl, seed, **kw):
    rec = fl.FlightRecorder(seed)
    rep = mod.IncidentReporter(rec, max_per_class=2, shed_storm=4,
                               repair_degraded=3, **kw)
    for sys_, kind, detail in NOTES:
        rec.note(sys_, kind, **detail)
    return rec, rep


def test_incident_reporter_witness_matches_jax():
    _, rep = _reporter(incident, flight, b"inc", profile=_feed(
        profile, 9, None))
    _, jrep = _reporter(jincident, jflight, b"inc", profile=_feed(
        jprofile, 9, None))
    assert rep.witness() == jrep.witness()
    assert rep.snapshot() == jrep.snapshot()
    assert [(b["trigger"], b["key"], b["seq"]) for b in rep.bundles()] == \
        [(b["trigger"], b["key"], b["seq"]) for b in jrep.bundles()]
    triggers = rep.snapshot()["triggers"]
    assert triggers["shed-storm"] == 1 and triggers["slo-burning"] == 2
    assert triggers["breaker-trip"] == 2 and "perf-regression" in triggers
    assert rep.rate_limited == jrep.rate_limited >= 1
    assert rep.deduplicated == jrep.deduplicated >= 1
    for b, jb in zip(rep.bundles(), jrep.bundles()):
        assert b["canon"] == jb["canon"]
        assert b["journal"] == jb["journal"]
        assert b["snapshots"]["profile"] == jb["snapshots"]["profile"]
        json.dumps(b)
    dump = rep.dump(limit=2)
    assert len(dump["bundles"]) == 2 and dump["reporter"] == rep.snapshot()
    for bad in (dict(max_per_class=0), dict(shed_storm=0)):
        with pytest.raises(ValueError):
            incident.IncidentReporter(flight.FlightRecorder(b""), **bad)


def test_incident_bundle_embeds_engine_planes():
    """A reporter on a port engine with a board, a tuner, admission and
    a profile plane: a bundle snapshots each of them, and its canon is
    the JAX reporter's over the same notes."""
    from cess_tpu_torch.obs.slo import SloBoard
    from cess_tpu_torch.resilience import ResilienceConfig

    plane = profile.ProfilePlane()
    eng = make_engine(K, M, rs_backend="cpu", resilience=ResilienceConfig(),
                      slo=SloBoard(), adaptive=True, profile=plane)
    try:
        eng.encode(rnd((3, K, 64), 1), timeout=30)
        rec = flight.FlightRecorder(b"eng")
        rep = incident.IncidentReporter(rec, engine=eng)
        assert rep.board is eng.slo and rep.profile is plane
        jrec = jflight.FlightRecorder(b"eng")
        jrep = jincident.IncidentReporter(jrec)
        for r in (rec, jrec):
            r.note("breaker", "hold", name="codec", reason="slo:verify")
        (b,), (jb,) = rep.bundles(), jrep.bundles()
        assert b["canon"] == jb["canon"]
        snaps = b["snapshots"]
        assert {"engine", "breakers", "slo", "adaptive", "admission",
                "profile", "flight"} <= set(snaps)
        assert snaps["profile"]["pads"]["total"] == {
            "served": 3, "padded": 1, "sources": {"engine": 1}}
        assert snaps["engine"]["classes"]["encode"]["completed"] == 1
        json.dumps(b)
    finally:
        eng.close()

