"""The port's SLO board, adaptive tuner and admission controller
(cess_tpu_torch.obs.slo, cess_tpu_torch.serve.adaptive) against the JAX
package's on the same seeded inputs, and the engine's SLO plane on the
CPU.

Tolerance: exact. Every transition log, snapshot, series, histogram
snapshot, adjustment log, shed count and anchor choice must be equal;
the planes read no clock, so the same observation sequence gives the
same bytes. Host timings never enter a comparison. The engine-level
drill below runs on the port alone (its timings are the host's) with
decisive margins: the fault delay is 5x the verify objective, and the
objective tens of times the CPU verify floor at this width (a verify of
two fragments of one block, one torch thread); it asserts the episode's
transitions, sheds and bundles, and that a same-seed replay reproduces
them.
"""
import numpy as np
import pytest
import torch

from cess_tpu import obs as jobs
from cess_tpu import serve as jserve
from cess_tpu.obs import flight as jflight
from cess_tpu.obs import slo as jslo
from cess_tpu.resilience import HealthMonitor as JHealthMonitor
from cess_tpu_torch import obs
from cess_tpu_torch.obs import IncidentReporter, flight, slo
from cess_tpu_torch.ops import podr2
from cess_tpu_torch.resilience import (FaultPlan, FaultSpec, HealthMonitor,
                                       ResilienceConfig, faults)
from cess_tpu_torch.serve import (AdaptiveBatchPolicy, AdmissionController,
                                  AdmissionPolicy, EngineShed, StreamingIngest,
                                  SubmissionEngine, make_engine)

K, M = 2, 1


@pytest.fixture(autouse=True)
def _one_thread_and_disarm():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    obs.disarm()
    flight.disarm()
    faults.disarm()
    jobs.disarm()


def rnd(shape, seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)


def boards(targets=(("verify", 0.02, 0.01),), **kw):
    """(port board, JAX board) with the same targets and bounds."""
    return (slo.SloBoard(tuple(slo.SloTarget(*t) for t in targets), **kw),
            jslo.SloBoard(tuple(jslo.SloTarget(*t) for t in targets), **kw))


def hist_snaps(board):
    return [(fam, labels, h.snapshot()) for fam, labels, h in
            board.tenant_histograms()]


def same_board(b, jb):
    assert b.transition_log() == jb.transition_log()
    assert b.snapshot() == jb.snapshot()
    assert b.series() == jb.series()
    assert hist_snaps(b) == hist_snaps(jb)
    for t in b.targets:
        assert b.state(t.cls) == jb.state(t.cls)
    assert b.burning() == jb.burning()


# -- targets and syntax --------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "", "verify:p99=50ms,err=1%;encode:p99=2s", "prove:p99=0.1,err=0.02",
    " verify : p99 = 7ms ; ", "stream:p99=1.5s,err=5%",
    "verify", "verify:err=1%", "verify:p99=50ms,x=1", "verify:p99",
    "verify:p99=0", "verify:p99=1s,err=100%"])
def test_parse_targets_matches_jax(spec):
    def parsed(mod):
        try:
            return [(t.cls, t.p99_s, t.error_rate, t.budget)
                    for t in mod.parse_targets(spec)]
        except ValueError:
            return "ValueError"

    assert parsed(slo) == parsed(jslo)


def test_default_targets_and_validation_match_jax():
    assert [(t.cls, t.p99_s, t.error_rate) for t in slo.DEFAULT_TARGETS] == \
        [(t.cls, t.p99_s, t.error_rate) for t in jslo.DEFAULT_TARGETS]
    assert (slo.STATES, slo.UNTAGGED, slo.OVERFLOW) == \
        (jslo.STATES, jslo.UNTAGGED, jslo.OVERFLOW)
    for args in (("", 0.05), ("verify", 0.0), ("verify", 0.05, 1.0)):
        with pytest.raises(ValueError):
            slo.SloTarget(*args)
    for kw in (dict(fast_window=0), dict(slow_window=2, fast_window=4),
               dict(warn_burn=7.0, page_burn=6.0), dict(max_tenants=0)):
        with pytest.raises(ValueError):
            slo.SloBoard(**kw)
    with pytest.raises(ValueError):
        slo.SloBoard((slo.SloTarget("verify", 0.05),
                      slo.SloTarget("verify", 0.1)))


# -- burn rates ------------------------------------------------------------------

@pytest.mark.parametrize("seed,bounds", [
    (1, dict(fast_window=4, slow_window=16, eval_every=4)),
    (2, dict(fast_window=8, slow_window=32, eval_every=2)),
    (3, dict(fast_window=4, slow_window=8, eval_every=1, warn_burn=0.5,
             page_burn=2.0)),
])
def test_burn_rate_transitions_match_jax(seed, bounds):
    """A synthetic episode: calm, a burst of slow and failed requests,
    calm again, over two targeted classes and an untargeted one, with
    tenants; every log, snapshot, series and histogram equal."""
    targets = (("verify", 0.02, 0.01), ("encode", 0.5, 0.05))
    b, jb = boards(targets, **bounds)
    seen, jseen = [], []
    b.add_listener(lambda *a: seen.append(a))
    jb.add_listener(lambda *a: jseen.append(a))
    rng = np.random.default_rng(seed)
    phases = [(60, 0.004, 0.0), (40, 0.08, 0.2), (90, 0.003, 0.0)]
    for n, scale, fail in phases:
        lats = rng.exponential(scale, n)
        oks = rng.random(n) >= fail
        clss = rng.choice(["verify", "encode", "tag"], n, p=[.6, .3, .1])
        tens = rng.choice(["alice", "bob", None], n)
        rows = rng.integers(1, 9, n)
        for lat, ok, cls, ten, r in zip(lats, oks, clss, tens, rows):
            for board in (b, jb):
                board.observe(str(cls), float(lat), ok=bool(ok),
                              tenant=ten, rows=int(r))
        same_board(b, jb)
    assert seen == jseen and len(seen) >= 2
    assert {x[2] for x in seen} >= {"burning", "ok"}


def test_transition_announcements_match_jax():
    """The span and the flight note of each transition: the same names,
    attributes and journal entries in both packages."""
    b, jb = boards(fast_window=4, slow_window=16, eval_every=4)
    tracer, jtracer = obs.Tracer(), jobs.Tracer()
    rec, jrec = flight.FlightRecorder(b"slo"), jflight.FlightRecorder(b"slo")
    with obs.armed(tracer), flight.armed(rec), jobs.armed(jtracer), \
            jflight.armed(jrec):
        for lat in [1.0] * 8 + [0.001] * 24:
            b.observe("verify", lat)
            jb.observe("verify", lat)
    spans = [(s["name"], s["sys"], s["attrs"]) for s in tracer.finished()]
    jspans = [(s["name"], s["sys"], s["attrs"]) for s in jtracer.finished()]
    assert spans == jspans and len(spans) == 3
    assert rec.journal_tail() == jrec.journal_tail()
    assert [e["detail"]["to"] for e in rec.journal_tail("slo")] == \
        ["burning", "warn", "ok"]


def test_tenant_cap_and_overflow_match_jax():
    b, jb = boards(max_tenants=3)
    for board in (b, jb):
        board.observe("encode", 0.001, tenant="a", rows=4)
        board.observe("encode", 0.001, ok=False, tenant="a")
        board.note_shed("encode", "a")
        board.observe("encode", 0.001)
        for t in ("b", "c", "d", "e"):
            board.observe("verify", 0.03, tenant=t, rows=2)
        board.note_shed("verify", "zz")
    same_board(b, jb)
    tenants = b.snapshot()["tenants"]
    assert set(tenants) == {"a", "-", "b", slo.OVERFLOW}
    assert tenants[slo.OVERFLOW]["verify"]["requests"] == 3
    assert tenants[slo.OVERFLOW]["verify"]["shed"] == 1


# -- the weighted-fair anchor ------------------------------------------------------

def _parked_engines(board, jboard):
    """A port and a JAX engine whose batchers never drain by themselves
    (a long delay, large budgets)."""
    pol = dict(max_delay=30.0, max_batch_requests=64, max_batch_rows=4096)
    eng = make_engine(K, M, rs_backend="cpu", policy=AdmissionPolicy(**pol),
                      slo=board)
    jeng = jserve.make_engine(K, M, rs_backend="jax",
                              policy=jserve.AdmissionPolicy(**pol),
                              slo=jboard)
    return eng, jeng


@pytest.mark.parametrize("served", [
    {"heavy": 10_000, "light": 0},
    {"heavy": 0, "light": 10_000},
    {"heavy": 5, "light": 5, "": 0},
    "over-cap",
])
def test_fair_anchor_matches_jax(served):
    """A crafted queue: the same submits and deficit counters give the
    same anchor and the same drained batch (tenants and rows) in both
    engines."""
    b, jb = boards()
    eng, jeng = _parked_engines(b, jb)
    subs = [((2, K, 64), 0, "heavy"), ((2, K, 64), 1, "heavy"),
            ((2, K, 32), 2, None), ((4, K, 64), 3, "light"),
            ((1, K, 64), 4, "t00"), ((2, K, 64), 5, "newcomer")]
    if served == "over-cap":
        served = {f"t{i:02d}": 10 for i in range(b.max_tenants)}
        served[slo.OVERFLOW] = 10_000
    got = []
    try:
        for e in (eng, jeng):
            for shape, seed, tenant in subs:
                e.submit_encode(rnd(shape, seed), timeout=60, tenant=tenant)
            with e._cond:
                e._tenant_rows["encode"] = dict(served)
                q = e._queues["encode"]
                idx = e._anchor_index("encode", q)
                batch = e._drain("encode")
            got.append((idx, [(r.tenant, r.rows, r.key) for r in batch]))
            for r in batch:
                r.future._resolve(None)
                r.span.finish()
        assert got[0] == got[1]
    finally:
        eng.close(timeout=0.1)
        jeng.close(timeout=0.1)


def test_without_a_board_the_oldest_anchors():
    eng = make_engine(K, M, rs_backend="cpu",
                      policy=AdmissionPolicy(max_delay=30.0))
    try:
        eng.submit_encode(rnd((2, K, 64), 0), timeout=60, tenant="b")
        eng.submit_encode(rnd((2, K, 64), 1), timeout=60, tenant="a")
        with eng._cond:
            assert eng._anchor_index("encode", eng._queues["encode"]) == 0
            batch = eng._drain("encode")
        assert [r.tenant for r in batch] == ["b", "a"]
        assert eng._tenant_rows == {}
        for r in batch:
            r.future._resolve(None)
            r.span.finish()
    finally:
        eng.close(timeout=0.1)


# -- the adaptive tuner ------------------------------------------------------------

@pytest.mark.parametrize("seed,kw", [
    (4, dict(targets={"verify": 0.02}, update_every=4, window=8,
             min_delay_s=0.001, min_rows=8)),
    (5, dict(targets={"verify": 0.01, "encode": 0.5}, update_every=8,
             window=32)),
    (6, dict(update_every=4, window=16, occupancy_target=2.0)),
])
def test_tuner_adjustments_match_jax(seed, kw):
    pol = dict(max_delay=0.01, max_batch_rows=512)
    b, jb = boards((("verify", 0.02, 0.01), ("prove", 0.1)))
    ad = AdaptiveBatchPolicy(AdmissionPolicy(**pol), board=b, **kw)
    jad = jserve.AdaptiveBatchPolicy(jserve.AdmissionPolicy(**pol),
                                     board=jb, **kw)
    rng = np.random.default_rng(seed)
    for scale in (0.05, 0.001, 0.03, 0.0005):
        lats = rng.exponential(scale, 48)
        occ = rng.integers(1, 12, 48)
        clss = rng.choice(["verify", "encode", "prove"], 48)
        for lat, o, cls in zip(lats, occ, clss):
            ad.note(str(cls), float(lat), int(o))
            jad.note(str(cls), float(lat), int(o))
        for cls in ("verify", "encode", "prove", "tag"):
            assert ad.knobs(cls) == jad.knobs(cls)
            assert ad.p99_est(cls) == jad.p99_est(cls)
            assert ad.target_for(cls) == jad.target_for(cls)
    assert ad.adjustment_log() == jad.adjustment_log()
    assert len(ad.adjustment_log()) >= 2
    assert ad.snapshot() == jad.snapshot()
    assert ad.metrics() == jad.metrics()
    for bad in (dict(update_every=0), dict(update_every=8, window=4),
                dict(shrink=1.0), dict(grow=1.0), dict(headroom=0.0)):
        with pytest.raises(ValueError):
            AdaptiveBatchPolicy(**bad)


# -- the admission controller ---------------------------------------------------------

class _FleetBoard:
    """A stand-in fleet board: ``add_listener(fn(cls, view, old, new))``."""

    def __init__(self):
        self.listeners = []

    def add_listener(self, fn):
        self.listeners.append(fn)

    def fire(self, *args):
        for fn in self.listeners:
            fn(*args)


class _EngineLike:
    def __init__(self, mon):
        self.monitors = {"codec": mon}


def test_controller_shed_and_hold_match_jax():
    """Shed and hold across burning -> warn -> ok on a board, then the
    same through a fleet view (a local recovery does not release a
    fleet-held protection); the admit results, controller snapshots,
    breaker states and journals equal in both packages."""
    b, jb = boards(fast_window=4, slow_window=16, eval_every=4)
    mon, jmon = HealthMonitor(), JHealthMonitor()
    mon.name, jmon.name = "codec", "codec"
    ctrl = AdmissionController(b, AdaptiveBatchPolicy(board=b))
    jctrl = jserve.AdmissionController(jb, jserve.AdaptiveBatchPolicy(
        board=jb))
    ctrl.bind(_EngineLike(mon))
    jctrl.bind(_EngineLike(jmon))
    fleet, jfleet = _FleetBoard(), _FleetBoard()
    ctrl.attach_fleet(fleet)
    jctrl.attach_fleet(jfleet)
    rec, jrec = flight.FlightRecorder(b"ctl"), jflight.FlightRecorder(b"ctl")
    trail, jtrail = [], []

    def step(what, *args):
        for c, bd, fl, m, out in ((ctrl, b, fleet, mon, trail),
                                  (jctrl, jb, jfleet, jmon, jtrail)):
            if what == "obs":
                for lat in args[1] * [args[0]]:
                    bd.observe("verify", lat)
            elif what == "fleet":
                fl.fire(*args)
            out.append((bd.state("verify"), c.engaged, m.state,
                        c.admit("encode", 30.0, tenant="bulk"),
                        c.admit("verify", 30.0), c.admit("tag", 30.0)))

    with flight.armed(rec), jflight.armed(jrec):
        step("none")
        step("obs", 1.0, 8)                       # -> burning: engaged
        step("obs", 0.001, 8)                     # -> warn: still engaged
        step("obs", 0.001, 16)                    # -> ok: released
        step("fleet", "verify", "worst", "ok", "burning")   # other view
        step("fleet", "verify", "quorum", "ok", "burning")  # engaged
        step("obs", 1.0, 8)
        step("obs", 0.001, 24)                    # local ok, fleet burning
        step("fleet", "verify", "quorum", "burning", "ok")  # released
        step("fleet", "encode", "quorum", "ok", "burning")  # unprotected
    assert trail == jtrail
    engaged = [t[1] for t in trail]
    assert engaged == [False, True, True, False, False, True, True, True,
                       False, False]
    assert ctrl.snapshot() == jctrl.snapshot()
    assert ctrl.snapshot()["holds"] == 2
    assert mon.snapshot()["holds"] == jmon.snapshot()["holds"] == 2
    assert b.snapshot() == jb.snapshot()
    assert rec.journal_tail() == jrec.journal_tail()


def test_deadline_unmeetable_matches_jax():
    b, jb = boards()
    ad = AdaptiveBatchPolicy(board=b, targets={"encode": 0.01},
                             update_every=4)
    jad = jserve.AdaptiveBatchPolicy(board=jb, targets={"encode": 0.01},
                                     update_every=4)
    ctrl, jctrl = AdmissionController(b, ad), jserve.AdmissionController(
        jb, jad)
    for a in (ad, jad):
        for _ in range(4):
            a.note("encode", 5.0)
    cases = [(1.0, None), (10.0, None), (None, None), (1.0, 0), (1.0, 3)]
    got = [ctrl.admit("encode", t, queued=q) for t, q in cases]
    assert got == [jctrl.admit("encode", t, queued=q) for t, q in cases]
    assert got == ["deadline-unmeetable", None, None, None,
                   "deadline-unmeetable"]
    assert ctrl.snapshot() == jctrl.snapshot()
    assert b.snapshot() == jb.snapshot()


def test_engine_shed_matches_jax():
    """``EngineShed`` through a port engine: the shed counter, the tenant
    accounting, the plane sections and the metric names, beside the JAX
    engine's; after recovery the engine admits again."""
    b, jb = boards(fast_window=4, slow_window=16, eval_every=4)
    pol = dict(max_delay=0.002)
    eng = make_engine(K, M, rs_backend="cpu", policy=AdmissionPolicy(**pol),
                      slo=b, adaptive=True)
    jeng = jserve.make_engine(K, M, rs_backend="jax",
                              policy=jserve.AdmissionPolicy(**pol),
                              slo=jb, adaptive=True)
    tracer = obs.Tracer()
    rec = flight.FlightRecorder(b"shed")
    try:
        assert isinstance(eng.admission, AdmissionController)
        for bd in (b, jb):
            for _ in range(8):
                bd.observe("verify", 1.0)
        with obs.armed(tracer), flight.armed(rec):
            for e, shed in ((eng, EngineShed), (jeng, jserve.EngineShed)):
                for _ in range(3):
                    with pytest.raises(shed, match="slo-burning"):
                        e.encode(rnd((2, K, 64), 3), timeout=5,
                                 tenant="bulk")
        snaps = [e.stats_snapshot() for e in (eng, jeng)]
        for s in snaps:
            assert s["classes"]["encode"]["shed"] == 3
            assert s["classes"]["encode"]["submitted"] == 0
        assert snaps[0]["slo"] == snaps[1]["slo"]
        assert snaps[0]["adaptive"] == snaps[1]["adaptive"]
        assert [(s["name"], s["attrs"]) for s in tracer.finished()] == \
            [("engine.encode", {"cls": "encode", "rows": 2, "op": "encode",
                                "outcome": "shed", "reason": "slo-burning",
                                "tenant": "bulk"})] * 3
        assert [(e["sys"], e["kind"], e["detail"]) for e in
                rec.journal_tail("engine")] == [
            ("engine", "shed", {"cls": "encode", "reason": "slo-burning",
                                "tenant": "bulk"})] * 3
        assert eng.labeled_series() == jeng.labeled_series()
        assert [(f, lab) for f, lab, _ in eng.labeled_histograms()] == \
            [(f, lab) for f, lab, _ in jeng.labeled_histograms()]
        for bd in (b, jb):
            for _ in range(24):
                bd.observe("verify", 0.001)
        for e in (eng, jeng):
            e.encode(rnd((1, K, 64), 4), timeout=30, tenant="bulk")
        m, jm = eng.stats_metrics(), jeng.stats_metrics()
        assert set(m) == set(jm)
        assert m["cess_engine_encode_shed"] == 3
        assert "cess_adaptive_encode_delay_s" in m
        assert eng.stats_snapshot()["slo"] == jeng.stats_snapshot()["slo"]
    finally:
        eng.close()
        jeng.close()


def test_admission_on_a_pool_engine_matches_jax():
    """The planes over a device pool, beside the JAX pool engine: while
    verify burns, encodes are shed and the engine-level codec breaker is
    held (a pool batch is gated by its lane's breakers, in both
    packages); a lane whose codec breaker is held is never probed, so
    every repair lands on its sibling; placements, pool snapshots,
    profile witnesses (the lane index keys the accounts) and results
    are equal."""
    from cess_tpu_torch.obs.profile import ProfilePlane
    from cess_tpu.obs.profile import ProfilePlane as JProfilePlane
    from cess_tpu.resilience import ResilienceConfig as JResilienceConfig
    from cess_tpu_torch.ops import rs
    from cess_tpu_torch.serve import DevicePool

    b, jb = boards(fast_window=4, slow_window=16, eval_every=4)
    plane, jplane = ProfilePlane(), JProfilePlane()
    pol = dict(max_delay=0.002)
    eng = SubmissionEngine(rs.make_codec(K, M, "cpu"), None,
                           AdmissionPolicy(**pol),
                           resilience=ResilienceConfig(), slo=b,
                           adaptive=AdaptiveBatchPolicy(board=b),
                           admission=AdmissionController(
                               b, AdaptiveBatchPolicy(board=b)),
                           pool=DevicePool(["cpu"] * 2), profile=plane)
    jeng = jserve.make_engine(K, M, rs_backend="jax",
                              policy=jserve.AdmissionPolicy(**pol),
                              resilience=JResilienceConfig(), slo=jb,
                              adaptive=True, pool=jserve.DevicePool(n=2),
                              profile=jplane)
    outs = []
    try:
        for e, bd, shed in ((eng, b, EngineShed),
                            (jeng, jb, jserve.EngineShed)):
            for _ in range(8):
                bd.observe("verify", 1.0)
            assert e.monitors["codec"].state == "held"
            with pytest.raises(shed):
                e.encode(rnd((2, K, 64), 1), timeout=30, tenant="bulk")
            e.pool.lanes[0].monitors["codec"].hold_open("slo:verify")
            got = []
            for i in range(6):
                data = rnd((1 + i % 3, K, 64), 10 + i)
                shards = rs.make_codec(K, M, "cpu").encode(data).numpy()
                got.append(e.reconstruct(shards[:, 1:], (1, 2), (0,),
                                         timeout=30, tenant="repairer"))
                assert e.flush(30)
            outs.append(got)
        for x, y in zip(*outs):
            assert np.array_equal(np.asarray(x), np.asarray(y))
        assert eng.pool.placement_log() == jeng.pool.placement_log()
        assert [r[4] for r in eng.pool.placement_log()] == [1] * 6
        assert eng.pool.snapshot() == jeng.pool.snapshot()
        assert plane.witness() == jplane.witness()
        assert eng.admission.snapshot() == jeng.admission.snapshot()
        assert b.snapshot() == jb.snapshot()
        assert eng.stats_snapshot()["classes"]["encode"]["shed"] == 1
    finally:
        eng.close()
        jeng.close()


def test_make_engine_plane_wiring():
    b = slo.SloBoard()
    with pytest.raises(ValueError, match="slo"):
        make_engine(K, M, rs_backend="cpu", adaptive=True)
    eng = make_engine(K, M, rs_backend="cpu", slo=b, adaptive=True,
                      admission=False)
    try:
        assert eng.admission is None
        assert isinstance(eng.adaptive, AdaptiveBatchPolicy)
        assert eng.adaptive.board is b
    finally:
        eng.close()
    ctrl = AdmissionController(b, degrade=True)
    eng = make_engine(K, M, rs_backend="cpu", slo=b, admission=ctrl,
                      resilience=ResilienceConfig())
    try:
        assert eng.admission is ctrl
        assert ctrl.snapshot()["degrade"] is True
    finally:
        eng.close()


# -- the zero-cost-when-off contract ---------------------------------------------------

def test_disarmed_engine_and_stream_allocate_no_plane_objects():
    """With no plane configured the attributes ARE None, requests carry
    the bare None tenant, and after real traffic (an engine's and a
    stream's) no SLO, tenant, adaptive or profile structure exists on
    the engine, its stats, its program cache or its exposition."""
    from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline

    eng = make_engine(K, M, rs_backend="cpu",
                      policy=AdmissionPolicy(max_delay=0.002))
    try:
        assert (eng.slo, eng.adaptive, eng.admission, eng.profile) == \
            (None,) * 4
        assert (eng.stats.slo, eng.stats.adaptive, eng.stats.profile,
                eng.programs.profile) == (None,) * 4
        eng.encode(rnd((2, K, 64), 1), tenant="ignored-without-a-board")
        cfg = PipelineConfig(segment_size=2048, k=K, m=M)
        pipe = StoragePipeline(cfg, device="cpu")
        ing = StreamingIngest(pipe, 2, engine=eng, tenant="gw")
        for _ in ing.run(rnd((3, cfg.segment_size), 2)):
            pass
        assert ing.stats.batches == 2
        assert eng._tenant_rows == {}
        snap = eng.stats_snapshot()
        assert not {"slo", "adaptive", "profile"} & set(snap)
        assert not [k for k in eng.stats_metrics()
                    if k.startswith(("cess_slo", "cess_tenant",
                                     "cess_adaptive", "cess_profile"))]
        assert eng.labeled_series() == [] and eng.labeled_histograms() == []
        assert snap["classes"]["encode"]["shed"] == 0
    finally:
        eng.close()
    fut_eng = make_engine(K, M, rs_backend="cpu",
                          policy=AdmissionPolicy(max_delay=30.0))
    try:
        fut_eng.submit_encode(rnd((1, K, 64), 3), timeout=60)
        with fut_eng._cond:
            (req,) = fut_eng._queues["encode"]
            assert req.tenant is None
    finally:
        fut_eng.close()


def test_planes_are_accepted_by_the_constructor():
    b = slo.SloBoard()
    ad = AdaptiveBatchPolicy(board=b)
    ctrl = AdmissionController(b, ad)
    from cess_tpu_torch.obs.profile import ProfilePlane
    from cess_tpu_torch.ops import rs

    plane = ProfilePlane()
    eng = SubmissionEngine(rs.make_codec(K, M, "cpu"), None, None, slo=b,
                           adaptive=ad, admission=ctrl, profile=plane)
    try:
        assert (eng.slo, eng.adaptive, eng.admission, eng.profile) == \
            (b, ad, ctrl, plane)
        assert eng.programs.profile is plane
        # no resilience: no breaker, shed-only admission
        assert ctrl.snapshot()["degrade"] is False
    finally:
        eng.close()


# -- the engine-level SLO drill ------------------------------------------------------

OBJECTIVE_S = 0.20      # verify p99 objective: tens of CPU verify floors
FAULT_DELAY_S = 1.00    # the seeded dispatch delay: 5x the objective
VERIFIES_1, VERIFIES_2 = 4, 20


def _drill(seed: bytes):
    """Phase 1, every dispatch delayed by a seeded plan: one encode, 4
    verifies (the 4th evaluation turns verify burning), 3 encodes (shed),
    a numpy repair (served on the CPU reference through the held codec
    breaker, no dispatch). Phase 2, fault-free: 20 rounds of an encode
    (shed until verify is back at ok) and a verify. Returns the evidence
    a replay must reproduce."""
    key = podr2.Podr2Key.generate(44, device="cpu")
    blocks = 1
    ids = np.stack([np.arange(2, dtype=np.uint32),
                    np.zeros(2, dtype=np.uint32)], axis=1)
    idx, nu = podr2.gen_challenge(b"slo-drill", blocks, device="cpu")
    mu = np.zeros((2, podr2.SECTORS), dtype=np.uint32)
    sigma = np.zeros((2, key.limbs), dtype=np.uint32)
    board = slo.SloBoard((slo.SloTarget("verify", OBJECTIVE_S, 0.01),),
                         fast_window=4, slow_window=16, eval_every=4)
    adaptive = AdaptiveBatchPolicy(board=board)
    admission = AdmissionController(board, adaptive, protect=("verify",),
                                    shed=("encode",))
    rec = flight.FlightRecorder(seed)
    eng = make_engine(K, M, rs_backend="cpu", podr2_key=key,
                      audit_backend="cpu",
                      policy=AdmissionPolicy(max_delay=0.002),
                      resilience=ResilienceConfig(), slo=board,
                      adaptive=adaptive, admission=admission)
    reporter = IncidentReporter(rec, engine=eng)
    plan = FaultPlan.seeded(seed, {"engine.dispatch": (
        1.0, FaultSpec("delay", delay_s=FAULT_DELAY_S))}, horizon=64)
    bulk = rnd((1, K, 512), 7)
    sheds, held, repaired = 0, None, None

    def encode():
        nonlocal sheds
        try:
            eng.encode(bulk, timeout=30, tenant="bulk")
        except EngineShed:
            sheds += 1

    try:
        with flight.armed(rec):
            with faults.armed(plan):
                encode()
                for _ in range(VERIFIES_1):
                    eng.verify_batch(ids, blocks, idx, nu, mu, sigma,
                                     timeout=30, tenant="auditor")
                for _ in range(3):
                    encode()
                held = (board.state("verify"), eng.monitors["codec"].state)
                shards = eng._fallback_codec.encode(bulk)
                got = eng.reconstruct(shards[:, :2], (0, 1), (2,),
                                      timeout=30, tenant="repairer")
                repaired = np.array_equal(got, shards[:, 2:])
            for _ in range(VERIFIES_2):
                encode()
                eng.verify_batch(ids, blocks, idx, nu, mu, sigma,
                                 timeout=30, tenant="auditor")
        snap = eng.stats_snapshot()
    finally:
        eng.close()
    return dict(log=board.transition_log(), sheds=sheds, held=held,
                repaired=repaired, snap=snap, fired=plan.fired_log(),
                bundles=[(b["trigger"], b["key"]) for b in
                         reporter.bundles()],
                witness=reporter.witness(),
                admission=admission.snapshot())


def test_slo_drill_on_the_port_and_its_replay():
    one = _drill(b"port-slo-drill")
    assert one["log"] == (("verify", "ok", "burning", 4),
                          ("verify", "burning", "warn", 8),
                          ("verify", "warn", "ok", 20))
    assert one["held"] == ("burning", "held")
    assert one["repaired"] is True
    # 3 in phase 1, then the 16 phase-2 rounds before verify's 20th
    # observation released the hold
    assert one["sheds"] == 19
    enc = one["snap"]["classes"]["encode"]
    assert enc["shed"] == 19 and enc["completed"] == 1 + 4
    assert one["snap"]["slo"]["tenants"]["bulk"]["encode"] == {
        "requests": 5, "failed": 0, "shed": 19, "rows": 5}
    res = one["snap"]["resilience"]
    assert res["breakers"]["codec"]["holds"] == 1
    assert res["breakers"]["codec"]["state"] == "closed"
    assert res["degraded_batches"].get("repair", 0) == 1
    assert [f[0] for f in one["fired"]] == ["engine.dispatch"] * 5
    assert one["admission"]["sheds"] == {"encode": {"slo-burning": 19}}
    assert ("slo-burning", "verify") in one["bundles"]
    assert ("breaker-hold", "codec:slo:verify") in one["bundles"]
    assert ("shed-storm", "encode:slo-burning") in one["bundles"]
    two = _drill(b"port-slo-drill")
    for k in ("log", "sheds", "fired", "bundles", "witness", "admission"):
        assert two[k] == one[k], k
