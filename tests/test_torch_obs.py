"""The port's tracing and flight-recorder planes (cess_tpu_torch.obs.trace,
cess_tpu_torch.obs.flight) against the JAX package's (cess_tpu.obs) on
the same span sequences, and the spans the port's engine records.

Span ids, parents, attributes, events, the Chrome export and the flight
recorder's replay witness must equal the JAX package's; only clock
readings (``ts``, ``dur``, event ``t_s``, ``latency_s``) differ and are
left out of the comparisons.
"""
import threading

import jax
import numpy as np
import pytest

from cess_tpu import resilience as jres
from cess_tpu import serve as jserve
from cess_tpu.obs import flight as jflight
from cess_tpu.obs import trace as jtrace
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.resilience import faults as jfaults
from cess_tpu_torch import obs
from cess_tpu_torch import resilience as tres
from cess_tpu_torch.convert import podr2_key_from_arrays
from cess_tpu_torch.obs import flight, trace
from cess_tpu_torch.resilience import faults
from cess_tpu_torch.serve import AdmissionPolicy, make_engine

K, M = 2, 1
FRAG = 1024


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    for mod in (trace, flight, faults, jtrace, jflight, jfaults):
        mod.disarm()


def rnd(shape, seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)


def untimed(export: dict) -> dict:
    """A Chrome export without its clock readings."""
    events = []
    for e in export["traceEvents"]:
        args = dict(e["args"])
        args["events"] = [{k: v for k, v in ev.items() if k != "t_s"}
                          for ev in args["events"]]
        args.pop("latency_s", None)
        events.append({**{k: v for k, v in e.items()
                          if k not in ("ts", "dur")}, "args": args})
    return {**export, "traceEvents": events}


def span_sequence(tr, tracer):
    """One span sequence: nested current spans, explicit parents, a
    remote parent, attrs of every JSON guest, events, a span finished on
    another thread, an unfinished span, an error unwinding a span, and a
    late child whose parent a small ring has evicted."""
    with tr.armed(tracer):
        with tr.span("upload", sys="pipeline", segments=3) as root:
            root.set(blob=b"\x01\xff", n=np.int64(7), xs=(1, 2.5),
                     arr=np.arange(2))
            with tr.span("encode", sys="pipeline") as enc:
                tr.event("fault", site="rs.encode", ordinal=0)
                enc.event("batched", members=2)
                assert tr.current_span() is enc
            assert tr.context() == (tracer.trace_id, root.span_id)
            cross = tracer.start("engine.tag", sys="engine", parent=root,
                                 cls="tag")
            t = threading.Thread(target=lambda: cross.finish(outcome="ok"))
            t.start()
            t.join(10)
            tracer.start("never finished", parent=root)
            with pytest.raises(ValueError):
                with tr.span("verify", sys="engine"):
                    raise ValueError("bad proof")
        tracer.start("net.recv", remote=(99, 5), peer="v1").finish()
        tracer.start("orphan", remote=(99, 0)).finish()
        tracer.start("late", parent=root).finish()
    return tracer


def test_unarmed_hooks_return_the_noop_singleton():
    trace.disarm()
    assert trace.span("x", sys="y", a=1) is trace.NOOP_SPAN
    assert trace.current_span() is trace.NOOP_SPAN
    assert trace.context() is None and trace.armed_tracer() is None
    trace.event("fault", site="x")                  # no current span
    sp = trace.NOOP_SPAN
    assert sp.set(a=1) is sp and sp.event("e") is sp and sp.finish() is sp
    with sp as entered:
        assert entered is sp
    assert not sp and sp.span_id == sp.trace_id == 0
    assert obs.NOOP_SPAN is trace.NOOP_SPAN
    flight.disarm()
    flight.note("engine", "saturated", cls="encode")     # no-op
    tracer = trace.Tracer()
    assert tracer.flight is None and not tracer.device_annotations


@pytest.mark.parametrize("capacity,filt", [(4096, None), (3, None),
                                           (4096, 99)])
def test_span_ids_and_chrome_export_match_reference(capacity, filt):
    got = span_sequence(trace, trace.Tracer(capacity=capacity, trace_id=7))
    want = span_sequence(jtrace, jtrace.Tracer(capacity=capacity,
                                               trace_id=7))
    assert got.started == want.started == 8
    assert got.dropped == want.dropped
    assert [(s["span_id"], s["parent_id"], s["trace_id"], s["name"])
            for s in got.finished()] == \
        [(s["span_id"], s["parent_id"], s["trace_id"], s["name"])
         for s in want.finished()]
    a = untimed(got.export_chrome(trace_id=filt))
    b = untimed(want.export_chrome(trace_id=filt))
    assert a == b and a["traceEvents"]
    assert untimed(got.export_chrome(limit=2)) == \
        untimed(want.export_chrome(limit=2))
    if capacity == 3:
        assert any(e["args"].get("truncated_parent")
                   for e in a["traceEvents"])
    with pytest.raises(ValueError):
        trace.Tracer(capacity=0)


def test_fault_and_retry_events_annotate_the_active_span():
    def run(tr, mod, hooks):
        tracer = tr.Tracer()
        plan = mod.FaultPlan({"engine.dispatch": {
            0: mod.FaultSpec("delay", delay_s=0.001),
            1: mod.FaultSpec("raise")}})
        pol = mod.RetryPolicy(max_attempts=3, base_delay_s=0.0,
                              jitter_frac=0.0)
        with tr.armed(tracer), hooks.armed(plan):
            with tr.span("request", sys="engine") as sp:
                hooks.inject("engine.dispatch")
                with pytest.raises(mod.FaultInjected):
                    hooks.inject("engine.dispatch")
                with pytest.raises(KeyError):
                    pol.call(lambda b: {}["k"], retry_on=(KeyError,),
                             cls="tag", sleep=lambda s: None)
        return [(name, attrs) for _, name, attrs in sp.events]

    got = run(trace, tres, faults)
    assert got == run(jtrace, jres, jfaults)
    assert [n for n, _ in got] == ["fault", "fault", "retry", "retry",
                                   "retry.abandon"]
    assert got[1][1] == {"site": "engine.dispatch", "ordinal": 1,
                         "kind": "raise"}


def offer_sequence(tr, fl):
    """Traces with every pin reason, over two threads' worth of late
    children, and journal notes with listeners."""
    tracer = tr.Tracer(capacity=8)
    rec = fl.FlightRecorder(b"flight-seed", baseline_rate=0.5,
                            objectives={"verify": 0.0}, pin_budget=12,
                            pending_cap=3)
    tracer.attach_flight(rec)
    heard = []
    rec.add_listener(lambda *entry: heard.append(entry))
    for i in range(12):
        root = tracer.start(f"engine.{('encode', 'tag', 'verify')[i % 3]}",
                            sys="engine", cls=("encode", "tag",
                                               "verify")[i % 3], rows=i)
        batch = tracer.start("engine.batch", parent=root, op="encode",
                             degraded=i % 4 == 1, backend="primary")
        dev = tracer.start("device.encode", parent=batch)
        if i % 5 == 2:
            dev.event("fault", site="engine.dispatch", ordinal=i)
        dev.finish()
        batch.finish()
        root.finish(outcome=("ok", "error", "timeout", "saturated")[i % 4],
                    latency_s=0.001 * i)
        if i % 6 == 0:
            tracer.start("late", parent=batch).finish()
        rec.note("breaker", ("trip", "recover")[i % 2], name="codec")
    with fl.armed(rec):
        fl.note("engine", "saturated", cls="tag")
    return rec, heard


def test_flight_witness_matches_reference():
    rec, heard = offer_sequence(trace, flight)
    jrec, jheard = offer_sequence(jtrace, jflight)
    assert repr(rec.witness()).encode() == repr(jrec.witness()).encode()
    assert rec.witness()
    assert rec.snapshot() == jrec.snapshot()
    assert rec.journal_tail() == jrec.journal_tail()
    assert rec.journal_tail("breaker", 3) == jrec.journal_tail("breaker", 3)
    assert heard == jheard and len(heard) == 13

    def pins(r):
        return [{k: v for k, v in p.items() if k != "spans"}
                for p in r.pinned()]

    assert pins(rec) == pins(jrec)
    with pytest.raises(ValueError):
        flight.FlightRecorder(baseline_rate=2.0)


def test_engine_request_spans_cover_submit_to_resolve():
    jkey = jpodr2.Podr2Key.generate(5)
    key = podr2_key_from_arrays(np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                "cpu")
    tracer = trace.Tracer(device_annotations=True)
    eng = make_engine(K, M, rs_backend="cpu", audit_backend="cpu",
                      podr2_key=key, policy=AdmissionPolicy(max_delay=0.05),
                      tracer=tracer)
    try:
        futs = [eng.submit_encode(rnd((1, K, 128), i), tenant="alice")
                for i in range(2)]
        for f in futs:
            f.result(timeout=30)
        frags = rnd((2, FRAG), 3)
        eng.tag_fragments(np.array([[1, 0], [2, 0]], np.uint32), frags)
    finally:
        eng.close()
    spans = {s["span_id"]: s for s in tracer.finished()}
    reqs = [s for s in spans.values() if s["name"] == "engine.encode"]
    assert len(reqs) == 2
    batch = next(s for s in spans.values() if s["name"] == "engine.batch"
                 and s["attrs"]["op"] == "encode")
    dev = next(s for s in spans.values() if s["name"] == "device.encode")
    assert batch["parent_id"] == reqs[0]["span_id"]
    assert dev["parent_id"] == batch["span_id"]
    assert batch["attrs"]["members"] == 2
    assert batch["attrs"]["backend"] == dev["attrs"]["backend"] == "primary"
    for r in reqs:
        a = r["attrs"]
        assert (a["outcome"], a["tenant"], a["occupancy"]) == ("ok", "alice",
                                                               2)
        assert a["batch_span"] == batch["span_id"]
        # opened at submit (on this thread), closed at resolve (on the
        # batcher's): it covers the batch and the device dispatch
        assert r["ts_s"] <= batch["ts_s"] <= dev["ts_s"]
        assert r["ts_s"] + r["dur_s"] >= dev["ts_s"] + dev["dur_s"]
        assert r["tid"] == threading.get_ident() != dev["tid"]
        assert [e["name"] for e in r["events"]] == ["batched"]
    assert {s["name"] for s in spans.values()} >= {"engine.tag",
                                                   "device.tag"}


def test_engine_chaos_witness_matches_reference():
    """One seeded chaos workload through both engines, each with a
    tracer and an attached flight recorder: the same pinned traces
    (request, batch, device and fallback spans, their outcomes and
    errors) and the same breaker journal."""
    jkey = jpodr2.Podr2Key.generate(9)
    key = podr2_key_from_arrays(np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                "cpu")
    sites = {"engine.dispatch": (0.5, "raise"), "rs.encode": (0.5, "raise")}

    def run(port: bool):
        tr, fl, mod, hooks = (trace, flight, tres, faults) if port \
            else (jtrace, jflight, jres, jfaults)
        tracer = tr.Tracer()
        rec = fl.FlightRecorder(b"chaos")
        tracer.attach_flight(rec)
        res = mod.ResilienceConfig(monitor=lambda: mod.HealthMonitor(
            min_samples=2, probe_every=2))
        if port:
            eng = make_engine(K, M, rs_backend="cpu", audit_backend="cpu",
                              podr2_key=key, resilience=res, tracer=tracer,
                              policy=AdmissionPolicy(max_delay=0.002))
        else:
            eng = jserve.make_engine(K, M, rs_backend="jax", podr2_key=jkey,
                                     resilience=res, tracer=tracer,
                                     policy=jserve.AdmissionPolicy(
                                         max_delay=0.002))
        outs = []
        try:
            with fl.armed(rec), hooks.armed(mod.FaultPlan.seeded(
                    b"obs-chaos", sites, horizon=64)) as plan:
                for seed in range(6):
                    outs.append(eng.encode(rnd((1, K, 64), seed),
                                           timeout=60))
        finally:
            eng.close()
        return rec, plan.fired_log(), outs

    (rec, log, outs), (jrec, jlog, jouts) = run(True), run(False)
    assert log and log == jlog
    assert all(np.array_equal(a, b) for a, b in zip(outs, jouts))
    assert repr(rec.witness()) == repr(jrec.witness())
    assert rec.snapshot()["anomaly_pins"] >= 1
    assert rec.journal_tail("breaker") == jrec.journal_tail("breaker")
    assert [e["kind"] for e in rec.journal_tail("breaker")][:1] == ["trip"]
    names = {s["name"] for p in rec.pinned() for s in p["spans"]}
    assert {"engine.encode", "engine.batch", "device.encode",
            "resilience.fallback"} <= names
    degraded = [s for p in rec.pinned() for s in p["spans"]
                if s["name"] == "device.encode" and s["attrs"]["degraded"]]
    assert all(s["attrs"]["backend"] == "cpu-fallback" for s in degraded)


# -- host stages and the profiler's one call site -------------------------------
def counted_record_function(monkeypatch):
    """Count every ``torch.profiler.record_function`` made from now on."""
    import torch

    made = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        made.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return made


def counted_spans(monkeypatch):
    """Count every ``Span`` made from now on."""
    made = []
    real = trace.Span.__init__

    def counting(self, *args, **kwargs):
        made.append(args[1])
        real(self, *args, **kwargs)

    monkeypatch.setattr(trace.Span, "__init__", counting)
    return made


def test_stage_off_opens_no_span_and_no_range(monkeypatch):
    made = counted_record_function(monkeypatch)
    spans = counted_spans(monkeypatch)
    trace.disarm()
    clocks = {}
    st = trace.stage("host.step.part", clocks, "step.part")
    with st as sp:
        assert sp is trace.NOOP_SPAN
        assert st._span is None and st._range is None
    assert not hasattr(st, "__dict__")
    assert made == [] and spans == []
    assert set(clocks) == {"step", "step.part"}
    assert clocks["step"] == clocks["step.part"] > 0


def test_stage_parts_sum_to_the_stage_and_errors_pass():
    clocks = {}
    with trace.stage("s", clocks):
        with trace.stage("s.a", clocks, "s.a"):
            pass
        with trace.stage("s.b", clocks, "s.b"):
            pass
    with pytest.raises(ValueError):
        with trace.stage("t", clocks, "t"):
            raise ValueError("kept")
    assert list(clocks) == ["s.a", "s", "s.b", "t"]
    assert clocks["s"] == clocks["s.a"] + clocks["s.b"]
    assert clocks["t"] > 0


def test_stage_under_a_tracer_is_a_current_child_span():
    tracer = trace.Tracer()
    clocks = {}
    with trace.armed(tracer):
        with trace.span("root", sys="x") as root:
            with trace.stage("root.a", clocks, "a") as a:
                assert isinstance(a, trace.Span)
                assert trace.current_span() is a
                with trace.stage("root.a.b", clocks, "a.b") as b:
                    assert b.parent_id == a.span_id
            assert trace.current_span() is root
    spans = {s["name"]: s for s in tracer.finished()}
    assert spans["root.a"]["parent_id"] == spans["root"]["span_id"]
    assert spans["root.a.b"]["parent_id"] == spans["root.a"]["span_id"]
    assert clocks["a"] >= clocks["a.b"] > 0


def test_stage_under_the_profiler_opens_one_range(monkeypatch):
    import torch

    made = counted_record_function(monkeypatch)
    clocks = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.stage("host.outer", clocks):
            with trace.stage("host.outer.inner", clocks, "outer.inner"):
                torch.ones(4).add_(1)
    assert made == ["host.outer", "host.outer.inner"]
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("host.")}
    assert set(ranges) == {"host.outer", "host.outer.inner"}
    outer, inner = ranges["host.outer"], ranges["host.outer.inner"]
    assert outer.start <= inner.start and inner.end <= outer.end


@pytest.mark.parametrize("armed", [True, False])
def test_engine_and_stream_annotations_enter_through_profiler_range(
        monkeypatch, armed):
    """The engine's batch dispatch and the stream's batch dispatch open
    their ranges through ``trace.profiler_range``, as armed as before."""
    from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
    from cess_tpu_torch.serve.stream import StreamingIngest

    opened = []
    real = trace.profiler_range
    monkeypatch.setattr(trace, "profiler_range",
                        lambda name: opened.append(name) or real(name))
    tracer = trace.Tracer(device_annotations=armed)
    eng = make_engine(K, M, rs_backend="cpu", tracer=tracer)
    try:
        eng.submit_encode(rnd((1, K, 128))).result(timeout=30)
    finally:
        eng.close()
    pipe = StoragePipeline(PipelineConfig(k=K, m=M, segment_size=8192),
                           device="cpu")
    with trace.armed(tracer):
        StreamingIngest(pipe, 2).ingest(rnd((3, 8192), 4))
    assert opened == (["cess:encode", "cess_stream#0", "cess_stream#1"]
                      if armed else [])
