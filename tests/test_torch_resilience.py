"""The port's resilience plane (cess_tpu_torch.resilience and the engine's
and stream's fault seams) against the JAX package's (cess_tpu.resilience)
on the same seeded plans and inputs.

Every case runs through both packages: schedules, firing logs, hook
outcomes, retry delays and breaker states must be equal, and engine
results byte-equal (the port returns field elements as int32 where the
JAX package returns uint32, so values are compared). Port engines run
with ``rs_backend="cpu", audit_backend="cpu"``, JAX engines with
``rs_backend="jax"`` on the CPU. A breaker snapshot's
``mean_latency_s`` is a host-clock reading and is left out of the
comparisons; every count and state is compared.
"""
import time

import jax
import numpy as np
import pytest
import torch

from cess_tpu import resilience as jres
from cess_tpu import serve as jserve
from cess_tpu.models import pipeline as jpipeline
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.ops import rs as jrs
from cess_tpu.resilience import faults as jfaults
from cess_tpu.serve import stream as jstream
from cess_tpu_torch import _build
from cess_tpu_torch import resilience as tres
from cess_tpu_torch.convert import pipeline_from_arrays, podr2_key_from_arrays
from cess_tpu_torch.ops import rs
from cess_tpu_torch.resilience import (Budget, FaultInjected, FaultPlan,
                                       FaultSpec, HealthMonitor,
                                       ResilienceConfig, RetryPolicy, faults)
from cess_tpu_torch.serve import (AdmissionPolicy, EngineSaturated,
                                  EngineUnavailable, StreamingIngest,
                                  SubmissionEngine, make_engine)

K, M = 2, 1
FRAG = 1024               # bytes per fragment: 2 PoDR2 blocks


@pytest.fixture(autouse=True)
def _always_disarm():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    faults.disarm()
    jfaults.disarm()


def rnd(shape, seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.astype(np.int64),
                                                 b.astype(np.int64))


def keys(seed=44, limbs=2):
    jkey = jpodr2.Podr2Key.generate(seed, jpodr2.Podr2Params(limbs=limbs))
    key = podr2_key_from_arrays(np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                "cpu")
    return jkey, key


def engine(port: bool, res, policy=None, key_pair=None, audit=True):
    """The port's engine (``port``) or the JAX package's, with one
    geometry, key and policy and the package's own ResilienceConfig."""
    policy = policy or AdmissionPolicy(max_delay=0.002)
    jkey, key = key_pair or keys()
    if port:
        return make_engine(K, M, rs_backend="cpu", audit_backend="cpu",
                           podr2_key=key if audit else None, policy=policy,
                           resilience=res)
    jpol = jserve.AdmissionPolicy(**{
        f: getattr(policy, f) for f in ("queue_cap", "max_batch_requests",
                                        "max_batch_rows", "max_delay",
                                        "default_timeout")})
    return jserve.make_engine(K, M, rs_backend="jax",
                              podr2_key=jkey if audit else None,
                              policy=jpol, resilience=res)


def stable(snap: dict) -> dict:
    """A ResilienceStats snapshot without the breakers' host-clock mean."""
    out = dict(snap)
    out["breakers"] = {name: {k: v for k, v in b.items()
                              if k != "mean_latency_s"}
                       for name, b in snap["breakers"].items()}
    return out


def resilience_metrics(eng) -> dict:
    return {k: v for k, v in eng.stats_metrics().items()
            if k.startswith("cess_resilience_")}


def spec_table(plan) -> dict:
    return {site: {n: (s.kind, s.message, s.delay_s, s.xor)
                   for n, s in specs.items()}
            for site, specs in plan.schedule.items()}


# -- plans, hooks, retry, breakers ----------------------------------------------

@pytest.mark.parametrize("seed,horizon", [(b"seed-1", 128), ("seed-2", 64),
                                          (b"chip-chaos", 256)])
def test_seeded_plan_schedule_matches_reference(seed, horizon):
    sites = {"engine.dispatch": (0.3, "raise"), "net.send": (0.5, "drop"),
             "stream.h2d": (0.25, "delay"),
             "podr2.tag.cuda": (0.5, FaultSpec("corrupt", xor=0x21))}
    jsites = dict(sites, **{"podr2.tag.cuda": (0.5, jres.FaultSpec(
        "corrupt", xor=0x21))})
    plan = FaultPlan.seeded(seed, sites, horizon=horizon)
    jplan = jres.FaultPlan.seeded(seed, jsites, horizon=horizon)
    assert spec_table(plan) == spec_table(jplan)
    assert plan.seed == jplan.seed
    assert all(0 < len(v) < horizon for v in plan.schedule.values())
    for kwargs in ({"kind": "boom"}, {"kind": "delay"},
                   {"kind": "corrupt", "xor": 0}):
        with pytest.raises(ValueError):
            FaultSpec(**kwargs)
        with pytest.raises(ValueError):
            jres.FaultSpec(**kwargs)


def test_hooks_fire_at_the_reference_ordinals():
    def plan_of(mod):
        return mod.FaultPlan({
            "a.raise": {1: mod.FaultSpec("raise", message="boom")},
            "b.drop": {0: mod.FaultSpec("drop"), 2: mod.FaultSpec("drop")},
            "c.corrupt": {0: mod.FaultSpec("corrupt", xor=0x01),
                          2: mod.FaultSpec("corrupt", xor=0x80)},
            "d.delay": {0: mod.FaultSpec("delay", delay_s=0.01)},
        })

    def drive(mod, hooks, payload):
        seen = []
        with hooks.armed(plan_of(mod)) as plan:
            for _ in range(3):
                try:
                    hooks.inject("a.raise")
                    seen.append("ok")
                except RuntimeError as e:
                    seen.append(str(e))
            seen.append([hooks.allow("b.drop") for _ in range(4)])
            seen.append(hooks.corrupt("c.corrupt", b"\x10\x20"))
            seen.append(np.asarray(hooks.corrupt("c.corrupt",
                                                 payload)).tolist())
            seen.append(np.asarray(hooks.corrupt("c.corrupt",
                                                 payload)).tolist())
            t0 = time.perf_counter()
            hooks.inject("d.delay")
            seen.append(time.perf_counter() - t0 >= 0.01)
        return seen, plan.fired_log(), plan.counts()

    data = np.array([4, 5], dtype=np.uint8)
    got = drive(tres, faults, torch.from_numpy(data))
    want = drive(jres, jfaults, data)
    assert got == want
    assert got[0][1] == "injected fault at a.raise#1: boom"
    assert got[0][6] == [4 ^ 0x80, 5]        # the tensor path flips too
    assert faults.armed_plan() is None
    faults.inject("anything")                 # unarmed: no-ops
    assert faults.allow("anything") is True
    assert faults.corrupt("anything", b"xy") == b"xy"


def test_retry_delays_and_budgets_match_reference():
    pol = RetryPolicy(max_attempts=4, base_delay_s=0.01, multiplier=2.0,
                      max_delay_s=0.03, jitter_frac=0.5)
    jpol = jres.RetryPolicy(max_attempts=4, base_delay_s=0.01,
                            multiplier=2.0, max_delay_s=0.03,
                            jitter_frac=0.5)
    for token in ("", "encode", b"tag", 7):
        assert [pol.delay_for(a, token) for a in range(1, 9)] == \
            [jpol.delay_for(a, token) for a in range(1, 9)]
    assert RetryPolicy(jitter_frac=0).delay_for(3) == \
        jres.RetryPolicy(jitter_frac=0).delay_for(3)

    def run(policy, mod, seconds):
        stats = mod.ResilienceStats()
        slept, seen = [], []

        def fn(budget):
            seen.append(budget.remaining() is None)
            raise KeyError("transient")

        with pytest.raises(KeyError):
            policy.call(fn, retry_on=(KeyError,), budget=mod.Budget(seconds),
                        token="x", stats=stats, cls="encode",
                        sleep=slept.append)
        return slept, seen, stats.snapshot()

    for seconds in (None, 10.0, 0.001):
        assert run(pol, tres, seconds) == run(jpol, jres, seconds)
    assert Budget(None).remaining() is None and not Budget(None).expired()
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)


def test_health_monitor_sequences_match_reference():
    script = (["err"] * 3 + ["allow"] * 4 + ["ok", "err", "allow", "allow",
                                              "err"] + ["allow"] * 3
              + ["ok", "allow", "hold", "allow", "err", "release", "allow",
                 "force_open", "allow", "allow", "ok", "force_close",
                 "ok", "err", "err", "err", "err", "hold", "release",
                 "allow", "allow", "allow", "ok"])

    def run(mon):
        mon.name = "codec"
        out = []
        for step in script:
            if step == "allow":
                out.append(mon.allow())
            elif step == "ok":
                mon.record_success(0.0)
            elif step == "err":
                mon.record_error()
            elif step == "hold":
                mon.hold_open("slo")
            elif step == "release":
                mon.release()
            else:
                getattr(mon, step)()
            out.append((mon.state, mon.snapshot()))
        return out

    for kw in ({}, {"window": 4, "error_threshold": 0.75, "min_samples": 2,
                    "probe_every": 3}):
        assert run(HealthMonitor(**kw)) == run(jres.HealthMonitor(**kw))
    with pytest.raises(ValueError):
        HealthMonitor(window=0)
    cfg = ResilienceConfig()
    assert cfg.fallback and isinstance(cfg.monitor(), HealthMonitor)


# -- the engine --------------------------------------------------------------

@pytest.mark.parametrize("limbs", [2, 3])
def test_identical_seed_identical_faults_and_outputs(limbs):
    """The JAX package's replay workload (tests/test_resilience.py) in
    both engines: the same fired_log (and twice the same in the port),
    byte-equal outputs that equal the clean direct path, and equal
    resilience snapshots and cess_resilience_* metrics."""
    key_pair = keys(71, limbs)
    sites = {"engine.dispatch": (0.5, "raise"), "rs.encode": (0.4, "raise")}

    def run_once(port: bool):
        mod = tres if port else jres
        hooks = faults if port else jfaults
        plan = mod.FaultPlan.seeded(b"replay", sites, horizon=256)
        use = engine(port, mod.ResilienceConfig(), key_pair=key_pair)
        outs = []
        try:
            with hooks.armed(plan):
                for seed in range(4):
                    outs.append(use.encode(rnd((2, K, 128), seed),
                                           timeout=60))
                frags = rnd((3, FRAG), 9)
                ids = np.stack([jpodr2.fragment_id_from_hash(
                    bytes([limbs, i]) * 16) for i in range(3)])
                tags = use.tag_fragments(ids, frags, timeout=60)
                outs.append(tags)
                idx, nu = (np.asarray(x) for x in jpodr2.gen_challenge(
                    b"replay-round", tags.shape[1]))
                r = np.asarray(jpodr2.aggregate_coeffs(b"replay-round", ids))
                mu, sigma = use.prove_aggregate(frags, tags, idx, nu, r,
                                                timeout=60)
                outs.extend([np.asarray(mu), np.asarray(sigma)])
                ok = use.verify_aggregate(ids, tags.shape[1], idx, nu, r,
                                          mu, sigma, timeout=60)
        finally:
            use.close()
        return (plan.fired_log(), plan.counts(), outs, ok,
                use.resilience.stats.snapshot(), resilience_metrics(use))

    got, again, want = run_once(True), run_once(True), run_once(False)
    assert got[0], "the plan never fired: the run tested nothing"
    assert got[0] == again[0] == want[0]          # sites, ordinals, kinds
    assert got[1] == want[1]                      # every crossing
    assert got[3] is want[3] is True
    assert len(got[2]) == len(want[2]) == 7
    for a, b, c in zip(got[2], again[2], want[2]):
        assert same(a, b) and same(a, c)
    codec = jrs.make_codec(K, M, backend="cpu")
    for seed, out in enumerate(got[2][:4]):
        assert same(out, codec.encode(rnd((2, K, 128), seed)))
    assert got[2][6].shape == (limbs,)
    assert stable(got[4]) == stable(again[4]) == stable(want[4])
    assert sum(got[4]["fallback_batches"].values()) >= 1
    assert got[5] == want[5]


def test_device_failure_degrades_to_cpu_bit_identical():
    """Every dispatch fails: the breaker trips, batches serve on the CPU
    reference with equal bytes, and probes close it once the faults
    stop; step for step as the JAX engine does."""
    def run(port: bool):
        mod = tres if port else jres
        hooks = faults if port else jfaults
        res = mod.ResilienceConfig(monitor=lambda: mod.HealthMonitor(
            min_samples=2, probe_every=2))
        plan = mod.FaultPlan.seeded(b"degrade",
                                    {"engine.dispatch": (1.0, "raise")},
                                    horizon=4096)
        use = engine(port, res)
        outs, states = [], []
        try:
            with hooks.armed(plan):
                for seed in range(6):
                    outs.append(use.encode(rnd((2, K, 128), seed),
                                           timeout=60))
                    states.append(use.monitors["codec"].state)
            tripped = (stable(res.stats.snapshot()), resilience_metrics(use))
            for seed in range(20):
                outs.append(use.encode(rnd((1, K, 128), 50 + seed),
                                       timeout=60))
                states.append(use.monitors["codec"].state)
                if states[-1] == "closed":
                    break
        finally:
            use.close()
        return (plan.fired_log(), outs, states, tripped,
                stable(res.stats.snapshot()), resilience_metrics(use))

    got, want = run(True), run(False)
    assert got[0] and got[0] == want[0]
    assert len(got[1]) == len(want[1])
    codec = rs.TorchCodec(K, M, "cpu")
    for a, b in zip(got[1], want[1]):
        assert same(a, b)
        assert same(a, codec.encode(torch.from_numpy(b.astype(np.uint8)
                                                     [:, :K])))
    assert got[2] == want[2] and got[2][-1] == "closed"
    assert "open" in got[2]
    assert got[3] == want[3]
    snap, metrics = got[3]
    assert snap["fallback_batches"]["encode"] >= 1
    assert snap["degraded_batches"]["encode"] >= 1
    assert metrics["cess_resilience_breaker_codec_open"] == 1.0
    assert got[4:] == want[4:]
    assert got[5]["cess_resilience_breaker_codec_recoveries"] == 1.0


def test_batch_member_isolation_requeues_individually():
    """A failed coalesced batch re-runs its members alone: the healthy
    mate resolves, only the poisoned member fails (fallback off, so the
    rejection shows), as in the JAX engine."""
    def run(port: bool):
        mod = tres if port else jres
        hooks = faults if port else jfaults
        res = mod.ResilienceConfig(fallback=False)
        use = engine(port, res, policy=AdmissionPolicy(max_delay=0.25),
                     audit=False)
        plan = mod.FaultPlan({"engine.dispatch": {0: mod.FaultSpec("raise"),
                                                  2: mod.FaultSpec("raise")}})
        a, b = rnd((2, K, 128), 1), rnd((3, K, 128), 2)
        try:
            with hooks.armed(plan):
                fa, fb = use.submit_encode(a), use.submit_encode(b)
                out = fa.result(timeout=30)
                with pytest.raises(mod.FaultInjected):
                    fb.result(timeout=30)
            st = use.stats_snapshot()["classes"]["encode"]
        finally:
            use.close()
        return (plan.fired_log(), out, stable(res.stats.snapshot()),
                resilience_metrics(use), (st["completed"], st["failed"]))

    got, want = run(True), run(False)
    assert got[0] == want[0] == (("engine.dispatch", 0, "raise"),
                                 ("engine.dispatch", 2, "raise"))
    assert same(got[1], want[1])
    assert got[2:] == want[2:]
    assert got[2]["batch_requeues"] == 2 and got[4] == (1, 1)


def test_saturated_blocking_submit_retries_with_backoff():
    outs = []
    for port in (True, False):
        mod = tres if port else jres
        res = mod.ResilienceConfig(retry=mod.RetryPolicy(max_attempts=10,
                                                         base_delay_s=0.02))
        use = engine(port, res, policy=AdmissionPolicy(queue_cap=1,
                                                       max_delay=0.005),
                     audit=False)
        real = use._op_encode
        use._op_encode = lambda b, d=False: (time.sleep(0.25), real(b, d))[1]
        try:
            use.submit_encode(rnd((1, K, 64), 1))   # drains, sleeps 0.25 s
            time.sleep(0.05)
            use.submit_encode(rnd((1, K, 64), 2))   # queued: cap reached
            outs.append(use.encode(rnd((1, K, 64), 3), timeout=30))
            assert res.stats.snapshot()["retries"]["encode"] >= 1
        finally:
            use.close()
    assert same(outs[0], outs[1])


def test_abandon_when_budget_exhausted():
    seen = []
    for port in (True, False):
        mod = tres if port else jres
        res = mod.ResilienceConfig(retry=mod.RetryPolicy(max_attempts=8,
                                                         base_delay_s=0.05))
        use = engine(port, res, policy=AdmissionPolicy(queue_cap=1,
                                                       max_delay=30.0),
                     audit=False)
        try:
            use.submit_encode(rnd((1, K, 64), 1))   # parks in the queue
            with pytest.raises((EngineSaturated, jserve.EngineSaturated)):
                use.encode(rnd((1, K, 64), 2), timeout=0.08)
            seen.append(res.stats.snapshot()["abandoned"])
        finally:
            use.close(timeout=0.5)
    assert seen[0] == seen[1] == {"encode": 1}


def test_kernel_build_error_is_never_degraded(monkeypatch):
    """A KernelBuildError raised by the loader reaches every member's
    future as it is: no solo re-run, no CPU fallback, no breaker
    outcome."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build",
                        lambda src_dir=None: _build.BUILD_DIR / "missing.so")
    codec = rs.TorchCodec(K, M, "cpu")

    def encode(data):
        _build.library()          # what a kernel wrapper does on the card
        return rs.TorchCodec.encode(codec, data)

    monkeypatch.setattr(codec, "encode", encode)
    res = ResilienceConfig(monitor=lambda: HealthMonitor(min_samples=1))
    eng = SubmissionEngine(codec, policy=AdmissionPolicy(max_delay=0.2),
                           resilience=res)
    try:
        futs = [eng.submit_encode(rnd((1, K, 64), i)) for i in range(3)]
        for f in futs:
            with pytest.raises(_build.KernelBuildError, match="cannot load"):
                f.result(timeout=30)
        snap = res.stats.snapshot()
        assert snap["fallback_batches"] == {} \
            and snap["degraded_batches"] == {}
        assert snap["batch_requeues"] == 0
        assert snap["breakers"]["codec"]["window_samples"] == 0
        assert eng.monitors["codec"].state == "closed"
        assert eng.stats_snapshot()["classes"]["encode"]["failed"] == 3
    finally:
        eng.close()


def test_numpy_member_degrades_with_a_dead_context(monkeypatch):
    """With the CUDA context dead every CUDA call raises; a numpy member
    of a degraded batch still gets its bytes from the CPU reference,
    since its path makes no CUDA call."""
    codec = rs.TorchCodec(K, M, "cpu")

    def dead(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(codec, "encode", dead)
    for name in ("current_stream", "synchronize", "Event", "Stream"):
        monkeypatch.setattr(torch.cuda, name, dead)
    res = ResilienceConfig(monitor=lambda: HealthMonitor(min_samples=1,
                                                         probe_every=100))
    eng = SubmissionEngine(codec, policy=AdmissionPolicy(max_delay=0.002),
                           resilience=res)
    ref = rs.TorchCodec(K, M, "cpu")
    try:
        for seed in range(3):                     # fallback, then degraded
            data = rnd((2, K, 256), seed)
            out = eng.encode(data, timeout=30)
            assert isinstance(out, np.ndarray)
            assert np.array_equal(out, ref.encode(data).numpy())
        snap = res.stats.snapshot()
        assert snap["fallback_batches"] == {"encode": 1}
        assert snap["degraded_batches"] == {"encode": 2}
    finally:
        eng.close()


def test_mixed_members_keep_their_domains_when_degraded():
    """A degraded batch of a tensor member and a numpy member: each gets
    its result in its own domain, the bytes of the clean path."""
    codec = rs.TorchCodec(K, M, "cpu")
    res = ResilienceConfig()
    eng = SubmissionEngine(codec, policy=AdmissionPolicy(max_delay=0.2),
                           resilience=res)
    eng.monitors["codec"].force_open()
    try:
        a, b = rnd((2, K, 128), 1), rnd((1, K, 128), 2)
        fa = eng.submit_encode(torch.from_numpy(a))
        fb = eng.submit_encode(b)
        ta, nb = fa.result(timeout=30), fb.result(timeout=30)
        assert isinstance(ta, torch.Tensor) and isinstance(nb, np.ndarray)
        assert torch.equal(ta, codec.encode(a))
        assert np.array_equal(nb, codec.encode(b).numpy())
        assert res.stats.snapshot()["degraded_batches"] == {"encode": 1}
        assert any(k[-1] == "cpu-fallback" for k in eng.programs.keys())
    finally:
        eng.close()


def test_card_members_are_never_served_on_the_host(monkeypatch):
    """On an engine on the card a tensor member's work never moves to
    the host: a failed attempt rejects it with that attempt's error and
    an open breaker refuses it with EngineUnavailable, while the numpy
    member of the same batch is served on the CPU reference. The engine
    runs on the CPU with its device read as the card's; the paths taken
    here (a dispatch fault, salvage, degradation) make no device call."""
    codec = rs.TorchCodec(K, M, "cpu")
    res = ResilienceConfig(monitor=lambda: HealthMonitor(min_samples=1,
                                                         probe_every=100))
    eng = SubmissionEngine(codec, policy=AdmissionPolicy(max_delay=0.2),
                           resilience=res)
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    plan = FaultPlan({"engine.dispatch": {0: FaultSpec("raise")}})
    try:
        for step, exc in enumerate((FaultInjected, EngineUnavailable)):
            a, b = rnd((2, K, 128), 10 + step), rnd((1, K, 128), 20 + step)
            with faults.armed(plan):
                fa = eng.submit_encode(torch.from_numpy(a))
                fb = eng.submit_encode(b)
                with pytest.raises(exc):
                    fa.result(timeout=30)
                out = fb.result(timeout=30)
            assert isinstance(out, np.ndarray)
            assert np.array_equal(out, codec.encode(b).numpy())
        assert plan.fired_log() == (("engine.dispatch", 0, "raise"),)
        snap = res.stats.snapshot()
        assert snap["fallback_batches"] == {"encode": 1}
        assert snap["degraded_batches"] == {"encode": 1}
        assert eng.stats_snapshot()["classes"]["encode"]["failed"] == 2
    finally:
        eng.close()


# -- the stream's seams ----------------------------------------------------

def test_stream_staging_fault_seams():
    jkey, _ = keys()
    jpipe = jpipeline.StoragePipeline(
        jpipeline.PipelineConfig(k=K, m=M, segment_size=K * FRAG),
        podr2_key=jkey)
    pipe = pipeline_from_arrays(K, M, K * FRAG, jpodr2.SECTORS,
                                np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                device="cpu")
    segs = rnd((5, K * FRAG), 3)
    clean = StreamingIngest(pipe, batch=2).ingest(segs)

    def delayed(mod, hooks, ingest, p):
        plan = mod.FaultPlan({"stream.h2d": {
            0: mod.FaultSpec("delay", delay_s=0.01),
            2: mod.FaultSpec("delay", delay_s=0.01)}})
        with hooks.armed(plan):
            out = ingest(p, batch=2).ingest(segs)
        return plan.fired_log(), np.asarray(out["tags"])

    got = delayed(tres, faults, StreamingIngest, pipe)
    want = delayed(jres, jfaults, jstream.StreamingIngest, jpipe)
    assert got[0] == want[0] == (("stream.h2d", 0, "delay"),
                                 ("stream.h2d", 2, "delay"))
    assert same(got[1], want[1]) and same(got[1], clean["tags"])
    logs = []
    for mod, hooks, ingest, p in (
            (tres, faults, StreamingIngest, pipe),
            (jres, jfaults, jstream.StreamingIngest, jpipe)):
        plan = mod.FaultPlan({"stream.dispatch": {1: mod.FaultSpec("raise")}})
        with hooks.armed(plan):
            with pytest.raises(mod.FaultInjected, match="stream.dispatch#1"):
                ingest(p, batch=2).ingest(segs)
        logs.append((plan.fired_log(), plan.counts()))
    assert logs[0] == logs[1]
