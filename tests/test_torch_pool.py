"""The port's device pool (cess_tpu_torch.serve.pool) against the JAX
package's (cess_tpu.serve.pool), every case of tests/test_pool.py but the
CLI's (the port carries no CLI).

Port pools run on ``DevicePool(["cpu"] * n)`` (torch has one CPU device;
a pool may list it more than once), JAX pools on conftest's virtual CPU
devices. The pool changes WHERE a batch runs, never what it computes:
results are byte-equal to the JAX pool engine's and the direct calls';
the chaos drill fires, trips, places and journals as the JAX drill does
and replays bit for bit; warm programs hit only their own lane; the
snapshot and the ``cess_engine_device_*`` names are the JAX pool's.
Tolerance: none.
"""
import types

import jax
import numpy as np
import pytest
import torch

from cess_tpu import serve as jserve
from cess_tpu.models import pipeline as jpipeline
from cess_tpu.obs import flight as jflight
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.resilience import ResilienceConfig as JResilienceConfig
from cess_tpu.resilience import faults as jfaults
from cess_tpu.resilience.faults import FaultPlan as JFaultPlan
from cess_tpu.serve import stream as jstream
from cess_tpu_torch.convert import pipeline_from_arrays, podr2_key_from_arrays
from cess_tpu_torch.obs import flight
from cess_tpu_torch.ops import podr2, regen, rs
from cess_tpu_torch.parallel import mesh
from cess_tpu_torch.resilience import ResilienceConfig, faults
from cess_tpu_torch.resilience.faults import FaultPlan
from cess_tpu_torch.serve import (AdmissionPolicy, DeviceLane, DevicePool,
                                  StreamingIngest, SubmissionEngine,
                                  make_engine)
from cess_tpu_torch.serve.pool import lane_codec

K, M = 2, 1
FRAG = 1024


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
    if a.dtype == bool or b.dtype == bool:
        return a.shape == b.shape and np.array_equal(a, b)
    return a.shape == b.shape and np.array_equal(a.astype(np.int64),
                                                 b.astype(np.int64))


def keys(seed=21):
    jkey = jpodr2.Podr2Key.generate(seed)
    key = podr2_key_from_arrays(np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                "cpu")
    return jkey, key


def pool_engine(n=2, res=None, key=None, regen_codec=False):
    codec = regen.RegenCodec(K, M, device="cpu") if regen_codec \
        else rs.make_codec(K, M, "cpu")
    audit = None
    if key is not None:
        from cess_tpu_torch.ops.audit_backend import make_audit_backend

        audit = make_audit_backend(key, "cpu")
    return SubmissionEngine(codec, audit, AdmissionPolicy(max_delay=0.002),
                            resilience=res, pool=DevicePool(["cpu"] * n))


def jax_pool_engine(n=2, res=None, jkey=None):
    return jserve.make_engine(K, M, rs_backend="jax", podr2_key=jkey,
                              resilience=res,
                              policy=jserve.AdmissionPolicy(max_delay=0.002),
                              pool=jserve.DevicePool(n=n))


# -- determinism: pool == JAX pool == direct --------------------------------

def test_pool_engine_bit_identical_across_ops():
    jkey, key = keys()
    eng, jeng = pool_engine(2, key=key), jax_pool_engine(2, jkey=jkey)
    codec = rs.make_codec(K, M, "cpu")
    try:
        assert eng.pool.n_devices == 2
        data = rnd((4, K, 256), 5)
        coded = eng.encode(data, timeout=60)
        assert same(coded, jeng.encode(data, timeout=60))
        assert np.array_equal(coded, codec.encode(data).numpy())
        surv = coded[:, [1, 2]]
        rec = eng.reconstruct(surv, (1, 2), (0,), timeout=60)
        assert same(rec, jeng.reconstruct(surv, (1, 2), (0,), timeout=60))
        assert np.array_equal(rec, data[:, :1])
        frags = rnd((5, FRAG), 7)
        ids = np.stack([podr2.fragment_id_from_hash(bytes([i]) * 32)
                        for i in range(5)])
        tags = eng.tag_fragments(ids, frags, timeout=60)
        assert same(tags, jeng.tag_fragments(ids, frags, timeout=60))
        # the audit round through the lanes: per-fragment and aggregated
        idx, nu = jpodr2.gen_challenge(b"pool-round", 2)
        r = np.asarray(jpodr2.aggregate_coeffs(b"pool-round", ids))
        mu, sigma = eng.prove_aggregate(frags, tags, idx, nu, r, timeout=60)
        jmu, jsigma = jeng.prove_aggregate(frags, tags.astype(np.uint32),
                                           idx, nu, r, timeout=60)
        assert same(mu, jmu) and same(sigma, jsigma)
        forged = (sigma + 1) % podr2.pf.P
        for e in (eng, jeng):
            assert e.verify_aggregate(ids, 2, idx, nu, r, mu, sigma,
                                      timeout=60)
            assert not e.verify_aggregate(ids, 2, idx, nu, r, mu, forged,
                                          timeout=60)
        snap = eng.pool.snapshot()
        assert snap["placements"] >= 3
        assert sum(ln["batches"] for ln in snap["lanes"]) >= 3
        log = eng.pool.placement_log()
        assert [row[0] for row in log] == list(range(1, len(log) + 1))
        assert log == jeng.pool.placement_log()
        assert all(row[5] in ("least-loaded", "probe", "all-open",
                              "requeue") for row in log)
    finally:
        eng.close()
        jeng.close()


def test_placement_takes_the_least_loaded_lane():
    """Sequential batches all land on lane 0 (ties break by index); with
    lane 0 holding rows in flight the next goes to lane 1. Every result
    is byte-equal to the direct encode."""
    eng = pool_engine(2)
    codec = rs.make_codec(K, M, "cpu")
    try:
        datas = [rnd((3, K, 4096), 40 + i) for i in range(8)]
        futs = []
        for d in datas:
            futs.append(eng.submit_encode(d))
            eng.flush(30)                  # one batch each, none waiting
            futs[-1].result(timeout=60)
        lanes = eng.pool.lanes
        with eng.pool._cond:
            lanes[0].inflight_rows += 100   # lane 0 looks busy
        try:
            futs.append(eng.submit_encode(datas[0]))
            eng.flush(30)
        finally:
            with eng.pool._cond:
                lanes[0].inflight_rows -= 100
        for d, f in zip(datas + [datas[0]], futs):
            assert np.array_equal(f.result(timeout=60),
                                  codec.encode(d).numpy())
        assert eng.pool.placement_log()[-1][4:] == (1, "least-loaded")
        assert lanes[1].batches == 1
    finally:
        eng.close()


def test_pool_stream_entry_matches_jax_pool_stream():
    """StreamingIngest(pool=): each batch's seg axis over the lanes, a
    ragged tail, default ids; equal to the JAX pool stream and the
    direct ingest. The batch must divide over the lanes."""
    jkey, _ = keys()
    jpipe = jpipeline.StoragePipeline(
        jpipeline.PipelineConfig(k=K, m=M, segment_size=2048), podr2_key=jkey)
    pipe = pipeline_from_arrays(K, M, 2048, jpodr2.SECTORS,
                                np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                device="cpu")
    segs = rnd((6, 2048), 3)
    pooled = StreamingIngest(pipe, 4,
                             pool=DevicePool(["cpu"] * 2)).ingest(segs)
    direct = StreamingIngest(pipe, 4).ingest(segs)
    jpooled = jstream.StreamingIngest(jpipe, 4,
                                      pool=jserve.DevicePool(n=2)).ingest(segs)
    for name in ("fragments", "tags"):
        assert same(pooled[name], jpooled[name])
        assert torch.equal(pooled[name], direct[name])
    with pytest.raises(ValueError, match="not divisible"):
        StreamingIngest(pipe, 3, pool=DevicePool(["cpu"] * 2))
    with pytest.raises(ValueError, match="not divisible"):
        mesh.pool_stream_entry(pipe, ["cpu"] * 2, 3)


# -- the chaos drill: one sick lane drains to its sibling -------------------

def _drill(seed, port=True, n_batches=12):
    """The seeded chaos drill: every dispatch on lane 0 raises. Returns
    (outputs, pool snapshot, resilience snapshot, placement log, fired
    log), from the port's pool or the JAX package's."""
    res = ResilienceConfig() if port else JResilienceConfig()
    eng = pool_engine(2, res) if port else jax_pool_engine(2, res)
    plan = (FaultPlan if port else JFaultPlan).seeded(
        seed, {"engine.dispatch.d0": (1.0, "raise")}, horizon=64)
    outs = []
    try:
        with (faults if port else jfaults).armed(plan):
            for i in range(n_batches):
                outs.append(eng.encode(rnd((3, K, 256), 100 + i),
                                       timeout=60))
                # settle lane counters between offers: the placement log
                # is then a function of the offered sequence alone
                assert eng.flush(30)
        return (outs, eng.pool.snapshot(), res.stats.snapshot(),
                eng.pool.placement_log(), plan.fired_log())
    finally:
        eng.close()


def _stable(rsnap):
    """A resilience snapshot without the breakers' host-clock latency."""
    return {k: ({b: {f: v for f, v in m.items() if f != "mean_latency_s"}
                 for b, m in v.items()} if k == "breakers" else v)
            for k, v in rsnap.items()}


def test_chaos_drill_sick_lane_drains_to_sibling():
    outs, snap, rsnap, log, fired = _drill(b"pool-drill")
    jouts, jsnap, jrsnap, jlog, jfired = _drill(b"pool-drill", port=False)
    codec = rs.make_codec(K, M, "cpu")
    for i, (out, jout) in enumerate(zip(outs, jouts)):
        assert same(out, jout)
        assert np.array_equal(out, codec.encode(rnd((3, K, 256),
                                                    100 + i)).numpy())
    assert fired == jfired and log == jlog
    assert snap == jsnap and _stable(rsnap) == _stable(jrsnap)
    # the asserts of the JAX package's drill, on the port's run
    br = rsnap["breakers"]
    assert br["codec.d0"]["state"] == "open"
    assert br["codec.d0"]["trips"] == 1
    assert br["codec.d1"]["state"] == "closed"
    assert br["codec.d1"]["trips"] == 0
    assert br["codec"]["trips"] == 0
    lanes = {ln["device"]: ln for ln in snap["lanes"]}
    assert lanes[0]["batches"] == 0
    assert lanes[1]["batches"] == len(outs)
    assert lanes[1]["requeues"] > 0
    assert rsnap["degraded_batches"] == {}
    assert fired and all(site == "engine.dispatch.d0"
                         for site, _, _ in fired)
    reasons = [(row[4], row[5]) for row in log]
    assert (0, "least-loaded") in reasons
    assert (1, "requeue") in reasons
    assert (1, "least-loaded") in reasons
    assert (0, "probe") in reasons          # trips are never permanent


def test_chaos_drill_replays_bit_for_bit():
    outs1, _, _, log1, fired1 = _drill(b"pool-replay")
    outs2, _, _, log2, fired2 = _drill(b"pool-replay")
    assert fired1 == fired2
    assert log1 == log2
    for a, b in zip(outs1, outs2):
        assert np.array_equal(a, b)


def test_chaos_drill_journals_the_drain():
    rec = flight.FlightRecorder(b"pool-journal")
    with flight.armed(rec):
        _drill(b"pool-drill", n_batches=6)
    jrec = jflight.FlightRecorder(b"pool-journal")
    with jflight.armed(jrec):
        _drill(b"pool-drill", port=False, n_batches=6)
    requeues = rec.journal_tail("pool")
    assert requeues and all(e["kind"] == "requeue" for e in requeues)
    assert all(e["detail"]["src"] == 0 and e["detail"]["dst"] == 1
               for e in requeues)
    assert [(e["kind"], e["detail"]) for e in requeues] == \
        [(e["kind"], e["detail"]) for e in jrec.journal_tail("pool")]
    trips = [e for e in rec.journal_tail("breaker") if e["kind"] == "trip"]
    assert any(e["detail"]["name"] == "codec.d0" for e in trips)


def test_every_lane_sick_refuses_card_members_and_degrades_numpy(monkeypatch):
    """The single-device rule holds on the pool path: with every lane's
    breaker open, a member whose payload lies on the card is refused
    (EngineUnavailable) and a numpy member is served on the CPU
    reference. The engine runs on the CPU with its device read as the
    card's; the degraded path makes no device call."""
    from cess_tpu_torch.resilience import FaultSpec, HealthMonitor
    from cess_tpu_torch.serve import EngineUnavailable

    res = ResilienceConfig(monitor=lambda: HealthMonitor(min_samples=1,
                                                         probe_every=100))
    eng = pool_engine(2, res)
    codec = rs.make_codec(K, M, "cpu")
    plan = FaultPlan({"engine.dispatch.d0": {0: FaultSpec("raise")},
                      "engine.dispatch.d1": {0: FaultSpec("raise")}})
    try:
        with faults.armed(plan):
            out = eng.encode(rnd((1, K, 128), 1), timeout=30)
        assert np.array_equal(out, codec.encode(rnd((1, K, 128), 1)).numpy())
        assert [ln["breakers"]["codec"] for ln in
                eng.pool.snapshot()["lanes"]] == ["open", "open"]
        monkeypatch.setattr(eng, "device", torch.device("cuda"))
        a, b = rnd((2, K, 128), 10), rnd((1, K, 128), 20)
        fa = eng.submit_encode(torch.from_numpy(a))
        fb = eng.submit_encode(b)
        with pytest.raises(EngineUnavailable):
            fa.result(timeout=30)
        assert np.array_equal(fb.result(timeout=30), codec.encode(b).numpy())
        assert res.stats.snapshot()["degraded_batches"] == {"encode": 1}
        assert eng.pool.placement_log()[-1][5] == "all-open"
    finally:
        eng.close()


# -- warm programs are lane-keyed ------------------------------------------

def test_warm_reconstruct_hits_only_its_own_lane():
    """Each lane's codec view holds its own warm programs: one warmed on
    lane 0 never serves lane 1's call, whose cold path still serves."""
    pool = DevicePool(["cpu"] * 2)
    base = rs.make_codec(K, M, "cpu")
    views = [lane_codec(base, lane.device) for lane in pool.lanes]
    assert all(type(v) is rs.TorchCodec and v is not base for v in views)
    data = rnd((K, 256), 11)
    coded = base.encode(data).numpy()
    surv, present, missing = coded[[1, 2]], (1, 2), (0,)
    views[0].warm_reconstruct(present, missing, surv.shape)
    out = views[1].reconstruct(surv, present, missing)
    assert views[0].warm_hits == views[1].warm_hits == 0
    assert np.array_equal(out[0].numpy(), data[0])
    views[1].warm_reconstruct(present, missing, surv.shape)
    out2 = views[1].reconstruct(surv, present, missing)
    assert (views[0].warm_hits, views[1].warm_hits) == (0, 1)
    assert torch.equal(out2, out)


@pytest.mark.parametrize("regen_codec", [False, True])
def test_engine_warm_repair_warms_every_lane(regen_codec):
    eng = pool_engine(2, regen_codec=regen_codec)
    jeng = jax_pool_engine(2)
    try:
        eng.warm_repair([((1, 2), (0,))], 256, buckets=(1,))
        jeng.warm_repair([((1, 2), (0,))], 256, buckets=(1,))
        keys_ = {("repair", (1, 2), (0,), 256, 1),
                 ("repair", (1, 2), (0,), 256, 1, ("device", 0)),
                 ("repair", (1, 2), (0,), 256, 1, ("device", 1))}
        repair = {k for k in eng.programs.keys() if k[0] == "repair"}
        assert repair == keys_ == {k for k in jeng.programs._programs
                                   if k[0] == "repair"}
        if regen_codec:                 # the helper folds, base + lanes
            c = regen.repair_coeffs(K, M, (1, 2), (0,))
            folds = {k for k in eng.programs.keys() if k[0] == "symbol"}
            assert folds == {("symbol", cc, 256, 1) + lane
                             for cc in c if cc
                             for lane in ((), (("device", 0),),
                                          (("device", 1),))}
        lanes = eng.pool.lanes
        assert all(len(ln.codec._warm) == len(eng.codec._warm) >= 1
                   for ln in lanes)
        # a one-row repair lands on lane 0 and hits lane 0's program only
        data = rnd((1, K, 256), 4)
        coded = eng.encode(data, timeout=60)
        rec = eng.reconstruct(coded[:, [1, 2]], (1, 2), (0,), timeout=60)
        assert np.array_equal(rec, data[:, :1])
        assert (lanes[0].codec.warm_hits, lanes[1].codec.warm_hits,
                eng.codec.warm_hits) == (1, 0, 0)
    finally:
        eng.close()
        jeng.close()


# -- surfaces: zero-cost default, snapshot, metrics, lifecycle --------------

def test_engine_without_pool_is_unchanged():
    eng = make_engine(K, M, rs_backend="cpu",
                      policy=AdmissionPolicy(max_delay=0.002))
    try:
        assert eng.pool is None
        assert "devices" not in eng.stats_snapshot()
        assert not any(k.startswith("cess_engine_device")
                       for k in eng.stats.metrics())
        data = rnd((2, K, 128), 1)
        assert np.array_equal(eng.encode(data, timeout=60),
                              rs.make_codec(K, M, "cpu").encode(data).numpy())
        assert all(len(k) == 4 for k in eng.programs.keys())  # no device
    finally:
        eng.close()


def test_pool_snapshot_and_metrics_surface():
    eng, jeng = pool_engine(2, ResilienceConfig()), \
        jax_pool_engine(2, JResilienceConfig())
    try:
        for e in (eng, jeng):
            e.encode(rnd((3, K, 128), 2), timeout=60)
            assert e.flush(30)
        snap = eng.stats_snapshot()["devices"]
        assert snap == jeng.stats_snapshot()["devices"]
        assert snap["n_devices"] == 2 and snap["placements"] >= 1
        assert [ln["device"] for ln in snap["lanes"]] == [0, 1]
        for ln in snap["lanes"]:
            assert ln["breakers"] == {"codec": "closed"}
            assert ln["inflight_rows"] == 0
        m, jm = eng.stats.metrics(), jeng.stats.metrics()
        dev = {k: v for k, v in m.items() if k.startswith("cess_engine_device")}
        assert dev == {k: v for k, v in jm.items()
                       if k.startswith("cess_engine_device")}
        assert m["cess_engine_device_count"] == 2.0
        assert m["cess_engine_device_placements"] >= 1.0
        assert sum(m[f"cess_engine_device_{i}_batches"]
                   for i in (0, 1)) >= 1.0
        assert m["cess_engine_device_0_codec_open"] == 0.0
    finally:
        eng.close()
        jeng.close()


def test_pool_lifecycle_guards():
    with pytest.raises(ValueError):
        DevicePool(devices=[])
    with pytest.raises(ValueError):
        DevicePool(["cpu"], probe_every=0)
    pool = DevicePool(["cpu"])
    assert isinstance(pool.lanes[0], DeviceLane) and pool.lanes[0].stream \
        is None
    eng = make_engine(K, M, rs_backend="cpu", pool=pool)
    try:
        with pytest.raises(ValueError):     # one pool, one engine
            pool.bind(eng)
    finally:
        eng.close()
    with pytest.raises(RuntimeError):       # closed pools refuse work
        pool.dispatch([types.SimpleNamespace(key=("encode",), rows=1)])
    # make_engine's count forms: an int builds the pool itself (N "cpu"
    # lanes for an engine on the CPU)
    eng2 = make_engine(K, M, rs_backend="cpu", pool=2)
    try:
        assert eng2.pool.n_devices == 2
        assert eng2.pool.devices() == [torch.device("cpu")] * 2
    finally:
        eng2.close()
