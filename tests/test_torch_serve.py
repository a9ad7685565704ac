"""The port's submission engine (cess_tpu_torch.serve) against the JAX
package's (cess_tpu.serve) on the same seeded inputs.

Every result must be exactly equal (tolerance 0: fragments, tags,
proofs and verdicts are protocol facts); the port returns field elements
as int32 where the JAX package returns uint32, so values are compared.
The engine-semantics tests mirror tests/test_serve.py on the port.
The card's own engine tests are in tests/test_torch_serve_card.py.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from cess_tpu import serve as jserve
from cess_tpu.models import pipeline as jpipeline
from cess_tpu.obs import prom as jprom
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.serve import buckets as jbuckets
from cess_tpu_torch.convert import podr2_key_from_arrays
from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
from cess_tpu_torch.obs import prom
from cess_tpu_torch.ops import podr2, regen, rs
from cess_tpu_torch.serve import (CLASS_PRIORITY, CLASSES, AdmissionPolicy,
                                  EngineClosed, EngineSaturated,
                                  EngineTimeout, SubmissionEngine,
                                  make_engine)
from cess_tpu_torch.serve.buckets import ProgramCache, bucket_rows

FRAG = 1024                 # bytes per fragment: 2 PoDR2 blocks
P = (1 << 31) - 1


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(shape, seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)


def same(a, b) -> bool:
    """Exact equality of values (port int32/int64 vs JAX uint32)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == bool or b.dtype == bool:
        return a.shape == b.shape and np.array_equal(a, b)
    return a.shape == b.shape and np.array_equal(a.astype(np.int64),
                                                 b.astype(np.int64))


def keys(seed=21, limbs=2):
    jkey = jpodr2.Podr2Key.generate(seed, jpodr2.Podr2Params(limbs=limbs))
    key = podr2_key_from_arrays(np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                "cpu")
    return jkey, key


def engines(k=2, m=1, limbs=2, policy=None, audit=True):
    """(port engine, JAX engine) over the same geometry and key."""
    jkey, key = keys(limbs=limbs)
    policy = policy or AdmissionPolicy(max_delay=0.005)
    jpol = jserve.AdmissionPolicy(**{
        f: getattr(policy, f) for f in ("queue_cap", "max_batch_requests",
                                        "max_batch_rows", "max_delay",
                                        "default_timeout")})
    eng = make_engine(k, m, rs_backend="cpu", podr2_key=key if audit else None,
                      audit_backend="cpu", policy=policy)
    jeng = jserve.make_engine(k, m, rs_backend="cpu",
                              podr2_key=jkey if audit else None,
                              audit_backend="cpu", policy=jpol)
    return eng, jeng


@pytest.fixture
def pair():
    eng, jeng = engines()
    yield eng, jeng
    eng.close()
    jeng.close()


def tagged(key, f, seed, tag=0):
    """f fragments, their hash-derived id pairs and their tags (the
    port's direct tags, equal to the JAX package's)."""
    frags = rnd((f, FRAG), seed)
    ids = np.stack([jpodr2.fragment_id_from_hash(bytes([tag, j]) * 16)
                    for j in range(f)])
    tags = podr2.tag_fragments(key, ids, torch.from_numpy(frags)).numpy()
    return frags, ids, tags


# -- every class against the JAX engine ------------------------------------

@pytest.mark.parametrize("k,m", [(2, 1), (4, 8)])
def test_encode_matches_jax(k, m):
    eng, jeng = engines(k, m, audit=False)
    try:
        for b, seed in ((1, 1), (3, 2), (5, 3)):     # odd sizes force pads
            data = rnd((b, k, 256), seed)
            got = eng.encode(data)
            assert isinstance(got, np.ndarray)
            assert same(got, jeng.encode(data))
        one = rnd((k, 256), 9)                       # 2-D submit
        assert same(eng.encode(one), jeng.encode(one))
        st = eng.stats_snapshot()["classes"]["encode"]
        assert st["pad_waste"] == \
            jeng.stats_snapshot()["classes"]["encode"]["pad_waste"] > 0
    finally:
        eng.close()
        jeng.close()


@pytest.mark.parametrize("k,m,present,missing", [
    (2, 1, (1, 2), (0,)), (4, 8, (4, 5, 6, 7), (0, 1, 2, 3))])
def test_reconstruct_and_decode_match_jax(k, m, present, missing):
    eng, jeng = engines(k, m, audit=False)
    try:
        coded = np.asarray(jeng.encode(rnd((4, k, 512), 5)))
        surv = coded[:, list(present)]
        rec = eng.reconstruct(surv, present, missing)
        assert same(rec, jeng.reconstruct(surv, present, missing))
        assert same(rec, coded[:, list(missing)])
        assert same(eng.decode_data(surv, present),
                    jeng.decode_data(surv, present))
        assert same(eng.reconstruct(surv[0], present),
                    jeng.reconstruct(surv[0], present))
    finally:
        eng.close()
        jeng.close()


@pytest.mark.parametrize("limbs", [2, 3])
def test_tag_prove_verify_match_jax(limbs):
    eng, jeng = engines(limbs=limbs)
    jkey = jeng.audit.key
    try:
        frags = rnd((5, FRAG), 7)
        ids = np.stack([jpodr2.fragment_id_from_hash(bytes([i]) * 32)
                        for i in range(5)])
        tags = eng.tag_fragments(ids, frags)
        assert tags.dtype == np.int32 and tags.shape == (5, 2, limbs)
        jtags = jeng.tag_fragments(ids, frags)
        assert same(tags, jtags)
        idx, nu = (np.asarray(x) for x in jpodr2.gen_challenge(b"round-1", 2))
        r = np.asarray(jpodr2.aggregate_coeffs(b"round-1", ids))
        mu, sigma = eng.prove_aggregate(frags, tags, idx, nu, r)
        jmu, jsigma = jeng.prove_aggregate(frags, jtags, idx, nu, r)
        assert same(mu, jmu) and same(sigma, jsigma)
        assert eng.verify_aggregate(ids, 2, idx, nu, r, mu, sigma) is True
        bad = (np.asarray(sigma, np.int64) + 1) % P
        assert eng.verify_aggregate(ids, 2, idx, nu, r, mu, bad) is False
        assert jeng.verify_aggregate(ids, 2, idx, nu, r, jmu, bad) is False
        mu_b, sigma_b = (np.asarray(x) for x in jpodr2.prove_batch(
            frags, jtags, idx, nu))
        sigma_b = sigma_b.copy()
        sigma_b[3, 0] = (sigma_b[3, 0] + 1) % P      # one bad fragment
        ok = eng.verify_batch(ids, 2, idx, nu, mu_b, sigma_b)
        assert ok.dtype == bool
        assert same(ok, jeng.verify_batch(ids, 2, idx, nu, mu_b, sigma_b))
        assert ok.tolist() == [True, True, True, False, True]
        direct = podr2.tag_fragments(eng.audit.key, ids,
                                     torch.from_numpy(frags))
        assert same(tags, direct)
        assert jkey.limbs == limbs
    finally:
        eng.close()
        jeng.close()


@pytest.mark.parametrize("limbs", [2, 3])
def test_stacked_classes_coalesce_like_jax(limbs):
    """Ragged missions of one round coalesce into one F-padded batch in
    both classes; proofs and verdicts (one mission tampered) equal the
    JAX engine's, and so do the batch counts."""
    pol = AdmissionPolicy(max_delay=0.25)
    eng, jeng = engines(limbs=limbs, policy=pol)
    try:
        idx, nu = (np.asarray(x) for x in jpodr2.gen_challenge(b"round-2", 2))
        missions = []
        for i, f in enumerate((2, 3, 5)):
            frags, ids, tags = tagged(eng.audit.key, f, 30 + i, tag=40 + i)
            r = np.asarray(jpodr2.aggregate_coeffs(b"round-2", ids))
            missions.append((frags, ids, tags, r))
        got = [f.result(timeout=60) for f in [
            eng.submit_prove_aggregate(fr, t, idx, nu, r)
            for fr, _, t, r in missions]]
        want = [f.result(timeout=60) for f in [
            jeng.submit_prove_aggregate(fr, t, idx, nu, r)
            for fr, _, t, r in missions]]
        for (mu, sg), (jmu, jsg) in zip(got, want):
            assert same(mu, jmu) and same(sg, jsg)
        checks = []
        for i, ((_, ids, _, r), (mu, sg)) in enumerate(zip(missions, got)):
            if i == 1:
                sg = (np.asarray(sg, np.int64) + 1) % P
            checks.append((ids, r, mu, sg))
        verdicts = [f.result(timeout=60) for f in [
            eng.submit_verify_aggregate(ids, 2, idx, nu, r, mu, sg)
            for ids, r, mu, sg in checks]]
        jverdicts = [bool(f.result(timeout=60)) for f in [
            jeng.submit_verify_aggregate(ids, 2, idx, nu, r, mu, sg)
            for ids, r, mu, sg in checks]]
        assert verdicts == jverdicts == [True, False, True]
        for cls in ("prove", "verify"):
            st = eng.stats.classes[cls]
            jst = jeng.stats.classes[cls]
            assert (st.batches, st.batched_requests, st.rows,
                    st.padded_rows) == (jst.batches, jst.batched_requests,
                                        jst.rows, jst.padded_rows)
            assert st.occupancy > 1
    finally:
        eng.close()
        jeng.close()


def test_repair_symbol_matches_jax_regen():
    from cess_tpu.ops import regen as jregen

    codec = regen.RegenCodec(2, 1, device="cpu")
    eng = SubmissionEngine(codec=codec,
                           policy=AdmissionPolicy(max_delay=0.005))
    jeng = jserve.make_engine(2, 1, rs_backend="regen",
                              policy=jserve.AdmissionPolicy(max_delay=0.005))
    try:
        coded = np.asarray(jeng.encode(rnd((3, 2, 256), 11)))
        coeffs = jregen.repair_coeffs(2, 1, (1, 2), (0,))
        assert coeffs == regen.repair_coeffs(2, 1, (1, 2), (0,))
        acc = np.zeros((3, 1, 256), np.uint8)
        jacc = acc.copy()
        for p, row in enumerate((1, 2)):
            pairs = np.concatenate([acc, coded[:, row:row + 1]], axis=1)
            jpairs = np.concatenate([jacc, coded[:, row:row + 1]], axis=1)
            acc = eng.repair_symbol(pairs, coeffs[p])
            jacc = np.asarray(jeng.repair_symbol(jpairs, coeffs[p]))
            assert same(acc, jacc)
        assert same(acc, coded[:, :1])
        plain = make_engine(2, 1, rs_backend="cpu")
        try:
            with pytest.raises(ValueError, match="regenerating codec"):
                plain.submit_repair_symbol(pairs, 3)
        finally:
            plain.close()
    finally:
        eng.close()
        jeng.close()


def test_deterministic_coalescing_counts_match_jax():
    """AdmissionPolicy(max_batch_requests=4, max_delay=10): every 4
    submits make exactly one batch, and the batch, row, pad and
    program-cache counts equal the JAX engine's after the same
    sequence."""
    pol = AdmissionPolicy(max_batch_requests=4, max_delay=10.0)
    eng, jeng = engines(policy=pol)
    try:
        seqs = [[rnd((b, 2, 256), 10 + b + 4 * s) for b in rows]
                for s, rows in enumerate(((1, 2, 3, 1), (2, 2, 2, 2),
                                          (1, 1, 1, 1)))]
        for datas in seqs:
            outs = [[f.result(timeout=60) for f in
                     [e.submit_encode(d) for d in datas]]
                    for e in (eng, jeng)]
            assert all(same(o, jo) for o, jo in zip(*outs))
        frags, ids, want = tagged(eng.audit.key, 4, 50)
        for e in (eng, jeng):
            futs = [e.submit_tag(ids[i:i + 1], frags[i:i + 1])
                    for i in range(4)]
            tags = np.concatenate([np.asarray(f.result(timeout=60))
                                   for f in futs])
            assert same(tags, want)
        for cls in ("encode", "tag"):
            st, jst = eng.stats.classes[cls], jeng.stats.classes[cls]
            got = (st.batches, st.batched_requests, st.rows, st.padded_rows)
            assert got == (jst.batches, jst.batched_requests, jst.rows,
                           jst.padded_rows)
        assert (eng.stats.classes["encode"].batches,
                eng.stats.classes["tag"].batches) == (3, 1)
        snap, jsnap = eng.stats_snapshot(), jeng.stats_snapshot()
        assert (snap["programs_built"], snap["programs_reused"]) == \
            (jsnap["programs_built"], jsnap["programs_reused"]) == (3, 1)
    finally:
        eng.close()
        jeng.close()


def test_tensor_payloads_come_back_as_tensors(pair):
    """Tensors in, tensors out; numpy submitters keep numpy even when
    coalesced with a tensor submitter in one batch."""
    eng, jeng = pair
    codec = rs.make_codec(2, 1, "cpu")
    host = rnd((2, 2, 128), 4)
    dev = torch.from_numpy(rnd((3, 2, 128), 5))
    out = eng.encode(dev)
    assert isinstance(out, torch.Tensor) and torch.equal(out,
                                                         codec.encode(dev))
    slow = AdmissionPolicy(max_delay=0.25)
    eng2, _ = engines(policy=slow, audit=False)
    try:
        f_host, f_dev = eng2.submit_encode(host), eng2.submit_encode(dev)
        out_host, out_dev = f_host.result(timeout=30), f_dev.result(timeout=30)
        assert isinstance(out_host, np.ndarray)
        assert isinstance(out_dev, torch.Tensor)
        assert same(out_host, jeng.encode(host))
        assert same(out_dev, jeng.encode(dev.numpy()))
        st = eng2.stats_snapshot()["classes"]["encode"]
        assert st["batches"] == 1 and st["batch_occupancy"] == 2
    finally:
        eng2.close()
    frags, ids, _ = tagged(eng.audit.key, 3, 6)
    tags = eng.tag_fragments(torch.from_numpy(ids.astype(np.int64)),
                             torch.from_numpy(frags))
    assert isinstance(tags, torch.Tensor) and tags.dtype == torch.int32
    assert same(tags, jeng.tag_fragments(ids, frags))
    idx, nu = (np.asarray(x) for x in jpodr2.gen_challenge(b"round-zc", 2))
    r = np.asarray(jpodr2.aggregate_coeffs(b"round-zc", ids))
    mu, sigma = eng.prove_aggregate(torch.from_numpy(frags), tags,
                                    torch.tensor(idx), nu,
                                    torch.from_numpy(r.astype(np.int64)))
    assert isinstance(mu, torch.Tensor) and mu.dtype == torch.int32
    jmu, jsigma = jeng.prove_aggregate(frags, np.asarray(tags).astype(
        np.uint32), idx, nu, r)
    assert same(mu, jmu) and same(sigma, jsigma)


def test_concurrent_submitters_coalesce():
    """8 concurrent submitters coalesce into shared batches (mean
    occupancy > 1); every result equals the JAX engine's."""
    eng, jeng = engines(policy=AdmissionPolicy(max_delay=0.3), audit=False)
    n_threads = 8
    datas = [rnd((2, 2, 256), 100 + i) for i in range(n_threads)]
    outs: list = [None] * n_threads
    barrier = threading.Barrier(n_threads)

    def submit(i):
        barrier.wait()
        outs[i] = eng.encode(datas[i], timeout=30)

    try:
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        for i in range(n_threads):
            assert same(outs[i], jeng.encode(datas[i])), i
        st = eng.stats_snapshot()["classes"]["encode"]
        assert st["submitted"] == st["completed"] == n_threads
        assert st["batch_occupancy"] > 1, st
    finally:
        eng.close()
        jeng.close()


def test_submitter_stress_loses_no_update():
    """16 threads x 10 submits with a tiny switch interval: every
    request is counted once in every counter, and every result is
    right."""
    import sys

    codec = rs.make_codec(2, 1, "cpu")
    eng = make_engine(2, 1, rs_backend="cpu",
                      policy=AdmissionPolicy(max_delay=0.001))
    n_threads, per = 16, 10
    bad: list = []

    def submit(i):
        for j in range(per):
            data = rnd((1 + (i + j) % 3, 2, 64), 1000 * i + j)
            if not same(eng.encode(data, timeout=60), codec.encode(data)):
                bad.append((i, j))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
        eng.close()
    assert not any(t.is_alive() for t in threads)
    assert not bad
    st = eng.stats.classes["encode"]
    total = n_threads * per
    assert st.submitted == st.completed == st.batched_requests == total
    assert st.hist.count == total and st.failed == 0


# -- engine semantics (mirrors of tests/test_serve.py) ----------------------

def test_verify_preempts_queued_encode():
    eng, _ = engines(policy=AdmissionPolicy(max_delay=0.4))
    _.close()
    order: list[str] = []
    real_encode, real_verify = eng._op_encode, eng._op_verify_batch
    eng._op_encode = lambda b: (order.append("encode"), real_encode(b))[1]
    eng._op_verify_batch = lambda b: (order.append("verify"),
                                      real_verify(b))[1]
    # the round is derived before the encode's 0.4 s window opens
    idx, nu = (np.asarray(x) for x in jpodr2.gen_challenge(b"round-4", 2))
    try:
        f_enc = eng.submit_encode(rnd((1, 2, 256), 1))
        time.sleep(0.05)          # verify arrives LATER...
        f_ver = eng.submit_verify_batch(
            np.zeros((1, 2), np.uint32), 2, idx, nu,
            np.zeros((1, podr2.SECTORS), np.uint32),
            np.zeros((1, podr2.LIMBS), np.uint32))
        f_ver.result(timeout=30)
        f_enc.result(timeout=30)
        assert order == ["verify", "encode"]     # ...but runs FIRST
    finally:
        eng.close()


def test_saturation_is_explicit():
    eng = make_engine(2, 1, rs_backend="cpu", policy=AdmissionPolicy(
        queue_cap=2, max_delay=30.0))
    try:
        data = rnd((1, 2, 64), 3)
        eng.submit_encode(data)
        eng.submit_encode(data)
        with pytest.raises(EngineSaturated):
            eng.submit_encode(data)
        st = eng.stats_snapshot()["classes"]["encode"]
        assert st["saturated"] == 1 and st["queue_depth"] == 2
    finally:
        eng.close()


def test_deadline_expiry_cancels():
    eng = make_engine(2, 1, rs_backend="cpu",
                      policy=AdmissionPolicy(max_delay=30.0))
    try:
        fut = eng.submit_encode(rnd((1, 2, 64), 4), timeout=0.05)
        with pytest.raises(EngineTimeout):
            fut.result(timeout=10)
        st = eng.stats_snapshot()["classes"]["encode"]
        assert st["timeouts"] == 1 and st["completed"] == 0
    finally:
        eng.close()


def test_deadline_expiry_crosses_classes():
    eng, jeng = engines(policy=AdmissionPolicy(max_delay=30.0))
    jeng.close()
    try:
        idx, nu = (np.asarray(x) for x in jpodr2.gen_challenge(b"round-6", 2))
        f_ver = eng.submit_verify_batch(        # higher class, queued
            np.zeros((1, 2), np.uint32), 2, idx, nu,
            np.zeros((1, podr2.SECTORS), np.uint32),
            np.zeros((1, podr2.LIMBS), np.uint32))
        f_enc = eng.submit_encode(rnd((1, 2, 64), 7), timeout=0.05)
        with pytest.raises(EngineTimeout):
            f_enc.result(timeout=10)
        st = eng.stats_snapshot()["classes"]
        assert st["encode"]["timeouts"] == 1
        assert st["verify"]["batches"] == 0      # not force-drained
        eng.close()
        assert f_ver.result(timeout=10).shape == (1,)
    finally:
        eng.close()


def test_stacked_ops_cap_pad_spread():
    """One huge prove request must not drag tiny same-round peers into
    its row bucket: buckets more than PAD_SPREAD apart split."""
    eng, jeng = engines(policy=AdmissionPolicy(max_delay=0.25,
                                               max_batch_rows=512))
    jeng.close()
    key = eng.audit.key
    try:
        idx, nu = podr2.gen_challenge(b"round-7", 2, device="cpu")
        sets = []
        for i, f in enumerate((64, 1, 1)):       # 64-row + two tiny
            frags, ids, tags = tagged(key, f, 80 + i, tag=90 + i)
            r = podr2.aggregate_coeffs(b"round-7", ids, device="cpu")
            sets.append((frags, tags, r))
        futs = [eng.submit_prove_aggregate(f, t, idx, nu, r)
                for f, t, r in sets]
        for (f, t, r), fut in zip(sets, futs):
            mu, sigma = fut.result(timeout=60)
            dmu, dsigma = podr2.prove_aggregate(
                torch.from_numpy(f), torch.from_numpy(t), idx, nu, r)
            assert same(mu, dmu) and same(sigma, dsigma)
        assert eng.stats_snapshot()["classes"]["prove"]["batches"] == 2
    finally:
        eng.close()


def test_closed_engine_refuses():
    eng = make_engine(2, 1, rs_backend="cpu")
    eng.close()
    with pytest.raises(EngineClosed):
        eng.submit_encode(rnd((1, 2, 64), 5))


def test_close_drains_pending():
    codec = rs.make_codec(2, 1, "cpu")
    eng = make_engine(2, 1, rs_backend="cpu",
                      policy=AdmissionPolicy(max_delay=30.0))
    data = rnd((2, 2, 64), 6)
    fut = eng.submit_encode(data)
    eng.close()
    assert same(fut.result(timeout=10), codec.encode(data))


def test_flush_waits_for_quiescence():
    codec = rs.make_codec(2, 1, "cpu")
    eng = make_engine(2, 1, rs_backend="cpu",
                      policy=AdmissionPolicy(max_delay=10.0))
    real = eng._op_encode
    eng._op_encode = lambda b: (time.sleep(0.3), real(b))[1]
    try:
        datas = [rnd((1, 2, 64), s) for s in (1, 2)]
        futs = [eng.submit_encode(d) for d in datas]
        assert eng.flush(timeout=0.01) is False     # still working
        assert eng.flush(timeout=30) is True
        for f, d in zip(futs, datas):
            assert f.done()
            assert same(f.result(), codec.encode(d))
    finally:
        eng.close()


def test_close_timeout_rejects_still_queued():
    eng = make_engine(2, 1, rs_backend="cpu",
                      policy=AdmissionPolicy(max_delay=30.0))
    real = eng._op_encode
    eng._op_encode = lambda b: (time.sleep(1.5), real(b))[1]
    # different shapes -> two batches: the first goes in flight (and
    # sleeps), the second is still queued when close() gives up
    f1 = eng.submit_encode(rnd((1, 2, 64), 1))
    f2 = eng.submit_encode(rnd((1, 2, 128), 2))
    time.sleep(0.3)
    eng.close(timeout=0.1)
    with pytest.raises(EngineClosed):
        f2.result(timeout=10)
    assert f1.result(timeout=10).shape == (1, 3, 64)


def test_failed_batch_rejects_every_member():
    """An op failure rejects each member's future with the op's error;
    nothing is rerun."""
    eng = make_engine(2, 1, rs_backend="cpu",
                      policy=AdmissionPolicy(max_delay=0.25))
    calls = []

    def boom(batch):
        calls.append(len(batch))
        raise RuntimeError("device fault")

    eng._op_encode = boom
    try:
        futs = [eng.submit_encode(rnd((1, 2, 64), s)) for s in (1, 2, 3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device fault"):
                f.result(timeout=10)
        assert calls == [3]
        st = eng.stats_snapshot()["classes"]["encode"]
        assert st["failed"] == 3 and st["completed"] == 0
    finally:
        eng.close()


def test_program_cache_lru_bounded():
    cache = ProgramCache(capacity=3)
    jcache = jbuckets.ProgramCache(capacity=3)
    for c in (cache, jcache):
        for i in range(5):
            c.get(("op", i), lambda i=i: (lambda: i))
        assert len(c) == 3               # oldest two evicted
        c.get(("op", 2), lambda: (lambda: None))
        c.get(("op", 9), lambda: (lambda: None))
        assert len(c) == 3
        built = []
        c.get(("op", 2), lambda: built.append(1))
        assert not built                 # hot key still cached
    assert cache.keys() == [("op", 4), ("op", 9), ("op", 2)]  # LRU first
    assert ProgramCache.CAPACITY == jbuckets.ProgramCache.CAPACITY == 256


def test_bucket_padding_and_program_reuse():
    assert [bucket_rows(n) for n in (1, 2, 3, 5, 9, 600)] == \
        [jbuckets.bucket_rows(n) for n in (1, 2, 3, 5, 9, 600)] == \
        [1, 2, 4, 8, 16, 1024]
    with pytest.raises(ValueError):
        bucket_rows(0)
    eng, jeng = engines(audit=False)
    try:
        for seed in (1, 2, 3):
            data = rnd((3, 2, 128), seed)   # same bucket every time
            assert same(eng.encode(data), jeng.encode(data))
        snap = eng.stats_snapshot()
        assert snap["programs_built"] == 1
        assert snap["programs_reused"] == 2
    finally:
        eng.close()
        jeng.close()


def test_mixed_shapes_do_not_cross_coalesce():
    eng, jeng = engines(policy=AdmissionPolicy(max_delay=0.2), audit=False)
    try:
        a, b = rnd((2, 2, 128), 1), rnd((2, 2, 256), 2)
        fa, fb = eng.submit_encode(a), eng.submit_encode(b)
        assert same(fa.result(timeout=30), jeng.encode(a))
        assert same(fb.result(timeout=30), jeng.encode(b))
        assert eng.stats_snapshot()["classes"]["encode"]["batches"] == 2
    finally:
        eng.close()
        jeng.close()


# -- StoragePipeline(engine=...) ---------------------------------------------

@pytest.mark.parametrize("limbs", [2, 3])
def test_pipeline_engine_matches_direct_and_jax(limbs):
    jkey, key = keys(limbs=limbs)
    seg = 2 * FRAG
    cfg = PipelineConfig(k=2, m=1, segment_size=seg)
    jcfg = jpipeline.PipelineConfig(k=2, m=1, segment_size=seg)
    eng = make_engine(2, 1, rs_backend="cpu", podr2_key=key,
                      audit_backend="cpu",
                      policy=AdmissionPolicy(max_delay=0.005))
    try:
        piped = StoragePipeline(cfg, podr2_key=key, device="cpu", engine=eng)
        direct = StoragePipeline(cfg, podr2_key=key, device="cpu")
        jpipe = jpipeline.StoragePipeline(jcfg, podr2_key=jkey)
        segs = rnd((3, seg), 11)
        ids = rnd((3, 3, 2), 12, dtype=np.uint32)
        out = piped(segs, ids)
        ref = direct(segs, ids)
        jref = jpipe.forward(segs, ids)
        for name in ("fragments", "tags"):
            assert isinstance(out[name], torch.Tensor)
            assert torch.equal(out[name], ref[name])
            assert same(out[name], jref[name])
        snap = eng.stats_snapshot()["classes"]
        assert snap["encode"]["completed"] == snap["tag"]["completed"] == 1
        # scalar (default) ids stay on the direct path, as in the JAX package
        assert torch.equal(piped(segs)["tags"], direct(segs)["tags"])
        assert eng.stats_snapshot()["classes"]["tag"]["completed"] == 1
    finally:
        eng.close()


@pytest.mark.parametrize("mismatch", ["geometry", "key"])
def test_pipeline_refuses_mismatched_engine(mismatch):
    _, key = keys()
    cfg = PipelineConfig(k=2, m=1, segment_size=2 * FRAG)
    if mismatch == "geometry":
        eng = make_engine(4, 8, rs_backend="cpu")
        match = "RS"
    else:
        other = podr2.Podr2Key.generate(99, device="cpu")
        eng = make_engine(2, 1, rs_backend="cpu", podr2_key=other,
                          audit_backend="cpu")
        match = "key"
    try:
        with pytest.raises(ValueError, match=match):
            StoragePipeline(cfg, podr2_key=key, device="cpu", engine=eng)
    finally:
        eng.close()


# -- warm repair ---------------------------------------------------------------

def test_warm_repair_fills_the_keys_op_repair_reads():
    """warm_repair prepares the codec's program for each bucket and
    fills the cache under _op_repair's keys: the warmed reconstruct
    builds no program and bumps warm_hits; a bucket never warmed
    misses."""
    codec = rs.TorchCodec(2, 1, "cpu")
    eng = SubmissionEngine(codec=codec,
                           policy=AdmissionPolicy(max_delay=0.005))
    jeng = jserve.make_engine(2, 1, rs_backend="jax",
                              policy=jserve.AdmissionPolicy(max_delay=0.005))
    try:
        n = 256
        eng.warm_repair([((1, 2), (0,))], n, buckets=(1, 2, 4))
        jeng.warm_repair([((1, 2), (0,))], n, buckets=(1, 2, 4))
        built = eng.stats_snapshot()["programs_built"]
        assert built == jeng.stats_snapshot()["programs_built"] == 3
        assert codec.warm_hits == 0
        coded = np.asarray(jeng.codec.encode(rnd((3, 2, n), 61)))
        for rows in (1, 2, 3):                   # buckets 1, 2, 4
            rec = eng.reconstruct(coded[:rows, [1, 2]], (1, 2), (0,))
            assert same(rec, coded[:rows, :1])
            assert same(rec, jeng.reconstruct(coded[:rows, [1, 2]],
                                              (1, 2), (0,)))
        snap = eng.stats_snapshot()
        assert snap["programs_built"] == built
        assert snap["programs_reused"] == 3
        assert codec.warm_hits == 3
        eng.reconstruct(rnd((5, 2, n), 62), (1, 2), (0,))   # bucket 8: cold
        assert codec.warm_hits == 3
        assert eng.stats_snapshot()["programs_built"] == built + 1
    finally:
        eng.close()
        jeng.close()


def test_warm_repair_warms_the_regen_folds():
    codec = regen.RegenCodec(2, 1, device="cpu")
    eng = SubmissionEngine(codec=codec,
                           policy=AdmissionPolicy(max_delay=0.005))
    try:
        n = 128
        eng.warm_repair([((1, 2), (0,))], n)
        coeffs = sorted(set(regen.repair_coeffs(2, 1, (1, 2), (0,))) - {0})
        # reconstruct x 2 buckets, fold x 2 buckets per coefficient
        assert eng.stats_snapshot()["programs_built"] == 2 + 2 * len(coeffs)
        pairs = rnd((2, 2, n), 63)
        out = eng.repair_symbol(pairs, coeffs[0])
        assert same(out, regen.fold_symbol_pairs(pairs, coeffs[0]))
        assert codec.warm_hits == 1
        assert eng.stats_snapshot()["programs_reused"] == 1
    finally:
        eng.close()


# -- surface -------------------------------------------------------------------

@pytest.mark.parametrize("plane", ["slo", "adaptive", "admission",
                                   "profile"])
def test_unported_planes_are_refused(plane):
    """Each control plane is accepted and exposed by the constructor and
    by make_engine (the name is kept from when the port refused them)."""
    from cess_tpu_torch.obs.profile import ProfilePlane
    from cess_tpu_torch.obs.slo import SloBoard
    from cess_tpu_torch.serve import AdaptiveBatchPolicy, AdmissionController

    board = SloBoard()
    built = {"slo": lambda: board,
             "adaptive": lambda: AdaptiveBatchPolicy(board=board),
             "admission": lambda: AdmissionController(board),
             "profile": ProfilePlane}
    for make in (lambda **kw: SubmissionEngine(rs.make_codec(2, 1, "cpu"),
                                               None, None, **kw),
                 lambda **kw: make_engine(2, 1, rs_backend="cpu", **kw)):
        obj = built[plane]()
        eng = make(**{plane: obj})
        try:
            assert getattr(eng, plane) is obj
            for other in {"slo", "adaptive", "admission", "profile"} - {
                    plane}:
                assert getattr(eng, other) is None
            assert eng.encode(rnd((1, 2, 64), 1)).shape == (1, 3, 64)
            snap = eng.stats_snapshot()
            if plane in ("slo", "adaptive", "profile"):
                assert plane in snap
        finally:
            eng.close()
        with pytest.raises(TypeError):
            make(**{plane + "_plane": obj})


def test_policy_and_metric_names_match_jax():
    assert CLASS_PRIORITY == jserve.policy.CLASS_PRIORITY
    assert CLASSES == jserve.policy.CLASSES
    assert AdmissionPolicy() == AdmissionPolicy(
        queue_cap=256, max_batch_requests=32, max_batch_rows=512,
        max_delay=0.002)
    jdef = jserve.AdmissionPolicy()
    assert [getattr(AdmissionPolicy(), f) for f in (
        "queue_cap", "max_batch_requests", "max_batch_rows", "max_delay",
        "default_timeout")] == [getattr(jdef, f) for f in (
            "queue_cap", "max_batch_requests", "max_batch_rows", "max_delay",
            "default_timeout")]
    with pytest.raises(ValueError):
        AdmissionPolicy(queue_cap=0)
    eng, jeng = engines()
    try:
        eng.encode(rnd((2, 2, 128), 8))
        jeng.encode(rnd((2, 2, 128), 8))
        m, jm = eng.stats_metrics(), jeng.stats_metrics()
        assert m["cess_engine_encode_completed"] == 1
        # the same names, the SLO plane's shed counter included
        assert set(m) == set(jm)
        assert set(eng.stats_histograms()) == set(jeng.stats_histograms())
        assert eng.stats_histograms()[
            "cess_engine_encode_latency_seconds"].count == 1
    finally:
        eng.close()
        jeng.close()


def test_latency_histogram_matches_jax():
    assert prom.LATENCY_BUCKETS_S == jprom.LATENCY_BUCKETS_S
    h, jh = prom.Histogram(), jprom.Histogram()
    xs = np.random.default_rng(3).exponential(0.02, 200)
    for x in xs:
        h.observe(x)
        jh.observe(x)
    assert h.snapshot() == jh.snapshot()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    other, jother = prom.Histogram(), jprom.Histogram()
    other.observe(20.0)
    jother.observe(20.0)
    assert h.merge(other).snapshot() == jh.merge(jother).snapshot()
    assert h.count == 201
    with pytest.raises(ValueError):
        h.merge(prom.Histogram((1.0, 2.0)))


def test_bad_submits_are_refused():
    eng, jeng = engines()
    jeng.close()
    try:
        with pytest.raises(ValueError, match="shards"):
            eng.submit_encode(rnd((2, 3, 64), 1))
        with pytest.raises(ValueError, match="empty"):
            eng.submit_encode(np.zeros((0, 2, 64), np.uint8))
        with pytest.raises(ValueError, match="ids"):
            eng.submit_tag(np.zeros((2, 3), np.int64), rnd((2, FRAG), 2))
        with pytest.raises(ValueError, match="codec and/or audit"):
            SubmissionEngine()
        audit_only = make_engine(podr2_key=eng.audit.key,
                                 audit_backend="cpu")
        try:
            with pytest.raises(ValueError, match="no ErasureCodec"):
                audit_only.submit_encode(rnd((1, 2, 64), 3))
        finally:
            audit_only.close()
    finally:
        eng.close()
