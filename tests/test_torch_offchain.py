"""The device half of the off-chain agents (cess_tpu_torch.node) against
the JAX package's agents (cess_tpu.node.offchain) on the same seeded
inputs, on the CPU.

Tolerance 0 everywhere: fragments, hashes, tags, challenges, proofs and
verdicts are protocol facts. ``HostPodr2`` must also hand back the dtypes
``np.asarray`` gives the JAX results. The JAX agents are built partially
(``__new__``) or around a stand-in node, since only their device half is
compared; the whole agents on the port run in tests/test_torch_sim.py.
The card's run of the same steps is tests/test_torch_agents_card.py.
"""
import hashlib
import os
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from cess_tpu import codec as jcodec
from cess_tpu.crypto import hashing as jhashing
from cess_tpu.models import pipeline as jpipeline
from cess_tpu.node import offchain as joff
from cess_tpu.obs import trace as jtrace
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.ops import rs as jrs
from cess_tpu.resilience import faults as jfaults
from cess_tpu_torch import convert
from cess_tpu_torch.models.pipeline import PipelineConfig
from cess_tpu_torch.node import hashing, offchain
from cess_tpu_torch.obs import trace
from cess_tpu_torch.ops import podr2
from cess_tpu_torch.resilience import faults
from cess_tpu_torch.serve import make_engine

SEG = 128 * 1024            # RS(2,1): fragments of 64 KiB, 128 blocks
K, M = 2, 1
ROWS = K + M
BLOCKS = SEG // K // 512
P = (1 << 31) - 1


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def adapt(jkey):
    """The test's key adapter: a JAX key as a port key on the CPU."""
    return convert.podr2_key_from_arrays(
        np.asarray(jkey.alpha), np.asarray(jax.random.key_data(jkey.prf_key)),
        "cpu")


def jkey_of(limbs=2, seed=7):
    return jpodr2.Podr2Key.generate(seed, jpodr2.Podr2Params(limbs=limbs))


def host_podr2():
    return offchain.HostPodr2("cpu", key_adapter=adapt)


def rnd(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def hash_ids(frags):
    hashes = [jhashing.fragment_hash(f.tobytes()) for f in frags]
    return hashes, np.stack([jpodr2.fragment_id_from_hash(h) for h in hashes])


class StandInNode:
    """What ``OssGateway.upload`` reads of its node: a place to submit."""

    def __init__(self):
        self.extrinsics = []

    def submit_extrinsic(self, *args):
        self.extrinsics.append(args)


def agent_pipelines(limbs=2, engine=None):
    """(JAX StoragePipeline, port AgentPipeline on the CPU), one key."""
    jkey = jkey_of(limbs)
    jpipe = jpipeline.StoragePipeline(
        jpipeline.PipelineConfig(k=K, m=M, segment_size=SEG), podr2_key=jkey)
    pipe = offchain.AgentPipeline(PipelineConfig(k=K, m=M, segment_size=SEG),
                                  podr2_key=adapt(jkey), device="cpu",
                                  engine=engine)
    return jpipe, pipe


@pytest.fixture(scope="module")
def deal():
    """Four fragments with JAX tags under the chain's key: a miner's store."""
    jkey = jkey_of()
    frags = rnd((4, SEG // K), 3)
    hashes, ids = hash_ids(frags)
    tags = np.asarray(jpodr2.tag_fragments(jkey, ids, frags))
    return {"jkey": jkey, "frags": frags, "hashes": hashes, "ids": ids,
            "tags": tags,
            "store": {h: f.tobytes() for h, f in zip(hashes, frags)},
            "tag_map": dict(zip(hashes, tags))}


# -- own copies of the host hashes -----------------------------------------
@pytest.mark.parametrize("miner,index,size", [
    ("m0", 0, 8192), ("miner-with-a-long-name", 7, 1000), ("m1", 3, 0)])
def test_filler_bytes_and_fragment_hash_match_reference(miner, index, size):
    blob = hashing.filler_bytes(miner, index, size)
    assert blob == joff.filler_bytes(miner, index, size)
    assert hashing.fragment_hash(blob) == jhashing.fragment_hash(blob)
    assert hashing.fragment_hash(np.frombuffer(blob, np.uint8)) \
        == jhashing.fragment_hash(blob)


# -- HostPodr2 against cess_tpu.ops.podr2 ------------------------------------
def test_host_podr2_constants_and_ids():
    ops = host_podr2()
    for name in ("SECTORS", "BLOCK_BYTES", "LIMBS", "PROOF_BYTES"):
        assert getattr(ops, name) == getattr(jpodr2, name)
    h = jhashing.fragment_hash(b"fragment")
    got, want = ops.fragment_id_from_hash(h), jpodr2.fragment_id_from_hash(h)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("blocks", [16, 128, 16384])
def test_gen_challenge_matches(blocks):
    idx, nu = host_podr2().gen_challenge(b"round-seed", blocks)
    jidx, jnu = (np.asarray(x) for x in jpodr2.gen_challenge(b"round-seed",
                                                             blocks))
    assert idx.dtype == jidx.dtype and nu.dtype == jnu.dtype
    assert np.array_equal(idx, jidx) and np.array_equal(nu, jnu)


def test_aggregate_coeffs_matches(deal):
    ids = jax.numpy.asarray(deal["ids"])
    got = host_podr2().aggregate_coeffs(b"round-seed", ids)
    want = np.asarray(jpodr2.aggregate_coeffs(b"round-seed", ids))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("limbs", [2, 3])
def test_tag_fragments_matches(limbs):
    jkey = jkey_of(limbs)
    frags = rnd((3, SEG // K), 5)
    _, ids = hash_ids(frags)
    ops = host_podr2()
    got = ops.tag_fragments(jkey, jax.numpy.asarray(ids),
                            jax.numpy.asarray(frags))
    want = np.asarray(jpodr2.tag_fragments(jkey, ids, frags))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("limbs", [2, 3])
def test_prove_and_verify_aggregate_match(limbs):
    jkey = jkey_of(limbs)
    frags = rnd((3, SEG // K), 6)
    _, ids = hash_ids(frags)
    tags = np.asarray(jpodr2.tag_fragments(jkey, ids, frags))
    ops = host_podr2()
    idx, nu = ops.gen_challenge(b"s", BLOCKS)
    r = ops.aggregate_coeffs(b"s", ids)
    mu, sigma = ops.prove_aggregate(jax.numpy.asarray(frags),
                                    jax.numpy.asarray(tags), idx, nu, r)
    jmu, jsigma = (np.asarray(x) for x in jpodr2.prove_aggregate(
        jax.numpy.asarray(frags), jax.numpy.asarray(tags), idx, nu, r))
    assert mu.dtype == jmu.dtype and sigma.dtype == jsigma.dtype
    assert np.array_equal(mu, jmu) and np.array_equal(sigma, jsigma)
    bad = (jsigma.astype(np.int64) + 1) % P
    for s, want in ((jsigma, True), (bad.astype(np.uint32), False)):
        got = ops.verify_aggregate(jkey, ids, BLOCKS, idx, nu, r, jmu, s)
        ref = bool(np.asarray(jpodr2.verify_aggregate(
            jkey, ids, BLOCKS, idx, nu, r, jmu, s)))
        assert type(got) is bool and got == ref == want


def test_keys_equal_through_the_adapter():
    a, b = jkey_of(), jkey_of(seed=8)
    ops = host_podr2()
    assert ops.keys_equal(a, a) and ops.keys_equal(a, jkey_of())
    assert ops.keys_equal(a, adapt(a)) and not ops.keys_equal(a, b)
    assert isinstance(ops.port_key(a), podr2.Podr2Key)
    assert ops.port_key(a).alpha.device.type == "cpu"
    with pytest.raises(TypeError, match="key_adapter"):
        offchain.HostPodr2("cpu").tag_fragments(a, np.zeros((1, 2), np.uint32),
                                                np.zeros((1, 512), np.uint8))


# -- the gateway ---------------------------------------------------------------
@pytest.mark.parametrize("routed", ["direct", "engine"])
def test_upload_batch_matches_gateway_upload(routed):
    jpipe, pipe = agent_pipelines()
    eng = None
    if routed == "engine":
        eng = make_engine(K, M, rs_backend="cpu", audit_backend="cpu",
                          podr2_key=pipe.podr2_key)
        pipe.engine = eng
    data = rnd(3 * SEG - 1000, 8).tobytes()          # a ragged last segment
    node = StandInNode()
    gw = joff.OssGateway(node, "gw0", jpipe)
    try:
        file_hash = gw.upload("alice", "photos", "f.bin", data)
        up = offchain.upload_batch(pipe, data, tenant="alice")
    finally:
        if eng is not None:
            eng.close()
    _, _, want_hash, seg_list, _, size = node.extrinsics[0]
    assert up.file_hash == file_hash == want_hash and size == len(data)
    assert [(s, f) for s, f in zip(up.segment_hashes,
                                   up.fragment_hashes)] == seg_list
    assert up.tags.dtype == np.uint32 and up.ids.dtype == np.uint32
    for i, hashes in enumerate(up.fragment_hashes):
        for j, h in enumerate(hashes):
            assert up.fragments[i, j].tobytes() == gw.fragment_store[h]
            assert np.array_equal(up.tags[i, j], gw.tag_store[h])
            assert np.array_equal(up.ids[i, j], jpodr2.fragment_id_from_hash(h))
    assert up.fetches == 1 and pipe.fragment_uploads == 0
    assert set(up.seconds) == {"pad", "encode", "encode.h2d",
                               "encode.launch", "fetch", "fetch.wait",
                               "fetch.copy", "hash", "tag", "finish",
                               "encode.queue", "tag.queue", "hash.queue",
                               "hash.busy"}
    # the engine's requests, encode then tag; none on the direct path
    assert [rc.cls for rc in up.engine] == (
        ["encode", "tag"] if routed == "engine" else [])


TOP_STAGES = ("pad", "encode", "fetch", "hash", "tag", "finish")
STAGE_RANGES = ["offchain.upload." + k for k in offchain.UPLOAD_STAGES]


def test_upload_stage_parts_sum_to_their_stage():
    _, pipe = agent_pipelines()
    up = offchain.upload_batch(pipe, rnd(2 * SEG + 5, 41).tobytes())
    s = up.seconds
    assert list(s) == list(offchain.UPLOAD_STAGES + offchain.ENGINE_CLOCKS
                           + offchain.HASH_CLOCKS)
    assert s["encode"] == s["encode.h2d"] + s["encode.launch"]
    assert s["fetch"] == s["fetch.wait"] + s["fetch.copy"]
    assert all(v >= 0 for v in s.values()) and s["hash"] > 0
    parts = [k for k in offchain.UPLOAD_STAGES if "." in k]
    assert {k.split(".")[0] for k in parts} == {"encode", "fetch"}
    assert [k for k in s if "." not in k] == list(TOP_STAGES)
    # no engine: its queue clocks read 0
    assert [s[k] for k in offchain.ENGINE_CLOCKS] == [0.0, 0.0]


def test_upload_stages_cover_the_wall():
    """The top-level stages leave almost nothing of an upload unclocked:
    the best of three calls, timed around ``upload_batch``."""
    _, pipe = agent_pipelines()
    data = rnd(3 * SEG - 1000, 42)
    shares = []
    for _ in range(3):
        t0 = time.perf_counter()
        up = offchain.upload_batch(pipe, data)
        wall = time.perf_counter() - t0
        shares.append(sum(up.seconds[k] for k in TOP_STAGES) / wall)
    assert 0.95 <= max(shares) <= 1.0


@pytest.mark.parametrize("all_threads", [False, True])
def test_upload_opens_one_profiler_range_per_stage_in_order(all_threads):
    """Under a profiler of this thread, and under one of every thread
    (``profile_all_threads``, the benchmark's slice), whose state the
    calling thread's ``torch.autograd._profiler_enabled()`` misses."""
    from torch._C._profiler import _ExperimentalConfig

    _, pipe = agent_pipelines()
    config = {"experimental_config": _ExperimentalConfig(
        profile_all_threads=True)} if all_threads else {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            **config) as prof:
        offchain.upload_batch(pipe, rnd(SEG + 7, 43).tobytes())
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.name.startswith("offchain.upload.")))
    assert [n for _, _, n in ranges] == STAGE_RANGES
    span = {n: (t0, t1) for t0, t1, n in ranges}
    for name, (t0, t1) in span.items():
        parent = name.rsplit(".", 1)[0]
        if parent in span:                  # a part inside its stage
            assert span[parent][0] <= t0 and t1 <= span[parent][1]
    top = [span["offchain.upload." + k] for k in TOP_STAGES]
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))


def test_upload_stages_are_child_spans_of_the_upload():
    _, pipe = agent_pipelines()
    tracer = trace.Tracer()
    with trace.armed(tracer):
        offchain.upload_batch(pipe, rnd(SEG, 44).tobytes(), file="f.bin")
    spans = {s["name"]: s for s in tracer.finished()}
    upload = spans["offchain.upload"]
    # one segment of RS(2,1): itself and data row 1 early, the parity
    # row after the fetch
    assert upload["attrs"] == {"file": "f.bin", "segments": 1, "size": SEG,
                               "pinned": False, "host_allocs": 0,
                               "hashed_bytes": 2 * SEG,
                               "early_bytes": SEG + SEG // K}
    for name in STAGE_RANGES:
        parent = name.rsplit(".", 1)[0]
        want = upload if parent == "offchain.upload" else spans[parent]
        assert spans[name]["parent_id"] == want["span_id"], name
    assert spans["pipeline.encode"]["parent_id"] == \
        spans["offchain.upload.encode.launch"]["span_id"]


def test_upload_off_opens_no_range_and_no_span(monkeypatch):
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: made.append(name) or real(name, *a))
    spans = []
    real_init = trace.Span.__init__

    def counting(self, *args, **kwargs):
        spans.append(args[1])
        real_init(self, *args, **kwargs)

    monkeypatch.setattr(trace.Span, "__init__", counting)
    trace.disarm()
    _, pipe = agent_pipelines()
    up = offchain.upload_batch(pipe, rnd(SEG, 45).tobytes())
    assert made == [] and spans == [] and up.fetches == 1
    # the same counters see an armed tracer's spans
    with trace.armed(trace.Tracer()):
        offchain.upload_batch(pipe, rnd(SEG, 45).tobytes())
    assert made == [] and len(spans) == 13


@pytest.mark.parametrize("size", [SEG, 3 * SEG - 1000])
def test_upload_on_the_cpu_stages_nothing_page_locked(size):
    """Whole segments and a padded file alike: the span says so."""
    _, pipe = agent_pipelines()
    tracer = trace.Tracer()
    with trace.armed(tracer):
        offchain.upload_batch(pipe, rnd(size, 46).tobytes())
    (upload,) = [s for s in tracer.finished()
                 if s["name"] == "offchain.upload"]
    assert upload["attrs"]["pinned"] is False
    assert upload["attrs"]["host_allocs"] == 0


def test_kept_uploads_on_the_cpu_share_no_memory():
    _, pipe = agent_pipelines()
    data = [rnd(2 * SEG - 9, seed) for seed in (47, 48, 49)]
    kept = [offchain.upload_batch(pipe, d) for d in data[:2]]
    copies = [up.fragments.copy() for up in kept]
    later = offchain.upload_batch(pipe, data[2])
    assert not np.shares_memory(kept[0].fragments, kept[1].fragments)
    assert not np.shares_memory(kept[1].fragments, later.fragments)
    for up, want in zip(kept, copies):
        assert np.array_equal(up.fragments, want)
    assert not np.array_equal(copies[0], copies[1])


@pytest.mark.parametrize("size", [2 * SEG, 2 * SEG + 5])
def test_wrapped_pipeline_upload_stages_nothing_page_locked_on_the_cpu(size):
    """A gateway on a port ``StoragePipeline`` wraps it as an
    ``AgentPipeline``: its uploads stage nothing page-locked on the CPU
    and give the identities of a direct upload."""
    _, pipe = agent_pipelines()
    data = rnd(size, 50).tobytes()
    want = offchain.upload_batch(pipe, data)
    gateway = offchain.OssGateway(StandInNode(), "gw0", pipe.pipeline)
    assert gateway.pipeline is not pipe
    assert gateway.pipeline.pipeline is pipe.pipeline
    assert gateway.pipeline.fragment_uploads == 0
    tracer = trace.Tracer()
    with trace.armed(tracer):
        file_hash = gateway.upload("alice", "photos", "f.bin", data)
    (upload,) = [s for s in tracer.finished()
                 if s["name"] == "offchain.upload"]
    assert upload["attrs"]["pinned"] is False
    assert upload["attrs"]["host_allocs"] == 0
    got = gateway.last_upload
    assert file_hash == got.file_hash == want.file_hash
    assert got.segment_hashes == want.segment_hashes
    assert got.fragment_hashes == want.fragment_hashes
    assert np.array_equal(got.ids, want.ids)
    assert np.array_equal(got.tags, want.tags)


@pytest.mark.parametrize("size", [2 * SEG, 2 * SEG + 5])
def test_upload_of_bytes_and_of_an_array_agree_on_the_cpu(size):
    """Read-only bytes are copied into segments of their own, a writable
    array of whole segments is read where it lies: the same upload."""
    _, pipe = agent_pipelines()
    data = rnd(size, 52)
    want = offchain.upload_batch(pipe, data)
    got = offchain.upload_batch(pipe, data.tobytes())
    assert np.array_equal(got.fragments, want.fragments)
    assert np.array_equal(got.tags, want.tags)
    assert got.fragment_hashes == want.fragment_hashes
    assert got.segment_hashes == want.segment_hashes
    assert got.file_hash == want.file_hash


GEOMETRIES = {"rs21": (2, 1), "rs48": (4, 8)}
HASH_SIZES = {"1B": 1, "seg-1": SEG - 1, "seg": SEG, "2seg": 2 * SEG,
              "3seg-1000": 3 * SEG - 1000}


def geometry_pipeline(k, m):
    """A port AgentPipeline of RS(k, m) over SEG-byte segments, on the
    CPU."""
    return offchain.AgentPipeline(PipelineConfig(k=k, m=m, segment_size=SEG),
                                  podr2_key=adapt(jkey_of()), device="cpu")


def sha(blob):
    return hashlib.sha256(blob).digest()


def padded_segments(data, seg):
    flat = np.frombuffer(bytes(data), np.uint8)
    out = np.zeros(-(-flat.size // seg) * seg, np.uint8)
    out[:flat.size] = flat
    return out.reshape(-1, seg)


def assert_hashed_after_the_fetch(up, segments):
    """The upload's identities are those of hashing the fetched rows and
    the padded segments after the fetch, as every row was hashed before
    the segments and their data rows went to the pool early."""
    want = [tuple(sha(row) for row in seg) for seg in up.fragments]
    assert up.fragment_hashes == want
    assert up.segment_hashes == [sha(seg) for seg in segments]
    assert up.file_hash == sha(b"".join(h for fs in want for h in fs))
    ids = np.stack([jpodr2.fragment_id_from_hash(h)
                    for fs in want for h in fs])
    assert np.array_equal(up.ids, ids.reshape(up.ids.shape))


@pytest.mark.parametrize("as_bytes", [True, False], ids=["bytes", "array"])
@pytest.mark.parametrize("size", HASH_SIZES.values(), ids=HASH_SIZES.keys())
@pytest.mark.parametrize("k,m", GEOMETRIES.values(), ids=GEOMETRIES.keys())
def test_upload_identities_hashed_early_equal_the_fetched_rows(
        k, m, size, as_bytes):
    pipe = geometry_pipeline(k, m)
    data = rnd(size, 60 + size % 97)
    up = offchain.upload_batch(pipe, data.tobytes() if as_bytes else data)
    segments = padded_segments(data, SEG)
    assert up.fragments.shape == (len(segments), k + m, SEG // k)
    assert_hashed_after_the_fetch(up, segments)
    # systematic: data row j is the segment's j-th slice
    n = SEG // k
    for seg, frags in zip(segments, up.fragments):
        for j in range(k):
            assert np.array_equal(frags[j], seg[j * n:(j + 1) * n])


@pytest.mark.parametrize("k,m,units,before,share", [
    (2, 1, 32, 40, (3, 4)), (4, 8, 60, 64, (28, 60))], ids=GEOMETRIES.keys())
def test_upload_counts_the_bytes_it_hashes_early(k, m, units, before, share):
    """Per segment, in sixteenths of it (MiB at the 16 MiB mainnet
    segment): the segment, its data rows 1..k-1 early, its parity rows
    after the fetch; row 0's digest comes off the segment's own pass.
    Before, every row and the segment were hashed after the fetch."""
    pipe = geometry_pipeline(k, m)
    n, unit = SEG // k, SEG // 16
    assert ((k + m) * n + SEG) // unit == before
    tracer = trace.Tracer()
    with trace.armed(tracer):
        for size in (2 * SEG, 3 * SEG - 1000):
            offchain.upload_batch(pipe, rnd(size, size % 89).tobytes())
    attrs = [s["attrs"] for s in tracer.finished()
             if s["name"] == "offchain.upload"]
    assert [a["hashed_bytes"] for a in attrs] == [2 * units * unit,
                                                  3 * units * unit]
    for a in attrs:
        assert a["early_bytes"] * share[1] == a["hashed_bytes"] * share[0]
        assert a["early_bytes"] == a["segments"] * (SEG + (k - 1) * n)


@pytest.mark.parametrize("n", [1, 63, 64, 65, SEG // 4, SEG // 2, SEG])
def test_segment_and_first_row_hash_in_one_pass(n):
    """The segment's digest and that of its first n bytes, whether or not
    n falls on sha256's 64-byte block, and up to the whole segment."""
    seg = rnd(SEG, 65 + n % 7)
    assert offchain._segment_and_first_row(seg, n) == (sha(seg),
                                                       sha(seg[:n]))


def test_uploads_side_by_side_on_the_shared_pool_keep_their_own_hashes():
    """Two threads upload different files on one pipeline at once, each
    several segments, so their hashes interleave on the process's pool:
    each ``Upload`` holds its own file's identities alone."""
    pipe = geometry_pipeline(K, M)
    datas = [rnd(5 * SEG - 333, 62), rnd(4 * SEG + 77, 63)]
    want = [offchain.upload_batch(pipe, d) for d in datas]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(3):
            barrier = threading.Barrier(len(datas))
            ups = [None] * len(datas)

            def client(i):
                barrier.wait()
                ups[i] = offchain.upload_batch(pipe, datas[i].tobytes())

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(datas))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            for up, w, d in zip(ups, want, datas):
                assert up.fragment_hashes == w.fragment_hashes
                assert up.segment_hashes == w.segment_hashes
                assert up.file_hash == w.file_hash
                assert_hashed_after_the_fetch(up, padded_segments(d, SEG))
    finally:
        sys.setswitchinterval(switch)


def slowed(fn, delay):
    def slow(*args):
        time.sleep(delay)
        return fn(*args)
    return slow


@pytest.fixture
def hash_pool(monkeypatch):
    """``pool(threads)`` makes the process's hashing pool one of that many
    threads for the test."""
    made = []

    def pool(threads):
        made.append(ThreadPoolExecutor(threads))
        monkeypatch.setattr(offchain, "_hash_pool", (os.getpid(), made[-1]))

    yield pool
    for p in made:
        p.shutdown(wait=True)


#: threads, the hashes slowed ("segment": each segment's own pass, "row":
#: every row's), segments, through the engine
HASH_POOL_CASES = {
    # one thread, every hash slowed: the parity rows queue behind the
    # segments' passes
    "queued": (1, ("segment", "row"), 2, False),
    # a pool of free threads, one slow segment pass: every task starts at
    # once and "hash" waits on the running pass
    "running": (8, ("segment",), 1, False),
    # the worker-seconds of every task, early and parity alike
    "busy": (8, ("segment", "row"), 3, False),
    "engine": (1, ("segment", "row"), 2, True),
}
DELAY = {"queued": 0.05, "running": 0.3, "busy": 0.02, "engine": 0.05}


@pytest.mark.parametrize("case", HASH_POOL_CASES)
def test_upload_clocks_its_hash_tasks_on_the_pool(case, hash_pool,
                                                  monkeypatch):
    """Planted waits: ``hash.queue`` is the part of "hash" before the
    upload's last hash task started, ``hash.busy`` its tasks' run time."""
    threads, slow, segments, routed = HASH_POOL_CASES[case]
    delay = DELAY[case]
    hash_pool(threads)
    if "segment" in slow:
        monkeypatch.setattr(offchain, "_segment_and_first_row",
                            slowed(offchain._segment_and_first_row, delay))
    if "row" in slow:
        monkeypatch.setattr(offchain, "fragment_hash",
                            slowed(offchain.fragment_hash, delay))
    eng = None
    pipe = geometry_pipeline(K, M)
    if routed:
        eng = make_engine(K, M, rs_backend="cpu", audit_backend="cpu",
                          podr2_key=pipe.podr2_key)
        pipe.engine = eng
    data = rnd(segments * SEG - 100, 66)
    try:
        up = offchain.upload_batch(pipe, data)
    finally:
        if eng is not None:
            eng.close()
    assert_hashed_after_the_fetch(up, padded_segments(data, SEG))
    s = up.seconds
    assert list(s)[-2:] == list(offchain.HASH_CLOCKS)
    assert 0.0 <= s["hash.queue"] <= s["hash"]
    # a segment's pass and each of its k - 1 data and m parity rows
    tasks = segments * ((K - 1 + M) if "row" in slow else 0) + segments
    assert s["hash.busy"] >= delay * tasks
    if case in ("queued", "engine"):
        assert s["hash.queue"] >= delay
    if case == "running":
        assert s["hash.queue"] <= 0.05
        assert s["hash"] - s["hash.queue"] >= delay / 2
    if routed:
        assert [rc.cls for rc in up.engine] == ["encode", "tag"]


def test_upload_hashes_count_only_tasks_that_ran(hash_pool):
    """Leaving the block cancels the tasks not yet started: they never
    run, so ``ran`` holds none of them. Tasks that ran on many threads at
    once are each counted once."""
    hash_pool(1)
    release = threading.Event()
    pool = offchain._hashers()
    pool.submit(release.wait)
    cfg = PipelineConfig(k=K, m=M, segment_size=SEG)
    with offchain._UploadHashes(cfg) as hashes:
        hashes.segment(rnd(SEG, 67))
        hashes.segment(rnd(SEG, 68))
    release.set()
    pool.shutdown(wait=True)
    assert hashes.ran == []
    hash_pool(1)
    with offchain._UploadHashes(cfg) as hashes:
        hashes.segment(rnd(SEG, 69))
        hashes.collect(np.zeros((1, K + M, SEG // K), np.uint8))
        queue, busy = hashes.clocks(time.perf_counter(), 1.0)
    assert len(hashes.ran) == K + M and queue == 0.0
    assert busy == pytest.approx(sum(t1 - t0 for t0, t1 in hashes.ran))
    assert all(t0 <= t1 for t0, t1 in hashes.ran)
    # more threads than cores, switching often: no append is lost
    hash_pool(4 * (os.cpu_count() or 1))
    segments = 40
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with offchain._UploadHashes(cfg) as hashes:
            for i in range(segments):
                hashes.segment(rnd(SEG, 70 + i))
            hashes.collect(np.zeros((segments, K + M, SEG // K), np.uint8))
    finally:
        sys.setswitchinterval(switch)
    assert len(hashes.ran) == segments * (K + M)


def test_corrupted_systematic_copy_keeps_the_segment_slices_identity(
        monkeypatch):
    """A data row's identity is the hash of the segment's bytes, which the
    protocol defines, not of the device's copy of them: the row is hashed
    from the host's segment before the fetch. A copy corrupted on the
    device therefore keeps the slice's identity, and a receiver's check
    of the bytes against it (``MinerAgent._transfer``) refuses the row,
    where hashing the fetched copy would have declared it under a hash
    of its own."""
    pipe = geometry_pipeline(K, M)
    real = pipe.pipeline._encode

    def corrupting(data, *args, **kwargs):
        out = real(data, *args, **kwargs)
        out[0, 1, 7] ^= 0xFF                # segment 0, data row 1
        return out

    monkeypatch.setattr(pipe.pipeline, "_encode", corrupting)
    data = rnd(2 * SEG - 5, 64)
    up = offchain.upload_batch(pipe, data)
    seg = padded_segments(data, SEG)[0]
    n = SEG // K
    assert up.fragment_hashes[0][1] == sha(seg[n:2 * n])
    assert sha(up.fragments[0, 1]) != up.fragment_hashes[0][1]
    assert not np.array_equal(up.fragments[0, 1], seg[n:2 * n])


def test_device_fragments_handle_fetches_once():
    jpipe, pipe = agent_pipelines()
    seg = rnd((2, SEG), 9)
    handle = pipe.encode_step(seg, tenant="alice")
    assert handle.shape == (2, ROWS, SEG // K) and handle.dtype == np.uint8
    assert handle.fetches == 0
    frags = np.asarray(handle)
    assert np.asarray(handle) is frags and handle.fetches == 1
    assert not frags.flags.writeable
    assert np.array_equal(frags, np.asarray(jpipe.encode_step(seg)))
    assert np.asarray(handle, dtype=np.int64).dtype == np.int64
    _, ids = hash_ids(frags.reshape(-1, SEG // K))
    ids = ids.reshape(2, ROWS, 2)
    tags = pipe.tag_step(handle, ids)
    assert pipe.fragment_uploads == 0 and handle.fetches == 1
    want = np.asarray(jpipe.tag_step(frags, ids))
    assert tags.dtype == want.dtype and np.array_equal(tags, want)
    # host fragments are copied to the device, and counted
    assert np.array_equal(pipe.tag_step(frags, ids), want)
    assert pipe.fragment_uploads == 1


def test_agent_pipeline_refuses_an_engine_of_another_key_or_geometry():
    _, pipe = agent_pipelines()
    other = make_engine(podr2_key=adapt(jkey_of(seed=8)), audit_backend="cpu")
    wide = make_engine(4, 2, rs_backend="cpu")
    try:
        for eng in (other, wide):
            with pytest.raises(ValueError):
                offchain.AgentPipeline(
                    PipelineConfig(k=K, m=M, segment_size=SEG),
                    podr2_key=pipe.podr2_key, device="cpu", engine=eng)
            with pytest.raises(ValueError):
                pipe.engine = eng
            assert pipe.engine is None
    finally:
        other.close()
        wide.close()


# -- the miner's proof -----------------------------------------------------------
def decoded(blob):
    proof = jcodec.decode(blob)
    return proof.mu, proof.sigma


@pytest.mark.parametrize("case", ["full", "partial", "empty", "limbs3",
                                  "engine"])
def test_prove_owed_matches_build_proof(case, deal):
    seed = b"round-" + case.encode()
    store, tag_map, owed = deal["store"], deal["tag_map"], deal["hashes"]
    limbs, eng = 2, None
    if case == "partial":
        store = {h: b for h, b in store.items() if h != owed[1]}
    elif case == "empty":
        store = {}
    elif case == "limbs3":
        jkey, limbs = jkey_of(3), 3
        tag_map = dict(zip(owed, np.asarray(jpodr2.tag_fragments(
            jkey, deal["ids"], deal["frags"]))))
    elif case == "engine":
        eng = make_engine(podr2_key=adapt(deal["jkey"]), audit_backend="cpu")
    try:
        mu, sigma = offchain.prove_owed(seed, owed, store, tag_map,
                                        limbs=limbs, engine=eng,
                                        tenant="m0", device="cpu")
    finally:
        if eng is not None:
            eng.close()
    want_mu, want_sigma = decoded(joff.build_proof(seed, owed, store, tag_map,
                                                   limbs=limbs))
    assert mu.dtype == want_mu.dtype == np.uint32
    assert sigma.dtype == want_sigma.dtype and sigma.shape == (limbs,)
    assert np.array_equal(mu, want_mu) and np.array_equal(sigma, want_sigma)
    assert (case == "empty") == (not mu.any() and not sigma.any())


# -- the TEE's check --------------------------------------------------------------
def jax_tee(jkey):
    tee = joff.TeeAgent.__new__(joff.TeeAgent)
    tee.key, tee.blocks, tee.engine = jkey, BLOCKS, None
    return tee


@pytest.mark.parametrize("case", ["honest", "wrong-owed", "tampered", "empty",
                                  "empty-nonzero", "wide-sigma", "sigma-at-p",
                                  "engine-honest", "engine-tampered",
                                  "engine-other-key"])
def test_verify_owed_matches_tee_verify(case, deal):
    seed = b"verify-round"
    owed = deal["hashes"]
    mu, sigma = decoded(joff.build_proof(seed, owed, deal["store"],
                                         deal["tag_map"]))
    if case == "engine-other-key":
        # the TEE refuses an engine that holds another key, and so does
        # the port's check, whatever the proof
        other = jkey_of(seed=8)
        with pytest.raises(ValueError):
            joff.TeeAgent(None, "tee0", deal["jkey"], BLOCKS,
                          engine=types.SimpleNamespace(
                              audit=types.SimpleNamespace(key=other)))
        eng = make_engine(podr2_key=adapt(other), audit_backend="cpu")
        try:
            with pytest.raises(ValueError, match="key"):
                offchain.verify_owed(adapt(deal["jkey"]), BLOCKS, seed, owed,
                                     mu, sigma, engine=eng, device="cpu")
        finally:
            eng.close()
        return
    if case == "wrong-owed":
        owed = owed[:-1] + [jhashing.fragment_hash(b"someone else's")]
    elif case.endswith("tampered"):
        mu = mu.copy()
        mu[0] = (int(mu[0]) + 1) % P
    elif case == "empty":
        owed, mu, sigma = [], np.zeros_like(mu), np.zeros_like(sigma)
    elif case == "empty-nonzero":
        owed = []
    elif case == "wide-sigma":
        sigma = np.concatenate([sigma, sigma])
    elif case == "sigma-at-p":
        sigma = np.full_like(sigma, P)
    eng = None
    if case.startswith("engine"):
        eng = make_engine(podr2_key=adapt(deal["jkey"]), audit_backend="cpu")
    jidx, jnu = jpodr2.gen_challenge(seed, BLOCKS)
    want = jax_tee(deal["jkey"])._verify(
        jcodec.encode(joff.Proof(mu=mu, sigma=sigma)), owed, seed, jidx, jnu)
    try:
        hoisted = {"idx": jidx, "nu": jnu} if case == "honest" else {}
        got = offchain.verify_owed(adapt(deal["jkey"]), BLOCKS, seed, owed,
                                   mu, sigma, engine=eng, tenant="tee0",
                                   device="cpu", **hoisted)
    finally:
        if eng is not None:
            eng.close()
    assert type(got) is bool and got == want
    assert got == (case in ("honest", "empty", "engine-honest"))


def test_certify_fillers_tags_match_reference():
    jkey = jkey_of()
    blobs = [joff.filler_bytes("m0", i, SEG // K) for i in range(3)]
    hashes, tags = offchain.certify_fillers(adapt(jkey), "m0", range(3), blobs,
                                            BLOCKS, device="cpu")
    assert hashes == [jhashing.fragment_hash(b) for b in blobs]
    ids = np.stack([jpodr2.fragment_id_from_hash(h) for h in hashes])
    want = np.asarray(jpodr2.tag_fragments(
        jkey, ids, np.stack([np.frombuffer(b, np.uint8) for b in blobs])))
    assert tags.dtype == want.dtype and np.array_equal(tags, want)
    with pytest.raises(ValueError, match="not canonical"):
        offchain.certify_fillers(adapt(jkey), "m1", [0], blobs[:1], BLOCKS,
                                 device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        offchain.certify_fillers(adapt(jkey), "m0", [0, 0], blobs[:2], BLOCKS,
                                 device="cpu")


# -- repair -----------------------------------------------------------------------
def holders_of(frags):
    """JAX miners holding one row each, partially built, and the segment."""
    hashes = [jhashing.fragment_hash(f.tobytes()) for f in frags]
    holders = {}
    for j, (h, f) in enumerate(zip(hashes, frags)):
        m = joff.MinerAgent.__new__(joff.MinerAgent)
        m.account, m.engine, m.store = f"m{j}", None, {h: f.tobytes()}
        holders[j] = m
    return holders, types.SimpleNamespace(fragment_hashes=hashes)


def rescuer():
    m = joff.MinerAgent.__new__(joff.MinerAgent)
    m.account, m.engine, m.repair_ingress_bytes = "r0", None, 0
    return m


def test_host_codec_matches_reference_codec():
    data = rnd((3, K, 4096), 50)
    jcodec_ = jrs.make_codec(K, M, "cpu")
    codec = offchain.host_codec(K, M, device="cpu")
    assert offchain.host_codec(K, M, device=torch.device("cpu")) is codec
    assert offchain.host_codec(K, M, "regen", device="cpu") is not codec
    with pytest.raises(ValueError, match="backend"):
        offchain.host_codec(K, M, "cpu", device="cpu")
    enc = codec.encode(data)
    want = np.asarray(jcodec_.encode(data))
    assert enc.dtype == np.uint8 and np.array_equal(enc, want)
    for present in ((0, 1), (0, 2), (1, 2)):
        surv = enc[:, list(present)]
        got = codec.decode_data(surv, present)
        assert np.array_equal(got, np.asarray(jcodec_.decode_data(surv,
                                                                  present)))
        assert np.array_equal(got, data)


def test_regen_host_codec_folds_and_replays_warm():
    from cess_tpu.ops import regen as jregen

    codec = offchain.host_codec(K, M, "regen", device="cpu")
    pairs = rnd((1, 2, 4096), 51)
    want = jregen.fold_symbol_host(pairs[0, 0], pairs[0, 1], 7)
    assert np.array_equal(codec.fold_symbol(pairs, 7)[0, 0], want)
    hits = codec.warm_hits
    codec.warm_fold(7, pairs.shape)
    got = codec.fold_symbol(pairs, 7)
    assert codec.warm_hits == hits + 1 and np.array_equal(got[0, 0], want)


@pytest.mark.parametrize("row", [0, 1, 2])
def test_repair_via_fragments_matches_cold_and_warm(row):
    cfg = jpipeline.PipelineConfig(k=K, m=M, segment_size=SEG)
    frags = np.asarray(jrs.make_codec(K, M, "cpu").encode(rnd((K, SEG // K),
                                                              10 + row)))
    holders, seg = holders_of(frags)
    present = tuple(j for j in range(ROWS) if j != row)[:K]
    want = rescuer()._repair_via_fragments(seg, row, present, holders, cfg)
    survivors = [holders[j].store[seg.fragment_hashes[j]] for j in present]
    codec = offchain.host_codec(K, M, device="cpu")
    cold = offchain.repair_via_fragments(K, M, survivors, present, row,
                                         device="cpu")
    hits = codec.warm_hits
    offchain.warm_restoral(K, M, SEG // K, device="cpu")
    warm = offchain.repair_via_fragments(K, M, survivors, present, row,
                                         device="cpu")
    assert codec.warm_hits == hits + 1
    assert cold == warm == want == frags[row].tobytes()
    assert hashing.fragment_hash(cold) == seg.fragment_hashes[row]


@pytest.mark.parametrize("fold", ["host", "regen-codec"])
def test_repair_via_symbols_matches(fold):
    cfg = jpipeline.PipelineConfig(k=K, m=M, segment_size=SEG)
    frags = np.asarray(jrs.make_codec(K, M, "cpu").encode(rnd((K, SEG // K),
                                                              20)))
    holders, seg = holders_of(frags)
    codec = offchain.host_codec(K, M, "regen", device="cpu") \
        if fold == "regen-codec" else None
    for row in range(ROWS):
        present = tuple(j for j in range(ROWS) if j != row)[:K]
        want = rescuer()._repair_via_symbols(seg, row, present, holders, cfg)
        got = offchain.repair_via_symbols(
            K, M, present, row,
            [holders[j].store[seg.fragment_hashes[j]] for j in present],
            codec=codec, device="cpu")
        assert got == want == frags[row].tobytes()
        assert hashing.fragment_hash(got) == seg.fragment_hashes[row]
    # a helper that holds nothing breaks the chain, as in the reference
    assert offchain.repair_via_symbols(K, M, (1, 2), 0, [None, b"x"],
                                       device="cpu") is None


def test_repair_symbol_fault_seams_match_reference():
    """The same seeded plan drops and corrupts the same hops in both
    packages: ``offchain.symbol`` and ``offchain.symbol_bytes``."""
    frags = rnd((4, 4096), 30)
    holders, seg = holders_of(frags)
    sites = {"offchain.symbol": (0.4, "drop"),
             "offchain.symbol_bytes": (0.4, "corrupt")}
    jplan = jfaults.FaultPlan.seeded(b"symbols", sites, horizon=64)
    plan = faults.FaultPlan.seeded(b"symbols", sites, horizon=64)
    got, want = [], []
    with jfaults.armed(jplan):
        for i in range(12):
            j = i % 4
            want.append(holders[j].repair_symbol(seg.fragment_hashes[j],
                                                 i + 1))
    with faults.armed(plan):
        for i in range(12):
            got.append(offchain.repair_symbol(K, M, frags[i % 4].tobytes(),
                                              i + 1, device="cpu"))
    assert plan.fired_log() == jplan.fired_log() and plan.fired_log()
    assert [None if g is None else g.tobytes() for g in got] \
        == [None if w is None else w.tobytes() for w in want]


# -- spans and the no-fallback rule ------------------------------------------------
def test_steps_open_the_reference_spans(deal):
    _, pipe = agent_pipelines()
    tracer = trace.Tracer()
    with trace.armed(tracer):
        offchain.upload_batch(pipe, rnd(SEG, 40).tobytes())
        mu, sigma = offchain.prove_owed(b"s", deal["hashes"], deal["store"],
                                        deal["tag_map"], device="cpu")
        offchain.verify_owed(adapt(deal["jkey"]), BLOCKS, b"s", deal["hashes"],
                             mu, sigma, device="cpu")
        offchain.repair_via_symbols(K, M, (1, 2), 0, [b"\1" * 512] * 2,
                                    device="cpu")
    names = [s["name"] for s in tracer.finished()]
    for name in ("offchain.upload", "pipeline.encode", "pipeline.tag",
                 "offchain.prove", "offchain.verify", "offchain.repair"):
        assert name in names
    assert jtrace.armed_tracer() is None and trace.armed_tracer() is None


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (offchain.AgentPipeline, offchain.HostPodr2,
                 lambda: offchain.host_codec(2, 1),
                 lambda: offchain.host_codec(2, 1, "regen")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offchain.prove_owed(b"s", [b"h"], {b"h": b"\0" * 512},
                            {b"h": np.zeros((1, 2), np.uint32)})
    for repair in (lambda: offchain.repair_symbol(2, 1, b"\1" * 512, 3),
                   lambda: offchain.repair_via_symbols(
                       2, 1, (1, 2), 0, [b"\1" * 512] * 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repair()
    assert offchain.HostPodr2("cpu").device.type == "cpu"
    assert offchain.host_codec(2, 1, device="cpu").device.type == "cpu"
