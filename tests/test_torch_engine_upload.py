"""Gateway uploads side by side through one pipeline and its submission
engine, on the CPU: a shared gateway card's deployment at a small
segment size.

Four threads upload seeded files of mixed segment counts through one
``AgentPipeline`` whose engine coalesces their encode and tag requests.
Each upload must equal, byte for byte and word for word, the direct
path's upload of the same file and the plain reference's
(``portbench/reference``, NumPy only): isolation, whatever batch a
request shared and whatever pad rows that batch carried. The engine's
receipts and the upload's queue clocks are checked beside.
"""
import hashlib
import threading

import numpy as np
import pytest
import torch

from cess_tpu_torch.models.pipeline import PipelineConfig
from cess_tpu_torch.node import offchain
from cess_tpu_torch.obs import trace
from cess_tpu_torch.ops import podr2
from cess_tpu_torch.serve import AdmissionPolicy, Receipt, make_engine
from portbench.reference import gf256, podr2 as ref_podr2, threefry

SEG = 64 * 1024             # RS(2,1): fragments of 32 KiB, 64 blocks
K, M = 2, 1
ROWS = K + M
P = (1 << 31) - 1
# each client's files: segment counts 1 to 4, ragged and whole
SIZES = [[SEG - 100, 3 * SEG], [2 * SEG + 7, SEG], [4 * SEG - 1, 100],
         [3 * SEG + 5, 2 * SEG]]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def key_material(seed=3):
    g = np.random.default_rng(seed)
    return (g.integers(0, P, (podr2.SECTORS, 2), dtype=np.int64),
            g.integers(0, 1 << 32, 2, dtype=np.uint64).astype(np.uint32))


def port_key(alpha, prf_key):
    return podr2.Podr2Key(torch.from_numpy(alpha.astype(np.int32)),
                          torch.from_numpy(prf_key.astype(np.int64)))


def pipeline(key, engine=None):
    return offchain.AgentPipeline(PipelineConfig(k=K, m=M, segment_size=SEG),
                                  podr2_key=key, device="cpu", engine=engine)


def engine_of(key, max_delay=0.2):
    return make_engine(K, M, rs_backend="cpu", audit_backend="cpu",
                       podr2_key=key, policy=AdmissionPolicy(
                           max_delay=max_delay))


def files():
    g = np.random.default_rng(11)
    return [[g.integers(0, 256, n, np.uint8) for n in sizes]
            for sizes in SIZES]


def reference_upload(alpha, prf_key, data):
    """Fragments, segment hashes, fragment hashes, ids and tags of one
    file by the plain reference, with no engine and no threads."""
    buf = np.zeros(-(-data.size // SEG) * SEG, np.uint8)
    buf[:data.size] = data
    segs = buf.reshape(-1, SEG)
    frags = np.stack([gf256.encode(K, M, s) for s in segs])
    rows = frags.reshape(-1, SEG // K)
    hashes = [hashlib.sha256(r).digest() for r in rows]
    ids = np.stack([threefry.fragment_id(h) for h in hashes])
    tags = np.stack([ref_podr2.tags(alpha, prf_key, ids[i], rows[i])
                     for i in range(len(rows))])
    return (frags, [hashlib.sha256(s).digest() for s in segs], hashes, ids,
            tags)


def upload_all(pipe, datas):
    """Every client's files, each client on its own thread in a closed
    loop, all released at once."""
    ups = [[None] * len(d) for d in datas]
    barrier = threading.Barrier(len(datas))
    errors = []

    def client(i):
        try:
            barrier.wait()
            for j, data in enumerate(datas[i]):
                ups[i][j] = offchain.upload_batch(pipe, data,
                                                  tenant=f"gw{i}")
        except Exception as e:      # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(datas))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return ups


def same_upload(a, b):
    assert np.array_equal(np.asarray(a.fragments), np.asarray(b.fragments))
    assert np.array_equal(a.tags, b.tags) and np.array_equal(a.ids, b.ids)
    assert a.fragment_hashes == b.fragment_hashes
    assert a.segment_hashes == b.segment_hashes
    assert a.file_hash == b.file_hash


def test_shared_engine_uploads_equal_direct_and_reference():
    alpha, prf_key = key_material()
    key = port_key(alpha, prf_key)
    eng = engine_of(key)
    datas = files()
    try:
        ups = upload_all(pipeline(key, eng), datas)
        st = eng.stats_snapshot()["classes"]
    finally:
        eng.close()
    direct = pipeline(key)
    for i, client in enumerate(datas):
        for j, data in enumerate(client):
            up = ups[i][j]
            same_upload(up, offchain.upload_batch(direct, data))
            frags, seg_hashes, hashes, ids, tags = reference_upload(
                alpha, prf_key, data)
            assert np.array_equal(up.fragments, frags)
            assert up.segment_hashes == seg_hashes
            assert [h for fs in up.fragment_hashes for h in fs] == hashes
            assert np.array_equal(up.ids.reshape(-1, 2), ids)
            assert np.array_equal(up.tags.reshape(len(hashes), -1, 2), tags)
            assert up.file_hash == hashlib.sha256(b"".join(hashes)).digest()
    # a long max_delay makes the clients' requests share batches, and
    # mixed segment counts leave pad rows in them
    for cls in ("encode", "tag"):
        assert st[cls]["batch_occupancy"] > 1, st[cls]
        assert st[cls]["completed"] == sum(len(c) for c in SIZES)
    assert st["encode"]["pad_waste"] + st["tag"]["pad_waste"] > 0, st


def test_upload_receipts_and_queue_clocks():
    alpha, prf_key = key_material(5)
    key = port_key(alpha, prf_key)
    eng = engine_of(key)
    try:
        ups = upload_all(pipeline(key, eng), files())
    finally:
        eng.close()
    batches = {}
    for up in (u for client in ups for u in client):
        s = up.seconds
        assert list(s) == list(offchain.UPLOAD_STAGES
                               + offchain.ENGINE_CLOCKS
                               + offchain.HASH_CLOCKS)
        assert 0.0 <= s["hash.queue"] <= s["hash"] and s["hash.busy"] > 0
        assert all(v >= 0 for v in s.values())
        assert [rc.cls for rc in up.engine] == ["encode", "tag"]
        enc, tag = up.engine
        assert isinstance(enc, Receipt)
        assert s["encode.queue"] == enc.queued <= s["encode.launch"]
        assert s["tag.queue"] == tag.queued <= s["tag"]
        segs = up.fragments.shape[0]
        for rc, mine in ((enc, segs), (tag, segs * ROWS)):
            assert rc.queued >= 0
            assert mine <= rc.rows <= rc.bucket
            assert rc.bucket & (rc.bucket - 1) == 0     # a power of two
            assert rc.members >= 1
            # every member of one batch reads the batch alike
            assert batches.setdefault(rc.batch, (rc.cls, rc.members, rc.rows,
                                                 rc.bucket)) == \
                (rc.cls, rc.members, rc.rows, rc.bucket)
    assert len({b[0] for b in batches.values()}) == 2
    assert any(b[1] > 1 for b in batches.values())


def test_direct_upload_has_no_receipts_and_zero_queue_clocks():
    key = port_key(*key_material())
    up = offchain.upload_batch(pipeline(key), files()[0][0])
    assert up.engine == ()
    assert [up.seconds[k] for k in offchain.ENGINE_CLOCKS] == [0.0, 0.0]


def test_future_receipt_and_request_span_attributes():
    key = port_key(*key_material())
    tracer = trace.Tracer()
    eng = make_engine(K, M, rs_backend="cpu", audit_backend="cpu",
                      podr2_key=key, policy=AdmissionPolicy(max_delay=0.2),
                      tracer=tracer)
    g = np.random.default_rng(2)
    try:
        futs = [eng.submit_encode(g.integers(0, 256, (r, K, 64), np.uint8))
                for r in (3, 2)]
        for f in futs:
            f.result(timeout=30)
    finally:
        eng.close()
    a, b = (f.receipt for f in futs)
    assert a.batch == b.batch and (a.members, a.rows, a.bucket) == (2, 5, 8)
    assert a.cls == "encode" and a.queued >= 0
    spans = tracer.finished()
    batch = next(s for s in spans if s["name"] == "engine.batch")
    assert batch["attrs"]["batch"] == a.batch
    # both members' rows copied in and three pad rows zeroed: 8 rows
    assert batch["attrs"]["stacked_bytes"] == 8 * K * 64
    requests = [s["attrs"] for s in spans if s["name"] == "engine.encode"]
    assert len(requests) == 2
    for at, rc in zip(sorted(requests, key=lambda at: at["queued_s"]),
                      sorted((a, b), key=lambda rc: rc.queued)):
        assert at["batch_span"] == batch["span_id"]
        assert at["queued_s"] == round(rc.queued, 6) <= at["latency_s"]


def test_receipts_collect_this_threads_blocking_calls_only():
    key = port_key(*key_material())
    eng = engine_of(key, max_delay=0.0)
    g = np.random.default_rng(4)
    other = []
    try:
        with eng.receipts() as outer:
            eng.encode(g.integers(0, 256, (1, K, 64), np.uint8))
            with eng.receipts() as inner:
                eng.encode(g.integers(0, 256, (2, K, 64), np.uint8))
            t = threading.Thread(target=lambda: other.append(eng.encode(
                g.integers(0, 256, (1, K, 64), np.uint8))))
            t.start()
            t.join(30)
        eng.encode(g.integers(0, 256, (1, K, 64), np.uint8))
    finally:
        eng.close()
    assert not t.is_alive() and len(other) == 1
    assert [rc.rows for rc in inner] == [2]
    assert [rc.rows for rc in outer] == [1, 2]
    assert len({rc.batch for rc in outer}) == 2
