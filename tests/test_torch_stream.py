"""The port's streaming ingest (cess_tpu_torch.serve.stream) and fused
program against the JAX package's (cess_tpu.serve.stream) on the same
seeded segments: fragments and tags exactly equal on both MAC limb
widths, ragged tail, explicit ids and chunked sources included; the
stage counters and their export through an attached engine. On the CPU
the ingest copies nothing (no pinned buffers, no side stream); the
card's staged path is held to the direct forward in
tests/test_torch_serve_card.py."""
import jax
import numpy as np
import pytest
import torch

from cess_tpu import serve as jserve
from cess_tpu.models import pipeline as jpipeline
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.serve import stream as jstream
from cess_tpu_torch.convert import pipeline_from_arrays
from cess_tpu_torch.serve import AdmissionPolicy, StreamingIngest, make_engine
from cess_tpu_torch.serve.stream import _rebatch

K, M = 2, 1
FRAG = 1024                 # 2 PoDR2 blocks per fragment
SEG = K * FRAG
ROWS = K + M


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
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.astype(np.int64),
                                                 b.astype(np.int64))


def pipes(limbs=2):
    """(port pipeline on the CPU, JAX pipeline) with one key."""
    jkey = jpodr2.Podr2Key.generate(31, jpodr2.Podr2Params(limbs=limbs))
    jpipe = jpipeline.StoragePipeline(
        jpipeline.PipelineConfig(k=K, m=M, segment_size=SEG), podr2_key=jkey)
    pipe = pipeline_from_arrays(K, M, SEG, jpodr2.SECTORS,
                                np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                device="cpu")
    return pipe, jpipe


@pytest.fixture(scope="module")
def pipe_pair():
    return pipes()


def test_fused_program_matches_jax_forward(pipe_pair):
    pipe, jpipe = pipe_pair
    segs = rnd((4, SEG), 1)
    ids = rnd((4, ROWS, 2), 2, np.uint32)
    for fragment_ids in (np.arange(4 * ROWS), ids):
        got = pipe.fused_program()(torch.from_numpy(segs), fragment_ids)
        want = jpipe.fused_program()(segs, jax.numpy.asarray(fragment_ids))
        assert same(got["fragments"], want["fragments"])
        assert same(got["tags"], want["tags"])
    steps = pipe.tag_step(pipe.encode_step(segs), ids)
    assert torch.equal(pipe(segs, ids)["tags"], steps)


@pytest.mark.parametrize("limbs", [2, 3])
def test_stream_matches_jax_both_limb_widths(limbs):
    """7 segments through batches of 3: two full batches and a ragged
    1-segment tail, default (global arange) ids."""
    pipe, jpipe = pipes(limbs)
    segs = rnd((7, SEG), 10 + limbs)
    ing = StreamingIngest(pipe, 3)
    out = ing.ingest(segs)
    jing = jstream.StreamingIngest(jpipe, 3)
    want = jing.ingest(segs)
    assert out["tags"].shape[-1] == limbs
    assert same(out["fragments"], want["fragments"])
    assert same(out["tags"], want["tags"])
    direct = pipe(torch.from_numpy(segs))      # arange over all 7*ROWS
    assert torch.equal(out["tags"], direct["tags"])
    for name in ("batches", "segments", "padded_segments", "bytes_in"):
        assert getattr(ing.stats, name) == getattr(jing.stats, name)
    assert (ing.stats.batches, ing.stats.padded_segments) == (3, 2)


def test_stream_explicit_ids_match_jax(pipe_pair):
    pipe, jpipe = pipe_pair
    segs = rnd((5, SEG), 20)
    ids = rnd((5, ROWS, 2), 21, dtype=np.uint32)
    outs = list(StreamingIngest(pipe, 2).run(segs, fragment_ids=ids))
    jouts = list(jstream.StreamingIngest(jpipe, 2).run(segs,
                                                        fragment_ids=ids))
    assert [o["rows"] for o in outs] == [o["rows"] for o in jouts] == [2, 2, 1]
    for o, jo in zip(outs, jouts):
        assert isinstance(o["tags"], torch.Tensor)
        assert same(o["fragments"], jo["fragments"])
        assert same(o["tags"], jo["tags"])
    scalar = rnd((5, ROWS), 22, dtype=np.uint32)
    got = StreamingIngest(pipe, 2).ingest(segs, fragment_ids=scalar)
    want = jstream.StreamingIngest(jpipe, 2).ingest(segs, fragment_ids=scalar)
    assert same(got["tags"], want["tags"])


def test_stream_chunked_and_tensor_sources_match_jax(pipe_pair):
    """A chunked source (the network-receive shape) rebatches into the
    batch size; a CPU tensor source streams as the array does."""
    pipe, jpipe = pipe_pair
    segs = rnd((6, SEG), 30)
    pieces = [segs[0:1], segs[1:4], segs[4:6]]      # ragged chunks
    got = StreamingIngest(pipe, 4).ingest(iter(pieces))
    want = jstream.StreamingIngest(jpipe, 4).ingest(iter(pieces))
    assert same(got["tags"], want["tags"])
    assert same(got["fragments"], want["fragments"])
    from_tensor = StreamingIngest(pipe, 4).ingest(torch.from_numpy(segs))
    assert torch.equal(from_tensor["tags"], got["tags"])
    sizes = [c.shape[0] for c in _rebatch(iter(pieces), 4)]
    assert sizes == [c.shape[0] for c in jstream._rebatch(iter(pieces), 4)] \
        == [4, 2]
    assert [c.shape[0] for c in _rebatch(torch.from_numpy(segs[:5]), 2)] \
        == [2, 2, 1]


def test_stream_validates_at_call_time(pipe_pair):
    pipe, _ = pipe_pair
    with pytest.raises(ValueError, match="batch"):
        StreamingIngest(pipe, 0)
    with pytest.raises(ValueError, match="depth"):
        StreamingIngest(pipe, 2, depth=0)
    ing = StreamingIngest(pipe, 2)
    segs = rnd((4, SEG), 54)
    # run() raises at the CALL site, not at the consumer's first next()
    with pytest.raises(ValueError, match="array segment source"):
        ing.run(iter([segs[:2], segs[2:]]),
                fragment_ids=rnd((4, ROWS, 2), 55, np.uint32))
    with pytest.raises(ValueError, match="rows"):
        ing.run(rnd((3, SEG), 1), fragment_ids=rnd((2, ROWS, 2), 2,
                                                   np.uint32))
    with pytest.raises(ValueError, match="empty"):
        ing.ingest(np.zeros((0, SEG), np.uint8))


def test_stream_metrics_through_engine_and_detach(pipe_pair):
    """Attached streams' counters export as cess_engine_stream_* under
    the JAX package's names, summed over streams; detach() removes a
    stream's (idempotent)."""
    pipe, jpipe = pipe_pair
    eng = make_engine(K, M, rs_backend="cpu",
                      policy=AdmissionPolicy(max_delay=0.005))
    jeng = jserve.make_engine(K, M,
                              policy=jserve.AdmissionPolicy(max_delay=0.005))
    try:
        a = StreamingIngest(pipe, 2, engine=eng)
        for _ in a.run(rnd((2, SEG), 70)):
            pass
        b = StreamingIngest(pipe, 2, engine=eng)
        for _ in b.run(rnd((4, SEG), 71)):
            pass
        ja = jstream.StreamingIngest(jpipe, 2, engine=jeng)
        for _ in ja.run(rnd((2, SEG), 70)):
            pass
        m = eng.stats_metrics()
        assert m["cess_engine_stream_batches"] == 3
        assert m["cess_engine_stream_segments"] == 6
        assert m["cess_engine_stream_bytes_in"] == 6 * SEG
        assert {k for k in m if k.startswith("cess_engine_stream_")} == \
            {k for k in jeng.stats_metrics()
             if k.startswith("cess_engine_stream_")}
        assert eng.stats_snapshot()["streams"][0]["batches"] == 1
        hist = eng.stats_histograms()["cess_engine_stream_batch_seconds"]
        assert hist.count == 3
        a.detach()
        a.detach()                                  # idempotent
        assert eng.stats_metrics()["cess_engine_stream_batches"] == 2
        b.detach()
        assert "cess_engine_stream_batches" not in eng.stats_metrics()
    finally:
        eng.close()
        jeng.close()
