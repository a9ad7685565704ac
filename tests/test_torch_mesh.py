"""The port's mesh-sharded pipeline (cess_tpu_torch.parallel) against the
JAX package's (cess_tpu.parallel) on the same seeded inputs.

Every case of tests/test_mesh.py, and the mesh stream entry of
tests/test_stream.py, on a port mesh of
``"cpu"`` entries (torch has one CPU device; a mesh may list it more
than once, as conftest's 8 virtual CPU devices serve the JAX package).
Tolerance: none. Fragments, tags, verdicts and corpus summaries are
protocol facts and must be byte-equal, on every mesh shape, to the JAX
sharded step and to the JAX single-device forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cess_tpu.models import pipeline as jpipeline
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.parallel import mesh as jmesh
from cess_tpu.parallel import multihost as jmultihost
from cess_tpu.serve import stream as jstream
from cess_tpu_torch.convert import pipeline_from_arrays
from cess_tpu_torch.ops import podr2
from cess_tpu_torch.parallel import mesh, multihost
from cess_tpu_torch.serve import StreamingIngest


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


def pipes(k, m, segment_size, seed=0):
    """(port pipeline on the CPU, JAX pipeline), one key."""
    jkey = jpodr2.Podr2Key.generate(seed)
    jpipe = jpipeline.StoragePipeline(
        jpipeline.PipelineConfig(k=k, m=m, segment_size=segment_size),
        podr2_key=jkey)
    pipe = pipeline_from_arrays(k, m, segment_size, jpodr2.SECTORS,
                                np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                device="cpu")
    return pipe, jpipe


def cpu_mesh(seg, byte):
    return mesh.make_mesh(["cpu"] * (seg * byte), seg=seg, byte=byte)


@pytest.fixture(scope="module")
def setup():
    byte_max = 2
    frag = 4 * byte_max * 512
    pipe, jpipe = pipes(4, 8, 4 * frag)
    cfg = pipe.config
    b, rows = 8, cfg.k + cfg.m
    data = rnd((b, cfg.k, cfg.fragment_size), 1)
    ids = np.arange(b * rows, dtype=np.int32).reshape(b, rows)
    jref = jpipe.forward(jnp.asarray(data.reshape(b, cfg.segment_size)),
                         fragment_ids=jnp.asarray(ids))
    return pipe, jpipe, data, ids, jref


@pytest.mark.parametrize("seg,byte", [(8, 1), (4, 2), (2, 2), (1, 2)])
def test_topology_invariance(setup, seg, byte):
    pipe, jpipe, data, ids, jref = setup
    idx, nu = jpodr2.gen_challenge(b"topology-round",
                                   pipe.config.blocks_per_fragment)
    jstep = jmesh.sharded_pipeline_step(
        jpipe, jmesh.make_mesh(jax.devices()[:seg * byte], seg=seg,
                               byte=byte))
    jshards, jtags, jok = jstep(jnp.asarray(data), jnp.asarray(ids), idx, nu)
    step = mesh.sharded_pipeline_step(pipe, cpu_mesh(seg, byte))
    shards, tags, ok = step(data, ids, np.asarray(idx), np.asarray(nu))
    # the results stay in pieces, one a mesh entry (ok: one a seg row)
    assert len(shards.pieces) == len(tags.pieces) == seg * byte
    assert len(ok.pieces) == seg
    for got, jgot, ref in ((shards, jshards, jref["fragments"]),
                           (tags, jtags, jref["tags"])):
        assert same(got, jgot) and same(got, ref)
    assert same(ok, jok) and np.asarray(ok).all()


def test_sharded_proof_matches_single_device(setup):
    """The sharded step's verdicts equal the single-device prove_batch /
    verify_batch (and the JAX package's), honest and with one fragment's
    byte shard XORed with 0xA5 after tagging."""
    pipe, jpipe, data, ids, jref = setup
    cfg = pipe.config
    b, rows, n = np.asarray(jref["fragments"]).shape
    blocks = cfg.blocks_per_fragment
    idx, nu = jpodr2.gen_challenge(b"single-device-round", blocks)
    frags = np.array(jref["fragments"]).reshape(b * rows, n)
    tags = np.array(jref["tags"]).reshape(b * rows, blocks, podr2.LIMBS)
    jmu, jsigma = jpodr2.prove_batch(jnp.asarray(frags), jnp.asarray(tags),
                                     idx, nu)
    mu, sigma = podr2.prove_batch(torch.from_numpy(frags),
                                  torch.from_numpy(tags.astype(np.int64)),
                                  torch.tensor(np.asarray(idx)),
                                  torch.tensor(np.asarray(nu)))
    assert same(mu, jmu) and same(sigma, jsigma)
    flat_ids = ids.reshape(-1)
    assert np.asarray(jpodr2.verify_batch(
        jpipe.podr2_key, jnp.asarray(flat_ids), blocks, idx, nu, jmu,
        jsigma)).all()
    single = podr2.verify_batch(pipe.podr2_key, flat_ids, blocks,
                                torch.tensor(np.asarray(idx)),
                                torch.tensor(np.asarray(nu)), mu, sigma)
    assert bool(single.all())

    step = mesh.sharded_pipeline_step(pipe, cpu_mesh(2, 2))
    shards, tags_sh, ok = step(data, ids, np.asarray(idx), np.asarray(nu))
    assert np.asarray(ok).all()
    # tamper segment 5's fragment 5 in the byte shard holding the first
    # challenged block (entry (1, j): segments 4..7, half j of the bytes)
    j = int(np.asarray(idx)[0]) // (blocks // 2)
    piece = shards.pieces[(1, j)][1]
    piece[1, 5] ^= 0xA5
    bad = np.asarray(step.audit(shards, tags_sh, ids, np.asarray(idx),
                                np.asarray(nu)))
    frags_bad = np.asarray(shards).reshape(b * rows, n)
    mu_b, sigma_b = podr2.prove_batch(torch.from_numpy(frags_bad),
                                      torch.from_numpy(tags.astype(np.int64)),
                                      torch.tensor(np.asarray(idx)),
                                      torch.tensor(np.asarray(nu)))
    want = podr2.verify_batch(pipe.podr2_key, flat_ids, blocks,
                              torch.tensor(np.asarray(idx)),
                              torch.tensor(np.asarray(nu)), mu_b, sigma_b)
    assert same(bad.reshape(-1), want)
    assert not bad[5, 5] and bad.sum() == b * rows - 1


def test_protocol_geometry_sharded_pipeline():
    """The sharded pipeline at the protocol's shapes: 16 MiB segments,
    8 MiB fragments (RS(2,1)), 256 sectors, 16384 blocks a fragment;
    2 segments over a (2, 4) mesh, byte-equal to the JAX sharded step."""
    from cess_tpu import constants

    pipe, jpipe = pipes(2, 1, constants.SEGMENT_SIZE)
    cfg = pipe.config
    assert cfg.fragment_size == constants.FRAGMENT_SIZE          # 8 MiB
    assert cfg.blocks_per_fragment == 16384
    b, rows = 2, cfg.k + cfg.m
    data = rnd((b, cfg.k, cfg.fragment_size), 3)
    ids = np.arange(b * rows, dtype=np.int32).reshape(b, rows)
    idx, nu = jpodr2.gen_challenge(b"protocol-geometry-round",
                                   cfg.blocks_per_fragment)
    step = mesh.sharded_pipeline_step(pipe, cpu_mesh(2, 4))
    shards, tags, ok = step(data, ids, np.asarray(idx), np.asarray(nu))
    assert shards.shape == (b, rows, cfg.fragment_size)
    assert tags.shape == (b, rows, cfg.blocks_per_fragment, podr2.LIMBS)
    assert np.asarray(ok).all(), "protocol-geometry audit failed"
    # systematic rows ARE the data (hash identity is a chain invariant)
    assert np.array_equal(np.asarray(shards)[:, :cfg.k], data)
    jstep = jmesh.sharded_pipeline_step(
        jpipe, jmesh.make_mesh(jax.devices()[:8], seg=2, byte=4))
    jshards, jtags, jok = jstep(jnp.asarray(data), jnp.asarray(ids), idx, nu)
    assert same(shards, jshards) and same(tags, jtags) and same(ok, jok)


def corpus_plan(total_segments, batch):
    return (multihost.CorpusPlan(total_bytes=total_segments * 8192,
                                 segment_size=8192, batch_segments=batch),
            jmultihost.CorpusPlan(total_bytes=total_segments * 8192,
                                  segment_size=8192, batch_segments=batch))


def test_multihost_corpus_run_single_process():
    """The corpus path in one process (the same code as a multi-process
    run but for the process group): equal dicts in both packages."""
    assert multihost.init_multihost() == 1    # nothing configured: no-op
    assert jmultihost.init_multihost() == 1
    pipe, jpipe = pipes(2, 1, 8192)
    plan, jplan = corpus_plan(8, 4)
    assert plan.total_segments == 8 and plan.num_batches == 2
    corpus = rnd((8, 2, 4096), 0)

    def local_batch(b, local_segs):
        return corpus[b * local_segs:(b + 1) * local_segs]

    got = list(multihost.run_corpus(
        pipe, multihost.global_mesh(seg=4, byte=2, devices=["cpu"] * 8),
        plan, local_batch))
    want = list(jmultihost.run_corpus(
        jpipe, jmultihost.global_mesh(seg=4, byte=2), jplan, local_batch))
    assert got == want and len(got) == 2
    for r in got:
        assert r["verified"] == r["expected"], r


def test_multihost_corpus_partial_final_batch():
    """9 segments in batches of 4: the final batch of 1 is padded to the
    batch shape and its padding is masked out of the verified count."""
    pipe, jpipe = pipes(2, 1, 8192)
    plan, jplan = corpus_plan(9, 4)
    assert plan.num_batches == 3
    corpus = rnd((9, 2, 4096), 2)

    def feeder():
        offset = [0]

        def local_batch(b, local_want):
            got = corpus[offset[0]:offset[0] + local_want]
            offset[0] += local_want
            return got
        return local_batch

    cpu8 = ["cpu"] * 8
    got = list(multihost.run_corpus(
        pipe, multihost.global_mesh(seg=4, byte=2, devices=cpu8), plan,
        feeder()))
    want = list(jmultihost.run_corpus(
        jpipe, jmultihost.global_mesh(seg=4, byte=2), jplan, feeder()))
    assert got == want
    assert [r["segments"] for r in got] == [4, 4, 1]
    for r in got:
        assert r["verified"] == r["expected"] == r["segments"] * 3, r
    # an indivisible batch is an explicit error, not a silent drop
    bad, _ = corpus_plan(8, 6)
    with pytest.raises(ValueError, match="divide"):
        next(iter(multihost.run_corpus(
            pipe, multihost.global_mesh(seg=4, byte=2, devices=cpu8), bad,
            feeder())))


def test_sharded_stream_entry_matches_jax_stream():
    byte = 2
    frag = byte * 2 * 512                   # blocks % byte == 0
    pipe, jpipe = pipes(2, 1, 2 * frag)
    segs = rnd((6, 2 * frag), 50)
    out = StreamingIngest(pipe, 2, **mesh.stream_entry(
        pipe, cpu_mesh(2, byte), 2)).ingest(segs)
    jout = jstream.StreamingIngest(jpipe, 2, **jmesh.stream_entry(
        jpipe, jmesh.make_mesh(jax.devices()[:4], seg=2, byte=byte),
        2)).ingest(segs)
    ref = jpipe.forward(segs)               # single-device fused
    for name in ("fragments", "tags"):
        assert same(out[name], jout[name]) and same(out[name], ref[name])


def test_sharded_stream_entry_pair_ids():
    """pair_ids=True: explicit hash-pair ids lay out by seg rows and
    match the JAX stream; the default arange ids are rejected (no
    pair-shaped default exists)."""
    byte = 2
    frag = byte * 2 * 512
    pipe, jpipe = pipes(2, 1, 2 * frag)
    segs = rnd((4, 2 * frag), 51)
    ing = StreamingIngest(pipe, 2, **mesh.stream_entry(
        pipe, cpu_mesh(2, byte), 2, pair_ids=True))
    with pytest.raises(ValueError, match="pair_ids=True"):
        list(ing.run(segs))                 # default ids: no pair shape
    ids = rnd((4, 3, 2), 52, np.uint32)
    out = ing.ingest(segs, fragment_ids=ids)
    jing = jstream.StreamingIngest(jpipe, 2, **jmesh.stream_entry(
        jpipe, jmesh.make_mesh(jax.devices()[:4], seg=2, byte=byte), 2,
        pair_ids=True))
    jout = jing.ingest(segs, fragment_ids=ids)
    assert same(out["tags"], jout["tags"])
    assert same(out["tags"], jpipe.forward(segs, fragment_ids=ids)["tags"])


def test_mesh_surface_and_errors():
    m = mesh.make_mesh(["cpu"] * 6, byte=2)
    assert m.shape == {"seg": 3, "byte": 2} and m.devices.shape == (3, 2)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    with pytest.raises(ValueError, match="mesh 4x2 != 6"):
        mesh.make_mesh(["cpu"] * 6, seg=4, byte=2)
    pipe, _ = pipes(2, 1, 2048)                 # 2 blocks a fragment
    with pytest.raises(ValueError, match="not divisible by byte axis"):
        mesh.sharded_pipeline_step(pipe, cpu_mesh(1, 4))
