"""The port's XOR-scheduled codec (``cess_tpu_torch.ops.xor_sched``,
``ops.rs_xor``, the "xor"/"auto" strategies of ``ops.rs`` and of the
``StoragePipeline``) against the JAX package on the CPU. Inputs come from
numpy seeds; every comparison is byte equality (tolerance 0): schedules,
cost-model verdicts, fragments and digests are protocol facts."""
import functools

import jax
import numpy as np
import pytest
import torch

from cess_tpu.models import pipeline as jpipeline
from cess_tpu.ops import gf as jgf
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.ops import rs as jrs
from cess_tpu.ops import rs_xor as jrs_xor
from cess_tpu.ops import xor_sched as jxor
from cess_tpu_torch import kat
from cess_tpu_torch.convert import podr2_key_from_arrays
from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
from cess_tpu_torch.ops import gf, rs, rs_xor, xor_sched
from cess_tpu_torch.ops.rs import TorchCodec, make_codec

GEOMETRIES = [(2, 1), (2, 2), (3, 3), (4, 8), (10, 4)]
SEGMENT = 64 * 1024
SLICED_N = [1, 31, 32, 33, 701, 4096]

# each builds a GF matrix with the given package's gf module
MATRICES = {
    "parity_2_1": lambda g: g.cauchy_parity_matrix(2, 1),
    "parity_3_3": lambda g: g.cauchy_parity_matrix(3, 3),
    "parity_4_8": lambda g: g.cauchy_parity_matrix(4, 8),
    "parity_10_4": lambda g: g.cauchy_parity_matrix(10, 4),
    "decode_4_8_from_parity": lambda g: g.decode_matrix(4, 8, (4, 5, 6, 7)),
    "symbol_213": lambda g: np.array([[1, 213]], dtype=np.uint8),
}
# the 32-byte plane executor runs every schedule above, the encode matrix
# of every geometry, and one with COPY and ZERO ops (an identity row and a
# zero row), which its uniform op list turns into XORs with the zero slot
SLICED = {**MATRICES,
          "parity_2_2": lambda g: g.cauchy_parity_matrix(2, 2),
          "copy_zero": lambda g: np.array([[1, 0], [0, 0], [3, 7]],
                                          dtype=np.uint8)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def schedules(name):
    mat = MATRICES[name](gf)
    np.testing.assert_array_equal(mat, MATRICES[name](jgf))
    return (xor_sched.compile_schedule(gf.expand_bitmatrix(mat)),
            jxor.compile_schedule(jgf.expand_bitmatrix(MATRICES[name](jgf))))


# -- the compiler and the cost model ----------------------------------------

@pytest.mark.parametrize("name", sorted(MATRICES))
def test_witness_and_dump_match_jax(name):
    port, ref = schedules(name)
    assert port.witness() == ref.witness()
    assert port.dump() == ref.dump()
    assert port.out_base == ref.out_base
    assert (port.r8, port.q8, port.n_scratch, port.ops) == \
        (ref.r8, ref.q8, ref.n_scratch, ref.ops)


def test_compile_is_pure_and_cached():
    bmat = gf.expand_bitmatrix(gf.cauchy_parity_matrix(4, 8))
    first = xor_sched.compile_schedule(bmat)
    xor_sched._compile_cached.cache_clear()
    second = xor_sched.compile_schedule(bmat)
    assert second.witness() == first.witness() and second == first
    assert xor_sched.compile_schedule(bmat) is second
    for bad in (np.zeros((7, 16), np.uint8), np.zeros(16, np.uint8)):
        with pytest.raises(ValueError, match="bitmatrix"):
            xor_sched.compile_schedule(bad)


@pytest.mark.parametrize("bucket", [1, 2, 32, 64])
def test_estimate_matches_jax(bucket):
    for name in sorted(MATRICES):
        port, ref = schedules(name)
        assert xor_sched.estimate(port.r8, port.q8, port.n_xors, bucket) == \
            jxor.estimate(ref.r8, ref.q8, ref.n_xors, bucket)
    assert [xor_sched.rows_bucket(r) for r in range(70)] == \
        [jxor.rows_bucket(r) for r in range(70)]


# -- the executor: plain version against the JAX executors ------------------

@pytest.mark.parametrize("seed", range(4))
def test_plain_executor_matches_jnp_executor(seed):
    """Random GF matrices, ragged n and leading dims: the port's plain
    executor equals the TPU package's jnp executor and the GF matmul."""
    rng = np.random.default_rng(seed)
    r, q = int(rng.integers(1, 7)), int(rng.integers(1, 7))
    mat = rng.integers(0, 256, (r, q), dtype=np.uint8)
    n = int(rng.integers(1, 200))
    data = rng.integers(0, 256, (2, 3, q, n), dtype=np.uint8)
    sched = xor_sched.compile_schedule(gf.expand_bitmatrix(mat))
    got = rs_xor.apply_schedule(sched, torch.from_numpy(data)).numpy()
    want = np.asarray(jrs_xor.apply_schedule(
        jxor.compile_schedule(jgf.expand_bitmatrix(mat)), data, force="jnp"))
    assert got.shape == (2, 3, r, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1, 2], gf.gf_matmul(mat, data[1, 2]))


@pytest.mark.parametrize("n", [100, 101, 7])
def test_plain_executor_matches_pallas_kernel(n):
    """The TPU kernel in interpret mode (small tiles, so its grid
    iterates) against the port's plain version, ragged n included."""
    port, ref = schedules("parity_3_3")
    data = rnd((2, 3, n), seed=n)
    want = np.asarray(jrs_xor.apply_schedule(ref, data, tile_lanes=8,
                                             force="pallas"))
    got = rs_xor.xor_apply_plain(port, torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_executor_walks_lanes_in_chunks(monkeypatch):
    port, ref = schedules("parity_4_8")
    data = rnd((3, 4, 1001), seed=3)
    whole = rs_xor.xor_apply_plain(port, torch.from_numpy(data))
    monkeypatch.setattr(rs_xor, "PLAIN_LANES", 7)      # 2 lanes a chunk
    np.testing.assert_array_equal(
        rs_xor.xor_apply_plain(port, torch.from_numpy(data)).numpy(),
        whole.numpy())
    np.testing.assert_array_equal(whole.numpy(), np.asarray(
        jrs_xor.apply_schedule(ref, data, force="jnp")))


def test_gf_xor_wrapper_contract_on_the_cpu():
    """``out``/``sys_out`` views of one [B, k+m, n] buffer, as encode uses
    them; refusals; no launch counted for CPU tensors."""
    sched, _ = schedules("parity_4_8")
    data = torch.from_numpy(rnd((3, 4, 50), seed=4))
    buf = torch.zeros((3, 12, 50), dtype=torch.uint8)
    before = rs_xor.gf_xor.launches
    rs_xor.gf_xor(sched, None, data, out=buf[:, 4:], sys_out=buf[:, :4])
    assert rs_xor.gf_xor.launches == before
    assert torch.equal(buf[:, :4], data)
    assert torch.equal(buf[:, 4:], rs_xor.xor_apply_plain(sched, data))
    with pytest.raises(ValueError, match="shape"):
        rs_xor.gf_xor(sched, None, data[:, :3])
    with pytest.raises(TypeError, match="uint8"):
        rs_xor.gf_xor(sched, None, data.to(torch.int32))
    with pytest.raises(ValueError, match="unit stride"):
        rs_xor.gf_xor(sched, None, data[..., ::2])
    with pytest.raises(ValueError, match="schedule inputs"):
        rs_xor.apply_schedule(sched, data[:, :2])


def test_kernel_block_size_and_envelope():
    """Threads a block (each takes a 32-byte group of every row) for the
    schedules of this slice, the odd stride of a thread's address space,
    the staged uniform op list, and the refusal, naming the limit, of a
    schedule that does not fit at 32 threads."""
    s48 = schedules("parity_4_8")[0]
    assert (rs_xor.words(s48), rs_xor.threads_for(s48)) == (167, 256)
    assert len(rs_xor.bundled_ops(s48)) == 4 * 95      # 374 ops, 98% full
    assert rs_xor.smem_bytes(s48, 256) == 167 * 256 * 4 + 96 * 32
    assert rs_xor.threads_for(schedules("parity_10_4")[0]) == 128
    s21 = schedules("parity_2_1")[0]
    ops = rs_xor.stage_ops(s21, "cpu")
    assert ops.dtype == torch.int16 and ops.shape == (28, 4)   # 7 bundles
    assert rs_xor.words(s21) % 2 == 1
    assert rs_xor.words(s21) > rs_xor.zero_slot(s21) == s21.out_base + s21.r8
    assert ops[:, 3].eq(0).all()
    sched = xor_sched.compile_schedule(gf.expand_bitmatrix(
        SLICED["copy_zero"](gf)))
    z = rs_xor.zero_slot(sched)
    for (op, d, a, b), row in zip(sched.ops, rs_xor.uniform_ops(sched)):
        assert tuple(row) == {xor_sched.OP_XOR: (d, a, b),
                              xor_sched.OP_ACC: (d, d, a),
                              xor_sched.OP_COPY: (d, a, z),
                              xor_sched.OP_ZERO: (d, z, z)}[op]
    assert {op[0] for op in sched.ops} >= {xor_sched.OP_COPY,
                                           xor_sched.OP_ZERO}
    big = xor_sched.XorSchedule(r8=8, q8=8, n_scratch=2000, ops=(),
                                n_xors=0, dense_xors=0, saving_frac=0.0,
                                matrix_sha256="")
    with pytest.raises(ValueError, match=str(rs_xor.SMEM_BYTES)):
        rs_xor.threads_for(big)


@pytest.mark.parametrize("name", sorted(SLICED))
def test_bundles_compute_the_bitmatrix(name):
    """The staged list holds each uniform op once, in bundles of
    ``BUNDLE`` padded with ``zero ^ zero``. Run symbolically as the kernel
    runs it (a bundle's loads, then its stores in order), each slot a
    bitmask of input planes and every other slot but the zero slot
    starting with a garbage bit of its own, every output equals its
    bitmatrix row: no read moved ahead of its write."""
    bmat = gf.expand_bitmatrix(SLICED[name](gf))
    sched = xor_sched.compile_schedule(bmat)
    z = rs_xor.zero_slot(sched)
    staged = rs_xor.bundled_ops(sched).reshape(-1, rs_xor.BUNDLE, 3).tolist()
    placed = [tuple(op) for bundle in staged for op in bundle
              if tuple(op) != (z, z, z)]
    assert sorted(placed) == sorted(
        tuple(op) for op in rs_xor.uniform_ops(sched).tolist())
    buf = [1 << i for i in range(z)] + [0]
    for bundle in staged:
        vals = [buf[a] ^ buf[b] for _, a, b in bundle]
        for (d, _, _), v in zip(bundle, vals):
            buf[d] = v
    assert buf[z] == 0
    for i in range(sched.r8):
        want = sum(1 << j for j in np.flatnonzero(bmat[i]).tolist())
        assert buf[sched.out_base + i] == want


# -- the kernel's 32-byte plane layout, pinned on the CPU --------------------

@pytest.mark.parametrize("n", SLICED_N)
def test_planes32_round_trip_and_bit_order(n):
    data = torch.from_numpy(rnd((2, 3, n), seed=n))
    planes = rs_xor.planes32(data)
    assert planes.shape == (2, 3, 8, -(-n // 32)) and planes.dtype == torch.int64
    assert int(planes.min()) >= 0 and int(planes.max()) < 1 << 32
    assert torch.equal(rs_xor.unplanes32(planes, n), data)
    # bit b of byte 32g + 4k + e sits at bit 8e + k of plane b of group g
    one = torch.zeros(n, dtype=torch.uint8)
    t = n - 1
    one[t] = 1 << (t % 8)
    g, k, e = divmod(t, 32)[0], (t % 32) // 4, t % 4
    want = torch.zeros((8, -(-n // 32)), dtype=torch.int64)
    want[t % 8, g] = 1 << (8 * e + k)
    assert torch.equal(rs_xor.planes32(one), want)


@functools.lru_cache(maxsize=None)
def _sliced_case(name):
    """A schedule, data [2, q, 4096] and the TPU package's ``_apply_jnp``
    on it; a narrower case is a prefix, since the map is column-wise."""
    port = xor_sched.compile_schedule(gf.expand_bitmatrix(SLICED[name](gf)))
    ref = jxor.compile_schedule(jgf.expand_bitmatrix(SLICED[name](jgf)))
    data = rnd((2, port.q8 // 8, max(SLICED_N)), seed=port.n_xors)
    u32 = np.ascontiguousarray(data).view(np.uint32)
    want = np.asarray(jrs_xor._apply_jnp(ref, jax.numpy.asarray(u32)))
    return port, data, np.ascontiguousarray(want).view(np.uint8)


@pytest.mark.parametrize("n", SLICED_N)
@pytest.mark.parametrize("name", sorted(SLICED))
def test_sliced32_matches_plain_and_jax(name, n):
    """The kernel's layout and op list (``xor_apply_sliced32``) against the
    4-byte-lane plain version and the TPU package's jnp executor."""
    sched, data, want = _sliced_case(name)
    x = torch.from_numpy(data[..., :n].copy())
    got = rs_xor.xor_apply_sliced32(sched, x)
    assert got.shape == (2, sched.r8 // 8, n)
    np.testing.assert_array_equal(got.numpy(), want[..., :n])
    assert torch.equal(got, rs_xor.xor_apply_plain(sched, x))


# -- the codec's strategies against TPUCodec --------------------------------

@pytest.mark.parametrize("strategy", ["xor", "auto"])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_codec_matches_jax(k, m, strategy):
    port = TorchCodec(k, m, "cpu", strategy=strategy)
    ref = jrs.TPUCodec(k, m, strategy=strategy)
    rng = np.random.default_rng(k * 31 + m)
    data = rnd((3, k, 129), seed=k * 7 + m)
    coded = np.asarray(ref.encode(data))
    np.testing.assert_array_equal(port.encode(data).numpy(), coded)
    np.testing.assert_array_equal(port.encode_parity(data).numpy(),
                                  coded[:, k:])
    patterns = [tuple(sorted(rng.choice(k + m, size=k,
                                        replace=False).tolist()))]
    if m >= k:
        patterns.append(tuple(range(k, 2 * k)))     # every data row lost
    for present in patterns:
        missing = tuple(i for i in range(k + m) if i not in present)
        surv = coded[:, list(present)]
        np.testing.assert_array_equal(
            port.reconstruct(surv, present, missing).numpy(),
            np.asarray(ref.reconstruct(surv, present, missing)))
        np.testing.assert_array_equal(
            port.decode_data(surv, present).numpy(),
            np.asarray(ref.decode_data(surv, present)))


def test_program_meta_matches_jax_on_both_sides_of_auto():
    for strategy in ("xor", "auto"):
        port = TorchCodec(4, 8, "cpu", strategy=strategy)
        ref = jrs.TPUCodec(4, 8, strategy=strategy)
        for rows in (1, 2, 31, 32, 64):
            for args in (("encode", (), (), (rows, 4, 64)),
                         ("repair", (1, 3, 5, 9), (0,), (rows, 4, 64)),
                         ("decode", (4, 5, 6, 7), (), (rows, 4, 64))):
                assert port.program_meta(*args) == ref.program_meta(*args)
    auto = TorchCodec(4, 8, "cpu", strategy="auto")
    assert dict(auto.program_meta("encode", shape=(1, 4, 64)))["strategy"] \
        == "auto:dense"
    assert dict(auto.program_meta("encode", shape=(32, 4, 64)))["strategy"] \
        == "auto:xor"
    assert TorchCodec(4, 8, "cpu").program_meta(
        "encode", shape=(64, 4, 64)) == jrs.TPUCodec(4, 8).program_meta(
        "encode", shape=(64, 4, 64)) == ()


def test_auto_never_changes_results_only_executors():
    auto = TorchCodec(4, 8, "cpu", strategy="auto")
    dense = TorchCodec(4, 8, "cpu")
    for batch in (1, 64):     # both sides of the cost model's boundary
        data = rnd((batch, 4, 64), seed=batch)
        assert torch.equal(auto.encode(data), dense.encode(data))


def test_strategy_names_and_gate():
    assert TorchCodec(2, 1, "cpu").strategy == jrs.TPUCodec(2, 1).strategy \
        == "gather"
    data = rnd((2, 2, 40), seed=5)
    want = TorchCodec(2, 1, "cpu").encode(data)
    for strategy in rs.STRATEGIES:
        assert torch.equal(TorchCodec(2, 1, "cpu", strategy).encode(data),
                           want)
    with pytest.raises(ValueError, match="unknown strategy"):
        TorchCodec(2, 1, "cpu", strategy="nope")
    with pytest.raises(ValueError, match="unknown strategy"):
        jrs.TPUCodec(2, 1, strategy="nope")
    codec = make_codec(4, 8, "cpu", strategy="xor")
    assert codec.strategy == "xor" and codec is make_codec(4, 8, "cpu",
                                                           strategy="xor")
    with pytest.raises(ValueError, match="unknown ErasureCodec backend"):
        make_codec(2, 1, "tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_codec(2, 1, "regen")


def test_warm_reconstruct_hits_only_its_exact_key():
    """As tests/test_xor_sched.py pins the TPU package's warm path: a
    reconstruct hits only a program warmed for its pattern and shape."""
    codec = TorchCodec(2, 1, "cpu", strategy="xor")
    data = rnd((2, 256), seed=21)
    coded = codec.encode(data)
    surv, present, missing = coded[[1, 2]], (1, 2), (0,)
    cold = codec.reconstruct(surv, present, missing)
    assert codec.warm_hits == 0
    codec.warm_reconstruct(present, missing, surv.shape)
    warm = codec.reconstruct(surv, present, missing)
    assert codec.warm_hits == 1
    assert torch.equal(warm, cold) and torch.equal(warm[0], coded[0])
    codec.reconstruct(coded[[1, 2], :128], present, missing)
    codec.reconstruct(coded[[0, 2]], (0, 2), (1,))
    assert codec.warm_hits == 1
    assert codec.warm_reconstruct(present, missing, surv.shape) is \
        codec.warm_reconstruct(present, missing, tuple(surv.shape), "cpu")
    with pytest.raises(ValueError, match="exact survivor shape"):
        codec.warm_reconstruct(present, missing)
    with pytest.raises((ValueError, RuntimeError)):
        codec.warm_reconstruct(present, missing, surv.shape, device="cuda")


# -- the xor pipeline and the known answer ----------------------------------

@pytest.mark.parametrize("strategy", ["xor", "auto"])
def test_pipeline_matches_jax_under_strategy(strategy):
    key = jpodr2.Podr2Key.generate(5)
    jpipe = jpipeline.StoragePipeline(jpipeline.PipelineConfig(
        k=4, m=8, segment_size=SEGMENT, strategy=strategy), podr2_key=key)
    pipe = StoragePipeline(
        PipelineConfig(k=4, m=8, segment_size=SEGMENT, strategy=strategy),
        podr2_key=podr2_key_from_arrays(
            np.asarray(key.alpha), np.asarray(jax.random.key_data(key.prf_key)),
            device="cpu"), device="cpu")
    seg = rnd((2, SEGMENT), seed=11)
    want = jpipe.forward(seg)
    got = pipe(torch.from_numpy(seg))
    np.testing.assert_array_equal(got["fragments"].numpy(),
                                  np.asarray(want["fragments"]))
    np.testing.assert_array_equal(got["tags"].numpy().astype(np.uint32),
                                  np.asarray(want["tags"]))


def test_pipeline_strategy_state_and_refusal():
    cfg = PipelineConfig(k=4, m=8, segment_size=SEGMENT, strategy="xor")
    pipe = StoragePipeline(cfg, device="cpu")
    assert pipe.strategy == "xor"
    assert set(pipe.state_dict()) == {"parity_tables", "alpha", "prf_key"}
    assert pipe.to("cpu").parity_ops.shape == (
        len(rs_xor.bundled_ops(pipe.parity_sched)), 4)
    seg = torch.from_numpy(rnd((2, SEGMENT), seed=12))
    assert torch.equal(pipe.encode_step(seg), StoragePipeline(
        PipelineConfig(k=4, m=8, segment_size=SEGMENT),
        device="cpu").encode_step(seg))
    with pytest.raises(ValueError, match="unknown strategy"):
        StoragePipeline(PipelineConfig(segment_size=SEGMENT, strategy="x"),
                        device="cpu")


def test_known_answer_digest_under_xor():
    assert kat.run_port("cpu", strategy="xor") == (kat.DIGEST, True)
