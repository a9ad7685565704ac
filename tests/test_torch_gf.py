"""The port's GF(2^8) tables, M31 field and RS codec against cess_tpu.

Inputs are made with numpy from a seed and handed to both packages;
every comparison is byte-exact."""
import numpy as np
import pytest
import torch

from cess_tpu.ops import gf as jgf
from cess_tpu.ops import pfield as jpf
from cess_tpu.ops.rs import TPUCodec
from cess_tpu.ops.rs import nibble_tables as j_nibble_tables
from cess_tpu.ops.rs_ref import ReferenceCodec
from cess_tpu_torch.ops import gf, rs_kernel
from cess_tpu_torch.ops import pfield as pf
from cess_tpu_torch.ops.rs import TorchCodec, make_codec

GEOMETRIES = [(2, 1), (2, 2), (3, 3), (4, 8), (10, 4)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def survivor_sets(k, m):
    """First k rows, last k rows (all parity when m >= k), a permuted
    mixed set."""
    n = k + m
    sets = [tuple(range(k)), tuple(range(n - k, n))]
    mixed = tuple(range(1, n, 2))[:k]
    if len(mixed) == k:
        sets.append(mixed[::-1])
    return sets


def test_field_tables_match():
    np.testing.assert_array_equal(gf.EXP, jgf.EXP)
    np.testing.assert_array_equal(gf.LOG, jgf.LOG)
    np.testing.assert_array_equal(gf.mul_table(), jgf.mul_table())
    for a in (1, 2, 29, 255):
        assert gf.gf_inv(a) == jgf.gf_inv(a)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_matrices_match(k, m):
    np.testing.assert_array_equal(gf.cauchy_parity_matrix(k, m),
                                  jgf.cauchy_parity_matrix(k, m))
    mat = gf.cauchy_parity_matrix(k, m)
    np.testing.assert_array_equal(gf.expand_bitmatrix(mat),
                                  jgf.expand_bitmatrix(mat))
    lo, hi = gf.nibble_tables(mat)
    jlo, jhi = j_nibble_tables(mat)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    for present in survivor_sets(k, m):
        np.testing.assert_array_equal(gf.decode_matrix(k, m, present),
                                      jgf.decode_matrix(k, m, present))
        missing = tuple(i for i in range(k + m) if i not in present)
        np.testing.assert_array_equal(
            gf.repair_matrix(k, m, present, missing),
            jgf.repair_matrix(k, m, present, missing))


def test_matrix_refusals_match():
    for bad in [(0, 0), (0, 9)]:
        with pytest.raises(ValueError):
            gf.decode_matrix(2, 1, bad)
        with pytest.raises(ValueError):
            jgf.decode_matrix(2, 1, bad)


def field_lanes(seed=0, n=2000):
    a = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)
    a = a.astype(np.uint32)
    a[:3] = [0, jpf.P - 1, 0xFFFFFFFF]
    return a


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_pfield_ops_match():
    a, b = field_lanes(1), field_lanes(2)
    fa, fb = jpf.to_field(a), jpf.to_field(b)
    ta, tb = pf.to_field(t64(a)), pf.to_field(t64(b))
    np.testing.assert_array_equal(ta.numpy(), fa)
    np.testing.assert_array_equal(pf.to_field(torch.from_numpy(a.view(np.int32))).numpy(), fa)
    for port_op, jax_op in [(pf.addmod, jpf.addmod), (pf.submod, jpf.submod),
                            (pf.mulmod, jpf.mulmod)]:
        np.testing.assert_array_equal(port_op(ta, tb).numpy(), jax_op(fa, fb))
    for k in (0, 1, 8, 16, 30):
        np.testing.assert_array_equal(pf.rotk(ta, k).numpy(), jpf.rotk(fa, k))
    x = fa.reshape(40, 50)
    np.testing.assert_array_equal(pf.summod(t64(x), dim=0).numpy(),
                                  jpf.summod(x, axis=0))
    np.testing.assert_array_equal(
        pf.dotmod(t64(x), t64(fb.reshape(40, 50)), dim=1).numpy(),
        jpf.dotmod(x, fb.reshape(40, 50), axis=1))
    for v in (1, 2, jpf.P - 1, 123456789):
        assert pf.invmod(v) == jpf.invmod(v)
    with pytest.raises(ZeroDivisionError):
        pf.invmod(jpf.P)


@pytest.mark.parametrize("width", [1, 2, 3])
def test_pack_bytes_match(width):
    data = rand((3, 12 * width), seed=width)
    want = jpf.pack_bytes(data, width)
    got = pf.pack_bytes(torch.from_numpy(data), width)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pf.unpack_bytes(got, width).numpy(), data)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_gf_apply_plain_matches_pallas_kernel(k, m):
    """The plain GF apply against the Pallas kernel in interpret mode."""
    from cess_tpu.ops.rs_pallas import apply_bitmatrix

    mat = jgf.cauchy_parity_matrix(k, m)
    data = rand((2, k, 512), seed=k * 16 + m)
    want = np.asarray(apply_bitmatrix(jgf.expand_bitmatrix(mat), data,
                                      tile_n=512))
    got = rs_kernel.gf_apply(rs_kernel.tables(mat, "cpu"),
                             torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_codec_matches_reference(k, m):
    ref = ReferenceCodec(k, m)
    codec = TorchCodec(k, m, device="cpu")
    data = rand((3, k, 700), seed=k + 100 * m)   # 700: not a multiple of 16
    shards = ref.encode(data)
    got = codec.encode(data)
    assert got.dtype == torch.uint8 and got.shape == (3, k + m, 700)
    np.testing.assert_array_equal(got.numpy(), shards)
    np.testing.assert_array_equal(codec.encode_parity(data).numpy(),
                                  ref.encode_parity(data))
    for present in survivor_sets(k, m):
        surv = shards[:, list(present)]
        np.testing.assert_array_equal(
            codec.reconstruct(surv, present).numpy(),
            ref.reconstruct(surv, present))
        np.testing.assert_array_equal(
            codec.decode_data(torch.from_numpy(surv), present).numpy(), data)


def test_codec_matches_tpu_codec_and_strided_survivors():
    k, m = 4, 8
    data = rand((2, k, 256), seed=5)
    jax_shards = np.asarray(TPUCodec(k, m).encode(data))
    codec = TorchCodec(k, m, device="cpu")
    shards = codec.encode(torch.from_numpy(data))
    np.testing.assert_array_equal(shards.numpy(), jax_shards)
    # a strided view of the coded buffer, as a repair reads it
    present = (4, 5, 6, 7)
    got = codec.decode_data(shards[:, 4:8], present)
    np.testing.assert_array_equal(got.numpy(), data)


def test_codec_leading_dims_and_refusals():
    codec = TorchCodec(2, 1, device="cpu")
    data = rand((2, 3, 2, 64), seed=9)
    np.testing.assert_array_equal(codec.encode(data).numpy(),
                                  ReferenceCodec(2, 1).encode(data))
    with pytest.raises(ValueError, match="expected 2 data rows"):
        codec.encode(rand((3, 64), seed=1))
    with pytest.raises(TypeError):
        codec.encode(np.zeros((2, 64), dtype=np.int32))
    with pytest.raises(ValueError):
        TorchCodec(0, 1, device="cpu")


def test_gf_apply_wrapper_checks():
    tab = rs_kernel.tables(gf.cauchy_parity_matrix(2, 1), "cpu")
    data = torch.from_numpy(rand((1, 2, 32), seed=3))
    with pytest.raises(ValueError, match="shape"):
        rs_kernel.gf_apply(tab, data, out=torch.empty((1, 2, 32),
                                                      dtype=torch.uint8))
    with pytest.raises(TypeError):
        rs_kernel.gf_apply(tab, data.to(torch.int32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        rs_kernel.gf_apply(tab.to("meta"), data.to("meta"))
    before = rs_kernel.gf_apply.launches
    rs_kernel.gf_apply(tab, data)
    assert rs_kernel.gf_apply.launches == before   # the CPU never launches


def test_make_codec_gate():
    """"cpu" is the only way to the host; the default, "auto" and
    "cuda" take the card and raise without one."""
    assert make_codec(2, 1, "cpu").device == torch.device("cpu")
    for backend in (None, "auto", "cuda"):
        if torch.cuda.is_available():
            assert make_codec(2, 1, backend).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_codec(2, 1, backend)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_codec(2, 1)
    with pytest.raises(ValueError, match="unknown ErasureCodec"):
        make_codec(2, 1, "tpu")



def test_gf_pow_matches():
    for a in (0, 1, 2, 3, 0x53, 255):
        for n in (0, 1, 2, 7, 254, 255, 256, 1000):
            assert gf.gf_pow(a, n) == jgf.gf_pow(a, n)


def test_pfield_single_fragment_helpers_match():
    """negmod, powmod and the int64 bodies of the TPU's 16-bit lowering
    (mulmod_u16, dot_u16_deferred) give the reference's values."""
    a = jpf.to_field(field_lanes(3))
    np.testing.assert_array_equal(pf.negmod(t64(a)).numpy(), jpf.negmod(a))
    m = field_lanes(4) & 0xFFFF
    np.testing.assert_array_equal(pf.mulmod_u16(t64(m), t64(a)).numpy(),
                                  jpf.mulmod_u16(m, a))
    mm, bb = m[:256 * 7].reshape(7, 256), a[:256 * 7].reshape(7, 256)
    np.testing.assert_array_equal(
        pf.dot_u16_deferred(t64(mm), t64(bb), dim=1).numpy(),
        jpf.dot_u16_deferred(mm, bb, axis=1))
    with pytest.raises(ValueError, match="256"):
        pf.dot_u16_deferred(t64(m[:257]), t64(a[:257]), dim=0)
    assert pf.MASK16 == jpf.MASK16
    for v, e in ((2, 31), (123456789, jpf.P - 2), (0, 0), (jpf.P - 1, 5)):
        assert pf.powmod(v, e) == jpf.powmod(v, e)
