"""The port's regenerating repair plane (``cess_tpu_torch.ops.regen``)
against ``cess_tpu.ops.regen`` on the CPU. Inputs come from numpy seeds;
every comparison is byte equality (tolerance 0): matrices, coefficients
and rebuilt fragments are protocol facts."""
import itertools

import numpy as np
import pytest
import torch

from cess_tpu.ops import regen as jregen
from cess_tpu.ops import rs_ref as jrs_ref
from cess_tpu_torch.ops import gf, regen, rs_ref
from cess_tpu_torch.ops.rs import make_codec


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_cauchy_inverse_matches_jax():
    for k, m in ((2, 1), (2, 2), (3, 3), (4, 8), (10, 4)):
        for t in range(1, min(k, m) + 1):
            xs, ys = [k + q for q in range(t)], list(range(t))
            got = regen.cauchy_inverse(xs, ys)
            np.testing.assert_array_equal(got, jregen.cauchy_inverse(xs, ys))
            a = np.array([[gf.gf_inv(x ^ y) for y in ys] for x in xs],
                         dtype=np.uint8)
            np.testing.assert_array_equal(gf.gf_matmul(got, a),
                                          np.eye(t, dtype=np.uint8))


@pytest.mark.parametrize("k,m", [(2, 2), (4, 8)])
def test_matrices_and_coeffs_match_jax_for_every_pattern(k, m):
    """Every survivor pattern (495 for RS(4,8)): the decode and repair
    matrices and every lost row's repair coefficients."""
    for present in itertools.combinations(range(k + m), k):
        missing = tuple(r for r in range(k + m) if r not in present)
        np.testing.assert_array_equal(regen.decode_matrix(k, m, present),
                                      jregen.decode_matrix(k, m, present))
        np.testing.assert_array_equal(
            regen.repair_matrix(k, m, present, missing),
            jregen.repair_matrix(k, m, present, missing))
        for lost in missing:
            assert regen.repair_coeffs(k, m, present, (lost,)) == \
                jregen.repair_coeffs(k, m, present, (lost,))
    # survivor columns follow the caller's order, in both packages
    permuted = (3, 1) + tuple(range(4, k + 2))
    np.testing.assert_array_equal(regen.decode_matrix(k, m, permuted),
                                  jregen.decode_matrix(k, m, permuted))


def test_refusals_match_jax():
    cases = [
        ("cauchy_inverse", ([1, 2], [3])), ("cauchy_inverse", ([1, 1], [2, 3])),
        ("cauchy_inverse", ([1, 2], [2, 3])), ("decode_matrix", (2, 2, (0, 1, 2))),
        ("decode_matrix", (2, 2, (1, 1))), ("decode_matrix", (2, 2, (0, 4))),
        ("repair_matrix", (2, 2, (0, 1), (2, 2))),
        ("repair_matrix", (2, 2, (0, 1), (9,))),
        ("repair_coeffs", (2, 2, (0, 1), (2, 3))),
        ("fold_symbol_pairs", (rnd((3, 64), 1), 7)),
        ("_symbol_matrix", (256,)),
    ]
    for name, args in cases:
        with pytest.raises(ValueError) as port:
            getattr(regen, name)(*args)
        with pytest.raises(ValueError) as ref:
            getattr(jregen, name)(*args)
        assert str(port.value) == str(ref.value), name


def test_host_folds_match_jax():
    pairs = rnd((5, 2, 64), 9)
    for coeff in (0, 1, 2, 255):
        got = regen.fold_symbol_pairs(pairs, coeff)
        np.testing.assert_array_equal(got, jregen.fold_symbol_pairs(pairs, coeff))
        np.testing.assert_array_equal(
            regen.fold_symbol_host(pairs[1, 0], pairs[1, 1], coeff),
            jregen.fold_symbol_host(pairs[1, 0], pairs[1, 1], coeff))
        np.testing.assert_array_equal(regen._symbol_matrix(coeff),
                                      jregen._symbol_matrix(coeff))


@pytest.mark.parametrize("strategy", ["gather", "xor", "auto"])
def test_regen_codec_matches_jax(strategy):
    k, m = 4, 8
    port = regen.RegenCodec(k, m, device="cpu", strategy=strategy)
    ref = jregen.RegenCodec(k, m, strategy=strategy)
    data = rnd((3, k, 96), seed=21)
    coded = np.asarray(ref.encode(data))
    np.testing.assert_array_equal(port.encode(data).numpy(), coded)
    for present in ((1, 3, 5, 9), (4, 5, 6, 7), (0, 1, 2, 11)):
        surv = coded[:, list(present)]
        missing = tuple(r for r in range(k + m) if r not in present)
        np.testing.assert_array_equal(
            port.reconstruct(surv, present, missing).numpy(),
            np.asarray(ref.reconstruct(surv, present, missing)))
        np.testing.assert_array_equal(
            port.decode_data(surv, present).numpy(),
            np.asarray(ref.decode_data(surv, present)))
    pairs = rnd((3, 2, 65), seed=12)
    for coeff in (0, 1, 7, 213):
        np.testing.assert_array_equal(port.fold_symbol(pairs, coeff).numpy(),
                                      np.asarray(ref.fold_symbol(pairs, coeff)))
    assert port.repair_coeffs((1, 3, 5, 9), (0,)) == \
        ref.repair_coeffs((1, 3, 5, 9), (0,))


@pytest.mark.parametrize("k,m", [(2, 1), (4, 8)])
def test_symbol_chain_matches_jax(k, m):
    """k fold hops over the repair coefficients rebuild the lost row, in
    the port's batched fold and in the TPU package's host fold."""
    port = regen.RegenCodec(k, m, device="cpu", strategy="xor")
    data = rnd((2, k, 128), seed=k * 17 + m)
    coded = port.encode(data).numpy()
    present = tuple(range(1, k + 1))
    coeffs = port.repair_coeffs(present, (0,))
    acc = torch.zeros((2, 1, 128), dtype=torch.uint8)
    host = np.zeros((2, 128), dtype=np.uint8)
    for p, row in enumerate(present):
        pairs = torch.cat([acc, torch.from_numpy(coded[:, row:row + 1])], dim=1)
        acc = port.fold_symbol(pairs, coeffs[p])
        host = jregen.fold_symbol_host(host, coded[:, row], coeffs[p])
    np.testing.assert_array_equal(acc[:, 0].numpy(), host)
    np.testing.assert_array_equal(acc[:, 0].numpy(), coded[:, 0])


def test_warm_fold_hits():
    """As tests/test_regen.py pins the TPU package's warm fold."""
    codec = regen.RegenCodec(2, 1, device="cpu")
    pairs = rnd((2, 2, 64), 5)
    cold = codec.fold_symbol(pairs, 7)
    assert codec.warm_hits == 0
    codec.warm_fold(7, pairs.shape)
    warm = codec.fold_symbol(pairs, 7)
    assert codec.warm_hits == 1
    assert torch.equal(warm, cold)
    codec.fold_symbol(pairs, 8)
    codec.fold_symbol(rnd((3, 2, 64), 6), 7)
    assert codec.warm_hits == 1
    # the reconstruct warm path shares the cache and the count
    coded = codec.encode(rnd((2, 64), 3))
    codec.warm_reconstruct((1, 2), (0,), (2, 64))
    assert torch.equal(codec.reconstruct(coded[[1, 2]], (1, 2), (0,))[0],
                       coded[0])
    assert codec.warm_hits == 2 and len(codec._warm) == 2


def test_regen_reference_matches_jax():
    for k, m in ((2, 1), (2, 2), (4, 8)):
        port, ref = regen.RegenReference(k, m), jregen.RegenReference(k, m)
        plain, jplain = rs_ref.ReferenceCodec(k, m), jrs_ref.ReferenceCodec(k, m)
        data = rnd((2, k, 96), seed=k + m)
        coded = port.encode(data)
        np.testing.assert_array_equal(coded, ref.encode(data))
        np.testing.assert_array_equal(plain.encode_parity(data),
                                      jplain.encode_parity(data))
        for present in list(itertools.combinations(range(k + m), k))[:5]:
            surv = coded[:, list(present)]
            np.testing.assert_array_equal(port.decode_data(surv, present),
                                          ref.decode_data(surv, present))
            np.testing.assert_array_equal(plain.decode_data(surv, present),
                                          jplain.decode_data(surv, present))
            np.testing.assert_array_equal(port.reconstruct(surv, present),
                                          ref.reconstruct(surv, present))
        pairs = rnd((2, 2, 32), 4)
        np.testing.assert_array_equal(port.fold_symbol(pairs, 9),
                                      ref.fold_symbol(pairs, 9))
        assert port.repair_coeffs(tuple(range(1, k + 1)), (0,)) == \
            ref.repair_coeffs(tuple(range(1, k + 1)), (0,))


def test_make_codec_regen_gate():
    if torch.cuda.is_available():
        assert isinstance(make_codec(2, 2, "regen"), regen.RegenCodec)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_codec(2, 2, "regen")
    with pytest.raises(ValueError, match="unknown ErasureCodec backend"):
        make_codec(2, 2, "nope")
    assert isinstance(regen.RegenCodec(2, 2, device="cpu", strategy="xor"),
                      regen.RegenCodec)
