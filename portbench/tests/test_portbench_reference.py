"""The plain reference (``portbench/reference``) against the port's plain
versions on the CPU, at small sizes: encode, reconstruct, ids, tags, the
challenge and coefficients, mu and sigma, verdicts.

    python -m pytest -q portbench/tests
"""
import hashlib
import itertools

import numpy as np
import pytest
import torch

from cess_tpu_torch.node import offchain
from cess_tpu_torch.ops import podr2, prf, rs
from portbench.reference import gf256, m31, podr2 as ref_podr2, threefry

BLOCKS = 64
N = BLOCKS * 512


@pytest.fixture(scope="module")
def keyset():
    g = np.random.default_rng(7)
    alpha = g.integers(0, m31.P, (256, 2), dtype=np.int64)
    prf_key = g.integers(0, 1 << 32, 2, dtype=np.uint64).astype(np.uint32)
    key = podr2.Podr2Key(torch.from_numpy(alpha.astype(np.int32)),
                         torch.from_numpy(prf_key.astype(np.int64)))
    return alpha, prf_key, key


@pytest.fixture(scope="module")
def store(keyset):
    alpha, prf_key, key = keyset
    g = np.random.default_rng(8)
    frags = g.integers(0, 256, (24, N), dtype=np.uint8)
    hashes = [hashlib.sha256(f).digest() for f in frags]
    ids = np.stack([threefry.fragment_id(h) for h in hashes])
    tags = podr2.tag_fragments(key, ids, torch.from_numpy(frags)).numpy()
    return frags, hashes, ids, tags.astype(np.uint32)


@pytest.mark.parametrize("k,m", [(2, 1), (4, 8), (3, 2)])
def test_encode(k, m):
    seg = np.random.default_rng(k * 10 + m).integers(
        0, 256, k * 4096, dtype=np.uint8)
    got = rs.TorchCodec(k, m, "cpu").encode(
        torch.from_numpy(seg.reshape(k, -1))).numpy()
    assert np.array_equal(got, gf256.encode(k, m, seg))


@pytest.mark.parametrize("k,m", [(2, 1), (4, 8)])
def test_reconstruct(k, m):
    g = np.random.default_rng(k + m)
    frags = gf256.encode(k, m, g.integers(0, 256, k * 2048, dtype=np.uint8))
    patterns = list(itertools.combinations(range(k + m), k))
    for present in [patterns[i] for i in g.choice(len(patterns),
                                                  min(12, len(patterns)),
                                                  replace=False)]:
        for row in (j for j in range(k + m) if j not in present):
            ref = gf256.rebuild(k, m, frags[list(present)], present, row)
            got = offchain.repair_via_fragments(
                k, m, [frags[j].tobytes() for j in present], present, row,
                device="cpu")
            assert np.array_equal(ref, frags[row])
            assert np.frombuffer(got, np.uint8).tobytes() == ref.tobytes()


def test_ids_and_tags(keyset, store):
    alpha, prf_key, key = keyset
    frags, hashes, ids, tags = store
    assert np.array_equal(ids, np.stack(
        [podr2.fragment_id_from_hash(h) for h in hashes]))
    for i in range(len(frags)):
        assert np.array_equal(ref_podr2.tags(alpha, prf_key, ids[i],
                                             frags[i]), tags[i])
    at = np.array([0, 5, 63, 5])
    assert np.array_equal(ref_podr2.tags(alpha, prf_key, ids[0], frags[0], at),
                          tags[0][at])


@pytest.mark.parametrize("seed", [b"round-0", b"\x00" * 32, b"x" * 7])
def test_challenge_and_coefficients(seed, store):
    ids = store[2]
    idx, nu = podr2.gen_challenge(seed, 16384, device="cpu")
    ridx, rnu = threefry.challenge(seed, 16384)
    assert len(ridx) == 753
    assert np.array_equal(idx.numpy(), ridx) and np.array_equal(nu.numpy(),
                                                               rnu)
    r = podr2.aggregate_coeffs(seed, ids, device="cpu").numpy()
    assert np.array_equal(r, threefry.aggregate_coeffs(seed, ids))
    f = prf.prf_plain(torch.tensor([11, 12]),
                      torch.from_numpy(ids.astype(np.int64)),
                      torch.from_numpy(ridx[:40]), 2).numpy()
    assert np.array_equal(f, threefry.prf(np.array([11, 12], np.uint32), ids,
                                          ridx[:40], 2))


@pytest.mark.parametrize("drop", [0, 1, 5])
def test_prove_and_verify(keyset, store, drop):
    alpha, prf_key, key = keyset
    frags, hashes, ids, tags = store
    seed = b"audit-%d" % drop
    held = {h: frags[i] for i, h in enumerate(hashes) if i >= drop}
    tag_of = {h: tags[i] for i, h in enumerate(hashes)}
    mu, sigma = offchain.prove_owed(seed, hashes, held, tag_of, device="cpu")
    keep = [i for i in range(len(hashes)) if i >= drop]
    ref_mu, ref_sigma = ref_podr2.prove(alpha, prf_key, seed, ids[keep],
                                        [frags[i] for i in keep], 256)
    assert np.array_equal(mu, ref_mu) and np.array_equal(sigma, ref_sigma)
    got = offchain.verify_owed(key, BLOCKS, seed, hashes, mu, sigma,
                               device="cpu")
    assert got == ref_podr2.verify(alpha, prf_key, seed, ids, BLOCKS, mu,
                                   sigma) == (drop == 0)


def test_dot_u16_exact():
    g = np.random.default_rng(3)
    m = g.integers(0, 1 << 16, (50, 256), dtype=np.int64)
    w = g.integers(0, m31.P, (256, 2), dtype=np.int64)
    exact = np.array([[sum(int(a) * int(b) for a, b in zip(row, w[:, j]))
                       % m31.P for j in range(2)] for row in m])
    assert np.array_equal(m31.dot_u16(m, w), exact)
