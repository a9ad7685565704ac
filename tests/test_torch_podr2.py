"""The port's PoDR2 tags, proofs and verdicts against cess_tpu.ops.podr2.

Tags are compared with the TPU package's fused Pallas tag kernel, which
runs in interpret mode here (64 KiB fragments: 128 blocks, inside its
envelope). Proofs cross over: the port's tags and proofs verify in the
TPU package and the TPU package's in the port."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.ops import podr2_pallas
from cess_tpu_torch.convert import podr2_key_from_arrays
from cess_tpu_torch.ops import pfield as pf
from cess_tpu_torch.ops import podr2, podr2_kernel, prf
from cess_tpu_torch.ops.audit_backend import make_audit_backend

FRAG_BYTES = 64 * 1024              # 128 blocks of 512 bytes
BLOCKS = FRAG_BYTES // podr2.BLOCK_BYTES


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frags(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, FRAG_BYTES), dtype=np.uint8)


def hash_ids(n, salt=b""):
    return np.stack([jpodr2.fragment_id_from_hash(
        hashlib.sha256(salt + bytes([i])).digest()) for i in range(n)])


def both_keys(seed, limbs=2):
    """The same secret key in both packages, carried across as arrays."""
    import jax

    jk = jpodr2.Podr2Key.generate(seed, jpodr2.Podr2Params(limbs=limbs))
    key = podr2_key_from_arrays(np.asarray(jk.alpha),
                                np.asarray(jax.random.key_data(jk.prf_key)),
                                device="cpu")
    return jk, key


def u32(t):
    return t.numpy().astype(np.uint32)


def test_protocol_constants_match():
    assert podr2.SECTORS == jpodr2.SECTORS
    assert podr2.BLOCK_BYTES == jpodr2.BLOCK_BYTES
    assert podr2.LIMBS == jpodr2.LIMBS
    assert podr2.PROOF_BYTES == jpodr2.PROOF_BYTES
    assert podr2.Podr2Params().blocks_for(8 << 20) == 16384


@pytest.mark.parametrize("limbs", [2, 3])
@pytest.mark.parametrize("id_kind", ["int", "hash"])
def test_tag_fragments_match_pallas_kernel(limbs, id_kind):
    jk, key = both_keys(11, limbs)
    data = frags(3, seed=limbs)
    ids = np.arange(3, dtype=np.int32) if id_kind == "int" else hash_ids(3)
    assert podr2_pallas.supported(jpodr2.SECTORS, BLOCKS)
    want = np.asarray(jpodr2.tag_fragments(jk, jnp.asarray(ids), data))
    got = podr2.tag_fragments(key, ids, torch.from_numpy(data))
    assert got.dtype == torch.int32 and got.shape == (3, BLOCKS, limbs)
    np.testing.assert_array_equal(u32(got), want)


def test_tag_fragments_small_sectors():
    """The port takes any sectors <= 256 (the TPU package's jnp path
    outside its kernel envelope is the reference there)."""
    params = jpodr2.Podr2Params(sectors=100)
    jk = jpodr2.Podr2Key.generate(4, params)
    key = podr2.Podr2Key.generate(4, podr2.Podr2Params(sectors=100),
                                  device="cpu")
    data = np.random.default_rng(1).integers(0, 256, (2, 200 * 6),
                                             dtype=np.uint8)
    want = np.asarray(jpodr2.tag_fragments(jk, jnp.arange(2), data))
    got = podr2.tag_fragments(key, np.arange(2), torch.from_numpy(data))
    np.testing.assert_array_equal(u32(got), want)


def test_weight_table_matches_pallas_limbs():
    jk, key = both_keys(2)
    alpha = np.asarray(jk.alpha)
    w0, w1 = podr2_pallas._weight_limbs((alpha.shape[0], alpha.shape[1],
                                         alpha.tobytes()))
    w = podr2_kernel.weight_table(key.alpha).numpy().astype(np.int64)
    np.testing.assert_array_equal(w & 0xFFFF, w0)
    np.testing.assert_array_equal(w >> 16, w1)


def test_plain_tag_kernel_matches_bytes_times_weights():
    """The plain tag version (elements times alpha) equals the kernel's
    formulation (bytes times interleaved weights) on the same inputs."""
    _, key = both_keys(6)
    data = torch.from_numpy(frags(2, seed=6)).reshape(2, BLOCKS, 512)
    ids = torch.tensor([[0, 0], [1, 0]])
    prf_lm = podr2_kernel.prf_blocks(key.prf_key, ids, None, BLOCKS, 2,
                                     limb_major=True)
    got = podr2_kernel.podr2_tag(key.weights, prf_lm, data)
    mac = (data.to(torch.int64)[..., None] *
           key.weights.to(torch.int64).t()).sum(dim=-2)
    want = (mac + prf_lm.to(torch.int64).transpose(1, 2)) % pf.P
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def audit_round(pkg, key, fr, tags, ids, seed=b"round"):
    idx, nu = pkg.gen_challenge(seed, BLOCKS, **(
        {"device": "cpu"} if pkg is podr2 else {}))
    r = pkg.aggregate_coeffs(seed, ids, **(
        {"device": "cpu"} if pkg is podr2 else {}))
    mu, sigma = pkg.prove_aggregate(fr, tags, idx, nu, r)
    return idx, nu, r, mu, sigma


def test_proofs_match_and_verify_across_packages():
    jk, key = both_keys(21)
    data = frags(4, seed=21)
    ids = hash_ids(4, b"x")
    jtags = jpodr2.tag_fragments(jk, jnp.asarray(ids), data)
    tags = podr2.tag_fragments(key, ids, torch.from_numpy(data))
    np.testing.assert_array_equal(u32(tags), np.asarray(jtags))

    j = audit_round(jpodr2, jk, jnp.asarray(data), jtags, ids)
    p = audit_round(podr2, key, torch.from_numpy(data), tags, ids)
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(b).astype(np.int64))
    idx, nu, r, mu, sigma = p
    # the port's proof verifies in the TPU package, and the reverse
    assert bool(jpodr2.verify_aggregate(
        jk, ids, BLOCKS, jnp.asarray(idx.numpy().astype(np.int32)),
        jnp.asarray(u32(nu)), jnp.asarray(u32(r)), jnp.asarray(u32(mu)),
        np.asarray(u32(sigma))))
    j_idx, j_nu, j_r, j_mu, j_sigma = (
        torch.from_numpy(np.asarray(x).astype(np.int64)) for x in j)
    assert bool(podr2.verify_aggregate(key, ids, BLOCKS, j_idx, j_nu, j_r,
                                       j_mu, j_sigma))
    # a forgery in one limb is rejected by both
    for limb in range(2):
        forged = sigma.clone()
        forged[limb] = (forged[limb] + 1) % pf.P
        assert not bool(podr2.verify_aggregate(key, ids, BLOCKS, idx, nu, r,
                                               mu, forged))
        assert not bool(jpodr2.verify_aggregate(
            jk, ids, BLOCKS, jnp.asarray(idx.numpy().astype(np.int32)),
            jnp.asarray(u32(nu)), jnp.asarray(u32(r)), jnp.asarray(u32(mu)),
            np.asarray(u32(forged))))


@pytest.mark.parametrize("limbs", [2, 3])
def test_mission_axis_matches_jax_per_mission(limbs):
    """A leading mission axis on prove_aggregate / verify_aggregate (the
    engine's stacked classes) gives each mission the TPU package's
    one-mission answer; idx None takes blocks gathered beforehand."""
    jk, key = both_keys(9, limbs)
    missions, per = 3, 2
    data = frags(missions * per, seed=40 + limbs)
    ids = hash_ids(missions * per, b"m").astype(np.int64)
    tags = podr2.tag_fragments(key, ids, torch.from_numpy(data))
    idx, nu = podr2.gen_challenge(b"missions", BLOCKS, device="cpu")
    r = podr2.aggregate_coeffs(b"missions", ids, device="cpu")
    fr = torch.from_numpy(data).reshape(missions, per, FRAG_BYTES)
    tg = tags.reshape(missions, per, BLOCKS, limbs)
    rr = r.reshape(missions, per)
    mu, sigma = podr2.prove_aggregate(fr, tg, idx, nu, rr)
    gathered = fr.reshape(missions, per, BLOCKS, podr2.BLOCK_BYTES)[:, :, idx]
    mu_g, sigma_g = podr2.prove_aggregate(
        gathered.reshape(missions, per, -1), tg[:, :, idx], None, nu, rr)
    assert torch.equal(mu, mu_g) and torch.equal(sigma, sigma_g)
    jidx = jnp.asarray(idx.numpy().astype(np.int32))
    for i in range(missions):
        s = slice(i * per, (i + 1) * per)
        jmu, jsg = jpodr2.prove_aggregate(
            jnp.asarray(data[s]), jnp.asarray(u32(tags[s])), jidx,
            jnp.asarray(u32(nu)), jnp.asarray(u32(r[s])))
        np.testing.assert_array_equal(u32(mu[i]), np.asarray(jmu))
        np.testing.assert_array_equal(u32(sigma[i]), np.asarray(jsg))
    forged = sigma.clone()
    forged[1, 0] = (forged[1, 0] + 1) % pf.P
    ok = podr2.verify_aggregate(key, torch.from_numpy(ids).reshape(
        missions, per, 2), BLOCKS, idx, nu, rr, mu, forged)
    assert ok.tolist() == [True, False, True]
    assert [bool(jpodr2.verify_aggregate(
        jk, ids[i * per:(i + 1) * per], BLOCKS, jidx, jnp.asarray(u32(nu)),
        jnp.asarray(u32(rr[i])), jnp.asarray(u32(mu[i])),
        np.asarray(u32(forged[i])))) for i in range(missions)] == ok.tolist()


@pytest.mark.parametrize("limbs", [2, 3])
def test_prove_verify_batch_match(limbs):
    jk, key = both_keys(8, limbs)
    data = frags(3, seed=30 + limbs)
    ids = np.arange(3, dtype=np.int32)
    jtags = jpodr2.tag_fragments(jk, jnp.asarray(ids), data)
    tags = podr2.tag_fragments(key, ids, torch.from_numpy(data))
    jidx, jnu = jpodr2.gen_challenge(b"batch", BLOCKS)
    idx, nu = podr2.gen_challenge(b"batch", BLOCKS, device="cpu")
    jmu, jsg = jpodr2.prove_batch(jnp.asarray(data), jtags, jidx, jnu)
    mu, sg = podr2.prove_batch(torch.from_numpy(data), tags, idx, nu)
    np.testing.assert_array_equal(
        podr2.fragment_to_elems(torch.from_numpy(data)).numpy(),
        np.asarray(jpodr2.fragment_to_elems(data)))
    np.testing.assert_array_equal(u32(mu), np.asarray(jmu))
    np.testing.assert_array_equal(u32(sg), np.asarray(jsg))
    ok = podr2.verify_batch(key, ids, BLOCKS, idx, nu, mu, sg)
    assert ok.tolist() == [True] * 3
    corrupt = data.copy()
    corrupt[1, int(idx[0]) * podr2.BLOCK_BYTES] ^= 0xFF
    mu_c, sg_c = podr2.prove_batch(torch.from_numpy(corrupt), tags, idx, nu)
    assert podr2.verify_batch(key, ids, BLOCKS, idx, nu, mu_c,
                              sg_c).tolist() == [True, False, True]
    # verify_from_f with the full PRF range agrees
    f = podr2.prf_elems(key.prf_key, 2, BLOCKS, limbs)
    assert bool(podr2.verify_from_f(key.alpha, f, idx, nu, mu[2], sg[2]))
    assert not bool(podr2.verify_from_f(key.alpha, f, idx, nu, mu_c[1],
                                        sg_c[1]))


def test_keys_and_ids():
    a = podr2.Podr2Key.generate(1, device="cpu")
    assert podr2.keys_equal(a, podr2.Podr2Key.generate(1, device="cpu"))
    assert not podr2.keys_equal(a, podr2.Podr2Key.generate(2, device="cpu"))
    h = hashlib.sha256(b"frag").digest()
    np.testing.assert_array_equal(podr2.fragment_id_from_hash(h),
                                  jpodr2.fragment_id_from_hash(h))
    ids = podr2.fragment_ids(np.array([1, (5 << 32) | 3]), "cpu")
    assert ids.tolist() == [[1, 0], [3, 5]]


def test_supported_envelope_pinned():
    assert podr2_kernel.supported(256, 16384)
    assert podr2_kernel.supported(256, 192)      # outside the Pallas envelope
    assert not podr2_pallas.supported(256, 192)
    assert podr2_kernel.supported(100, 7)
    assert not podr2_kernel.supported(257, 128)
    assert not podr2_kernel.supported(0, 128)


def test_kernel_wrapper_checks():
    _, key = both_keys(3)
    data = torch.zeros((2, 4, 512), dtype=torch.uint8)
    prf_lm = torch.zeros((2, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="prf must be"):
        podr2_kernel.podr2_tag(key.weights, prf_lm[:, :, :3], data)
    with pytest.raises(ValueError, match="weights must be"):
        podr2_kernel.podr2_tag(key.weights.to(torch.int64), prf_lm, data)
    with pytest.raises(ValueError, match="cuda or cpu"):
        podr2_kernel.podr2_tag(key.weights.to("meta"), prf_lm.to("meta"),
                               data.to("meta"))
    with pytest.raises(ValueError, match="ids must be"):
        podr2_kernel.prf_blocks(key.prf_key, torch.zeros(3, dtype=torch.int64),
                                None, 4, 2)
    before = (podr2_kernel.podr2_tag.launches, podr2_kernel.prf_blocks.launches)
    podr2.tag_fragments(key, np.arange(2), torch.zeros((2, 2048),
                                                       dtype=torch.uint8))
    assert (podr2_kernel.podr2_tag.launches,
            podr2_kernel.prf_blocks.launches) == before   # CPU: plain only


def test_audit_backend_gate():
    jk, key = both_keys(3)
    cpu = make_audit_backend(key, "cpu")
    data = frags(2, seed=3)
    ids = np.stack([np.arange(2), np.zeros(2, np.int64)], 1).astype(np.uint32)
    tags = cpu.tag_fragments(ids, data)
    assert tags.device == torch.device("cpu")
    for backend in (None, "auto", "cuda"):
        if torch.cuda.is_available():
            np.testing.assert_array_equal(
                tags.numpy(), make_audit_backend(key, backend).tag_fragments(
                    ids, data).cpu().numpy())
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_audit_backend(key, backend)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_audit_backend(key)
    idx, nu = cpu.gen_challenge(b"gate", BLOCKS)
    mu, sg = cpu.prove_batch(data, tags, idx, nu)
    assert cpu.verify_batch(ids, BLOCKS, idx, nu, mu, sg).all()
    r = cpu.aggregate_coeffs(b"gate", ids)
    mu_t, sg_t = cpu.prove_aggregate(data, tags, idx, nu, r)
    assert bool(cpu.verify_aggregate(ids, BLOCKS, idx, nu, r, mu_t, sg_t))
    with pytest.raises(ValueError, match="unknown AuditBackend"):
        make_audit_backend(key, "tpu")



def test_single_fragment_api_matches_reference():
    """tag_from_elems, tag_fragment, prove and verify on the inputs of
    tests/test_podr2.py::test_tag_oracle_parity_numpy_bigint (key 5, one
    16-block fragment from seed 4, id 0), then a challenge round."""
    ORACLE_FRAG_BYTES = 4 * podr2.BLOCK_BYTES * 4     # test_podr2.FRAG_BYTES
    jk = jpodr2.Podr2Key.generate(5)
    key = podr2.Podr2Key.generate(5, device="cpu")
    assert podr2.keys_equal(key, both_keys(5)[1])
    frag = np.random.default_rng(4).integers(0, 256, (1, ORACLE_FRAG_BYTES),
                                             dtype=np.uint8)[0]
    want = np.asarray(jpodr2.tag_fragment(jk, 0, frag))
    tags = podr2.tag_fragment(key, 0, torch.from_numpy(frag))
    assert tags.dtype == torch.int32
    np.testing.assert_array_equal(u32(tags), want)
    m = podr2.fragment_to_elems(torch.from_numpy(frag))
    f = podr2.prf_elems(key.prf_key, 0, m.shape[0])
    np.testing.assert_array_equal(
        u32(podr2.tag_from_elems(key.alpha, f, m)),
        np.asarray(jpodr2.tag_from_elems(
            jk.alpha, jpodr2.prf_elems(jk.prf_key, 0, m.shape[0]),
            jpodr2.fragment_to_elems(jnp.asarray(frag)))))
    blocks = m.shape[0]
    idx, nu = podr2.gen_challenge(b"single", blocks, device="cpu")
    jidx, jnu = jpodr2.gen_challenge(b"single", blocks)
    mu, sigma = podr2.prove(torch.from_numpy(frag), tags, idx, nu)
    jmu, jsigma = jpodr2.prove(jnp.asarray(frag), jnp.asarray(want), jidx,
                               jnu)
    np.testing.assert_array_equal(u32(mu), np.asarray(jmu))
    np.testing.assert_array_equal(u32(sigma), np.asarray(jsigma))
    assert bool(podr2.verify(key, 0, blocks, idx, nu, mu, sigma))
    assert bool(jpodr2.verify(jk, 0, blocks, jidx, jnu, jnp.asarray(u32(mu)),
                              np.asarray(u32(sigma))))
    forged = mu.clone()
    forged[0] = (forged[0] + 1) % pf.P
    assert not bool(podr2.verify(key, 0, blocks, idx, nu, forged, sigma))
    assert not bool(jpodr2.verify(jk, 0, blocks, jidx, jnu,
                                  jnp.asarray(u32(forged)),
                                  np.asarray(u32(sigma))))
