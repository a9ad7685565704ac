"""The port's host crypto (cess_tpu_torch.crypto) against the reference's
(cess_tpu.crypto), on the CPU, with the same seeds.

Tolerance 0: keys and signatures are protocol facts. Ed25519 keys and
signatures are equal for the same seed and each package verifies the
other's; RSA keypairs from the same (bits, seed) are equal, at the
1024-bit size of tests/test_attestation.py; BLS12-381 keys, signatures,
aggregates and proofs of possession are byte-equal and verify across
packages, on the native backend (the port's own g++ build) and on the
pure-Python path (``_native`` set to None, as tests/test_bls.py does).
The EVM precompiles' RIPEMD-160 and secp256k1, the Ed25519 VRF and the
consensus primitives built on it (``node/consensus``: RRSC slot claims,
epoch randomness, the credit-weighted election) are equal for the same
seeds and inputs, and each package's proofs verify in the other.
"""
import hashlib

import pytest

from cess_tpu import codec as jcodec
from cess_tpu.chain import attestation as jatt
from cess_tpu.crypto import bls12381 as jbls
from cess_tpu.crypto import ed25519 as jed
from cess_tpu.crypto import hashing as jhashing
from cess_tpu.crypto import rsa as jrsa
from cess_tpu_torch import _build
from cess_tpu_torch import codec as pcodec
from cess_tpu_torch.chain import attestation as patt
from cess_tpu_torch.crypto import bls12381 as pbls
from cess_tpu_torch.crypto import ed25519 as ped
from cess_tpu_torch.crypto import hashing as phashing
from cess_tpu_torch.crypto import rsa as prsa
from cess_tpu_torch.node import hashing as node_hashing

SEEDS = [b"", b"alice", b"sess:v1", bytes(range(64))]
MSGS = [b"", b"hello", b"\x00" * 1000, hashlib.sha256(b"m").digest()]


def test_hashes_equal():
    for m in MSGS:
        assert phashing.sha256(m) == jhashing.sha256(m)
        assert phashing.blake2b_256(m) == jhashing.blake2b_256(m)
        assert phashing.fragment_hash(m) == jhashing.fragment_hash(m)
    # one implementation: the agents' fragment hash is crypto's
    assert node_hashing.fragment_hash is phashing.fragment_hash


@pytest.mark.parametrize("seed", SEEDS, ids=range(len(SEEDS)))
def test_ed25519_keys_and_signatures_equal_and_cross_verify(seed):
    pk, jk = ped.SigningKey.generate(seed), jed.SigningKey.generate(seed)
    assert pk.public == jk.public
    for m in MSGS:
        sig = pk.sign(m)
        assert sig == jk.sign(m)
        assert jed.verify(pk.public, m, sig) and ped.verify(jk.public, m, sig)
        bad = bytes([sig[0] ^ 1]) + sig[1:]
        assert not ped.verify(pk.public, m, bad)
        assert not jed.verify(pk.public, m, bad)
        assert not ped.verify(pk.public, m + b"!", sig)


@pytest.mark.parametrize("seed", [1, 2, 7])
def test_rsa_keypairs_equal_and_signatures_cross_verify(seed):
    p, j = (prsa.generate_rsa_keypair(1024, seed=seed),
            jrsa.generate_rsa_keypair(1024, seed=seed))
    assert (p.n, p.e, p.d) == (j.n, j.e, j.d)
    assert pcodec.encode(p.public) == jrsa.codec.encode(j.public)
    assert p.public.fingerprint() == j.public.fingerprint()
    for m in MSGS:
        sig = p.sign_pkcs1v15(m)
        assert sig == j.sign_pkcs1v15(m)
        assert jrsa.rsa_verify_pkcs1v15(j.public, m, sig)
        assert prsa.rsa_verify_pkcs1v15(p.public, m, sig)
        assert not prsa.rsa_verify_pkcs1v15(p.public, m + b"!", sig)


def test_attestation_issue_and_verify_across_packages():
    proot, jroot = (prsa.generate_rsa_keypair(1024, seed=1),
                    jrsa.generate_rsa_keypair(1024, seed=1))
    psig, jsig = (prsa.generate_rsa_keypair(1024, seed=2),
                  jrsa.generate_rsa_keypair(1024, seed=2))
    pcert = patt.issue_cert(proot, "ias-report-signer", psig.public)
    jcert = jatt.issue_cert(jroot, "ias-report-signer", jsig.public)
    assert pcodec.encode(pcert) == jatt.codec.encode(jcert)
    for bls_pk in (b"", b"\x07" * 96):
        prep = patt.issue_report(psig, b"\x01" * 32, b"pk", "tee1",
                                 bls_pk=bls_pk)
        jrep = jatt.issue_report(jsig, b"\x01" * 32, b"pk", "tee1",
                                 bls_pk=bls_pk)
        assert pcodec.encode(prep) == jatt.codec.encode(jrep)
        patt.verify_attestation((proot.public,), (pcert,), *prep)
        with pytest.raises(patt.DispatchError, match="VerifyCertFailed"):
            patt.verify_attestation((proot.public,), (pcert,), prep[0],
                                    prep[1][:-1] + b"\0")
    with pytest.raises(patt.DispatchError, match="UntrustedSigner"):
        patt.verify_attestation((psig.public,), (pcert,), *prep)


@pytest.fixture(params=["native", "python"])
def backend(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(pbls, "_native", None)
        monkeypatch.setattr(jbls, "_native", None)
    else:
        assert pbls._native is not None, "the port's native BLS did not load"
    return request.param


def test_native_bls_is_the_ports_own_build():
    from cess_tpu_torch.crypto import bls_native

    path = _build.host_library_path(_build.NATIVE_DIR / "bls381.cpp")
    assert path.exists() and path.parent == _build.HOST_BUILD_DIR
    assert bls_native._lib._name == str(path)
    assert "cess_tpu/native" not in bls_native._lib._name


def test_bls_keys_signatures_and_pops_equal(backend):
    for seed in (b"tee-1", b"tee-2"):
        (psk, ppk), (jsk, jpk) = pbls.keygen(seed), jbls.keygen(seed)
        assert (psk, ppk) == (jsk, jpk)
        assert len(ppk) == pbls.PK_BYTES
        for m in (b"verdict", b""):
            sig = pbls.sign(psk, m)
            assert sig == jbls.sign(jsk, m) and len(sig) == pbls.SIG_BYTES
            assert jbls.verify(ppk, m, sig) and pbls.verify(jpk, m, sig)
            assert not pbls.verify(ppk, m + b"!", sig)
        pop = pbls.prove_possession(psk, ppk)
        assert pop == jbls.prove_possession(jsk, jpk)
        assert jbls.verify_possession(ppk, pop)
        assert pbls.verify_possession(jpk, pop)
        assert not pbls.verify_possession(ppk, pbls.sign(psk, ppk))


def test_bls_aggregates_equal_and_verify(backend):
    keys = [pbls.keygen(bytes([i])) for i in range(3)]
    msgs = [b"m%d" % i for i in range(3)]
    sigs = [pbls.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    agg = pbls.aggregate(sigs)
    assert agg == jbls.aggregate(sigs)
    pairs = [(pk, m) for (_, pk), m in zip(keys, msgs)]
    assert pbls.aggregate_verify(pairs, agg)
    assert jbls.aggregate_verify(pairs, agg)
    assert not pbls.aggregate_verify(pairs[:2], agg)
    assert not pbls.aggregate_verify(pairs + [pairs[0]], agg)   # repeats
    assert not pbls.verify(b"\x00" * 96, b"m", sigs[0])


def test_native_and_python_paths_agree(monkeypatch):
    sk, pk = pbls.keygen(b"both-paths")
    sig = pbls.sign(sk, b"msg")
    monkeypatch.setattr(pbls, "_native", None)
    assert pbls.keygen(b"both-paths") == (sk, pk)
    assert pbls.sign(sk, b"msg") == sig
    assert pbls.verify(pk, b"msg", sig)
    assert pbls.g2_compress(pbls._g2_mul(pbls.G2_GEN, sk)) == pk


# -- the EVM's precompiles, the VRF and consensus ------------------------------

RIPEMD_MSGS = [b"", b"a", b"abc", b"message digest", b"a" * 1000,
               bytes(range(256)) * 3, b"\x00" * 55, b"\x00" * 56,
               b"\x00" * 64]


def test_ripemd160_equal_and_matches_hashlib():
    from cess_tpu.crypto import ripemd160 as jrmd
    from cess_tpu_torch.crypto import ripemd160 as prmd

    assert prmd.digest(b"abc").hex() \
        == "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"
    try:
        hashlib.new("ripemd160")
        have_hashlib = True
    except ValueError:                 # an OpenSSL build without it
        have_hashlib = False
    for m in RIPEMD_MSGS:
        assert prmd.digest(m) == jrmd.digest(m)
        if have_hashlib:
            assert prmd.digest(m) == hashlib.new("ripemd160", m).digest()


@pytest.mark.parametrize("seed", range(4))
def test_secp256k1_sign_recover_and_addresses_equal(seed):
    from cess_tpu.crypto import secp256k1 as jk
    from cess_tpu_torch.crypto import secp256k1 as pk

    secret = int.from_bytes(hashlib.sha256(b"secp:%d" % seed).digest(),
                            "big") % pk.N
    msg = hashlib.sha256(b"msg:%d" % seed).digest()
    assert pk.pubkey(secret) == jk.pubkey(secret)
    sig = pk.sign(secret, msg)
    assert sig == jk.sign(secret, msg)
    assert pk.address_of(secret) == jk.address_of(secret)
    # a port signature recovers in the reference, and the other way
    assert jk.recover_address(msg, *sig) == pk.address_of(secret)
    assert pk.recover_address(msg, *jk.sign(secret, msg)) \
        == jk.address_of(secret)
    assert pk.recover(msg, *sig) == jk.recover(msg, *sig)
    v, r, s = sig
    assert pk.recover_address(msg, v, r, (s + 1) % pk.N) \
        == jk.recover_address(msg, v, r, (s + 1) % pk.N)
    assert pk.recover_address(msg, v, 0, s) is None \
        and jk.recover_address(msg, v, 0, s) is None


@pytest.mark.parametrize("seed", SEEDS)
def test_vrf_outputs_and_proofs_equal_and_cross_verify(seed):
    from cess_tpu.crypto import vrf as jvrf
    from cess_tpu_torch.crypto import vrf as pvrf

    jk, pk_ = jed.SigningKey.generate(seed), ped.SigningKey.generate(seed)
    for alpha in (b"", b"input", b"slot-7" * 20):
        p = pvrf.vrf_sign(pk_, alpha)
        j = jvrf.vrf_sign(jk, alpha)
        assert pcodec.encode(p) == jcodec.encode(j)
        assert jvrf.vrf_verify(jk.public, alpha,
                               jcodec.decode(pcodec.encode(p)))
        assert pvrf.vrf_verify(pk_.public, alpha,
                               pcodec.decode(jcodec.encode(j)))
        assert not pvrf.vrf_verify(pk_.public, alpha + b"x", p)
    assert pvrf.output_below(p.output, 1, 4) \
        == jvrf.output_below(j.output, 1, 4)


def test_vrf_uniqueness_under_nonce_grinding_in_the_port(monkeypatch):
    """tests/test_node.py's grinding case on the port: other nonces give
    other valid proofs, never another output; the reference verifies
    each ground proof."""
    from cess_tpu.crypto import vrf as jvrf
    from cess_tpu_torch.crypto import vrf as pvrf

    k = ped.SigningKey.generate(b"grinder")
    honest = pvrf.vrf_sign(k, b"slot-7")
    outputs = set()
    for nonce in (12345, 98765, 2**200 + 3):
        monkeypatch.setattr(pvrf, "_derive_nonce",
                            lambda prefix, h, _n=nonce: _n)
        ground = pvrf.vrf_sign(k, b"slot-7")
        assert pvrf.vrf_verify(k.public, b"slot-7", ground)
        assert jvrf.vrf_verify(k.public, b"slot-7",
                               jcodec.decode(pcodec.encode(ground)))
        assert (ground.c, ground.s) != (honest.c, honest.s)
        outputs.add(ground.output)
    assert outputs == {honest.output}


def test_vrf_rejects_small_order_keys_in_both():
    """tests/test_node.py's identity-key forgery, built with the port's
    curve: neither package verifies it."""
    from cess_tpu.crypto import vrf as jvrf
    from cess_tpu_torch.crypto import vrf as pvrf
    from cess_tpu_torch.crypto.ed25519 import L, _compress, _mul

    identity = _compress((0, 1, 1, 0))
    h_pt = pvrf._hash_to_curve(identity, b"slot-9")
    k = 424242
    forged = pvrf.VrfProof(
        output=pvrf._output_from_gamma((0, 1, 1, 0)), gamma=identity,
        c=pvrf._challenge(_compress(h_pt), identity, _compress(_mul(k)),
                          _compress(_mul(k, h_pt))).to_bytes(16, "little"),
        s=(k % L).to_bytes(32, "little"))
    assert not pvrf.vrf_verify(identity, b"slot-9", forged)
    assert not jvrf.vrf_verify(identity, b"slot-9",
                               jcodec.decode(pcodec.encode(forged)))


def test_rrsc_slot_claims_and_randomness_equal():
    from cess_tpu.node import consensus as jcons
    from cess_tpu_torch.node import consensus as pcons

    auths = ("a", "b", "c")
    pkeys = {a: ped.SigningKey.generate(a.encode()) for a in auths}
    jkeys = {a: jed.SigningKey.generate(a.encode()) for a in auths}
    pr, jr = pcons.Rrsc(epoch_blocks=10), jcons.Rrsc(epoch_blocks=10)
    kinds = set()
    for slot in range(30):
        for a in auths:
            pc = pr.claim_slot(slot, a, pkeys[a], auths)
            jc = jr.claim_slot(slot, a, jkeys[a], auths)
            assert pcodec.encode(pc) == jcodec.encode(jc)
            if pc is None:
                continue
            kinds.add(pc.vrf is None)
            assert jr.verify_claim(jcodec.decode(pcodec.encode(pc)),
                                   pkeys[a].public, auths)
            assert pr.verify_claim(pc, pkeys[a].public, auths)
            assert pr.block_randomness(pc) == jr.block_randomness(jc)
            if pc.vrf is not None:
                pr.note_vrf(slot, pc.vrf.output)
                jr.note_vrf(slot, jc.vrf.output)
        assert pr.secondary_author(slot, auths) \
            == jr.secondary_author(slot, auths)
    assert kinds == {True, False}          # primary and secondary claims
    for epoch in range(5):
        assert pr.epoch_randomness(epoch) == jr.epoch_randomness(epoch)


def test_elect_validators_equal():
    import random

    from cess_tpu import constants
    from cess_tpu.node import consensus as jcons
    from cess_tpu_torch.node import consensus as pcons

    D = constants.DOLLARS
    stakes = {"a": 5_000_000 * D, "b": 4_000_000 * D,
              "c": 10_000_000 * D, "poor": 1 * D}
    credits = {"b": 900, "a": 100}
    assert pcons.elect_validators(stakes, credits, 2) == ("b", "a")
    rng = random.Random(7)
    for _ in range(20):
        n = rng.randrange(1, 30)
        stakes = {f"v{i}": rng.randrange(0, 8_000_000) * D
                  for i in range(n)}
        credits = {f"v{i}": rng.randrange(0, 1000)
                   for i in range(n) if rng.random() < 0.7}
        k = rng.randrange(1, n + 2)
        assert pcons.elect_validators(stakes, credits, k) \
            == jcons.elect_validators(stakes, credits, k)
