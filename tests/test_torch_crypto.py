"""The port's host crypto (cess_tpu_torch.crypto) against the reference's
(cess_tpu.crypto), on the CPU, with the same seeds.

Tolerance 0: keys and signatures are protocol facts. Ed25519 keys and
signatures are equal for the same seed and each package verifies the
other's; RSA keypairs from the same (bits, seed) are equal, at the
1024-bit size of tests/test_attestation.py; BLS12-381 keys, signatures,
aggregates and proofs of possession are byte-equal and verify across
packages, on the native backend (the port's own g++ build) and on the
pure-Python path (``_native`` set to None, as tests/test_bls.py does).
"""
import hashlib

import pytest

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
