"""The port's StoragePipeline against cess_tpu.models.pipeline, the
known-answer digest both packages share, and the port's isolation from
jax and cess_tpu."""
import hashlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cess_tpu.models import pipeline as jpipeline
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu_torch import kat
from cess_tpu_torch.convert import pipeline_from_arrays
from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
from cess_tpu_torch.ops import podr2
from cess_tpu_torch.serve import make_engine

SEGMENT = 64 * 1024
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def segments(b, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, SEGMENT),
                                                dtype=np.uint8)


def jax_pipeline(k, m, key_seed):
    key = jpodr2.Podr2Key.generate(key_seed)
    cfg = jpipeline.PipelineConfig(k=k, m=m, segment_size=SEGMENT)
    return jpipeline.StoragePipeline(cfg, podr2_key=key), key


def port_pipeline(k, m, jkey):
    return pipeline_from_arrays(k, m, SEGMENT, podr2.SECTORS,
                                np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                device="cpu")


@pytest.mark.parametrize("k,m", [(2, 1), (4, 8)])
def test_forward_matches_jax(k, m):
    jpipe, jkey = jax_pipeline(k, m, key_seed=5)
    pipe = port_pipeline(k, m, jkey)
    seg = segments(2, seed=k)
    want = jpipe.forward(seg)
    got = pipe(torch.from_numpy(seg))
    assert got["fragments"].shape == (2, k + m, SEGMENT // k)
    assert got["tags"].shape == (2, k + m, SEGMENT // k // 512, 2)
    assert got["tags"].dtype == torch.int32
    np.testing.assert_array_equal(got["fragments"].numpy(),
                                  np.asarray(want["fragments"]))
    np.testing.assert_array_equal(got["tags"].numpy().astype(np.uint32),
                                  np.asarray(want["tags"]))


def test_forward_hash_ids_and_steps_match_jax():
    k, m = 2, 1
    jpipe, jkey = jax_pipeline(k, m, key_seed=9)
    pipe = port_pipeline(k, m, jkey)
    seg = segments(2, seed=3)
    ids = np.stack([jpodr2.fragment_id_from_hash(
        hashlib.sha256(bytes([i])).digest()) for i in range(6)]).reshape(2, 3, 2)
    want = jpipe.forward(seg, fragment_ids=ids)
    got = pipe(torch.from_numpy(seg), fragment_ids=ids)
    np.testing.assert_array_equal(got["tags"].numpy().astype(np.uint32),
                                  np.asarray(want["tags"]))
    shards = pipe.encode_step(seg)
    np.testing.assert_array_equal(shards.numpy(), np.asarray(want["fragments"]))
    np.testing.assert_array_equal(
        pipe.tag_step(shards, ids).numpy().astype(np.uint32),
        np.asarray(want["tags"]))


def test_default_key_is_the_jax_default():
    cfg = PipelineConfig(k=2, m=1, segment_size=SEGMENT)
    pipe = StoragePipeline(cfg, device="cpu")
    jpipe = jpipeline.StoragePipeline(
        jpipeline.PipelineConfig(k=2, m=1, segment_size=SEGMENT))
    np.testing.assert_array_equal(
        pipe.alpha.numpy().astype(np.uint32),
        np.asarray(jpipe.podr2_key.alpha))
    np.testing.assert_array_equal(
        pipe.prf_key.numpy(),
        np.asarray(jax.random.key_data(jpipe.podr2_key.prf_key)))
    assert set(pipe.state_dict()) == {"parity_tables", "alpha", "prf_key"}
    # the tag weights follow alpha: a loaded key cannot leave them stale
    other = podr2.Podr2Key.generate(1, podr2.Podr2Params(cfg.sectors),
                                    device="cpu")
    pipe.load_state_dict({**pipe.state_dict(), "alpha": other.alpha,
                          "prf_key": other.prf_key})
    assert torch.equal(pipe.podr2_key.weights, other.weights)
    assert pipe.to("cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="segments must be"):
        pipe.encode_step(np.zeros((2, 100), dtype=np.uint8))


def test_known_answer_digest_of_jax_package():
    """The TPU package at the known-answer configuration hashes to
    kat.DIGEST, the constant chip_smoke.py holds the card to."""
    jpipe = jpipeline.StoragePipeline(
        jpipeline.PipelineConfig(k=kat.K, m=kat.M,
                                 segment_size=kat.SEGMENT_SIZE),
        podr2_key=jpodr2.Podr2Key.generate(kat.KEY_SEED))
    key = jpipe.podr2_key
    out = jpipe.forward(kat.segments())
    n = kat.BATCH * (kat.K + kat.M)
    blocks = jpipe.config.blocks_per_fragment
    frags = np.asarray(out["fragments"])
    tags = np.asarray(out["tags"])
    ids = kat.id_pairs()
    idx, nu = jpodr2.gen_challenge(kat.ROUND_SEED, blocks, kat.CHALLENGE_COUNT)
    r = jpodr2.aggregate_coeffs(kat.ROUND_SEED, ids)
    mu, sigma = jpodr2.prove_aggregate(frags.reshape(n, -1),
                                       tags.reshape(n, blocks, -1), idx, nu, r)
    assert bool(jpodr2.verify_aggregate(key, ids, blocks, idx, nu, r, mu,
                                        sigma))
    got = kat.digest(frags, tags, *(np.asarray(x) for x in (idx, nu, r, mu,
                                                             sigma)))
    assert got == kat.DIGEST


def test_known_answer_digest_of_port():
    digest, ok = kat.run_port("cpu")
    assert ok and digest == kat.DIGEST


def test_port_imports_no_jax_and_no_cess_tpu():
    code = ("import sys\n"
            # an era boundary and a migration run first: their lazy
            # imports (election -> node.consensus, migrations -> evm,
            # staking, contracts, crypto.rsa) must reach the port's own
            "from cess_tpu_torch.chain.runtime import Runtime, RuntimeConfig\n"
            "rt = Runtime(RuntimeConfig(era_blocks=2,\n"
            "                           genesis_spec_version=109))\n"
            "rt.apply_extrinsic('root', 'system.apply_runtime_upgrade')\n"
            "rt.run_to_block(2)\n"
            "assert 'cess_tpu_torch.node.consensus' in sys.modules\n"
            "import cess_tpu_torch, cess_tpu_torch.models.pipeline\n"
            "import cess_tpu_torch.convert, cess_tpu_torch.kat\n"
            "import cess_tpu_torch.ops.audit_backend, cess_tpu_torch.ops.rs\n"
            "import cess_tpu_torch.ops.xor_sched, cess_tpu_torch.ops.rs_xor\n"
            "import cess_tpu_torch.ops.rs_ref, cess_tpu_torch.ops.regen\n"
            "import cess_tpu_torch.serve, cess_tpu_torch.serve.engine\n"
            "import cess_tpu_torch.serve.stream, cess_tpu_torch.obs.prom\n"
            "import cess_tpu_torch.resilience, cess_tpu_torch.obs.trace\n"
            "import cess_tpu_torch.obs.flight\n"
            "import cess_tpu_torch.node, cess_tpu_torch.node.hashing\n"
            "import cess_tpu_torch.node.offchain\n"
            "import cess_tpu_torch.parallel, cess_tpu_torch.parallel.mesh\n"
            "import cess_tpu_torch.parallel.multihost\n"
            "import cess_tpu_torch.serve.pool\n"
            "import cess_tpu_torch.obs.slo, cess_tpu_torch.obs.profile\n"
            "import cess_tpu_torch.obs.incident\n"
            "import cess_tpu_torch.serve.adaptive\n"
            "import cess_tpu_torch.serve.remediate, cess_tpu_torch.obs.fleet\n"
            "import cess_tpu_torch.obs.custody, cess_tpu_torch.obs.chainwatch\n"
            "from cess_tpu_torch.models import PipelineConfig, StoragePipeline\n"
            "from cess_tpu_torch.ops.podr2 import (verify, prove, tag_fragment,\n"
            "                                      tag_from_elems)\n"
            "import cess_tpu_torch.codec, cess_tpu_torch.crypto\n"
            "import cess_tpu_torch.crypto.hashing, cess_tpu_torch.crypto.ed25519\n"
            "import cess_tpu_torch.crypto.rsa, cess_tpu_torch.crypto.bls12381\n"
            "import cess_tpu_torch.crypto.bls_native\n"
            "import cess_tpu_torch.ops.rs_native\n"
            "import cess_tpu_torch.chain, cess_tpu_torch.chain.state\n"
            "import cess_tpu_torch.chain.balances, cess_tpu_torch.chain.system\n"
            "import cess_tpu_torch.chain.storage_handler\n"
            "import cess_tpu_torch.chain.sminer, cess_tpu_torch.chain.scheduler\n"
            "import cess_tpu_torch.chain.file_bank\n"
            "import cess_tpu_torch.chain.attestation\n"
            "import cess_tpu_torch.chain.tee_worker, cess_tpu_torch.chain.audit\n"
            "from cess_tpu_torch.crypto import verify_bls\n"
            "import cess_tpu_torch.crypto.ripemd160\n"
            "import cess_tpu_torch.crypto.secp256k1, cess_tpu_torch.crypto.vrf\n"
            "import cess_tpu_torch.node.consensus\n"
            "from cess_tpu_torch.node import Rrsc, SlotClaim, elect_validators\n"
            "import cess_tpu_torch.chain.overlay, cess_tpu_torch.chain.oss\n"
            "import cess_tpu_torch.chain.scheduler_credit\n"
            "import cess_tpu_torch.chain.staking, cess_tpu_torch.chain.offences\n"
            "import cess_tpu_torch.chain.im_online\n"
            "import cess_tpu_torch.chain.extrinsic, cess_tpu_torch.chain.indices\n"
            "import cess_tpu_torch.chain.assets, cess_tpu_torch.chain.cacher\n"
            "import cess_tpu_torch.chain.governance\n"
            "import cess_tpu_torch.chain.contracts\n"
            "import cess_tpu_torch.chain.evm_interp, cess_tpu_torch.chain.evm\n"
            "import cess_tpu_torch.chain.election\n"
            "import cess_tpu_torch.chain.migrations\n"
            "import cess_tpu_torch.chain.weights_generated\n"
            "from cess_tpu_torch.chain.runtime import (ROOT, TREASURY,\n"
            "    ROOT_ONLY, SIGNED_CALLS, DISPATCHABLE, FEELESS, CALL_WEIGHTS,\n"
            "    WEIGHT_FEE, HAND_WEIGHTS)\n"
            "from cess_tpu_torch.chain.system import System\n"
            "assert callable(System.apply_runtime_upgrade)\n"
            "from cess_tpu_torch.node.offchain import (Proof, build_proof,\n"
            "                                         proof_wire_bytes)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith('jax.') or m == 'cess_tpu'\n"
            "             or m.startswith('cess_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result; alone in a directory it cannot import the port at all."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            (tmp_path / "chip_smoke.py").write_bytes(
                open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StoragePipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        podr2.Podr2Key.generate(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        podr2.gen_challenge(b"x", 128)
    with pytest.raises(RuntimeError):
        StoragePipeline(PipelineConfig(segment_size=SEGMENT), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(podr2_key=podr2.Podr2Key.generate(0, device="cpu"))
    eng = make_engine(2, 1, rs_backend="cpu")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StoragePipeline(PipelineConfig(segment_size=SEGMENT), engine=eng)
    finally:
        eng.close()
    # the multi-device planes: every CUDA device by default, never the CPU
    from cess_tpu_torch.parallel import global_mesh, make_mesh
    from cess_tpu_torch.serve import DevicePool

    for build in (make_mesh, global_mesh, DevicePool,
                  lambda: DevicePool(n=2),
                  lambda: make_engine(2, 1, pool=True),
                  lambda: make_engine(2, 1, rs_backend="cpu", pool=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


@pytest.mark.parametrize("surface", ["pipeline", "engine", "stream"])
def test_tenant_is_accepted_as_the_reference_accepts_it(surface):
    """``tenant=`` (the TPU package's per-tenant accounting tag) goes
    through the pipeline's steps, every engine submit and the stream
    and changes nothing: the results equal the JAX package's. The
    smallest case: RS(2,1) on one zero segment of 1 KiB."""
    from cess_tpu import serve as jserve
    from cess_tpu.serve import stream as jstream
    from cess_tpu_torch.serve import StreamingIngest

    jkey = jpodr2.Podr2Key.generate(3)
    cfg = jpipeline.PipelineConfig(k=2, m=1, segment_size=1024)
    jeng = eng = None
    if surface == "engine":
        eng = make_engine(2, 1, rs_backend="cpu", audit_backend="cpu",
                          podr2_key=port_pipeline(2, 1, jkey).podr2_key)
        jeng = jserve.make_engine(2, 1, podr2_key=jkey)
    jpipe = jpipeline.StoragePipeline(cfg, podr2_key=jkey, engine=jeng)
    pipe = pipeline_from_arrays(2, 1, 1024, podr2.SECTORS,
                                np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                device="cpu")
    pipe.engine = eng
    zero = np.zeros((1, 1024), np.uint8)
    seg = np.random.default_rng(4).integers(0, 256, (3, 1024), np.uint8)
    ids = np.random.default_rng(5).integers(0, 1 << 32, (3, 3, 2),
                                            np.uint64).astype(np.uint32)

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a.astype(np.int64),
                                                     b.astype(np.int64))

    try:
        if surface == "stream":
            got = StreamingIngest(pipe, 2, tenant="alice").ingest(seg, ids)
            want = jstream.StreamingIngest(jpipe, 2,
                                           tenant="alice").ingest(seg, ids)
            assert same(got["fragments"], want["fragments"])
            assert same(got["tags"], want["tags"])
            return
        enc = pipe.encode_step(zero, tenant="alice")
        assert tuple(enc.shape) == (1, 3, 512)
        assert same(enc, jpipe.encode_step(zero, tenant="alice"))
        frags = pipe.encode_step(seg, tenant="bob")
        assert same(pipe.tag_step(frags, ids, tenant="bob"),
                    jpipe.tag_step(np.asarray(frags), ids, tenant="bob"))
        got = pipe(seg, ids, tenant="carol")
        want = jpipe.forward(seg, ids, tenant="carol")
        assert same(got["fragments"], want["fragments"])
        assert same(got["tags"], want["tags"])
        if surface != "engine":
            return
        # every blocking form of the engine takes the tag too
        fr = np.asarray(got["fragments"])
        flat, flat_ids = fr.reshape(9, 512), ids.reshape(9, 2)
        tags = eng.tag_fragments(flat_ids, flat, tenant="t")
        assert same(tags, jeng.tag_fragments(flat_ids, flat, tenant="t"))
        for name, args in (("encode", (fr[:, :2],)),
                           ("reconstruct", (fr[:, 1:], (1, 2), (0,))),
                           ("decode_data", (fr[:, 1:], (1, 2)))):
            assert same(getattr(eng, name)(*args, tenant="t"),
                        getattr(jeng, name)(*args, tenant="t"))
        idx, nu = (np.asarray(x) for x in jpodr2.gen_challenge(b"t", 1))
        r = np.asarray(jpodr2.aggregate_coeffs(b"t", flat_ids))
        mu, sigma = eng.prove_aggregate(flat, tags, idx, nu, r, tenant="t")
        jmu, jsigma = jeng.prove_aggregate(flat, np.asarray(tags, np.uint32),
                                           idx, nu, r, tenant="t")
        assert same(mu, jmu) and same(sigma, jsigma)
        assert eng.verify_aggregate(flat_ids, 1, idx, nu, r, mu, sigma,
                                    tenant="t") is True
        bmu, bsigma = jpodr2.prove_batch(flat, np.asarray(tags, np.uint32),
                                         idx, nu)
        assert same(eng.verify_batch(flat_ids, 1, idx, nu, np.asarray(bmu),
                                     np.asarray(bsigma), tenant="t"),
                    jeng.verify_batch(flat_ids, 1, idx, nu, bmu, bsigma,
                                      tenant="t"))
        for name, args in (("submit_encode", (fr[:, :2],)),
                           ("submit_tag", (flat_ids, flat))):
            assert same(getattr(eng, name)(*args, tenant="t").result(),
                        getattr(jeng, name)(*args, tenant="t").result())
    finally:
        for e in (eng, jeng):
            if e is not None:
                e.close()
