"""One storage-audit round of the port, from the upload to the verdict on
chain, against the reference, on the CPU at a small size (RS(2,1), four
segments of 128 KiB: fragments of 64 KiB, 128 blocks).

The round (tests/torch_chain_wiring.py ``audit_round``) runs the port's
upload, proofs, checks and seals on the port's plain path, and applies
every call as a signed extrinsic through ``Runtime.apply_in_block`` to
the port's runtime and the reference's in lockstep (equal outcomes,
state roots and events after each block), then runs both to the next
era boundary. Then, tolerance 0:

- the port's ``build_proof`` bytes equal the reference's ``build_proof``
  bytes on the same store and tags;
- the reference's TEE check (``TeeAgent._verify`` on an instance built
  with ``__new__``) accepts the port's honest proofs and refuses the
  tampered one, as the port's check does;
- verdicts sealed by the port's BLS pass the reference's
  ``Audit.submit_verify_result``, and one sealed by the reference's BLS
  passes the port's; a forged seal is refused by both;
- both runtimes end on the same state root, with the rewards, the
  failure count and the fees the verdicts and the signed calls imply;
  the honest miners' first tranche reaches their beneficiaries at the
  era boundary, and the validators keep their audit keys across it.
"""
import jax
import numpy as np
import pytest
import torch

from cess_tpu import constants
from cess_tpu.chain import audit as jaudit
from cess_tpu.crypto import bls12381 as jbls
from cess_tpu.node import offchain as joff
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu_torch.models import PipelineConfig
from cess_tpu_torch.node import offchain
from cess_tpu_torch.ops import podr2

from torch_chain_wiring import (MINERS, TEE, USER, VALIDATORS,
                                Lockstep, audit_round)

SEG = 128 * 1024
NSEG = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def round_():
    cfg = PipelineConfig(segment_size=SEG)
    key = podr2.Podr2Key.generate(7, device="cpu")
    pipe = offchain.AgentPipeline(cfg, podr2_key=key, device="cpu")
    data = np.random.default_rng(11).integers(0, 256, NSEG * SEG, np.uint8)
    ls = Lockstep(["cess_tpu_torch", "cess_tpu"])
    port, ref = ls.chains
    ref_sealed = []

    def seal(tee, digest, idle_ok, service_ok):
        # the second miner's verdict is sealed by the reference's BLS
        msg = jaudit.verdict_message(tee, digest, idle_ok, service_ok)
        sk, _ = jbls.keygen(b"tee1-bls")
        if len(ref_sealed) == 1:
            ref_sealed.append(digest)
            return jbls.sign(sk, msg)
        ref_sealed.append(None)
        from cess_tpu_torch.crypto import bls12381 as pbls

        return pbls.sign(pbls.keygen(b"tee1-bls")[0], msg)

    r = audit_round(pipe, data, chains=ls, device="cpu",
                    tamper_row=1, seal=seal)
    return {**r, "port": port, "ref": ref, "cfg": cfg,
            "jkey": jpodr2.Podr2Key.generate(7), "ref_sealed": ref_sealed}


def test_verdicts_rewards_and_state_roots(round_):
    r = round_
    assert r["tampered"] == r["deal"].assigned[1]
    want = {w: (True, w != r["tampered"]) for w in r["deal"].assigned}
    assert r["verdicts"] == want
    port, ref = r["port"], r["ref"]
    assert port.state.state_root() == ref.state.state_root() \
        == r["state_root"]
    ls = r["lockstep"]
    assert ls.events_bytes(0) == ls.events_bytes(1)
    for w in r["deal"].assigned:
        orders = r["orders"][w]
        if w == r["tampered"]:
            assert orders is None and w not in r["paid"]
            assert r["received"][w] == 0
            assert ref.state.get("audit", "fail_count", w) == 1
        else:
            assert orders and orders[0].tranches_left \
                == constants.RELEASE_NUMBER
            assert r["received"][w] == r["paid"][w] == orders[0].each_share
            assert ref.state.get("sminer", "reward_orders", w)[0] \
                .tranches_left == constants.RELEASE_NUMBER - 1
    assert not ref.state.get("audit", "unverify", TEE)
    assert [e.name for e in ref.state.events_of("audit", "VerifyResult")] \
        == ["VerifyResult"] * 3


def test_signed_blocks_fees_and_the_era_boundary(round_):
    r = round_
    port, ref = r["port"], r["ref"]
    assert r["blocks"] == 50 == ref.state.block
    assert r["audit_keys"] == VALIDATORS == ref.audit.keys()
    failed = [(dict(e.data)["call"], dict(e.data)["error"])
              for e in ref.state.events_of("system", "ExtrinsicFailed")]
    assert failed == [("audit.save_challenge_info",
                       "audit.ChallengeInProgress"),
                      ("audit.submit_verify_result",
                       "audit.BadVerdictSignature")]
    # regnstk x3, register, fillers x3, the user's 3, reports x3 and
    # calculate_end, proposals x3, proofs x3, the forged seal and 3
    assert r["signed"] == 3 + 1 + 3 + 3 + 4 + 3 + 3 + 4
    assert ref.system.nonce(USER) == 3 and ref.system.nonce(TEE) == 5
    assert all(ref.system.nonce(w) == 4 for w in MINERS)
    assert ref.system.account_key(TEE) == r["lockstep"].keys[TEE].public
    assert ref.balances.free("treasury") > 0      # 80% of every fee
    assert [e.name for e in ref.state.events_of("system", "ExtrinsicFailed")
            ] == [e.name for e in port.state.events_of(
                "system", "ExtrinsicFailed")]


def test_build_proof_bytes_equal_reference(round_):
    r = round_
    seed = r["seed"]
    assert offchain.proof_wire_bytes() == joff.proof_wire_bytes()
    for m in r["missions"]:
        w, snap = m.miner, m.snapshot
        idle, service = r["proofs"][w]
        assert (m.idle_proof, m.service_proof) == (idle, service)
        assert service == joff.build_proof(seed, list(snap.service_frags),
                                           r["store"][w], r["tags"][w])
        assert idle == joff.build_proof(seed, list(snap.fillers),
                                        r["filler_store"][w],
                                        r["filler_tags"][w])
        for blob in (idle, service):
            assert len(blob) == offchain.proof_wire_bytes() \
                <= constants.SIGMA_MAX


def test_reference_tee_check_agrees(round_):
    r = round_
    tee = joff.TeeAgent.__new__(joff.TeeAgent)
    tee.key, tee.blocks, tee.engine = (r["jkey"],
                                       r["cfg"].blocks_per_fragment, None)
    idx, nu = jpodr2.gen_challenge(r["seed"], tee.blocks)
    for m in r["missions"]:
        snap = m.snapshot
        got = (tee._verify(m.idle_proof, list(snap.fillers), r["seed"], idx,
                           nu),
               tee._verify(m.service_proof, list(snap.service_frags),
                           r["seed"], idx, nu))
        assert got == r["verdicts"][m.miner]
    assert not tee._verify(b"\x00junk", list(snap.fillers), r["seed"], idx,
                           nu)


def test_seals_verify_across_packages(round_):
    r = round_
    _, bls_pk = r["bls"]
    assert jbls.keygen(b"tee1-bls")[1] == bls_pk
    assert sum(d is not None for d in r["ref_sealed"]) == 1
    for rec in r["verdict_log"]:
        assert jaudit.reverify_verdict(rec, bls_pk)
    assert r["log_ok"]
    ref_log = r["ref"].audit.verdicts()
    assert jaudit.reverify_verdicts_batch(
        ref_log, {TEE: r["ref"].tee_worker.bls_keys_of(TEE)})
    ls = r["lockstep"]
    assert ls.codecs[1].encode(ref_log) == ls.codecs[0].encode(
        r["verdict_log"])


def test_port_key_is_the_references(round_):
    jk = round_["jkey"]
    alpha = np.asarray(jk.alpha)
    words = np.asarray(jax.random.key_data(jk.prf_key))
    key = podr2.Podr2Key.generate(7, device="cpu")
    assert np.array_equal(key.alpha.numpy().astype(np.uint32), alpha)
    assert np.array_equal(key.prf_key.numpy().astype(np.uint32), words)
