"""The port's storage-audit pallets (cess_tpu_torch.chain) against the
reference's (cess_tpu.chain), each inside its package's ``Runtime``
(``RuntimeConfig(era_blocks=50)``, built by tests/torch_chain_wiring.py),
on the same dispatchable sequences.

The scenarios are those of tests/test_chain.py that touch the
storage-audit pallets. Every step runs on both runtimes; the arguments
reach the port through the two codecs (encoded by the reference's,
decoded by the port's). After every step both runtimes must hold the
same state root and the same events, and a refused step must fail on
both with the same ``DispatchError`` name. Tolerance 0: state roots are
protocol facts.
"""
import dataclasses

import pytest

from cess_tpu import codec as jcodec
from cess_tpu import constants
from cess_tpu.chain.attestation import issue_cert, issue_report
from cess_tpu.chain.audit import SESSION_SIGNING_CONTEXT, Audit
from cess_tpu.chain.file_bank import FileBank, UserBrief
from cess_tpu.crypto import ed25519
from cess_tpu.crypto.rsa import generate_rsa_keypair
from cess_tpu_torch import constants as pconstants
from cess_tpu_torch.chain import state as pstate

from torch_chain_wiring import ROOT, Lockstep

D = constants.DOLLARS
MIB = constants.MIB
FRAG = constants.FRAGMENT_SIZE
ALICE, BOB = "alice", "bob"
MINERS = ["m1", "m2", "m3", "m4", "m5"]
FILE = b"\x11" * 32


def seg_hashes(n, salt=b"s"):
    return [(salt + bytes([i]) + b"seg" + b"\0" * 28,
             tuple(salt + bytes([i, j]) + b"frag" + b"\0" * 26
                   for j in range(3)))
            for i in range(n)]


@pytest.fixture
def pair():
    p = Lockstep(["cess_tpu", "cess_tpu_torch"])
    for a in (ALICE, BOB):
        p.fund(a, 10_000_000 * D)
    for w in MINERS:
        p.fund(w, 10_000 * D)
        p.x(w, "sminer.regnstk", w, b"peer" + w.encode(), 2000 * D)
        p.direct("sminer.add_miner_idle_space", w, 4000 * FRAG)
    p.x(ALICE, "storage_handler.buy_space", 20)
    p.x(ALICE, "file_bank.create_bucket", ALICE, "bkt")
    return p


def declare(p, who=ALICE, file_hash=FILE, segs=2, bucket="bkt",
            refused=None):
    args = (who, "file_bank.upload_declaration", file_hash, seg_hashes(segs),
            UserBrief(who, "f.txt", bucket), segs * 16 * MIB)
    if refused:
        p.refused(refused, *args)
    else:
        p.x(*args)


def complete_deal(p, file_hash=FILE):
    deal = p.q(lambda c: c.file_bank.deal(file_hash))
    for w in deal.assigned:
        p.x(w, "file_bank.transfer_report", file_hash)
    p.x(ROOT, "file_bank.calculate_end", file_hash)


def setup_tee(p, controller="tee1", stash="stash1"):
    root_kp = generate_rsa_keypair(1024, seed=1)
    signer_kp = generate_rsa_keypair(1024, seed=2)
    p.fund(stash, 3_000_000 * D)
    mrenclave = b"\x01" * 32
    p.x(ROOT, "tee_worker.update_whitelist", mrenclave)
    p.x(ROOT, "tee_worker.pin_ias_signer", root_kp.public)
    podr2_pk = b"podr2-public-key"
    cert = issue_cert(root_kp, "ias-report-signer", signer_kp.public)
    report, sig = issue_report(signer_kp, mrenclave, podr2_pk, controller)
    p.x(controller, "tee_worker.register", stash, b"teepeer", podr2_pk,
         report, sig, (cert,))
    return root_kp


def audit_keys(p, validators):
    keys = {}
    for v in validators:
        k = ed25519.SigningKey.generate(b"sess:" + v.encode())
        p.direct("system.set_session_key", v, k.public)
        keys[v] = k
    p.direct("audit.set_keys", tuple(validators))
    return keys


def sign_proposal(key, net, miners):
    return key.sign(SESSION_SIGNING_CONTEXT
                    + Audit.snapshot_digest(net, miners))


def start_challenge(p, validators=("v1", "v2", "v3")):
    keys = audit_keys(p, validators)
    net, miners = p.q(lambda c: c.audit.generation_challenge())
    for v in validators[:2]:
        p.x(v, "audit.save_challenge_info", net, miners,
             sign_proposal(keys[v], net, miners))
    assert p.q(lambda c: c.audit.challenge()) is not None
    return net, miners


def filler_cert(p, tee_key, miner, hashes):
    nonce = p.q(lambda c: c.file_bank.filler_cert_nonce(miner))
    return tee_key.sign(FileBank.FILLER_CERT_CONTEXT
                        + jcodec.encode((miner, hashes, nonce)))


def bind_tee_key(p, tee="tee1"):
    tee_key = ed25519.SigningKey.generate(b"tee1-acct")
    p.direct("system.bind_account_key", tee, tee_key.public)
    return tee_key


# -- the scenarios ----------------------------------------------------------------

def sc_space_purchase(p):
    own = p.q(lambda c: c.storage_handler.owned_space(ALICE))
    assert own.total_space == 20 * constants.GIB
    p.x(ALICE, "storage_handler.expansion_space", 10)
    p.x(ALICE, "storage_handler.renewal_space", 30)
    p.refused("storage_handler.PurchasedSpace", ALICE,
          "storage_handler.buy_space", 1)
    p.refused("storage_handler.InsufficientAvailableSpace", BOB,
          "storage_handler.buy_space", 1000)


def sc_registration_and_collateral(p):
    m = p.q(lambda c: c.sminer.miner("m1"))
    assert m.collateral == 2000 * D and m.state == "positive"
    p.refused("sminer.AlreadyRegistered", "m1", "sminer.regnstk", "m1", b"p",
          2000 * D)
    p.refused("sminer.CollateralNotUp", "nm", "sminer.regnstk", "nm", b"p", 1 * D)


def sc_punish_and_freeze(p):
    p.fund("m1", 10_000 * D)
    p.direct("sminer.deposit_punish", "m1", 1500 * D)
    assert p.q(lambda c: c.sminer.miner("m1")).state == "frozen"
    p.x("m1", "sminer.increase_collateral", 1500 * D)
    assert p.q(lambda c: c.sminer.miner("m1")).state == "positive"
    p.direct("sminer.deposit_punish", "m2", 3000 * D)
    m = p.q(lambda c: c.sminer.miner("m2"))
    assert m.collateral == 0 and m.debt == 1000 * D


def sc_upload_lifecycle(p):
    declare(p)
    deal = p.q(lambda c: c.file_bank.deal(FILE))
    assert len(deal.assigned) == 3
    declare(p, refused="file_bank.DealExists")
    for w in deal.assigned:
        p.x(w, "file_bank.transfer_report", FILE)
    assert p.q(lambda c: c.file_bank.file(FILE)).state == "calculate"
    p.x(ROOT, "file_bank.calculate_end", FILE)
    assert p.q(lambda c: c.file_bank.file(FILE)).state == "active"
    assert p.q(lambda c: c.storage_handler.total_service_space()) \
        == 3 * 2 * FRAG


def sc_dedup(p):
    declare(p)
    complete_deal(p)
    p.x(BOB, "storage_handler.buy_space", 10)
    p.x(BOB, "file_bank.create_bucket", BOB, "bkt")
    declare(p, who=BOB)
    f = p.q(lambda c: c.file_bank.file(FILE))
    assert {o.user for o in f.owners} == {ALICE, BOB}
    declare(p, who=BOB, refused="file_bank.OwnedFile")


def sc_delete(p):
    declare(p)
    complete_deal(p)
    p.x(ALICE, "file_bank.delete_file", ALICE, FILE)
    assert p.q(lambda c: c.file_bank.file(FILE)) is None
    assert p.q(lambda c: c.storage_handler.owned_space(ALICE)).used_space == 0


def sc_deal_timeout(p):
    declare(p)
    deal0 = p.q(lambda c: c.file_bank.deal(FILE))
    p.x(deal0.assigned[0], "file_bank.transfer_report", FILE)
    life = constants.DEAL_TIMEOUT_BLOCKS * 3
    for retry in range(1, constants.DEAL_MAX_RETRIES + 1):
        p.blocks(life + 1)
        assert p.q(lambda c: c.file_bank.deal(FILE)).count == retry
    p.blocks(life + 1)
    assert p.q(lambda c: c.file_bank.deal(FILE)) is None
    assert p.q(lambda c: c.state.events_of("file_bank", "DealAborted"))


def sc_ownership_transfer(p):
    declare(p)
    complete_deal(p)
    p.x(BOB, "storage_handler.buy_space", 10)
    p.x(BOB, "file_bank.create_bucket", BOB, "bkt2")
    p.x(ALICE, "file_bank.ownership_transfer", ALICE,
         UserBrief(BOB, "f.txt", "bkt2"), FILE)
    assert [o.user for o in p.q(lambda c: c.file_bank.file(FILE)).owners] \
        == [BOB]


def sc_filler_registry(p):
    setup_tee(p)
    tee_key = bind_tee_key(p)
    hashes = tuple(bytes([i]) * 32 for i in range(3))
    sig = filler_cert(p, tee_key, "m1", hashes)
    p.x("m1", "file_bank.upload_filler", hashes, "tee1", sig)
    p.refused("file_bank.BadFillerCert", "m1", "file_bank.upload_filler", hashes,
          "tee1", sig)
    p.refused("file_bank.FillerExists", "m1", "file_bank.upload_filler", hashes,
          "tee1", filler_cert(p, tee_key, "m1", hashes))
    h2 = (b"\x99" * 32,)
    p.refused("file_bank.InvalidCount", "m1", "file_bank.upload_filler", h2 + h2,
          "tee1", filler_cert(p, tee_key, "m1", h2 + h2))
    p.refused("file_bank.BadFillerCert", "m1", "file_bank.upload_filler", h2,
          "tee1", b"\x00" * 64)
    sig2 = filler_cert(p, tee_key, "m1", h2)
    p.refused("file_bank.NonExistentTee", "m1", "file_bank.upload_filler", h2,
          "nobody", sig2)
    p.refused("file_bank.BadFillerCert", "m2", "file_bank.upload_filler", h2,
          "tee1", sig2)


def sc_replace_file_report(p):
    setup_tee(p)
    tee_key = bind_tee_key(p)
    hashes = tuple(bytes([40 + i]) * 32 for i in range(4))
    sig = filler_cert(p, tee_key, "m1", hashes)
    p.x("m1", "file_bank.upload_filler", hashes, "tee1", sig)
    p.each("pending_replace", lambda c: c.state.put(
        "file_bank", "pending_replace", "m1", 2))
    p.x("m1", "file_bank.replace_file_report", hashes[:2])
    p.refused("file_bank.BadFillerCert", "m1", "file_bank.upload_filler", hashes,
          "tee1", sig)
    p.refused("file_bank.InvalidCount", "m1", "file_bank.replace_file_report",
          hashes[2:])


def sc_filler_idle_ledger(p):
    for w in MINERS:
        m = p.q(lambda c: c.sminer.miner(w))
        p.direct("storage_handler.sub_total_idle_space", m.idle_space)
        p.each(f"rebase {w}", lambda c: c.state.put(
            "sminer", "miner", w, dataclasses.replace(c.sminer.miner(w),
                                                      idle_space=0)))
    setup_tee(p)
    tee_key = bind_tee_key(p)
    for w in MINERS:
        hashes = tuple(w.encode() + bytes([i]) * 31 for i in range(8))
        p.x(w, "file_bank.upload_filler", hashes, "tee1",
             filler_cert(p, tee_key, w, hashes))
    declare(p)
    complete_deal(p)
    deal_miners = p.q(lambda c: c.file_bank.file(FILE)).miners
    for w in deal_miners:
        n = p.q(lambda c: c.file_bank.pending_replacements(w))
        victims = tuple(p.q(lambda c: c.file_bank.filler_hashes(w)))[:n]
        p.x(w, "file_bank.replace_file_report", victims)
    w = deal_miners[0]
    p.direct("file_bank.delete_filler", w,
             p.q(lambda c: c.file_bank.filler_hashes(w))[0])


def sc_audit_reward(p):
    setup_tee(p)
    declare(p)
    complete_deal(p)
    p.fund("sminer_reward_pool", 1000 * D)
    start_challenge(p)
    target = p.q(lambda c: c.file_bank.file(FILE)).miners[0]
    p.x(target, "audit.submit_proof", b"ip", b"sp")
    p.refused("audit.NotChallengedMiner", target, "audit.submit_proof", b"ip",
          b"sp")
    p.x("tee1", "audit.submit_verify_result", target, True, True)
    orders = p.q(lambda c: c.state.get("sminer", "reward_orders", target))
    assert orders and orders[0].tranches_left == constants.RELEASE_NUMBER
    p.blocks(60)                           # an era: the first tranche


def sc_audit_fault_tolerance(p):
    setup_tee(p)
    declare(p)
    complete_deal(p)
    target = p.q(lambda c: c.file_bank.file(FILE)).miners[0]
    collateral0 = p.q(lambda c: c.sminer.miner(target)).collateral
    for _ in range(constants.AUDIT_FAULT_TOLERANCE):
        start_challenge(p)
        p.x(target, "audit.submit_proof", b"ip", b"sp")
        p.x("tee1", "audit.submit_verify_result", target, False, True)
        p.to_block(p.q(lambda c: c.audit.challenge()).verify_deadline + 1)
    assert p.q(lambda c: c.sminer.miner(target)).collateral < collateral0


def sc_clear_punish_escalation(p):
    setup_tee(p)
    declare(p)
    complete_deal(p)
    for _ in range(3):
        start_challenge(p)
        p.to_block(p.q(lambda c: c.audit.challenge()).verify_deadline + 1)
    target = p.q(lambda c: c.file_bank.file(FILE)).miners[0]
    assert p.q(lambda c: c.sminer.miner(target)).state == "locked"


def sc_proposal_two_thirds(p):
    keys = audit_keys(p, ("v1", "v2", "v3"))
    net, miners = p.q(lambda c: c.audit.generation_challenge())
    p.x("v1", "audit.save_challenge_info", net, miners,
         sign_proposal(keys["v1"], net, miners))
    assert p.q(lambda c: c.audit.challenge()) is None
    p.refused("audit.NotAuditKey", "vX", "audit.save_challenge_info", net, miners,
          sign_proposal(keys["v1"], net, miners))
    p.refused("audit.BadSessionSignature", "v2", "audit.save_challenge_info", net,
          miners, sign_proposal(keys["v1"], net, miners))
    p.x("v2", "audit.save_challenge_info", net, miners,
         sign_proposal(keys["v2"], net, miners))
    assert p.q(lambda c: c.audit.challenge()) is not None
    p.refused("audit.ChallengeInProgress", "v3", "audit.save_challenge_info", net,
          miners, sign_proposal(keys["v3"], net, miners))


def sc_vote_switching(p):
    keys = audit_keys(p, ("v0", "v1", "v2"))
    net_a, miners = p.q(lambda c: c.audit.generation_challenge())
    net_b = dataclasses.replace(net_a, total_reward=net_a.total_reward + 1)
    p.x("v0", "audit.save_challenge_info", net_a, miners,
         sign_proposal(keys["v0"], net_a, miners))
    p.x("v0", "audit.save_challenge_info", net_b, miners,
         sign_proposal(keys["v0"], net_b, miners))
    p.refused("audit.AlreadyProposed", "v0", "audit.save_challenge_info", net_a,
          miners, sign_proposal(keys["v0"], net_a, miners))
    assert p.q(lambda c: c.audit.challenge()) is None
    p.x("v1", "audit.save_challenge_info", net_a, miners,
         sign_proposal(keys["v1"], net_a, miners))
    assert p.q(lambda c: c.audit.challenge()) is not None


def sc_stale_proposal(p):
    keys = audit_keys(p, ("v1", "v2", "v3"))
    net, miners = p.q(lambda c: c.audit.generation_challenge())
    p.x("v1", "audit.save_challenge_info", net, miners,
         sign_proposal(keys["v1"], net, miners))
    p.blocks(p.first.audit.challenge_life + 1)
    p.x("v2", "audit.save_challenge_info", net, miners,
         sign_proposal(keys["v2"], net, miners))
    assert p.q(lambda c: c.audit.challenge()) is None
    p.x("v1", "audit.save_challenge_info", net, miners,
         sign_proposal(keys["v1"], net, miners))
    assert p.q(lambda c: c.audit.challenge()) is not None


def sc_tee_verify_timeout(p):
    setup_tee(p)
    declare(p)
    complete_deal(p)
    start_challenge(p)
    target = p.q(lambda c: c.file_bank.file(FILE)).miners[0]
    p.x(target, "audit.submit_proof", b"ip", b"sp")
    p.to_block(p.q(lambda c: c.audit.challenge()).verify_deadline + 1)
    assert p.q(lambda c: c.state.events_of("tee_worker", "PunishScheduler"))


def sc_tee_registration_refusals(p):
    root_kp = setup_tee(p)
    signer_kp = generate_rsa_keypair(1024, seed=2)
    cert = issue_cert(root_kp, "ias-report-signer", signer_kp.public)
    report, sig = issue_report(signer_kp, b"\x01" * 32, b"podr2-public-key",
                               "tee1")
    p.refused("tee_worker.Registered", "tee1", "tee_worker.register", "stash1",
          b"teepeer", b"podr2-public-key", report, sig, (cert,))
    report2, sig2 = issue_report(signer_kp, b"\x02" * 32, b"pk2", "tee2")
    p.refused("tee_worker.NonTeeWorker", "tee2", "tee_worker.register", "stash2",
          b"p2", b"pk2", report2, sig2, (cert,))
    report3, sig3 = issue_report(signer_kp, b"\x01" * 32, b"pk3", "tee3")
    p.refused("tee_worker.VerifyCertFailed", "tee3", "tee_worker.register",
          "stash3", b"p3", b"other-pk", report3, sig3, (cert,))


def sc_restoral_order(p):
    declare(p)
    complete_deal(p)
    f = p.q(lambda c: c.file_bank.file(FILE))
    victim = f.miners[0]
    frag = f.segments[0].fragment_hashes[0]
    p.x(victim, "file_bank.generate_restoral_order", FILE, frag)
    rescuer = next(w for w in MINERS if w not in f.miners)
    p.x(rescuer, "file_bank.claim_restoral_order", frag)
    p.refused("file_bank.OrderClaimed", f.miners[1],
          "file_bank.claim_restoral_order", frag)
    p.x(rescuer, "file_bank.restoral_order_complete", frag)
    assert p.q(lambda c: c.file_bank.restoral_order(frag)) is None


def sc_miner_exit(p):
    declare(p)
    complete_deal(p)
    f = p.q(lambda c: c.file_bank.file(FILE))
    leaver = f.miners[0]
    p.x(leaver, "file_bank.miner_exit_prep")
    p.refused("file_bank.CoolingNotOver", leaver, "file_bank.miner_withdraw")
    rescuer = next(w for w in MINERS if w not in f.miners)
    for seg in f.segments:
        frag = seg.fragment_hashes[0]
        p.x(rescuer, "file_bank.claim_restoral_order", frag)
        p.x(rescuer, "file_bank.restoral_order_complete", frag)
    p.blocks(constants.ONE_DAY_BLOCKS + 1)
    p.x(leaver, "file_bank.miner_withdraw")
    assert p.q(lambda c: c.sminer.miner(leaver)) is None


def sc_rollback_on_error(p):
    root0 = p.q(lambda c: c.state.state_root())
    declare(p, who=BOB, bucket="nobucket",
            refused="storage_handler.NotPurchasedSpace")
    assert p.q(lambda c: c.state.state_root()) == root0


SCENARIOS = {name[3:]: fn for name, fn in dict(globals()).items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pallets_match_reference_step_by_step(pair, name):
    SCENARIOS[name](pair)


def test_port_constants_have_the_reference_surface():
    names = [n for n in dir(constants) if not n.startswith("_")]
    assert len(names) >= 54
    for n in names:
        assert getattr(pconstants, n) == getattr(constants, n), n


def test_protocol_strings_are_the_references():
    from cess_tpu.chain import audit as jaudit
    from cess_tpu.crypto import bls12381 as jbls
    from cess_tpu_torch.chain import audit as paudit
    from cess_tpu_torch.chain.file_bank import FileBank as PFileBank
    from cess_tpu_torch.crypto import bls12381 as pbls

    assert paudit.SESSION_SIGNING_CONTEXT == jaudit.SESSION_SIGNING_CONTEXT
    assert paudit.VERDICT_SIGNING_CONTEXT == jaudit.VERDICT_SIGNING_CONTEXT
    assert PFileBank.FILLER_CERT_CONTEXT == FileBank.FILLER_CERT_CONTEXT
    assert (pbls.DST_G1, pbls.DST_POP) == (jbls.DST_G1, jbls.DST_POP)


def test_dispatch_error_and_port_state_root_are_the_references():
    from cess_tpu.chain import state as jstate

    a, b = jstate.State(), pstate.State()
    for s in (a, b):
        s.put("p", "k", 1, (b"x", 2))
        s.deposit_event("p", "E", v=3)
    assert a.state_root() == b.state_root() == b.recompute_root()
    e = pstate.DispatchError("x.Y", "detail")
    assert (e.name, str(e)) == ("x.Y", str(jstate.DispatchError("x.Y",
                                                                "detail")))
