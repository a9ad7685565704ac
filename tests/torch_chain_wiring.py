"""The storage-audit pallets of one package, wired as the reference's
runtime wires them (``cess_tpu/chain/runtime.py`` ``Runtime.__init__``),
without the pallets the slice leaves out (staking, credit, oss, EVM...).

``Chain("cess_tpu")`` and ``Chain("cess_tpu_torch")`` run the same
dispatchable sequences, so the port's pallets can be held to the
reference's state root, events and error names after every step. The
module imports neither package itself: ``chip_smoke.py`` drives the
port's round through it without the JAX package.

Dispatch and block execution follow ``Runtime.apply_extrinsic`` and
``Runtime.init_block`` for these pallets: a transaction rolls back on any
error (a non-dispatch error becomes ``system.BadCallArgs``), root-only
calls drop their origin, and each block runs the audit sweep, the lease
sweep and its file GC, the era's reward tranches and the scheduler's due
tasks in the runtime's order.
"""
from __future__ import annotations

import hashlib
import importlib

ROOT = "root"
# Runtime.ROOT_ONLY, restricted to the slice's pallets
ROOT_ONLY = {
    "file_bank.calculate_end", "file_bank.deal_timeout",
    "file_bank.force_miner_exit", "tee_worker.update_whitelist",
    "tee_worker.pin_ias_signer", "audit.set_keys",
}
MILLISECS_PER_BLOCK = 6000


class Chain:
    """State plus ``System``, ``Balances``, ``StorageHandler``,
    ``Sminer``, ``Scheduler``, ``TeeWorker``, ``FileBank`` and ``Audit``
    of package ``pkg`` ("cess_tpu" or "cess_tpu_torch")."""

    def __init__(self, pkg: str, era_blocks: int = 50):
        def mod(name):
            return importlib.import_module(f"{pkg}.chain.{name}")

        self.pkg = pkg
        self.codec = importlib.import_module(f"{pkg}.codec")
        self.DispatchError = mod("state").DispatchError
        self.era_blocks = era_blocks
        s = self.state = mod("state").State()
        self.system = mod("system").System(s)
        self.balances = mod("balances").Balances(s)
        self.storage_handler = mod("storage_handler").StorageHandler(
            s, self.balances)
        self.sminer = mod("sminer").Sminer(s, self.balances,
                                           self.storage_handler)
        self.scheduler = mod("scheduler").Scheduler(s)
        self.tee_worker = mod("tee_worker").TeeWorker(s)
        self.file_bank = mod("file_bank").FileBank(
            s, self.balances, self.storage_handler, self.sminer,
            self.scheduler)
        self.audit = mod("audit").Audit(
            s, self.sminer, tee_worker=self.tee_worker,
            storage_handler=self.storage_handler, file_bank=self.file_bank)
        self.pallets = {
            "system": self.system, "balances": self.balances,
            "storage_handler": self.storage_handler, "sminer": self.sminer,
            "scheduler": self.scheduler, "tee_worker": self.tee_worker,
            "file_bank": self.file_bank, "audit": self.audit,
        }
        self._update_randomness()

    # -- dispatch ---------------------------------------------------------
    def method(self, call: str):
        pallet, _, name = call.partition(".")
        return getattr(self.pallets[pallet], name)

    def apply_extrinsic(self, origin: str, call: str, *args, **kwargs):
        fn = self.method(call)
        if call in ROOT_ONLY:
            if origin != ROOT:
                raise self.DispatchError("system.BadOrigin", call)
            call_args = args
        else:
            call_args = (origin, *args)
        self.state.begin_tx()
        try:
            result = fn(*call_args, **kwargs)
        except self.DispatchError:
            self.state.rollback_tx()
            raise
        except Exception as e:
            self.state.rollback_tx()
            raise self.DispatchError(
                "system.BadCallArgs", f"{call}: {type(e).__name__}") from e
        self.state.commit_tx()
        return result

    def fund(self, who: str, amount: int) -> None:
        self.balances.mint(who, amount)

    # -- blocks -----------------------------------------------------------
    def _update_randomness(self) -> None:
        prev = self.state.get("system", "randomness", default=b"genesis")
        self.state.put("system", "randomness", hashlib.sha256(
            prev + self.state.block.to_bytes(8, "little")).digest())

    def init_block(self) -> None:
        s = self.state
        s.archive_events()
        s.block += 1
        s.put("system", "author", "")
        s.put("system", "now_ms", s.block * MILLISECS_PER_BLOCK)
        self._update_randomness()
        self.audit.on_initialize()
        dead = self.storage_handler.on_initialize()
        self.file_bank.on_initialize(dead)
        if s.block % self.era_blocks == 0:
            self.sminer.release_reward_tranches()
        for name, pallet, method, task_args in self.scheduler.take_due():
            s.begin_tx()
            try:
                getattr(self.pallets[pallet], method)(*task_args)
            except self.DispatchError as e:
                s.rollback_tx()
                s.deposit_event("scheduler", "TaskFailed", name=name,
                                error=e.name)
            except Exception as e:
                s.rollback_tx()
                s.deposit_event(
                    "scheduler", "TaskFailed", name=name,
                    error=f"scheduler.TaskPanicked:{type(e).__name__}")
            else:
                s.commit_tx()

    def run_to_block(self, n: int) -> None:
        while self.state.block < n:
            self.init_block()

    def advance_blocks(self, n: int) -> None:
        self.run_to_block(self.state.block + n)

    # -- what two chains compare ------------------------------------------
    def events_bytes(self) -> bytes:
        """Every event so far (history and current block), encoded."""
        return self.codec.encode(
            [e for _, e in self.state.event_history] + list(self.state.events))


# -- one storage-audit round, from the port's upload to a verdict on chain ----
USER = "alice"
MINERS = ("m1", "m2", "m3")
VALIDATORS = ("v1", "v2", "v3")
TEE, STASH = "tee1", "stash1"
PODR2_PK = b"podr2-public-key"
MRENCLAVE = b"\x01" * 32
FILLERS = 4                     # a miner's certified fillers


class Lockstep:
    """The same steps on several chains. Arguments are built with the
    types of ``chains[0]`` and reach every other chain through the two
    codecs. After each step the outcomes (success, or the same
    ``DispatchError`` name), the state roots and the events must agree;
    a step returns the first chain's result or raises its error."""

    def __init__(self, chains):
        self.chains = list(chains)
        self.first = self.chains[0]

    def _args(self, chain, args):
        if chain is self.first:
            return args
        return chain.codec.decode(self.first.codec.encode(args))

    def each(self, what, fn):
        """``fn(chain)`` on every chain, then the agreement checks."""
        outcomes = []
        for chain in self.chains:
            try:
                outcomes.append((None, fn(chain)))
            except chain.DispatchError as e:
                outcomes.append((e, None))
        names = [None if e is None else e.name for e, _ in outcomes]
        roots = {c.state.state_root() for c in self.chains}
        events = {c.events_bytes() for c in self.chains}
        if len(set(names)) != 1 or len(roots) != 1 or len(events) != 1:
            raise RuntimeError(f"{what}: chains disagree: outcomes {names}, "
                               f"{len(roots)} state roots, {len(events)} "
                               f"event logs")
        err, value = outcomes[0]
        if err is not None:
            raise err
        return value

    def x(self, origin, call, *args):
        """An extrinsic on every chain."""
        return self.each(call, lambda c: c.apply_extrinsic(
            origin, call, *self._args(c, args)))

    def refused(self, name, origin, call, *args):
        """An extrinsic every chain must refuse with ``name``."""
        try:
            self.x(origin, call, *args)
        except self.first.DispatchError as e:
            if e.name != name:
                raise RuntimeError(f"{call}: refused with {e.name}, not "
                                   f"{name}") from e
            return
        raise RuntimeError(f"{call} was accepted; want {name}")

    def direct(self, call, *args):
        """An internal pallet method (no transaction) on every chain."""
        return self.each(call, lambda c: c.method(call)(*self._args(c, args)))

    def fund(self, who, amount):
        self.each("fund", lambda c: c.fund(who, amount))

    def to_block(self, n):
        self.each(f"block {n}", lambda c: c.run_to_block(n))

    def blocks(self, n):
        self.to_block(self.first.state.block + n)

    def q(self, fn):
        """A query of every chain: equal encodings; the first's value."""
        values = [fn(c) for c in self.chains]
        if len({c.codec.encode(v) for c, v in zip(self.chains, values)}) != 1:
            raise RuntimeError("chains disagree on a query")
        return values[0]


def audit_round(pipeline, data, *, chains, device,
                tamper_row: int | None = None, seal=None) -> dict:
    """One storage-audit round of the port, the extrinsic sequence the
    JAX agents submit, on ``chains`` in lockstep (the port's first).

    Genesis: session keys of three validators and the TEE's account key
    through ``System``, three miners through ``sminer.regnstk`` with an
    idle grant, a TEE registered with an RSA attestation (root pinned,
    ``MRENCLAVE`` whitelisted) and a BLS key with its proof of
    possession, and ``FILLERS`` fillers a miner certified by
    ``certify_fillers`` and registered through ``file_bank.upload_filler``
    under the TEE's ed25519 certificate. Then ``upload_batch`` of ``data``
    on ``pipeline``, the space bought and the segments declared, every
    assigned miner's ``transfer_report`` and ``calculate_end``; two of the
    three validators' signed proposals start the challenge (the third is
    refused); every miner submits ``build_proof`` wire bytes for its
    service and idle sets; the TEE decodes each proof, checks it with
    ``verify_owed`` and seals the verdict with BLS (``seal(tee, digest,
    idle_ok, service_ok)``, the port's ``bls12381.sign`` by default); a
    seal over the flipped verdict is refused first. ``tamper_row``: that
    row's miner holds its first fragment XORed with 0xA5.

    Returns what the round computed and the host clock of its stages."""
    import importlib
    import time

    def mod(name):
        return importlib.import_module(f"cess_tpu_torch.{name}")

    constants, codec = mod("constants"), mod("codec")
    off, hashing = mod("node.offchain"), mod("node.hashing")
    ed, bls, rsa = (mod("crypto.ed25519"), mod("crypto.bls12381"),
                    mod("crypto.rsa"))
    att, audit_mod = mod("chain.attestation"), mod("chain.audit")
    file_bank = mod("chain.file_bank")
    ls = Lockstep(chains)
    port = ls.first
    D, FRAG = constants.DOLLARS, constants.FRAGMENT_SIZE
    cfg, key = pipeline.config, pipeline.podr2_key
    blocks = cfg.blocks_per_fragment
    t = {}

    # genesis: keys through System, funds, miners, the TEE
    sess = {v: ed.SigningKey.generate(b"sess:" + v.encode())
            for v in VALIDATORS}
    for v in VALIDATORS:
        ls.direct("system.set_session_key", v, sess[v].public)
    tee_acct = ed.SigningKey.generate(b"tee1-acct")
    ls.direct("system.bind_account_key", TEE, tee_acct.public)
    ls.x(ROOT, "audit.set_keys", VALIDATORS)
    ls.fund(USER, 10_000_000 * D)
    ls.fund(STASH, 3_000_000 * D)
    ls.fund("sminer_reward_pool", 1000 * D)
    for w in MINERS:
        ls.fund(w, 10_000 * D)
        ls.x(w, "sminer.regnstk", w, b"peer" + w.encode(), 2000 * D)
        ls.direct("sminer.add_miner_idle_space", w, 4000 * FRAG)
    root_kp = rsa.generate_rsa_keypair(1024, seed=1)
    signer_kp = rsa.generate_rsa_keypair(1024, seed=2)
    ls.x(ROOT, "tee_worker.update_whitelist", MRENCLAVE)
    ls.x(ROOT, "tee_worker.pin_ias_signer", root_kp.public)
    bls_sk, bls_pk = bls.keygen(b"tee1-bls")
    pop = bls.prove_possession(bls_sk, bls_pk)
    cert = att.issue_cert(root_kp, "ias-report-signer", signer_kp.public)
    report, report_sig = att.issue_report(signer_kp, MRENCLAVE, PODR2_PK,
                                          TEE, bls_pk=bls_pk)
    ls.x(TEE, "tee_worker.register", STASH, b"teepeer", PODR2_PK, report,
         report_sig, (cert,), bls_pk, pop)

    # fillers: generated, certified by the TEE, registered on chain
    t0 = time.perf_counter()
    filler_store, filler_tags = {}, {}
    for w in MINERS:
        blobs = [hashing.filler_bytes(w, i, cfg.fragment_size)
                 for i in range(FILLERS)]
        hashes, tags = off.certify_fillers(key, w, range(FILLERS), blobs,
                                           blocks, device=device)
        nonce = port.file_bank.filler_cert_nonce(w)
        sig = tee_acct.sign(file_bank.FileBank.FILLER_CERT_CONTEXT
                            + codec.encode((w, tuple(hashes), nonce)))
        ls.x(w, "file_bank.upload_filler", tuple(hashes), TEE, sig)
        filler_store[w] = dict(zip(hashes, blobs))
        filler_tags[w] = dict(zip(hashes, tags))
    t["fillers"] = time.perf_counter() - t0

    # the upload: encode and tag on the device, then the deal on chain
    t0 = time.perf_counter()
    up = off.upload_batch(pipeline, data, tenant=USER)
    t["upload"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ls.x(USER, "storage_handler.buy_space", 1)
    ls.x(USER, "file_bank.create_bucket", USER, "bkt")
    ls.x(USER, "file_bank.upload_declaration", up.file_hash,
         list(zip(up.segment_hashes, up.fragment_hashes)),
         file_bank.UserBrief(USER, "upload.bin", "bkt"), len(data))
    deal = port.file_bank.deal(up.file_hash)
    store, tag_map = {}, {}
    for row, w in enumerate(deal.assigned):
        store[w] = {hs[row]: up.fragments[s, row]
                    for s, hs in enumerate(up.fragment_hashes)}
        tag_map[w] = {hs[row]: up.tags[s, row]
                      for s, hs in enumerate(up.fragment_hashes)}
    tampered = None
    if tamper_row is not None:
        tampered = deal.assigned[tamper_row]
        h0 = up.fragment_hashes[0][tamper_row]
        store[tampered][h0] = up.fragments[0, tamper_row] ^ 0xA5
    for w in deal.assigned:
        ls.x(w, "file_bank.transfer_report", up.file_hash)
    ls.x(ROOT, "file_bank.calculate_end", up.file_hash)
    pallet_s = time.perf_counter() - t0

    # the challenge: the validators' signed snapshot, started at 2/3
    t0 = time.perf_counter()
    net, snaps = port.audit.generation_challenge()
    digest = audit_mod.Audit.snapshot_digest(net, snaps)
    for v in VALIDATORS[:2]:
        ls.x(v, "audit.save_challenge_info", net, snaps, sess[v].sign(
            audit_mod.SESSION_SIGNING_CONTEXT + digest))
    ls.refused("audit.ChallengeInProgress", VALIDATORS[2],
               "audit.save_challenge_info", net, snaps,
               sess[VALIDATORS[2]].sign(audit_mod.SESSION_SIGNING_CONTEXT
                                        + digest))
    t["snapshot_and_proposals"] = time.perf_counter() - t0
    ch = port.audit.challenge()
    seed = b"".join(ch.net.randoms)

    # the miners' proofs, as wire bytes, on the device
    t0 = time.perf_counter()
    proofs = {}
    for snap in ch.miners:
        w = snap.miner
        proofs[w] = (
            off.build_proof(seed, list(snap.fillers), filler_store[w],
                            filler_tags[w], limbs=key.limbs, device=device),
            off.build_proof(seed, list(snap.service_frags), store[w],
                            tag_map[w], limbs=key.limbs, device=device))
    t["proofs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for w, (idle, service) in proofs.items():
        ls.x(w, "audit.submit_proof", idle, service)
    pallet_s += time.perf_counter() - t0

    # the TEE: decode, check on the device, seal
    missions = port.state.get("audit", "unverify", TEE, default=())
    t0 = time.perf_counter()
    verdicts = {}
    for mission in missions:
        snap = mission.snapshot
        oks = []
        for blob, owed in ((mission.idle_proof, snap.fillers),
                           (mission.service_proof, snap.service_frags)):
            try:
                proof = codec.decode(blob)
            except (codec.CodecError, TypeError, ValueError):
                oks.append(False)
                continue
            oks.append(isinstance(proof, off.Proof) and off.verify_owed(
                key, blocks, seed, list(owed), proof.mu, proof.sigma,
                device=device))
        verdicts[mission.miner] = tuple(oks)
    t["checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seals = {}
    for mission in missions:
        idle_ok, service_ok = verdicts[mission.miner]
        d = audit_mod.mission_digest(mission)
        msg = audit_mod.verdict_message(TEE, d, idle_ok, service_ok)
        seals[mission.miner] = (seal(TEE, d, idle_ok, service_ok)
                                if seal else bls.sign(bls_sk, msg))
    t["seals"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    first = missions[0]
    idle_ok, service_ok = verdicts[first.miner]
    forged = bls.sign(bls_sk, audit_mod.verdict_message(
        TEE, audit_mod.mission_digest(first), idle_ok, not service_ok))
    ls.refused("audit.BadVerdictSignature", TEE,
               "audit.submit_verify_result", first.miner, idle_ok,
               service_ok, forged)
    for mission in missions:
        ls.x(TEE, "audit.submit_verify_result", mission.miner,
             *verdicts[mission.miner], seals[mission.miner])
    pallet_s += time.perf_counter() - t0
    t["pallet_calls"] = pallet_s

    log = port.audit.verdicts()
    return {
        "upload": up, "deal": deal, "challenge": ch, "seed": seed,
        "store": store, "tags": tag_map, "filler_store": filler_store,
        "filler_tags": filler_tags, "proofs": proofs, "missions": missions,
        "verdicts": verdicts, "seals": seals, "tampered": tampered,
        "bls": (bls_sk, bls_pk), "verdict_log": log,
        "log_ok": audit_mod.reverify_verdicts_batch(
            log, {TEE: port.tee_worker.bls_keys_of(TEE)}),
        "state_root": port.state.state_root(), "seconds": t,
    }
