"""Drive the same chain steps on each package's ``Runtime``
(``cess_tpu.chain.runtime`` and ``cess_tpu_torch.chain.runtime``), and
one storage-audit round of the port applied to them as signed
extrinsics, block by block.

``Lockstep(["cess_tpu", "cess_tpu_torch"])`` builds
``Runtime(RuntimeConfig(era_blocks=50))`` of each package by name
(``importlib``), so the module imports neither package itself:
``chip_smoke.py`` drives the port's round through it without the JAX
package. Every step runs on every runtime; arguments are built with the
types of the first and reach the others through the two codecs. After
each step the outcomes (success, or the same error type and
``DispatchError`` name), the state roots and the events must agree.
"""
from __future__ import annotations

import importlib

ROOT = "root"


def runtime(pkg: str, **config):
    """``Runtime(RuntimeConfig(era_blocks=50, **config))`` of package
    ``pkg`` ("cess_tpu" or "cess_tpu_torch")."""
    mod = importlib.import_module(f"{pkg}.chain.runtime")
    config.setdefault("era_blocks", 50)
    return mod.Runtime(mod.RuntimeConfig(**config))


# -- one storage-audit round, from the port's upload to a verdict on chain ----
USER = "alice"
MINERS = ("m1", "m2", "m3")
VALIDATORS = ("v1", "v2", "v3")
TEE, STASH, SUDO = "tee1", "stash1", "sudo"
PODR2_PK = b"podr2-public-key"
MRENCLAVE = b"\x01" * 32
FILLERS = 4                     # a miner's certified fillers


class Lockstep:
    """The same steps on several runtimes. ``chains``: package names
    (each becomes ``runtime(pkg, **config)``) or runtimes already built.
    Arguments are built with the types of ``chains[0]`` and reach every
    other runtime through the two codecs. After each step the outcomes
    (success, or the same exception type and ``DispatchError`` name),
    the state roots and the events must agree; a step returns the first
    runtime's result or raises its exception."""

    def __init__(self, chains=("cess_tpu", "cess_tpu_torch"), **config):
        self.chains = [runtime(c, **config) if isinstance(c, str) else c
                       for c in chains]
        self.first = self.chains[0]
        self.pkgs = [type(c).__module__.split(".")[0] for c in self.chains]
        self.codecs = [importlib.import_module(f"{p}.codec")
                       for p in self.pkgs]
        self.DispatchError = importlib.import_module(
            f"{self.pkgs[0]}.chain.state").DispatchError
        self._seen = [0] * len(self.chains)     # archived events compared
        self.keys: dict = {}                    # account -> SigningKey
        self._pending: dict = {}                # signer -> nonces in block
        self.signed = 0                         # signed extrinsics applied

    def mod(self, name: str, i: int = 0):
        """Module ``name`` of the ``i``-th runtime's package."""
        return importlib.import_module(f"{self.pkgs[i]}.{name}")

    def arg(self, i: int, value):
        """``value`` (of the first runtime's types) for runtime ``i``."""
        if i == 0:
            return value
        return self.codecs[i].decode(self.codecs[0].encode(value))

    def _args(self, chain, args):
        return self.arg(self.chains.index(chain), args)

    def events_bytes(self, i: int) -> bytes:
        """Runtime ``i``'s whole event log (history and current block)."""
        s = self.chains[i].state
        return self.codecs[i].encode(
            [e for _, e in s.event_history] + list(s.events))

    def _new_events(self, i: int):
        s = self.chains[i].state
        hist, seen = s.event_history, self._seen[i]
        new = hist[seen:] if seen <= len(hist) < s.EVENT_HISTORY_CAP \
            else hist
        self._seen[i] = len(hist)
        return len(hist), self.codecs[i].encode(list(new) + list(s.events))

    def check(self, what, outcomes=()):
        """The runtimes' agreement: outcomes, state roots, new events."""
        names = [None if e is None else
                 (type(e).__name__, getattr(e, "name", None))
                 for e, _ in outcomes]
        roots = {c.state.state_root() for c in self.chains}
        events = {self._new_events(i) for i in range(len(self.chains))}
        if len(set(names)) > 1 or len(roots) != 1 or len(events) != 1:
            raise RuntimeError(f"{what}: runtimes disagree: outcomes "
                               f"{names}, {len(roots)} state roots, "
                               f"{len(events)} event logs")

    def each(self, what, fn):
        """``fn(runtime)`` on every runtime, then the agreement checks."""
        outcomes = []
        for chain in self.chains:
            try:
                outcomes.append((None, fn(chain)))
            except Exception as e:         # compared across runtimes
                outcomes.append((e, None))
        self.check(what, outcomes)
        err, value = outcomes[0]
        if err is not None:
            raise err
        return value

    @staticmethod
    def method(chain, call: str):
        pallet, _, name = call.partition(".")
        return getattr(chain.pallets[pallet], name)

    def x(self, origin, call, *args):
        """``apply_extrinsic`` (the mock-runtime origin) on every runtime."""
        return self.each(call, lambda c: c.apply_extrinsic(
            origin, call, *self._args(c, args)))

    def refused(self, name, origin, call, *args):
        """An extrinsic every runtime must refuse with ``name``."""
        try:
            self.x(origin, call, *args)
        except self.DispatchError as e:
            if e.name != name:
                raise RuntimeError(f"{call}: refused with {e.name}, not "
                                   f"{name}") from e
            return
        raise RuntimeError(f"{call} was accepted; want {name}")

    def direct(self, call, *args):
        """An internal pallet method (no transaction) on every runtime."""
        return self.each(call, lambda c: self.method(c, call)(
            *self._args(c, args)))

    def fund(self, who, amount):
        self.each("fund", lambda c: c.fund(who, amount))

    def to_block(self, n):
        self.each(f"block {n}", lambda c: c.run_to_block(n))

    def blocks(self, n):
        self.to_block(self.first.state.block + n)

    def q(self, fn):
        """A query of every runtime: equal encodings; the first's value."""
        values = [fn(c) for c in self.chains]
        if len({codec.encode(v) for codec, v in zip(self.codecs, values)}) \
                != 1:
            raise RuntimeError("runtimes disagree on a query")
        return values[0]

    # -- the signed path: blocks of SignedExtrinsics ------------------------
    def key(self, who: str):
        """``who``'s account key (ed25519 of the first runtime's
        package), made from its name unless set in ``keys``."""
        if who not in self.keys:
            self.keys[who] = self.mod("crypto.ed25519").SigningKey.generate(
                b"acct:" + who.encode())
        return self.keys[who]

    def sign(self, who: str, call: str, *args):
        """``who``'s signed extrinsic for the block being built: the
        next nonce after the chain's and this block's earlier ones."""
        n = self._pending.get(who, 0)
        self._pending[who] = n + 1
        return self.mod("chain.extrinsic").sign_extrinsic(
            self.key(who), self.first.genesis_hash(), who,
            self.first.system.nonce(who) + n, call, args)

    def block(self, xts=(), *, author: str = "", failed=()):
        """One block on every runtime: ``init_block(author=author)``, then
        each extrinsic through ``apply_in_block``. ``apply_in_block`` never
        raises, so the block's ``system.ExtrinsicFailed`` events are read
        back: they must be exactly ``failed``, as (call, error name) in
        order. Returns the first runtime's seconds in ``init_block`` and
        in its ``apply_in_block`` calls."""
        import time

        self._pending.clear()
        seconds = []

        def run(c):
            xs = self._args(c, list(xts))
            t0 = time.perf_counter()
            c.init_block(author=author)
            t1 = time.perf_counter()
            for xt in xs:
                c.apply_in_block(xt)
            seconds.append((t1 - t0, time.perf_counter() - t1))

        self.each(f"block {self.first.state.block + 1}", run)
        self.signed += len(xts)
        got = [(dict(e.data)["call"], dict(e.data)["error"])
               for e in self.first.state.events
               if (e.pallet, e.name) == ("system", "ExtrinsicFailed")]
        if got != list(failed):
            raise RuntimeError(f"block {self.first.state.block}: failed "
                               f"extrinsics {got}, want {list(failed)}")
        return seconds[0]


def audit_round(pipeline, data, *, chains, device,
                tamper_row: int | None = None, seal=None) -> dict:
    """One storage-audit round of the port, the extrinsic sequence the
    JAX agents submit, applied as a node applies blocks: every call is a
    ``SignedExtrinsic`` of its account's ed25519 key through
    ``Runtime.apply_in_block`` on ``chains`` (a ``Lockstep``, or what
    builds one; the port's runtime first), block by block, with the
    fees, nonces and first-use key bindings that implies.

    Genesis (the chain spec's role, no block): session keys of three
    validators and the TEE's account key through ``System``, the audit
    keys (``ROOT``), a sudo account, funds, the TEE's attestation root
    pinned and ``MRENCLAVE`` whitelisted (``ROOT``). Block 1: three
    miners' ``sminer.regnstk`` and the TEE's ``tee_worker.register``
    with an RSA attestation and a BLS key with its proof of possession;
    then the miners' genesis idle grant. Block 2: ``FILLERS`` fillers a
    miner certified by ``certify_fillers`` through
    ``file_bank.upload_filler`` under the TEE's ed25519 certificate.
    ``upload_batch`` of ``data`` on ``pipeline``; block 3: the user's
    ``buy_space``, ``create_bucket`` and ``upload_declaration``; block
    4: every assigned miner's ``transfer_report`` and sudo's
    ``calculate_end``. Block 5: the three validators' signed proposals,
    the third refused (``audit.ChallengeInProgress``). Block 6: every
    miner's ``build_proof`` wire bytes for its service and idle sets.
    The TEE decodes each proof, checks it with ``verify_owed`` and seals
    the verdict with BLS (``seal(tee, digest, idle_ok, service_ok)``,
    the port's ``bls12381.sign`` by default); block 7: a seal over the
    flipped verdict (refused, ``audit.BadVerdictSignature``), then the
    verdicts. Then empty blocks to the next era boundary, where every
    honest miner's first reward tranche reaches its beneficiary.
    Every block's ``system.ExtrinsicFailed`` events must be exactly the
    two refusals named. ``tamper_row``: that row's miner holds its first
    fragment XORed with 0xA5.

    Returns what the round computed and the host clock of its stages."""
    import time

    ls = chains if isinstance(chains, Lockstep) else Lockstep(chains)
    port, mod = ls.first, ls.mod
    constants, codec = mod("constants"), mod("codec")
    off, hashing = mod("node.offchain"), mod("node.hashing")
    ed, bls, rsa = (mod("crypto.ed25519"), mod("crypto.bls12381"),
                    mod("crypto.rsa"))
    att, audit_mod = mod("chain.attestation"), mod("chain.audit")
    file_bank = mod("chain.file_bank")
    D, FRAG = constants.DOLLARS, constants.FRAGMENT_SIZE
    cfg, key = pipeline.config, pipeline.podr2_key
    blocks = cfg.blocks_per_fragment
    t = {"block_hooks": 0.0, "pallet_calls": 0.0}
    authors = iter(VALIDATORS * 1000)

    def block(xts=(), failed=()):
        init_s, apply_s = ls.block(xts, author=next(authors), failed=failed)
        t["block_hooks"] += init_s
        t["pallet_calls"] += apply_s
        return init_s

    # genesis: keys through System, funds, the attestation root
    sess = {v: ed.SigningKey.generate(b"sess:" + v.encode())
            for v in VALIDATORS}
    for v in VALIDATORS:
        ls.direct("system.set_session_key", v, sess[v].public)
    tee_acct = ls.keys[TEE] = ed.SigningKey.generate(b"tee1-acct")
    ls.direct("system.bind_account_key", TEE, tee_acct.public)
    ls.x(ROOT, "audit.set_keys", VALIDATORS)
    ls.direct("system.set_sudo", SUDO)
    for who, amount in ((USER, 10_000_000), (STASH, 3_000_000),
                        ("sminer_reward_pool", 1000), (TEE, 1000),
                        (SUDO, 1000), *((w, 10_000) for w in MINERS)):
        ls.fund(who, amount * D)
    root_kp = rsa.generate_rsa_keypair(1024, seed=1)
    signer_kp = rsa.generate_rsa_keypair(1024, seed=2)
    ls.x(ROOT, "tee_worker.update_whitelist", MRENCLAVE)
    ls.x(ROOT, "tee_worker.pin_ias_signer", root_kp.public)

    # block 1: the miners and the TEE register
    bls_sk, bls_pk = bls.keygen(b"tee1-bls")
    pop = bls.prove_possession(bls_sk, bls_pk)
    cert = att.issue_cert(root_kp, "ias-report-signer", signer_kp.public)
    report, report_sig = att.issue_report(signer_kp, MRENCLAVE, PODR2_PK,
                                          TEE, bls_pk=bls_pk)
    block([ls.sign(w, "sminer.regnstk", w, b"peer" + w.encode(), 2000 * D)
           for w in MINERS]
          + [ls.sign(TEE, "tee_worker.register", STASH, b"teepeer",
                     PODR2_PK, report, report_sig, (cert,), bls_pk, pop)])
    for w in MINERS:
        ls.direct("sminer.add_miner_idle_space", w, 4000 * FRAG)

    # block 2: fillers generated, certified by the TEE, registered
    t0 = time.perf_counter()
    filler_store, filler_tags, xts = {}, {}, []
    for w in MINERS:
        blobs = [hashing.filler_bytes(w, i, cfg.fragment_size)
                 for i in range(FILLERS)]
        hashes, tags = off.certify_fillers(key, w, range(FILLERS), blobs,
                                           blocks, device=device)
        nonce = port.file_bank.filler_cert_nonce(w)
        sig = tee_acct.sign(file_bank.FileBank.FILLER_CERT_CONTEXT
                            + codec.encode((w, tuple(hashes), nonce)))
        xts.append(ls.sign(w, "file_bank.upload_filler", tuple(hashes), TEE,
                           sig))
        filler_store[w] = dict(zip(hashes, blobs))
        filler_tags[w] = dict(zip(hashes, tags))
    block(xts)
    t["fillers"] = time.perf_counter() - t0

    # the upload: encode and tag on the device, then the deal on chain
    t0 = time.perf_counter()
    up = off.upload_batch(pipeline, data, tenant=USER)
    t["upload"] = time.perf_counter() - t0
    block([ls.sign(USER, "storage_handler.buy_space", 1),
           ls.sign(USER, "file_bank.create_bucket", USER, "bkt"),
           ls.sign(USER, "file_bank.upload_declaration", up.file_hash,
                   list(zip(up.segment_hashes, up.fragment_hashes)),
                   file_bank.UserBrief(USER, "upload.bin", "bkt"),
                   len(data))])
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
    block([ls.sign(w, "file_bank.transfer_report", up.file_hash)
           for w in deal.assigned]
          + [ls.sign(SUDO, "file_bank.calculate_end", up.file_hash)])

    # the challenge: the validators' signed snapshot, started at 2/3
    t0 = time.perf_counter()
    net, snaps = port.audit.generation_challenge()
    digest = audit_mod.Audit.snapshot_digest(net, snaps)
    proposals = [ls.sign(v, "audit.save_challenge_info", net, snaps,
                         sess[v].sign(audit_mod.SESSION_SIGNING_CONTEXT
                                      + digest))
                 for v in VALIDATORS]
    t["snapshot_and_proposals"] = time.perf_counter() - t0
    block(proposals, failed=[("audit.save_challenge_info",
                              "audit.ChallengeInProgress")])
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
    block([ls.sign(w, "audit.submit_proof", idle, service)
           for w, (idle, service) in proofs.items()])

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
    first = missions[0]
    idle_ok, service_ok = verdicts[first.miner]
    forged = bls.sign(bls_sk, audit_mod.verdict_message(
        TEE, audit_mod.mission_digest(first), idle_ok, not service_ok))
    t["seals"] = time.perf_counter() - t0
    block([ls.sign(TEE, "audit.submit_verify_result", first.miner, idle_ok,
                   service_ok, forged)]
          + [ls.sign(TEE, "audit.submit_verify_result", m.miner,
                     *verdicts[m.miner], seals[m.miner]) for m in missions],
          failed=[("audit.submit_verify_result",
                   "audit.BadVerdictSignature")])
    orders = {w: port.state.get("sminer", "reward_orders", w)
              for w in deal.assigned}

    # to the era boundary: the first reward tranche, the audit keys kept
    era = port.config.era_blocks
    before = {w: port.balances.free(port.sminer.miner(w).beneficiary)
              for w in deal.assigned}
    while (port.state.block + 1) % era:
        block()
    t["era_init"] = block()
    paid = {dict(e.data)["who"]: dict(e.data)["amount"]
            for e in port.state.events_of("sminer", "RewardPaid")}
    received = {w: port.balances.free(port.sminer.miner(w).beneficiary)
                - before[w] for w in deal.assigned}

    log = port.audit.verdicts()
    return {
        "lockstep": ls, "upload": up, "deal": deal, "challenge": ch,
        "seed": seed, "store": store, "tags": tag_map,
        "filler_store": filler_store, "filler_tags": filler_tags,
        "proofs": proofs, "missions": missions, "verdicts": verdicts,
        "seals": seals, "tampered": tampered, "bls": (bls_sk, bls_pk),
        "orders": orders, "paid": paid, "received": received,
        "audit_keys": port.audit.keys(), "verdict_log": log,
        "log_ok": audit_mod.reverify_verdicts_batch(
            log, {TEE: port.tee_worker.bls_keys_of(TEE)}),
        "signed": ls.signed, "blocks": port.state.block,
        "state_root": port.state.state_root(), "seconds": t,
    }
