"""Invariant checkers: what must hold in EVERY virtual round.

Each checker takes a :class:`~cess_tpu_torch.sim.world.World` and returns a
list of violation strings (empty = invariant holds). They read the
same internals the live tests pin — ``Node.finalized``,
``FinalityGadget.locked_rounds``, the on-chain event log, agent
fragment stores — so a regression in the production stack surfaces
here as a named invariant breaking inside a replayable world, not as
a flaky thread test.

The four core invariants:

- ``finalized-prefix``: all honest alive nodes agree on one finalized
  prefix (no two conflicting finalized blocks anywhere);
- ``vote-locks``: no own-vote lock (the GRANDPA-style safety lock) is
  held past the LOCK_HORIZON liveness backstop;
- ``audit-soundness``: a miner holding corrupt service bytes never
  passes a service audit (corrupt fragment => challenge failure);
- ``storage-convergence``: once a file is active, every honest alive
  assigned miner holds bytes matching the on-chain fragment hash.

Plus supporting checks scenarios opt into: ``heads-converged``
(post-heal: one head, one state root), ``restoral-single-winner``
(the restoral market pays exactly one rescuer per broken fragment)
and ``fleet-consistency`` (the fleet plane's global views
must be re-derivable from the per-node states it ingested — worst-of
and quorum recomputed from scratch must match the FleetBoard,
federated counters must be nonnegative, and no stitched span may
reference a parent uid outside its trace).

The ``remediation`` family judges the control loop itself:
``remediation-coverage`` (every detector edge the policy table
matched has a journaled fire/suppress decision by an enabled policy)
and ``remediation-effective`` (every engagement is visibly latched on
its seam, and a still-regressed perf metric is never left without an
active or cooldown-fresh engagement).

The ``custody`` family judges the durability plane:
``custody-ledger-consistent`` (every sealed erasure margin the
custody plane folds from its lineage ledger must re-derive from RAW
world storage — ledger holder identity checked against the holder's
actual fragment bytes and node liveness — and every active on-chain
file's segments must be in the ledger: a deleted byte nobody noted,
or a segment the ledger never saw, breaks it) and
``custody-proactive`` (while the remediation plane rides, no segment
may ever cross below k healthy fragments — the at-risk edge plus the
proactive-repair policy must hold the margin — and every active
at-risk key must have reached the remediation plane's evidence map).
"""
from __future__ import annotations

from ..crypto.hashing import fragment_hash
from ..obs import flight as _flight


class InvariantViolation(AssertionError):
    """Raised when a per-round invariant fails; the message carries
    every violation string so the seed + round fully localize it."""


def check_finalized_prefix(world) -> list[str]:
    views = []
    for i, node in enumerate(world.nodes):
        if not world.alive[i]:
            continue
        views.append((node.finalized, i, node))
    if not views:
        return []
    _, ref_i, ref = max(views)
    out = []
    for f, i, node in views:
        # ref's chain covers height f (ref.finalized >= f), and two
        # finalized prefixes may never disagree at any common height
        if node.chain[f].hash() != ref.chain[f].hash():
            out.append(
                f"finalized-prefix: node {i} finalized "
                f"#{f}={node.chain[f].hash().hex()[:12]} but node "
                f"{ref_i} has {ref.chain[f].hash().hex()[:12]} there")
    return out


def check_vote_locks(world) -> list[str]:
    out = []
    for i in world.validator_indices():
        if not world.alive[i]:
            continue
        node = world.nodes[i]
        head = node.chain[-1].number
        gadget = node.finality
        for account in node.keystore:
            for rnd in gadget.locked_rounds(account, head):
                if head - rnd > gadget.LOCK_HORIZON:
                    out.append(
                        f"vote-locks: node {i} account {account} still "
                        f"locked by round {rnd} at head #{head} "
                        f"(horizon {gadget.LOCK_HORIZON})")
    return out


def _ref_runtime(world):
    alive = [i for i in range(world.n) if world.alive[i]]
    if not alive:
        return None
    ref = max(alive, key=lambda i: (world.nodes[i].finalized, -i))
    return world.nodes[ref].runtime


def check_audit_soundness(world) -> list[str]:
    storage = getattr(world, "storage", None)
    if storage is None:
        return []
    rt = _ref_runtime(world)
    if rt is None:
        return []
    adversarial = {f"m{j}" for j in storage.adversarial_miners}
    latest: dict[str, dict] = {}
    for e in rt.state.events_of("audit", "VerifyResult"):
        d = dict(e.data)
        latest[d["miner"]] = d
    out = []
    for acct, d in latest.items():
        if acct not in adversarial:
            continue
        agent = world.agents.get(acct)
        if agent is None:
            continue
        corrupt_now = any(fragment_hash(blob) != h
                          for h, blob in agent.store.items())
        if corrupt_now and d["service"]:
            out.append(
                f"audit-soundness: adversarial miner {acct} holds "
                f"corrupt service bytes but its latest verify verdict "
                f"passed the service audit")
    return out


def check_storage_convergence(world) -> list[str]:
    storage = getattr(world, "storage", None)
    if storage is None:
        return []
    rt = _ref_runtime(world)
    if rt is None:
        return []
    adversarial = {f"m{j}" for j in storage.adversarial_miners}
    homes = getattr(world, "role_homes", {})
    # fragment -> current on-chain owner. The file's row->miner tuple
    # is NOT authoritative after a restoral: completion moves single
    # fragments in frag_of_miner, and the row only flips once the
    # origin holds none of that row's fragments
    owner = {frag: acct for (acct, frag), _entry
             in rt.state.iter_prefix("file_bank", "frag_of_miner")}
    out = []
    for (fh,), f in rt.state.iter_prefix("file_bank", "file"):
        if f.state != "active":
            continue
        for seg in f.segments:
            for h in seg.fragment_hashes:
                acct = owner.get(h)
                if acct is None or acct in adversarial:
                    continue          # corruption is audit's job
                if rt.file_bank.restoral_order(h) is not None:
                    continue          # loss reported; repair in flight
                agent = world.agents.get(acct)
                home = homes.get(acct)
                if agent is None or home is None \
                        or not world.alive[home]:
                    continue
                blob = agent.store.get(h)
                if blob is None:
                    # only ACTIVE files count: active means every
                    # assigned miner reported its transfer, so a hole
                    # with no restoral order is real divergence
                    out.append(
                        f"storage-convergence: miner {acct} lost "
                        f"fragment {h.hex()[:12]} of active file "
                        f"{fh.hex()[:12]} with no restoral order open")
                elif fragment_hash(blob) != h:
                    out.append(
                        f"storage-convergence: miner {acct} holds "
                        f"corrupt bytes for fragment {h.hex()[:12]} "
                        f"of active file {fh.hex()[:12]}")
    return out


def check_heads_converged(world) -> list[str]:
    heads = {}
    roots = set()
    for i, node in enumerate(world.nodes):
        if not world.alive[i]:
            continue
        heads.setdefault(node.chain[-1].hash(), []).append(i)
        roots.add(node.runtime.state.state_root())
    if len(heads) > 1:
        parts = "; ".join(
            f"{h.hex()[:12]}:{nodes}" for h, nodes in sorted(
                heads.items(), key=lambda kv: kv[1]))
        return [f"heads-converged: {len(heads)} distinct heads ({parts})"]
    if len(roots) > 1:
        return [f"heads-converged: one head but {len(roots)} state roots"]
    return []


def check_restoral_single_winner(world) -> list[str]:
    rt = _ref_runtime(world)
    if rt is None or getattr(world, "storage", None) is None:
        return []
    winners: dict[bytes, set[str]] = {}
    for e in rt.state.events_of("file_bank", "RestoralComplete"):
        d = dict(e.data)
        winners.setdefault(d["fragment_hash"], set()).add(d["miner"])
    out = []
    for frag, miners in winners.items():
        if len(miners) > 1:
            out.append(
                f"restoral-single-winner: fragment {frag.hex()[:12]} "
                f"paid {sorted(miners)} — the market must pay exactly "
                f"one rescuer")
    return out


def check_repair_exactly_once(world) -> list[str]:
    """Every fragment the restoral market completed was recovered
    EXACTLY once — one completion event, one winner — and the winner
    (when its home is still alive) holds bytes re-hashing to the
    on-chain identity. Double completion means double pay; a winner
    without verified bytes means the market paid for a repair that
    never happened."""
    rt = _ref_runtime(world)
    if rt is None or getattr(world, "storage", None) is None:
        return []
    homes = getattr(world, "role_homes", {})
    completions: dict[bytes, list[str]] = {}
    for e in rt.state.events_of("file_bank", "RestoralComplete"):
        d = dict(e.data)
        completions.setdefault(d["fragment_hash"], []).append(d["miner"])
    out = []
    for frag, accounts in sorted(completions.items()):
        if len(accounts) != 1:
            out.append(
                f"repair-exactly-once: fragment {frag.hex()[:12]} "
                f"completed {len(accounts)} times by "
                f"{sorted(set(accounts))}")
            continue
        agent = world.agents.get(accounts[0])
        home = homes.get(accounts[0])
        if agent is None or home is None or not world.alive[home]:
            continue
        blob = agent.store.get(frag)
        if blob is None:
            out.append(
                f"repair-exactly-once: winner {accounts[0]} of "
                f"fragment {frag.hex()[:12]} no longer holds it")
        elif fragment_hash(blob) != frag:
            out.append(
                f"repair-exactly-once: winner {accounts[0]} holds "
                f"corrupt bytes for fragment {frag.hex()[:12]}")
    return out


def check_repair_ingress_bound(world) -> list[str]:
    """When symbol-mode repairs ran, fleet-wide repair ingress must
    beat the whole-fragment baseline of k bytes per recovered byte —
    if the regenerating path silently stopped engaging (every repair
    fell back), this trips instead of the saving quietly vanishing."""
    storage = getattr(world, "storage", None)
    if storage is None:
        return []
    miners = getattr(world, "miners", ())
    if not any(getattr(m, "repair_mode", "") == "symbols"
               for m in miners):
        return []
    recovered = sum(m.repair_recovered_bytes for m in miners)
    ingress = sum(m.repair_ingress_bytes for m in miners)
    if recovered == 0:
        return []
    if ingress >= storage.k * recovered:
        return [
            f"repair-ingress-bound: {ingress} ingress bytes for "
            f"{recovered} recovered — not below the whole-fragment "
            f"baseline of {storage.k} bytes/byte (regenerating repair "
            f"never engaged?)"]
    return []


def check_repair_drained(world) -> list[str]:
    """Storm final check: the restoral market fully drained — no
    order still open anywhere on the reference chain view."""
    rt = _ref_runtime(world)
    if rt is None or getattr(world, "storage", None) is None:
        return []
    out = []
    for (frag,), order in sorted(
            rt.state.iter_prefix("file_bank", "restoral")):
        out.append(
            f"repair-drained: restoral order for fragment "
            f"{frag.hex()[:12]} still open "
            f"(claimed by {order.miner or 'nobody'})")
    return out


def check_fleet_consistency(world) -> list[str]:
    """Global fleet state must be DERIVABLE from per-node states: the
    FleetBoard's worst/quorum views recomputed from the node states it
    holds must match what it reports, every federated counter must be
    nonnegative (reset clamping can never produce a negative
    cumulative), and the stitched trace set must be internally
    consistent (every resolved parent uid exists in its trace)."""
    plane = getattr(world, "fleet", None)
    if plane is None:
        return []
    from ..obs import fleet as _fleet

    out = []
    board = plane.board.snapshot()
    for cls, view in board["classes"].items():
        states = [view["nodes"][i] for i in sorted(view["nodes"])]
        if not states:
            continue
        worst = max(states,
                    key=lambda s: _fleet._SEVERITY.get(s, 0))
        if view["worst"] != worst:
            out.append(
                f"fleet-consistency: class {cls} worst view "
                f"{view['worst']!r} but per-node states derive "
                f"{worst!r}")
        quorum = _fleet._quorum_state(states)
        if view["quorum"] != quorum:
            out.append(
                f"fleet-consistency: class {cls} quorum view "
                f"{view['quorum']!r} but per-node states derive "
                f"{quorum!r}")
    fed = plane.federator.snapshot()
    for key, value in fed["counters"].items():
        if value < 0:
            out.append(
                f"fleet-consistency: federated counter {key} is "
                f"negative ({value}) — reset clamping failed")
    for t in plane.stitcher.traces():
        uids = {s["uid"] for s in t["spans"]}
        for s in t["spans"]:
            parent = s["parent_uid"]
            if parent is not None and parent not in uids:
                out.append(
                    f"fleet-consistency: stitched span {s['uid']} "
                    f"resolves parent {parent} outside its trace "
                    f"{t['trace_id']}")
    return out


def check_remediation_coverage(world) -> list[str]:
    """Every detector edge the remediation policy table
    matched (trigger + guard) must have a journaled DECISION — a fire
    or an explicit suppression — by an ENABLED policy. An edge that
    matched a disabled row, or matched and was silently dropped, is
    the autopilot sleeping through its alarm."""
    plane = getattr(world, "remediation", None)
    if plane is None:
        return []
    out = []
    pols = {p.name: p for p in plane.policies()}
    decided = {e["edge"] for e in plane.journal()
               if e["event"] in ("fire", "suppress")}
    count = plane.count
    for edge in plane.edge_log():
        if edge["tick"] >= count:
            continue          # arrived after the round's decision tick
        p = pols.get(edge["policy"])
        if p is not None and not p.enabled:
            out.append(
                f"remediation-coverage: edge #{edge['id']} "
                f"({edge['policy']}:{edge['key']}) matched a DISABLED "
                f"policy — no decision will ever be journaled")
        elif edge["id"] not in decided:
            out.append(
                f"remediation-coverage: edge #{edge['id']} "
                f"({edge['policy']}:{edge['key']}) has no journaled "
                f"fire/suppress decision")
    return out


def check_remediation_effective(world) -> list[str]:
    """A fired policy must MEASURABLY hold — every live pin
    engagement is visibly latched on its monitor (``state ==
    "held"``), every live repair-mode engagement shows on the miner,
    and a perf metric the detectors still grade ``regressed`` has an
    active (or cooldown-fresh) engagement covering it. Fires when the
    world was tampered behind the plane's back (someone released its
    hold) — and on a world where the responsible policy is disabled,
    because nothing ever engaged."""
    plane = getattr(world, "remediation", None)
    if plane is None:
        return []
    snap = plane.snapshot()
    out = []
    if not snap["dry_run"]:
        for ekey, e in sorted(snap["engaged"].items()):
            pname, _, key = ekey.partition(":")
            if e["action"] in ("pin-reference", "quarantine-lane"):
                mons = plane._pin_monitors(key) \
                    if e["action"] == "pin-reference" \
                    else plane._lane_monitors(key)
                for mon in mons:
                    if mon.state != "held":
                        out.append(
                            f"remediation-effective: {ekey} is "
                            f"engaged but monitor "
                            f"{getattr(mon, 'name', '?')} is "
                            f"{mon.state!r}, not held")
            elif e["action"] == "flip-repair-mode":
                miner = plane._miners.get(key)
                if miner is not None \
                        and miner.repair_mode != "fragments":
                    out.append(
                        f"remediation-effective: {ekey} is engaged "
                        f"but miner {key} still runs "
                        f"{miner.repair_mode!r}")
    perf_pols = [p for p in plane.policies()
                 if tuple(p.trigger) == ("perf", "regression")]
    for metric, state in sorted(snap["health"]["perf"].items()):
        if state != "regressed" or not perf_pols:
            continue
        covered = False
        for p in perf_pols:
            ekey = f"{p.name}:{metric}"
            if ekey in snap["engaged"]:
                covered = True
                break
            if any(e["policy"] == p.name and e["key"] == metric
                   and snap["count"] - e["tick"] <= max(p.cooldown, 1)
                   for e in snap["journal"]):
                covered = True          # cooldown-fresh decision
                break
        if not covered:
            out.append(
                f"remediation-effective: perf metric {metric} is "
                f"still regressed with no active or recent "
                f"remediation engagement")
    return out


def check_custody_ledger_consistent(world) -> list[str]:
    """The custody plane's erasure-margin fold must agree
    with a raw re-derivation from world storage. The plane's side is
    :meth:`~cess_tpu_torch.obs.custody.CustodyPlane.fold_margins` — the
    LIVE fold over the ledger view (sealed margins go stale the
    moment the remediation tick repairs something between seal and
    check). The raw side replaces only the step the ledger cannot see
    from notes: a fragment counts healthy iff its ledger holder
    actually HOLDS matching bytes on an alive node (gateway custody —
    no holder yet — counts healthy on both sides). Deleting a miner's
    bytes behind the seams' back makes the two sides disagree. The
    coverage half: every active on-chain file's segments must be in
    the ledger — an upload the dispatch seam never noted is lineage
    lost before it started."""
    plane = getattr(world, "custody", None)
    if plane is None:
        return []
    out = []
    view = plane.ledger.view()
    folded = plane.fold_margins()
    for key in sorted(view["segments"]):
        seg = view["segments"][key]
        raw_good = 0
        for fh in seg["frags"]:
            if fh in view["lost"]:
                continue
            holder = view["holder"].get(fh)
            if holder is None:
                raw_good += 1        # still gateway custody
                continue
            home = world.role_homes.get(holder)
            if home is not None and not world.alive[home]:
                continue
            agent = world.agents.get(holder)
            blob = None if agent is None \
                else agent.store.get(bytes.fromhex(fh))
            if blob is None or fragment_hash(blob) != bytes.fromhex(fh):
                continue
            v = view["verdicts"].get(holder)
            if v is not None and not v["service"]:
                continue
            raw_good += 1
        raw_margin = raw_good - seg["k"]
        if folded.get(key) != raw_margin:
            out.append(
                f"custody-ledger-consistent: segment {key} folds "
                f"margin {folded.get(key)} from the ledger but raw "
                f"world storage derives {raw_margin}")
    alive = [i for i in range(world.n) if world.alive[i]]
    if alive:
        st = world.nodes[alive[0]].runtime.state
        for (fh,), f in sorted(st.iter_prefix("file_bank", "file")):
            if f.state != "active":
                continue
            for idx in range(len(f.segments)):
                key = f"{fh.hex()}:{idx}"
                if key not in view["segments"]:
                    out.append(
                        f"custody-ledger-consistent: active segment "
                        f"{key} is on chain but absent from the "
                        f"custody ledger")
    return out


def check_custody_proactive(world) -> list[str]:
    """The point of the durability plane — while the
    remediation plane rides, proactive repair must hold every erasure
    margin, so a ``lost`` edge (margin < 0: some fragment set crossed
    below k) is the drill failing by definition. Fires on a world
    where the custody-repair policy was disabled behind the plane's
    back (at-risk decays to lost with nobody rebuilding). The second
    half catches an unplugged listener: every ACTIVE at-risk key must
    have reached the remediation plane's custody evidence map."""
    plane = getattr(world, "custody", None)
    rem = getattr(world, "remediation", None)
    if plane is None or rem is None:
        return []
    out = []
    for (_seq, cls, key, _old, to) in plane.detector.transition_log():
        if cls == "lost" and to == "bad":
            out.append(
                f"custody-proactive: segment {key} crossed below k "
                f"healthy fragments while the remediation plane was "
                f"armed — proactive repair failed to hold the margin")
    evidence = rem.snapshot()["health"].get("custody", {})
    for key in plane.detector.active().get("at_risk", ()):
        if key not in evidence:
            out.append(
                f"custody-proactive: at-risk segment {key} never "
                f"reached the remediation plane's evidence map — the "
                f"custody listener is unplugged")
    return out


CHECKERS = {
    "finalized-prefix": check_finalized_prefix,
    "vote-locks": check_vote_locks,
    "audit-soundness": check_audit_soundness,
    "storage-convergence": check_storage_convergence,
    "heads-converged": check_heads_converged,
    "restoral-single-winner": check_restoral_single_winner,
    "repair-exactly-once": check_repair_exactly_once,
    "repair-ingress-bound": check_repair_ingress_bound,
    "repair-drained": check_repair_drained,
    "fleet-consistency": check_fleet_consistency,
    "remediation-coverage": check_remediation_coverage,
    "remediation-effective": check_remediation_effective,
    "custody-ledger-consistent": check_custody_ledger_consistent,
    "custody-proactive": check_custody_proactive,
}


def run_checks(world, names, *, context: str = "",
               strict: bool = True) -> list[str]:
    """Run the named checkers; raise :class:`InvariantViolation` with
    every violation (or return them when ``strict=False``)."""
    violations = []
    for name in names:
        violations.extend(f"[{context}] {v}" if context else v
                          for v in CHECKERS[name](world))
    if violations:
        # black-box journal first: when strict mode raises, the
        # incident trigger has already captured the evidence by the
        # time the exception unwinds the scenario
        _flight.note("sim", "invariant", context=context,
                     violations=list(violations))
        if strict:
            raise InvariantViolation("\n".join(violations))
    return violations
