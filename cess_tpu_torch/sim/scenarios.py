"""The scenario library: chaos campaigns as DATA, not code.

A :class:`Scenario` is a frozen description — world shape, a timeline
of ``(round, action, *args)`` rows, seeded fault sites, SLO targets
and the invariant checkers to run every virtual round. The
interpreter (:func:`run_scenario`) is the only code; adding a
scenario means adding a row to :data:`SCENARIOS`, and the replay
tests automatically cover it (every scenario must produce
bit-identical witnesses for two same-seed runs).

Timeline actions refer to nodes by ROLE, not index — ``"miner:1"``
resolves to miner m1's seed-drawn home node, ``"validator:2"`` to
node 2, ``"tail:0"`` to the last node (the dormant-spare convention
for join actions) — so one scenario runs unchanged at 40, 100 or
1000 nodes.

The witness (:meth:`SimReport.witness`) bundles the event queue's
fired log, every alive node's finalized prefix, the SLO board's
transition log, the fault plan's fired log, and — when armed — the
fleet plane's and chain watch's witnesses: independent deterministic
streams that must ALL match across same-seed replays.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib

from ..obs import flight as _flight
from ..obs import trace
from ..obs.incident import IncidentReporter
from ..obs.slo import SloBoard, SloTarget
from ..resilience import faults as _faults
from .invariants import InvariantViolation, run_checks
from .world import StorageProfile, World

# seeded baseline pin fraction for scenario runs: 1/16 of healthy
# round traces retained alongside every anomalous one
_BASELINE_RATE = 0.0625


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One chaos campaign, fully declarative.

    - ``world``: ``(key, value)`` pairs of :class:`World` kwargs; the
      ``"storage"`` value is itself ``(key, value)`` pairs for
      :class:`StorageProfile`; ``"dormant_tail"`` reserves that many
      trailing nodes as offline spares for ``join`` actions.
    - ``timeline``: ``(round, action, *args)`` rows, applied at the
      START of their round, in order.
    - ``faults``: ``(site, rate, kind)`` rows armed as one seeded
      :class:`~cess_tpu_torch.resilience.faults.FaultPlan` on the world's
      virtual clock.
    - ``slo``: ``(cls, p99_s)`` targets for the round's board.
    - ``checks`` run after EVERY round; ``final_checks`` once at the
      end (convergence properties that only hold after healing).
    - ``pool``: route the world's gateway encodes/tags through a
      device-pool submission engine (serve/pool.py) for the run, so
      chaos campaigns exercise the real multi-lane serving plane;
      the pool snapshot rides :attr:`SimReport.pool` and lane
      breaker trips land in the armed flight recorder's journal.
    - ``fleet``: arm a :class:`~cess_tpu_torch.obs.fleet.FleetPlane` as
      ``world.fleet`` and run one count-sequenced fleet scrape round
      per virtual round: every alive node contributes a head-lag
      derived SLO state + straggler sample, and every
      :data:`_FLEET_FEDERATE_EVERY`-th round its full /metrics
      exposition. The plane rides :attr:`SimReport.fleet` and its
      witness joins :meth:`SimReport.witness` as the fifth stream.
    - ``profile``: arm a :class:`~cess_tpu_torch.obs.profile.ProfilePlane`
      on the ``pool`` engine (requires ``pool=True`` — the plane
      accounts engine dispatches), so chaos campaigns leave the
      per-shape stage breakdowns and the unified pad ledger behind;
      the snapshot rides :attr:`SimReport.profile`. Unanchored (no
      bench baseline inside a sim world), so the watchdog stays
      inert — profiling without judging.
    - ``chainwatch``: arm a
      :class:`~cess_tpu_torch.obs.chainwatch.ChainWatch` as
      ``world.chainwatch`` and run one chain scan per virtual round:
      every alive node's consensus state (head/finalized/forks/vote
      locks/claimed blocks) plus the market ledger from the lowest
      alive node's runtime. The anomaly detector's triggers land in
      the armed incident reporter (the bundle embeds the chain
      snapshot), per-node finality lag folds into an armed ``fleet``
      plane (SLO class via :func:`_fleet_scrape`, straggler samples
      at seal), and the watch's witness joins
      :meth:`SimReport.witness` as the sixth stream.
    - ``remediate``: arm a
      :class:`~cess_tpu_torch.serve.remediate.RemediationPlane` as
      ``world.remediation``: it listens on the run's flight recorder,
      binds the ``pool`` engine / miners / lowest node as action
      seams, and ticks once per virtual round AFTER the scrapes (so
      the round's detector edges are decided in the same round and
      the ``remediation-*`` checkers see post-decision state). Its
      action-journal witness joins :meth:`SimReport.witness` as the
      seventh stream.
    - ``custody``: arm a
      :class:`~cess_tpu_torch.obs.custody.CustodyPlane` as ``world.custody``:
      its ledger fills continuously from the run recorder's
      ``("custody", ...)`` lineage notes (gateway dispatch, miner
      transfer, TEE verdict, repair completion), and one
      :func:`_custody_scrape` per virtual round feeds holder
      liveness + the open restoral-order set, cross-checks the
      MarketWatch when ``chainwatch`` rides too, and seals the
      erasure-margin fold (the at-risk/lost detector edges land in
      the armed incident reporter — the bundle embeds the segment's
      full custody timeline). With ``remediate`` the plane also
      binds as the remediation plane's repair-target feed
      (``bind_custody``), closing the proactive-repair loop. Its
      witness joins :meth:`SimReport.witness` as the eighth stream.
    """

    name: str
    rounds: int
    world: tuple = ()
    timeline: tuple = ()
    faults: tuple = ()
    slo: tuple = (("round", 4.0), ("upload", 4.0))
    checks: tuple = ("finalized-prefix", "vote-locks")
    final_checks: tuple = ()
    # False = no engine; True = one lane for each of the world's
    # devices; an int N: lanes on the first N of them
    pool: bool | int = False
    fleet: bool = False
    profile: bool = False
    chainwatch: bool = False
    remediate: bool = False
    # with ``pool``: build the engine on the regenerating codec
    # (ops/regen.py, rs_backend="regen") so storm_repair rescuers run
    # symbol-mode repairs and the fold programs ride the lane caches
    regen: bool = False
    custody: bool = False


def resolve_ref(world: World, ref: str) -> int:
    """``"role:ordinal"`` -> node index (see module doc)."""
    kind, _, tail = ref.partition(":")
    k = int(tail)
    if kind in ("node", "validator"):
        return k
    if kind == "tail":
        return world.n - 1 - k
    if kind == "spare":
        # k-th plain node: not a validator, not a role home — safe to
        # churn without silently taking a miner/gateway/TEE down
        homes = set(getattr(world, "role_homes", {}).values())
        spares = [i for i in range(world.n_validators, world.n)
                  if i not in homes]
        return spares[k]
    name = {"miner": f"m{k}", "gateway": f"gw{k}", "tee": "tee0"}[kind]
    return world.role_homes[name]


def _seeded_blob(seed: bytes, label: str, size: int) -> bytes:
    """Deterministic file contents from a SHA-256 stream."""
    out = bytearray()
    n = 0
    while len(out) < size:
        out += hashlib.sha256(b"cess-sim-blob:" + seed + b"|"
                              + label.encode() + b"|"
                              + n.to_bytes(4, "little")).digest()
        n += 1
    return bytes(out[:size])


@dataclasses.dataclass
class _Upload:
    round: int
    owner: str
    gw: object
    calc_sent: bool = False


@dataclasses.dataclass
class SimReport:
    """What a scenario run leaves behind: the world (for further
    inspection) and the four witness streams."""

    scenario: str
    seed: bytes
    world: World
    board: SloBoard
    plan: "_faults.FaultPlan | None"
    rounds_run: int
    uploads_active: int
    # the flight-recorder layer: the run's FlightRecorder
    # (pinned traces + journal) and its IncidentReporter (bundles) —
    # reporter.witness() is the postmortem determinism contract,
    # separate from the four run streams below
    recorder: "_flight.FlightRecorder | None" = None
    reporter: "IncidentReporter | None" = None
    # the device-pool serving plane: the pool's end-of-run
    # snapshot when the scenario ran ``pool=True`` — informational
    # (per-lane batch/requeue counters and breaker states), NOT part
    # of the witness: lane timing is wall-clock, outputs are
    # bit-identical to the single-device engine by construction
    pool: "dict | None" = None
    # the fleet observability plane: the run's FleetPlane
    # when the scenario ran ``fleet=True`` — its witness (federated
    # snapshot + FleetBoard transition log + stitched trace set) IS
    # part of the replay contract, as the fifth witness stream
    fleet: "object | None" = None
    # the continuous-profiling plane: the plane's
    # end-of-run snapshot when the scenario ran ``profile=True`` —
    # informational like ``pool`` (stage sums are wall-clock; the
    # plane's OWN witness() determinism contract is exercised
    # directly against the live engine in tests/test_profile.py)
    profile: "dict | None" = None
    # the chain-plane watch: the run's ChainWatch when the
    # scenario ran ``chainwatch=True`` — its witness (consensus views
    # + equivocation evidence + market ledger + anomaly transition
    # log) IS part of the replay contract, as the sixth witness stream
    chainwatch: "object | None" = None
    # the remediation plane: the run's RemediationPlane
    # when the scenario ran ``remediate=True`` — its action-journal
    # witness (same seed => byte-identical action log) IS part of the
    # replay contract, as the seventh witness stream
    remediation: "object | None" = None
    # the custody/durability plane: the run's CustodyPlane
    # when the scenario ran ``custody=True`` — its witness (flat
    # count-sequenced ledger log + sealed margins + detector
    # transitions) IS part of the replay contract, as the eighth
    # witness stream
    custody: "object | None" = None

    def witness(self) -> tuple:
        """Everything that must be bit-identical across two same-seed
        runs of the same scenario."""
        return (self.world.queue.fired_log(),
                self.world.finalized_prefix(),
                self.board.transition_log(),
                self.plan.fired_log() if self.plan is not None else (),
                self.fleet.witness() if self.fleet is not None else b"",
                self.chainwatch.witness()
                if self.chainwatch is not None else b"",
                self.remediation.witness()
                if self.remediation is not None else b"",
                self.custody.witness()
                if self.custody is not None else b"")


def _build_world(scenario: Scenario, seed, n_nodes: int | None,
                 devices=None) -> World:
    kwargs = dict(scenario.world)
    storage_pairs = kwargs.pop("storage", None)
    if storage_pairs is not None:
        kwargs["storage"] = StorageProfile(**dict(storage_pairs))
    if n_nodes is not None:
        kwargs["n_nodes"] = n_nodes
    n = kwargs.get("n_nodes", 100)
    tail = kwargs.pop("dormant_tail", 0)
    if tail:
        kwargs["dormant"] = tuple(range(n - tail, n))
    return World(seed, devices=devices, **kwargs)


def _drive_uploads(world: World, pending: dict, board: SloBoard,
                   rnd: int) -> int:
    """Advance in-flight uploads one lifecycle step per round (the
    scheduler's calculate_end fires via a root extrinsic, as in the
    live storage tests) and feed activation latency to the SLO board.
    Returns how many files went active this round."""
    active = 0
    for fh in sorted(pending):
        rec = pending[fh]
        f = rec.gw.node.runtime.file_bank.file(fh)
        if f is None:
            continue
        if f.state == "calculate" and not rec.calc_sent:
            rec.gw.node.submit_extrinsic("root", "file_bank.calculate_end",
                                         fh)
            rec.calc_sent = True
        elif f.state == "active":
            board.observe("upload", latency_s=float(rnd - rec.round + 1),
                          tenant=rec.owner)
            del pending[fh]
            active += 1
    return active


def _apply_action(world: World, pending: dict, rnd: int,
                  action: str, args: tuple) -> None:
    if action in ("crash", "leave", "restart", "join"):
        getattr(world, action)(resolve_ref(world, args[0]))
    elif action == "stripe":
        world.stripe_partition(args[0])
    elif action == "heal":
        world.heal()
    elif action == "upload":
        gw_ord, owner, size, count = (args + (1,))[:4]
        gw = world.gateways[gw_ord]
        for j in range(count):
            label = f"r{rnd}g{gw_ord}u{j}"
            data = _seeded_blob(world.seed, label, size)
            fh = gw.upload(owner, "photos", f"{label}.bin", data)
            pending[fh] = _Upload(round=rnd, owner=owner, gw=gw)
    elif action == "drop_fragment":
        # victim by fragment ROW of the first active file — the row ->
        # miner mapping is on-chain data, so the scenario stays valid
        # whatever the deal-assignment draw picked
        row = args[0]
        rt = world.gateways[0].node.runtime
        for (fh,), f in sorted(rt.state.iter_prefix("file_bank", "file")):
            if f.state != "active":
                continue
            agent = world.agents[f.miners[row]]
            frag = f.segments[0].fragment_hashes[row]
            if frag not in agent.store:
                continue
            del agent.store[frag]
            agent.tags.pop(frag, None)
            agent.node.submit_extrinsic(
                agent.account, "file_bank.generate_restoral_order",
                fh, frag)
            world.queue.mark(f"drop_fragment:{agent.account}")
            return
        raise LookupError(f"drop_fragment: no active file with a "
                          f"stored row-{row} fragment")
    elif action == "storm_kill":
        # mass miner failure: drop EVERY active-file fragment the
        # victim ordinals custody, open their restoral orders via the
        # (alive) gateway node, then crash the victims' home nodes —
        # the restoral market floods with concurrent orders at once
        start, count = args
        rt = world.gateways[0].node.runtime
        frag_file: dict[bytes, bytes] = {}
        for (fh,), f in sorted(rt.state.iter_prefix("file_bank", "file")):
            if f.state != "active":
                continue
            for seg in f.segments:
                for h in seg.fragment_hashes:
                    frag_file[h] = fh
        owner = {frag: acct for (acct, frag), _e
                 in rt.state.iter_prefix("file_bank", "frag_of_miner")}
        gw_node = world.gateways[0].node
        for j in range(start, start + count):
            victim = world.agents[f"m{j}"]
            dropped = 0
            for h in sorted(frag_file):
                if owner.get(h) != victim.account:
                    continue
                victim.store.pop(h, None)
                victim.tags.pop(h, None)
                gw_node.submit_extrinsic(
                    victim.account, "file_bank.generate_restoral_order",
                    frag_file[h], h)
                dropped += 1
            world.crash(world.role_homes[victim.account])
            world.queue.mark(f"storm_kill:{victim.account}:{dropped}")
    elif action == "storm_repair":
        # surviving miners fan the open orders across the pool engine:
        # first pass binds each alive rescuer to the scenario engine
        # (symbol mode when it carries the regenerating codec) and
        # warms the restoral patterns per lane, then every rescuer
        # sweeps the market — concurrent claims are the storm load
        eng = getattr(world.pipeline, "engine", None)
        repaired = 0
        for rescuer in world.miners:
            if not world.alive[world.role_homes[rescuer.account]]:
                continue
            if eng is not None and rescuer.engine is None:
                rescuer.attach_engine(eng)
                if hasattr(eng.codec, "fold_symbol"):
                    rescuer.set_repair_mode("symbols")
                rescuer.warm_restoral()
            rt = rescuer.node.runtime
            for (frag,), order in sorted(
                    rt.state.iter_prefix("file_bank", "restoral")):
                if order.miner or order.origin_miner == rescuer.account:
                    continue
                if rescuer.try_repair(frag, world.miners,
                                      world.gateways):
                    repaired += 1
        world.queue.mark(f"storm_repair:{repaired}")
    elif action == "repair_contend":
        # every OTHER miner sees the same open orders and races: all
        # reconstruct, all claim — the chain pays exactly ONE (the
        # restoral-single-winner invariant)
        repaired = 0
        for rescuer in world.miners:
            rt = rescuer.node.runtime
            for (frag,), order in sorted(
                    rt.state.iter_prefix("file_bank", "restoral")):
                if order.miner or order.origin_miner == rescuer.account:
                    continue         # claimed on this view / victim
                if rescuer.try_repair(frag, world.miners,
                                      world.gateways):
                    repaired += 1
        world.queue.mark(f"repair_contend:{repaired}")
    elif action == "attrition":
        # one seeded SILENT miner death (the durability drill's slow
        # attrition): the victim's fragments vanish and its home node
        # crashes, but — unlike storm_kill — nobody files restoral
        # orders. Detecting the decay is the custody plane's job (the
        # margin fold over holder liveness), and the proactive-repair
        # policy must file the orders itself. Victim drawn seeded from
        # the first active file's still-alive assigned miners
        rt = world.gateways[0].node.runtime
        holders: list[str] = []
        for (_fh,), f in sorted(rt.state.iter_prefix("file_bank", "file")):
            if f.state != "active":
                continue
            holders = sorted(set(f.miners))
            break
        alive_holders = [a for a in holders
                         if world.alive[world.role_homes[a]]]
        if not alive_holders:
            raise LookupError("attrition: no alive assigned miner "
                              "to kill")
        victim_acct = alive_holders[
            world.u64("attrition", rnd) % len(alive_holders)]
        victim = world.agents[victim_acct]
        dropped = len(victim.store)
        victim.store.clear()
        victim.tags.clear()
        world.crash(world.role_homes[victim_acct])
        world.queue.mark(f"attrition:{victim_acct}:{dropped}")
    elif action == "equivocate":
        _equivocate(world, args[0])
    elif action == "perf_edge":
        # scripted perf-watchdog edge: the live PerfWatchdog grades
        # HOST timings against a bench anchor, so a real edge inside a
        # sim world would be nondeterministic — the scenario scripts
        # the transition itself through the same journal note the
        # watchdog emits (obs/profile.py), and everything downstream
        # (incident trigger, remediation policy) reacts identically
        metric, to = args
        _flight.note("perf", "regression", metric=metric,
                     frm="regressed" if to == "ok" else "ok",
                     to=to, window=rnd)
        world.queue.mark(f"perf_edge:{metric}:{to}")
    else:
        raise ValueError(f"unknown scenario action {action!r}")


def _equivocate(world: World, ref: str) -> None:
    """A seeded double-signer. The slot claim signs (slot, author) but
    NOT the block contents, so re-issuing the same claim over
    different contents is exactly the BABE equivocation shape: forge
    a twin of the validator's newest unfinalized canonical block
    (mutated state root, same claim) and deliver it to every alive
    node. The twin's claim verifies, it lands as a side branch (equal
    weight — never adopted), and every chain watch now sees two
    distinct blocks signed by one author for one slot."""
    from ..node.network import Block

    want = f"v{resolve_ref(world, ref)}"
    src = next(i for i in range(world.n) if world.alive[i])
    node = world.nodes[src]
    header = None
    for h in reversed(node.chain):
        if h.claim is None or h.number <= node.finalized:
            continue
        header = h
        if h.author == want:
            break
    if header is None:
        raise LookupError(f"equivocate: no unfinalized canonical "
                          f"block to double-sign (finalized="
                          f"#{node.finalized})")
    twin = dataclasses.replace(
        header, state_root=hashlib.sha256(
            b"cess-sim-equivocation:" + header.state_root).digest())
    blk = Block(header=twin, extrinsics=())
    for i in range(world.n):
        if not world.alive[i]:
            continue
        try:
            world.nodes[i].import_block(blk)
        except ValueError:
            continue    # other partition / finalized past it: no view
    world.queue.mark(
        f"equivocate:{header.author}@{header.claim.slot}")


# every node's SLO state + straggler sample feeds the fleet plane
# each round; full /metrics expositions federate every N-th round
# (render_metrics walks runtime state, so scraping 100 nodes every
# round would dominate the run without observing anything new)
_FLEET_FEDERATE_EVERY = 4


def _fleet_scrape(world: World, plane, rnd: int) -> None:
    """One count-sequenced fleet scrape round over the world. Each
    alive node contributes a deterministic SLO snapshot derived from
    its head lag behind the best alive chain (lagging <=1 slot of
    chain is healthy, <=4 is warn, beyond burns — virtual-chain
    state, never host timing), and the same lag feeds its straggler
    window; every ``_FLEET_FEDERATE_EVERY``-th round the node's full
    /metrics exposition federates too. Crashed nodes skip the round —
    their last reported state stands, exactly like a silent peer."""
    from ..node.metrics import render_metrics

    heads = {i: world.nodes[i].chain[-1].number
             for i in range(world.n) if world.alive[i]}
    if not heads:
        return
    best = max(heads.values())
    federate = rnd % _FLEET_FEDERATE_EVERY == 0
    watch = world.chainwatch
    for i in sorted(heads):
        inst = f"n{i:03d}"
        lag = float(best - heads[i])
        state = "ok" if lag <= 1 else ("warn" if lag <= 4
                                       else "burning")
        targets = {"head": {"state": state}}
        if watch is not None:
            # chain-plane fold (obs/chainwatch.py): the node's
            # finality lag joins the same scrape as an SLO class, so
            # the FleetBoard's worst/quorum views flip when a quorum
            # of nodes stops finalizing — the sim-side analog of the
            # "chain" section riding live fleet gossip frames.
            # Graded against the BEST alive head (the head-lag
            # convention above): a stalled quorum keeps authoring
            # somewhere, so best - finalized grows for everyone
            from ..obs import chainwatch as _chainwatch

            flag = int(best) - world.nodes[i].finalized
            targets["finality_lag"] = {
                "state": _chainwatch.lag_state(flag), "lag": flag}
        plane.ingest(
            inst,
            exposition=render_metrics(world.nodes[i])
            if federate else None,
            slo={"targets": targets})
        plane.stragglers.observe(inst, "head_lag", lag)
    plane.seal_round()


def _chainwatch_scrape(world: World, watch, rnd: int) -> None:
    """One chain-plane scan round over the world (obs/chainwatch.py):
    every alive node contributes its consensus state (the same
    :func:`~cess_tpu_torch.obs.chainwatch.node_state` dict a live node's
    gossip frame carries), the lowest alive node's runtime feeds the
    market ledger (chain state is replicated — one copy suffices),
    and the seal runs the anomaly detectors. Crashed nodes skip the
    scan — their last reported view stands, like a silent peer."""
    from ..obs import chainwatch as _chainwatch

    alive = [i for i in range(world.n) if world.alive[i]]
    if not alive:
        return
    for i in alive:
        watch.ingest_state(f"n{i:03d}",
                           _chainwatch.node_state(world.nodes[i]))
    watch.ingest_market(_chainwatch.market_state(
        world.nodes[alive[0]].runtime.state,
        fragment_size=watch.fragment_size))
    watch.seal_round()


def _custody_scrape(world: World, plane, rnd: int) -> None:
    """One custody observation round (obs/custody.py). The ledger
    itself fills continuously from the armed recorder's
    ``("custody", ...)`` lineage notes — this helper feeds only the
    per-round facts no seam carries: holder liveness from the world's
    role homes, the open restoral-order set from the (replicated)
    chain state of the lowest alive node, and the MarketWatch
    cross-check when a chain watch rides the same run. The seal folds
    the erasure margins and runs the at-risk/lost detectors, whose
    edges land in the armed incident reporter."""
    homes = getattr(world, "role_homes", {})
    plane.observe_alive({acct: bool(world.alive[idx])
                         for acct, idx in homes.items()})
    alive = [i for i in range(world.n) if world.alive[i]]
    if alive:
        st = world.nodes[alive[0]].runtime.state
        plane.observe_restorals(tuple(
            frag for (frag,), _o
            in sorted(st.iter_prefix("file_bank", "restoral"))))
    watch = world.chainwatch
    if watch is not None:
        plane.cross_check_market(watch.market.snapshot())
    plane.seal_round()


def _pool_engine(world: World, profile: bool = False,
                 regen: bool = False, lanes=True):
    """A device-pool submission engine matched to the world's storage
    pipeline: same RS geometry, same PoDR2 key (a mismatched key would
    tag with different secrets than the direct path), its codec and
    audit gates on the pipeline's device, one lane for each of the
    world's devices (``lanes=N`` caps the pool width at the first N —
    the repair storm's per-lane warm sweep scales with lane count, and a
    lane trip + sibling drain needs few lanes, not all of them),
    breakers enabled so lane faults trip and drain. With ``profile``,
    an unanchored ProfilePlane rides along (no bench baseline inside a
    sim world — ledgers fill, watchdog inert)."""
    from ..ops import regen as _regen
    from ..ops.audit_backend import AuditBackend
    from ..ops.rs import TorchCodec
    from ..resilience import ResilienceConfig
    from ..serve import DevicePool, SubmissionEngine

    plane = None
    if profile:
        from ..obs.profile import ProfilePlane

        plane = ProfilePlane()
    pipe = world.pipeline
    k, m, dev = pipe.config.k, pipe.config.m, pipe.device
    codec = _regen.RegenCodec(k, m, dev) if regen else TorchCodec(k, m, dev)
    pool = DevicePool(world.devices, n=None if lanes is True else int(lanes))
    return SubmissionEngine(codec, AuditBackend(pipe.podr2_key, dev),
                            resilience=ResilienceConfig(), pool=pool,
                            profile=plane)


def run_scenario(scenario: Scenario, seed, *, n_nodes: int | None = None,
                 tracer=None, strict: bool = True,
                 flight=None, devices=None) -> SimReport:
    """Build the world, arm faults + tracer + flight recorder,
    interpret the timeline, check invariants every round. Raises
    :class:`~cess_tpu_torch.sim.invariants.InvariantViolation` on the first
    round whose checks fail (``strict=False`` collects instead); the
    raised exception carries ``.incidents`` (the bundles snapshotted
    before the unwind) and ``.reporter``.

    flight: an :class:`~cess_tpu_torch.obs.flight.FlightRecorder` to arm for
    the run; default builds one seeded from the scenario seed (so
    retention replays bit-identically) with the scenario's SLO targets
    as pin objectives.

    devices: where the world's storage plane and pool engine run
    (:class:`~cess_tpu_torch.sim.world.World`): None is every visible
    card (raises without one), ``["cpu"] * n`` the host; a pool takes
    the list as its lanes, so ``pool=3`` on one card needs the card
    listed three times."""
    seed_b = seed if isinstance(seed, bytes) else str(seed).encode()
    if scenario.profile and not scenario.pool:
        raise ValueError("Scenario.profile=True requires pool=True "
                         "(the profile plane accounts engine "
                         "dispatches)")
    world = _build_world(scenario, seed_b, n_nodes, devices)
    pool_snap: dict = {}
    profile_snap: dict = {}
    profile_plane = None
    # tiny windows: scenario rounds produce a handful of observations
    # per class, and the transition log must be able to flip on them
    board = SloBoard(tuple(SloTarget(cls, p99_s=p99)
                           for cls, p99 in scenario.slo),
                     fast_window=4, slow_window=16, eval_every=2)
    recorder = flight if flight is not None else _flight.FlightRecorder(
        seed_b, baseline_rate=_BASELINE_RATE,
        objectives=dict(scenario.slo))
    plan = None
    reporter = None
    fleet_plane = None
    chain_watch = None
    remediation = None
    custody_plane = None
    stack = contextlib.ExitStack()
    try:
        with stack:
            if scenario.faults:
                plan = _faults.FaultPlan.seeded(
                    seed_b, {site: (rate, kind)
                             for site, rate, kind in scenario.faults},
                    horizon=256, clock=world.clock)
                stack.enter_context(_faults.armed(plan))
            if tracer is not None:
                stack.enter_context(trace.armed(tracer))
                tracer.attach_flight(recorder)
                stack.callback(tracer.attach_flight, None)
            stack.enter_context(_flight.armed(recorder))
            if scenario.pool:
                # route the storage pipeline through a device-pool
                # engine for the run: gateway encode/tag submits place
                # across mesh lanes, faulted lanes drain to siblings,
                # and every breaker trip is journaled by the armed
                # recorder. Submits are synchronous from the single
                # sim thread, so placement (and the fault plan's
                # per-site ordinals) replay deterministically; the
                # snapshot is captured before the engine closes.
                eng = _pool_engine(world, profile=scenario.profile,
                                   regen=scenario.regen,
                                   lanes=scenario.pool)
                profile_plane = eng.profile
                stack.callback(eng.close)
                stack.callback(lambda: pool_snap.update(
                    eng.pool.snapshot()))
                if profile_plane is not None:
                    stack.callback(lambda: profile_snap.update(
                        profile_plane.snapshot()))
                stack.callback(setattr, world.pipeline, "engine", None)
                world.pipeline.engine = eng
            if scenario.fleet:
                # the fleet observability plane (obs/fleet.py): armed
                # as world.fleet so the fleet-consistency checker can
                # recompute its global views from the ingested
                # per-node states; one scrape round per virtual round
                from ..obs.fleet import FleetPlane

                fleet_plane = FleetPlane("sim")
                world.fleet = fleet_plane
            if scenario.chainwatch:
                # the chain-plane watch (obs/chainwatch.py): armed as
                # world.chainwatch; one scan + detector seal per
                # virtual round, folding per-node finality lag into
                # the fleet plane's straggler windows when one rides
                from ..constants import FRAGMENT_SIZE
                from ..obs.chainwatch import ChainWatch

                chain_watch = ChainWatch("sim",
                                         fragment_size=FRAGMENT_SIZE)
                if fleet_plane is not None:
                    chain_watch.attach_fleet(fleet_plane)
                world.chainwatch = chain_watch
            if scenario.custody:
                # the custody/durability plane (obs/custody.py): armed
                # as world.custody, its ledger fed by the recorder's
                # ("custody", ...) lineage notes; one scrape + margin
                # seal per virtual round (see _custody_scrape)
                from ..obs.custody import CustodyPlane

                custody_plane = CustodyPlane("sim")
                recorder.add_listener(custody_plane.on_note)
                world.custody = custody_plane
            if scenario.remediate:
                # the remediation plane (serve/remediate.py): armed as
                # world.remediation, fed by the run's flight recorder,
                # acting through whatever seams the scenario built —
                # the pool engine's breakers, the storage miners, the
                # lowest node's extrinsic surface, the custody plane's
                # repair targets
                from ..serve.remediate import RemediationPlane

                remediation = RemediationPlane(seed_b)
                if scenario.pool:
                    remediation.bind_engine(world.pipeline.engine)
                remediation.bind_miners(
                    getattr(world, "miners", ()) or ())
                remediation.bind_node(world.nodes[0])
                if custody_plane is not None:
                    remediation.bind_custody(custody_plane)
                recorder.add_listener(remediation.on_note)
                world.remediation = remediation
            # each bundle embeds the scenario identity + the live
            # witness streams — everything a replay needs
            reporter = IncidentReporter(
                recorder, board=board, plan=plan,
                stitcher=None if fleet_plane is None
                else fleet_plane.stitcher,
                profile=profile_plane,
                chainwatch=chain_watch,
                remediation=remediation,
                custody=custody_plane,
                context=lambda: {
                    "scenario": scenario.name,
                    "seed": seed_b.hex(),
                    "witness": (
                        world.queue.fired_log(),
                        world.finalized_prefix(),
                        board.transition_log(),
                        plan.fired_log() if plan is not None else ()),
                })
            pending: dict[bytes, _Upload] = {}
            active = 0
            for rnd in range(scenario.rounds):
                # one scenario round = ONE connected trace: actions,
                # authoring, gossip, agent reactions and invariant
                # checks all hang off this root span
                with trace.span("sim.round", sys="sim",
                                scenario=scenario.name, round=rnd):
                    for row in scenario.timeline:
                        if row[0] == rnd:
                            _apply_action(world, pending, rnd,
                                          row[1], tuple(row[2:]))
                    world.run_round()
                    active += _drive_uploads(world, pending, board, rnd)
                    board.observe("round",
                                  latency_s=float(world.last_round_slots))
                    if chain_watch is not None:
                        # scan BEFORE the fleet scrape: the watch's
                        # straggler fold must land in the same fleet
                        # round the plane seals below
                        _chainwatch_scrape(world, chain_watch, rnd)
                    if fleet_plane is not None:
                        _fleet_scrape(world, fleet_plane, rnd)
                    if custody_plane is not None:
                        # seal the margin fold BEFORE the remediation
                        # tick: an at-risk edge decided this round is
                        # acted on this round, and the custody-*
                        # checkers judge post-decision state
                        _custody_scrape(world, custody_plane, rnd)
                    if remediation is not None:
                        # decide + apply the round's detector edges
                        # BEFORE the checks: the remediation-*
                        # invariants judge post-decision state
                        remediation.tick()
                    run_checks(world, scenario.checks,
                               context=f"{scenario.name}:round{rnd}",
                               strict=strict)
            if fleet_plane is not None:
                # stitch the run's own evidence: the armed tracer's
                # ring (every sim.round trace) and the recorder's
                # pins — overlapping spans dedup by (trace, span) id
                if tracer is not None:
                    fleet_plane.stitcher.add_dump(
                        "sim", tracer.finished())
                fleet_plane.stitcher.add_pins("sim", recorder.pinned())
            run_checks(world, scenario.final_checks,
                       context=f"{scenario.name}:final", strict=strict)
    except InvariantViolation as e:
        # the bundle was built by the strict-raise's journal note
        # BEFORE the unwind; surface it on the exception so callers
        # (and pytest failure output) hold the postmortem directly
        e.reporter = reporter
        e.incidents = [] if reporter is None else reporter.bundles()
        raise
    return SimReport(scenario=scenario.name, seed=seed_b, world=world,
                     board=board, plan=plan, rounds_run=scenario.rounds,
                     uploads_active=active, recorder=recorder,
                     reporter=reporter, pool=pool_snap or None,
                     fleet=fleet_plane, profile=profile_snap or None,
                     chainwatch=chain_watch, remediation=remediation,
                     custody=custody_plane)


# -- the library --------------------------------------------------------------
SCENARIOS: dict[str, Scenario] = {
    # miners and plain nodes churn while a file upload is in flight;
    # lossy fragment transfers force the retry policy to earn its keep
    "miner_churn": Scenario(
        name="miner_churn", rounds=14,
        world=(("n_validators", 5),
               ("storage", (("n_miners", 4),)),
               ("dormant_tail", 1)),
        timeline=(
            (1, "upload", 0, "alice", 20_000),
            (3, "crash", "miner:3"),
            (5, "restart", "miner:3"),
            (6, "join", "tail:0"),
            (8, "leave", "spare:0"),
            (10, "crash", "spare:1"),
            (12, "restart", "spare:1"),
        ),
        faults=(("offchain.fetch", 0.12, "drop"),),
        checks=("finalized-prefix", "vote-locks"),
        final_checks=("storage-convergence", "audit-soundness"),
    ),
    # the classic split-brain: stripe the world in two (validators
    # 4/3 — neither side can finalize), let both sides author, heal,
    # and demand one head + one state root at the end
    "partition_heal": Scenario(
        name="partition_heal", rounds=12,
        world=(("n_validators", 7),),
        timeline=(
            (4, "stripe", 2),
            (9, "heal",),
        ),
        checks=("finalized-prefix", "vote-locks"),
        final_checks=("heads-converged",),
    ),
    # miners m1/m2 store corrupted fragment bytes while reporting
    # clean transfers; the PoDR2 service audit must fail whichever the
    # deal assigned (the 3-row assignment always includes one of them)
    "adversarial_audit": Scenario(
        name="adversarial_audit", rounds=30,
        world=(("n_validators", 5),
               ("storage", (("n_miners", 4),
                            ("adversarial_miners", (1, 2))))),
        timeline=(
            (1, "upload", 0, "alice", 20_000),
        ),
        checks=("finalized-prefix", "vote-locks"),
        final_checks=("audit-soundness",),
    ),
    # every tenant piles onto gateway 0 while gateway 1 idles: the
    # upload SLO breaches and recovers — the transition log is the
    # scenario's whole point
    "gateway_hotspot": Scenario(
        name="gateway_hotspot", rounds=14,
        world=(("n_validators", 5),
               ("storage", (("n_miners", 4), ("n_gateways", 2)))),
        timeline=(
            (1, "upload", 0, "alice", 20_000, 2),
            (3, "upload", 0, "alice", 20_000, 2),
            (6, "upload", 1, "alice", 20_000),
        ),
        slo=(("round", 4.0), ("upload", 2.0)),
        checks=("finalized-prefix", "vote-locks"),
        final_checks=("storage-convergence",),
    ),
    # the hotspot again, served by the REAL multi-lane plane:
    # gateway encodes/tags route through a device-pool engine while
    # a seeded fault kills every dispatch on lane 0 — the lane's
    # breakers trip, work drains to siblings, uploads still activate
    # and storage still converges; the pool snapshot rides the report.
    # profile=True: the same run leaves the per-shape
    # stage breakdowns + unified pad ledger behind on SimReport
    "gateway_hotspot_pool": Scenario(
        name="gateway_hotspot_pool", rounds=14, pool=True, profile=True,
        world=(("n_validators", 5),
               ("storage", (("n_miners", 4), ("n_gateways", 2)))),
        timeline=(
            (1, "upload", 0, "alice", 20_000, 2),
            (3, "upload", 0, "alice", 20_000, 2),
            (6, "upload", 1, "alice", 20_000),
        ),
        faults=(("engine.dispatch.d0", 1.0, "raise"),),
        slo=(("round", 4.0), ("upload", 2.0)),
        checks=("finalized-prefix", "vote-locks"),
        final_checks=("storage-convergence",),
    ),
    # the hotspot observed by the FLEET plane: every round
    # each alive node reports a head-lag SLO state + straggler sample
    # and periodically its full /metrics exposition; a 4-way stripe
    # partition mid-run makes lagging groups drift — the FleetBoard's
    # worst and quorum views both flip to warn and recover after the
    # heal, the MAD detector flags the laggards (fleet-outlier
    # incident bundles), the fleet-consistency checker re-derives the
    # global views from the ingested per-node states every round, and
    # the plane's witness joins the replay contract
    "gateway_hotspot_fleet": Scenario(
        name="gateway_hotspot_fleet", rounds=14, fleet=True,
        world=(("n_validators", 5),
               ("storage", (("n_miners", 4), ("n_gateways", 2)))),
        timeline=(
            (1, "upload", 0, "alice", 20_000, 2),
            (3, "upload", 0, "alice", 20_000, 2),
            (4, "stripe", 4),
            (6, "upload", 1, "alice", 20_000),
            (9, "heal",),
        ),
        slo=(("round", 4.0), ("upload", 2.0)),
        checks=("finalized-prefix", "vote-locks", "fleet-consistency"),
        final_checks=("storage-convergence",),
    ),
    # the byzantine chain-plane campaign: a 4-way stripe
    # stalls finality (no group holds 4 of 5 validators), and mid-
    # partition a seeded double-signer re-issues a slot claim over
    # forged contents — the chain watch's equivocation detector
    # records offences-shaped evidence and fires the `equivocation`
    # incident, growing finality lag fires `finality-stall`, the
    # fleet quorum finality_lag view flips to warn and recovers
    # after the heal, and the watch's witness joins the replay
    # contract as the sixth stream
    "equivocating_validator": Scenario(
        name="equivocating_validator", rounds=14, fleet=True,
        chainwatch=True,
        world=(("n_validators", 5),),
        timeline=(
            (3, "stripe", 4),
            (6, "equivocate", "validator:1"),
            (9, "heal",),
        ),
        checks=("finalized-prefix", "vote-locks",
                "fleet-consistency"),
        final_checks=("heads-converged",),
    ),
    # the repair plane's mass-failure drill: a wide
    # RS(2, 2) storage plane takes 6 uploads, then TWO miners die at
    # once — every fragment they custody floods the restoral market in
    # one round. The surviving miners bind to the pool engine's
    # REGENERATING codec (ops/regen.py), warm the per-lane repair +
    # fold programs, and sweep the market concurrently in symbol mode
    # (one fragment-sized aggregate ingressed per repair instead of k
    # fragments), while a seeded fault trips every repair-class
    # dispatch on lane 0 mid-storm — the lane's breaker opens (the
    # armed incident reporter captures the bundle), repairs drain
    # through the sibling lanes, and the market still pays exactly one
    # winner per fragment. The repair-* invariants pin it: every
    # completion exactly once with verified bytes, fleet ingress below
    # the whole-fragment baseline, no order left open at the end.
    "repair_storm": Scenario(
        name="repair_storm", rounds=14, pool=3, regen=True,
        world=(("n_validators", 5),
               ("storage", (("n_miners", 6), ("k", 2), ("m", 2)))),
        timeline=(
            (1, "upload", 0, "alice", 16_000, 3),
            (2, "upload", 0, "alice", 16_000, 3),
            (9, "storm_kill", 1, 2),
            (10, "storm_repair"),
            (11, "storm_repair"),
        ),
        faults=(("engine.dispatch.repair.d0", 1.0, "raise"),),
        checks=("finalized-prefix", "vote-locks",
                "repair-exactly-once"),
        final_checks=("restoral-single-winner", "repair-exactly-once",
                      "repair-ingress-bound", "repair-drained",
                      "storage-convergence"),
    ),
    # the autopilot drill: a scripted perf-watchdog edge
    # degrades the encode class mid-run — the remediation plane's
    # perf-pin policy latches the codec breaker held (the class now
    # runs the reference backend) within one observation round, the
    # recovery edge releases it, and a second regression later in the
    # run fires again so its incident bundle embeds a non-empty
    # action-journal tail. The remediation-* invariants run every
    # round: each matched edge must have a journaled decision, each
    # engagement must be visibly latched on the live monitor, and the
    # plane's action-journal witness joins the replay contract as the
    # seventh stream (bit-identical across same-seed runs at any n)
    "perf_regression_autopilot": Scenario(
        name="perf_regression_autopilot", rounds=14, pool=True,
        remediate=True,
        world=(("n_validators", 5),
               ("storage", (("n_miners", 4),))),
        timeline=(
            (1, "upload", 0, "alice", 20_000),
            (3, "perf_edge", "encode", "regressed"),
            (7, "perf_edge", "encode", "ok"),
            (9, "perf_edge", "decode", "regressed"),
            (11, "perf_edge", "decode", "ok"),
        ),
        checks=("finalized-prefix", "vote-locks",
                "remediation-coverage", "remediation-effective"),
        final_checks=("storage-convergence",),
    ),
    # a miner loses a fragment; TWO non-assigned rescuers race the
    # restoral order — both reconstruct, the market pays exactly one
    "restoral_auction": Scenario(
        name="restoral_auction", rounds=14,
        world=(("n_validators", 5),
               ("storage", (("n_miners", 5),))),
        timeline=(
            (1, "upload", 0, "alice", 20_000),
            (8, "drop_fragment", 0),
            (9, "repair_contend"),
        ),
        checks=("finalized-prefix", "vote-locks"),
        final_checks=("restoral-single-winner", "storage-convergence"),
    ),
    # the durability drill: miners die SILENTLY, one at a
    # time — no restoral order filed, no alarm raised by the dying
    # side. The custody plane's ledger (fed by the dispatch/transfer/
    # verdict/repair lineage notes) folds erasure margins over holder
    # liveness every round: each death drops the first file's margin
    # to the at-risk threshold, the `custody.at_risk` edge fires
    # BEFORE any fragment set crosses below k, the remediation
    # plane's custody-repair policy files the restoral order itself
    # and pumps a symbol-mode rebuild until the margin-recovered edge
    # releases it. custody-ledger-consistent re-derives every margin
    # from raw world storage each round; custody-proactive fails the
    # run if any segment ever crosses below k while the autopilot
    # rides. Same seed => byte-identical custody witness at any n
    "miner_attrition": Scenario(
        name="miner_attrition", rounds=14, custody=True,
        remediate=True,
        world=(("n_validators", 5),
               ("storage", (("n_miners", 6), ("k", 2), ("m", 2)))),
        timeline=(
            (1, "upload", 0, "alice", 16_000),
            (5, "attrition",),
            (9, "attrition",),
        ),
        checks=("finalized-prefix", "vote-locks",
                "custody-ledger-consistent", "custody-proactive",
                "remediation-coverage"),
        final_checks=("storage-convergence",),
    ),
}
