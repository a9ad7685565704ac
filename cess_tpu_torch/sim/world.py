"""The :class:`World` builder and event-driven network driver.

A world is N full :class:`~cess_tpu_torch.node.network.Node` replicas (the
first ``n_validators`` hold session keys and vote) connected by a
seeded topology with per-link virtual latency and loss, driven by one
:class:`~cess_tpu_torch.sim.clock.EventQueue` — no threads, no sockets, no
wall-clock sleeps. Block and vote gossip become queue events delivered
after the link's virtual latency; a lost delivery is simply never
scheduled, and the receiver catches up through the same
``sync_from`` path the live stack uses when an import hits an unknown
parent.

Everything a world does is a pure function of its seed: topology
edges, link latencies, loss draws, role placement and event
tie-breaking all come from SHA-256 streams over ``(seed, site,
counter)`` — the :meth:`FaultPlan.seeded` idiom at network scale.

Fork choice at the authoring seam is the SAME code the in-process
driver uses (:func:`cess_tpu_torch.node.network.author_race`), so behavior
proven here is behavior of the production stack, not of a model.

Devices: a world with a storage plane runs its device work (the
gateways' encodes and tags, the TEE's filler tags and proof checks, the
miners' proofs and repairs) where ``devices`` says. ``None`` means every
visible card and raises without one; ``["cpu"] * n`` is the explicit
host choice. The pipeline and the PoDR2 key lie on the first entry; a
scenario's pool engine takes the whole list as its lanes (one card may be
listed more than once). A world without a storage plane does no device
work and resolves no device.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import heapq

import numpy as np

from .. import constants
from ..node import offchain as _offchain
from ..node.chain_spec import ChainSpec, ValidatorGenesis
from ..node.network import Node, author_race
from ..obs import trace
from ..parallel.mesh import resolve_devices
from .clock import US, EventQueue, SimClock

D = constants.DOLLARS

TOPOLOGIES = ("chain", "ring", "random-degree", "clustered")


def _u64(seed: bytes, *parts) -> int:
    """Deterministic 64-bit draw from a SHA-256 stream over the seed
    and a site label — the only entropy source in this package."""
    label = "|".join(str(p) for p in parts).encode()
    h = hashlib.sha256(b"cess-sim:" + seed + b"|" + label).digest()
    return int.from_bytes(h[:8], "little")


def _unit(seed: bytes, *parts) -> float:
    return _u64(seed, *parts) / 2.0 ** 64


def topology_edges(kind: str, n: int, seed: bytes, degree: int = 4,
                   clusters: int = 4) -> tuple[tuple[int, int], ...]:
    """Seeded topology generator. Every generator yields a CONNECTED
    graph (chain/ring backbones; clusters bridged in a cycle) so a
    fresh world is partitioned only when a scenario says so."""
    if n < 2:
        raise ValueError(f"a world needs >= 2 nodes, got {n}")
    edges: set[tuple[int, int]] = set()

    def link(a: int, b: int) -> None:
        if a != b:
            edges.add((min(a, b), max(a, b)))

    if kind == "chain":
        for i in range(n - 1):
            link(i, i + 1)
    elif kind == "ring":
        for i in range(n):
            link(i, (i + 1) % n)
    elif kind == "random-degree":
        # ring backbone for connectivity + seed-drawn extra links until
        # each node has roughly the requested degree
        for i in range(n):
            link(i, (i + 1) % n)
        for i in range(n):
            for k in range(max(0, degree - 2)):
                link(i, _u64(seed, "edge", i, k) % n)
    elif kind == "clustered":
        if clusters < 1:
            raise ValueError("clustered topology needs clusters >= 1")
        groups: list[list[int]] = [[] for _ in range(clusters)]
        for i in range(n):
            groups[i * clusters // n].append(i)
        for g in groups:
            for a, b in zip(g, g[1:]):
                link(a, b)
            if len(g) > 2:
                link(g[-1], g[0])
        for c in range(clusters):     # bridge clusters in a cycle
            if groups[c] and groups[(c + 1) % clusters]:
                link(groups[c][0], groups[(c + 1) % clusters][0])
    else:
        raise ValueError(f"unknown topology {kind!r}; "
                         f"pick one of {TOPOLOGIES}")
    return tuple(sorted(edges))


class World:
    """Build and drive one simulated network.

    ``latency_ms=(lo, hi)`` bounds per-link latency; every link's
    actual latency is drawn from the seed. ``loss`` is the per-delivery
    loss probability per link (block and vote gossip both). Nodes
    listed in ``dormant`` are built but start offline (scenario
    ``join`` brings them up). The storage plane (gateway, miners, TEE,
    validator OCWs) is attached when a :class:`StorageProfile` is
    given; adversarial miner ordinals store CORRUPTED fragment bytes —
    the audit pipeline must catch them (invariant: audit soundness).
    ``devices``: where the storage plane runs (module doc).
    """

    SLOT_US = US                     # one virtual second per slot
    MAX_LATENCY_S = 0.4              # < half a slot: a slot's gossip
    # (delivery + triggered vote hop) always drains inside the slot

    def __init__(self, seed, n_nodes: int = 100, n_validators: int = 7,
                 topology: str = "random-degree", degree: int = 4,
                 clusters: int = 4, latency_ms=(2.0, 120.0),
                 loss: float = 0.0, chain_id: str = "sim",
                 dormant: tuple = (), storage=None, devices=None):
        if n_validators < 2 or n_validators > n_nodes:
            raise ValueError(f"need 2 <= n_validators <= n_nodes, got "
                             f"{n_validators}/{n_nodes}")
        self.seed = seed if isinstance(seed, bytes) else str(seed).encode()
        self.n = n_nodes
        self.n_validators = n_validators
        self.clock = SimClock()
        self.queue = EventQueue(self.seed, clock=self.clock)
        self.storage = storage
        self.devices = None if storage is None \
            else resolve_devices(devices)

        endowed = [("alice", 1_000_000_000 * D)]
        if storage is not None:
            endowed += storage.endowments()
        spec_kwargs = dict(
            name="sim", chain_id=chain_id, endowed=tuple(endowed),
            validators=tuple(ValidatorGenesis(f"v{i}", 4_000_000 * D)
                             for i in range(n_validators)),
            era_blocks=1000, epoch_blocks=1000, sudo="alice")
        if storage is not None:
            spec_kwargs.update(storage.spec_overrides())
        self.spec = ChainSpec(**spec_kwargs)
        self.nodes = [
            Node(self.spec, f"sim{i}",
                 {f"v{i}": self.spec.session_key(f"v{i}")}
                 if i < n_validators else {})
            for i in range(n_nodes)]
        self._idx = {node.name: i for i, node in enumerate(self.nodes)}

        self.edges = topology_edges(topology, n_nodes, self.seed,
                                    degree=degree, clusters=clusters)
        lo, hi = latency_ms
        lo_us = int(lo * 1000)
        hi_us = min(int(hi * 1000), int(self.MAX_LATENCY_S * US))
        self.latency_us = {
            e: lo_us + int(_unit(self.seed, "lat", *e) * (hi_us - lo_us))
            for e in self.edges}
        self.loss = float(loss)
        self._loss_ordinal: dict[tuple[int, int], int] = {}

        self.alive = [i not in dormant for i in range(n_nodes)]
        self.groups: dict[int, int] | None = None   # node -> partition
        self.slot = 0
        self.last_round_slots = 0
        self.agents: dict[str, object] = {}
        # the fleet observability plane (obs/fleet.py): armed by
        # fleet=True scenarios; None keeps every fleet hook a single
        # attribute load + None check (the zero-cost-off contract)
        self.fleet = None
        # the chain-plane watch (obs/chainwatch.py): armed by
        # chainwatch=True scenarios under the same zero-cost contract
        self.chainwatch = None
        # the custody/durability plane (obs/custody.py): armed by
        # custody=True scenarios under the same zero-cost contract
        self.custody = None
        if storage is not None:
            storage.install(self)

    # -- seeded draws ---------------------------------------------------------
    def u64(self, *parts) -> int:
        return _u64(self.seed, *parts)

    def unit(self, *parts) -> float:
        return _unit(self.seed, *parts)

    def _lost(self, src: int, dst: int) -> bool:
        if not self.loss:
            return False
        n = self._loss_ordinal.get((src, dst), 0)
        self._loss_ordinal[(src, dst)] = n + 1
        return self.unit("loss", src, dst, n) < self.loss

    # -- live graph -----------------------------------------------------------
    def neighbors(self) -> dict[int, list[int]]:
        adj: dict[int, list[int]] = {i: [] for i in range(self.n)
                                     if self.alive[i]}
        for a, b in self.edges:
            if not (self.alive[a] and self.alive[b]):
                continue
            if self.groups is not None \
                    and self.groups.get(a) != self.groups.get(b):
                continue
            adj[a].append(b)
            adj[b].append(a)
        return adj

    def components(self) -> list[list[int]]:
        """Connected components of alive nodes, each sorted, ordered by
        smallest member — a deterministic iteration order."""
        adj = self.neighbors()
        seen: set[int] = set()
        comps = []
        for start in sorted(adj):
            if start in seen:
                continue
            stack, comp = [start], []
            seen.add(start)
            while stack:
                i = stack.pop()
                comp.append(i)
                for j in adj[i]:
                    if j not in seen:
                        seen.add(j)
                        stack.append(j)
            comps.append(sorted(comp))
        return comps

    def path_latency_us(self, src: int) -> dict[int, int]:
        """Shortest virtual path latency from ``src`` to every node it
        can reach (Dijkstra over link latencies) — the gossip arrival
        model: floods take the fastest path."""
        adj = self.neighbors()
        if src not in adj:
            return {}
        dist = {src: 0}
        heap = [(0, src)]
        while heap:
            d, i = heapq.heappop(heap)
            if d > dist.get(i, 1 << 62):
                continue
            for j in adj[i]:
                e = (min(i, j), max(i, j))
                nd = d + self.latency_us[e]
                if nd < dist.get(j, 1 << 62):
                    dist[j] = nd
                    heapq.heappush(heap, (nd, j))
        return dist

    # -- event handlers -------------------------------------------------------
    def _comp_of(self, i: int) -> list[int]:
        for comp in self.components():
            if i in comp:
                return comp
        return [i]

    def _deliver_block(self, src: int, dst: int, block) -> None:
        if not self.alive[dst]:
            return                   # crashed while the bytes flew
        node = self.nodes[dst]
        with trace.span("sim.deliver", sys="sim",
                        block=block.header.number, to=node.name):
            try:
                node.import_block(block)
            except ValueError:
                # unknown parent / finality conflict: the live stack's
                # answer is catch-up sync from the sender
                if self.alive[src]:
                    node.sync_from(self.nodes[src])
            node.finality.apply_pending()
        self._gossip_votes(dst)

    def _deliver_votes(self, dst: int, votes: tuple) -> None:
        if not self.alive[dst]:
            return
        gadget = self.nodes[dst].finality
        for v in votes:
            gadget.on_vote(v)
        gadget.apply_pending()

    def _gossip_votes(self, src: int) -> None:
        """``src`` casts votes for its best chain and re-offers its
        own unfinalized votes (the healing re-gossip discipline of
        ``Network.exchange_votes``), delivered to every reachable node
        after the path latency — lossy like any other delivery."""
        node = self.nodes[src]
        if not node.keystore:
            return
        votes = tuple(node.finality.cast_votes()
                      + node.finality.own_unfinalized_votes())
        if not votes:
            return
        lat = self.path_latency_us(src)
        for dst in sorted(lat):
            if dst == src:
                continue
            if self._lost(src, dst):
                self.queue.mark(f"lost:votes:{src}->{dst}")
                continue
            self.queue.push_at_us(
                self.clock.now_us() + lat[dst],
                f"votes:{src}->{dst}:{len(votes)}",
                lambda d=dst, vs=votes: self._deliver_votes(d, vs))

    # -- slots ----------------------------------------------------------------
    def _author_component(self, slot: int, comp: list[int]) -> int:
        members = [self.nodes[i] for i in comp]
        for node in members:
            node.queue_heartbeats()
        # component-wide tx gossip snapshot: union of member pools in
        # index order, deduped by identity (Network's discipline)
        txs, seen = [], set()
        for node in members:
            for tx in node.tx_pool:
                if id(tx) not in seen:
                    seen.add(id(tx))
                    txs.append(tx)
        txs = tuple(txs)
        candidates = []
        for node in members:
            blk = node.try_author(slot, extrinsics=txs)
            if blk is not None:
                candidates.append((node, blk))
        winner, best, losers = author_race(candidates)
        if winner is None:
            return 0
        for loser, _ in losers:
            loser.abort_proposal(requeue=False)
        included = {id(tx) for tx in best.extrinsics}
        for node in members:
            node.tx_pool[:] = [tx for tx in node.tx_pool
                               if id(tx) not in included]
        winner.commit_proposal()
        src = self._idx[winner.name]
        self.queue.mark(f"author:{slot}:{src}:#{best.header.number}")
        lat = self.path_latency_us(src)
        for dst in sorted(lat):
            if dst == src:
                continue
            if self._lost(src, dst):
                self.queue.mark(
                    f"lost:#{best.header.number}:{src}->{dst}")
                continue
            self.queue.push_at_us(
                self.clock.now_us() + lat[dst],
                f"deliver:#{best.header.number}:{src}->{dst}",
                lambda s=src, d=dst, b=best: self._deliver_block(s, d, b))
        self._gossip_votes(src)
        return 1

    def _run_slot(self, slot: int) -> int:
        # a heal's explicit exchange may have advanced virtual time
        # past this slot's nominal boundary; never run time backwards
        t_us = max(slot * self.SLOT_US, self.clock.now_us())
        self.queue.run_until_us(t_us)
        produced = 0
        for comp in self.components():
            produced += self._author_component(slot, comp)
        # a slot's whole gossip cascade lands before the next slot
        # (latency is clamped under half a slot)
        self.queue.run_until_us(t_us + self.SLOT_US)
        return produced

    def run_round(self, max_slots: int = 16) -> int:
        """Advance slots until at least one component produces a block
        (a round). Returns blocks produced; records how many slots the
        round took (the liveness signal the SLO board watches)."""
        produced = 0
        slots = 0
        while produced == 0:
            if slots >= max_slots:
                break
            self.slot += 1
            slots += 1
            produced += self._run_slot(self.slot)
        self.last_round_slots = slots
        return produced

    def run_rounds(self, count: int) -> int:
        total = 0
        for _ in range(count):
            total += self.run_round()
        return total

    # -- churn / partitions ---------------------------------------------------
    def crash(self, i: int) -> None:
        """Fail-stop: state kept (a restart resumes from it)."""
        self.alive[i] = False
        self.queue.mark(f"crash:{i}")

    def leave(self, i: int) -> None:
        self.alive[i] = False
        self.queue.mark(f"leave:{i}")

    def restart(self, i: int) -> None:
        """Crash-restart (or first join of a dormant node): come back
        up and catch up from the best alive neighbor."""
        self.alive[i] = True
        self.queue.mark(f"restart:{i}")
        adj = self.neighbors()
        peers = [j for j in adj.get(i, ()) if self.alive[j]]
        if not peers:
            return
        best = max(peers, key=lambda j: (
            self.nodes[j].chain[-1].number, -j))
        self.nodes[i].sync_from(self.nodes[best])
        self.nodes[i].finality.apply_pending()
        self._gossip_votes(i)

    join = restart

    def set_partition(self, groups) -> None:
        """``groups``: iterable of node-index groups; links crossing
        group boundaries go dead until :meth:`heal`."""
        mapping: dict[int, int] = {}
        for g, members in enumerate(groups):
            for i in members:
                mapping[i] = g
        self.groups = mapping
        self.queue.mark(
            "partition:" + ":".join(
                ",".join(str(i) for i in sorted(members))
                for members in groups))

    def stripe_partition(self, k: int = 2) -> None:
        """Partition into k interleaved stripes (node i -> group i%k),
        splitting validators about evenly across the sides."""
        self.set_partition([[i for i in range(self.n) if i % k == g]
                            for g in range(k)])

    def heal(self) -> None:
        """Reconnect everything and run the explicit catch-up exchange
        the live partition test uses: everyone syncs the best head,
        the best head syncs everyone (so both sides' justifications
        and blocks meet), then validators re-offer their votes."""
        self.groups = None
        self.queue.mark("heal")
        alive = [i for i in range(self.n) if self.alive[i]]
        if not alive:
            return
        ref = max(alive, key=lambda i: (
            self.nodes[i]._weight(self.nodes[i].chain[-1].hash()), -i))
        ref_node = self.nodes[ref]
        # pull each DISTINCT competing head into the reference node
        # (one sync per branch, not per node)
        seen_heads = {ref_node.chain[-1].hash()}
        for i in alive:
            h = self.nodes[i].chain[-1].hash()
            if i != ref and h not in seen_heads:
                seen_heads.add(h)
                ref_node.sync_from(self.nodes[i])
        for i in alive:
            if i != ref:
                self.nodes[i].sync_from(ref_node)
                self.nodes[i].finality.apply_pending()
        for i in alive:
            self._gossip_votes(i)
        self.queue.run_until_us(
            self.clock.now_us() + self.SLOT_US)

    # -- views ----------------------------------------------------------------
    def alive_nodes(self) -> list[Node]:
        return [n for i, n in enumerate(self.nodes) if self.alive[i]]

    def validator_indices(self) -> list[int]:
        return list(range(self.n_validators))

    def finalized_prefix(self) -> tuple[tuple[int, bytes], ...]:
        """(finalized height, hash at that height) per alive node — the
        consensus half of the replay witness."""
        out = []
        for i, node in enumerate(self.nodes):
            if not self.alive[i]:
                continue
            f = node.finalized
            out.append((f, node.chain[f].hash()))
        return tuple(out)


# -- the storage plane --------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StorageProfile:
    """How much storage plane to bolt onto a world: miners, gateways,
    one TEE, TEE-certified fillers, and a validator OCW per validator
    (challenge proposals need a 2/3 match). ``adversarial_miners``
    names miner ordinals that STORE corrupted fragment bytes while
    reporting clean transfers — the attack the audit must catch."""

    n_miners: int = 4
    n_gateways: int = 1
    # space accounting is in PROTOCOL units (FRAGMENT_SIZE = 8 MiB per
    # filler) however small the test payloads are: alice's 1 GiB
    # purchase needs >= 128 fillers of unsold idle space world-wide
    fillers_per_miner: int = 40
    buy_gib: int = 1
    segment_size: int = 16 * 1024
    adversarial_miners: tuple = ()
    # RS geometry of the storage pipeline. The default matches the
    # live storage-net tests; the repair storm widens to (2, 2) so a
    # batch miner kill leaves every segment k-recoverable.
    k: int = 2
    m: int = 1

    def endowments(self) -> list[tuple[str, int]]:
        out = [("tee0", 1_000 * D), ("stash0", 10_000_000 * D)]
        out += [(f"gw{j}", 1_000_000 * D) for j in range(self.n_gateways)]
        out += [(f"m{j}", 10_000 * D) for j in range(self.n_miners)]
        return out

    def spec_overrides(self) -> dict:
        # the tight audit cadence the live storage-net tests run under;
        # fragment_count tracks the profile's RS geometry so deals
        # assign one distinct miner per row (k + m = 3 at the defaults
        # == constants.FRAGMENT_COUNT: zero change unless overridden)
        return {"audit_challenge_life": 6, "audit_verify_life": 8,
                "fragment_count": self.k + self.m}

    def _place_roles(self, world: World) -> dict[str, int]:
        """Seed-drawn home nodes for every storage role, preferring
        non-validator nodes (validators host the OCWs)."""
        pool = [i for i in range(world.n_validators, world.n)
                if world.alive[i]]
        if len(pool) < self.n_miners + self.n_gateways + 1:
            pool = [i for i in range(world.n) if world.alive[i]]
        homes: dict[str, int] = {}
        for name in ([f"gw{j}" for j in range(self.n_gateways)]
                     + [f"m{j}" for j in range(self.n_miners)]
                     + ["tee0"]):
            pick = pool[world.u64("role", name) % len(pool)]
            homes[name] = pick
            if len(pool) > 1:
                pool.remove(pick)
        return homes

    def install(self, world: World) -> None:
        from ..chain.attestation import issue_cert, issue_report
        from ..models.pipeline import PipelineConfig
        from ..node.offchain import (AgentPipeline, MinerAgent, OssGateway,
                                     TeeAgent, ValidatorOcw)
        from ..ops import podr2

        cfg = PipelineConfig(k=self.k, m=self.m,
                             segment_size=self.segment_size)
        dev = world.devices[0]
        key = podr2.Podr2Key.generate(7, device=dev)
        pipe = AgentPipeline(cfg, podr2_key=key, device=dev)
        world.pipeline = pipe
        homes = self._place_roles(world)
        world.role_homes = homes

        kp = _sim_rsa_keypair(1024, 5)
        signer_kp = _sim_rsa_keypair(1024, 6)
        mr = b"\x02" * 32
        for node in world.nodes:
            node.runtime.apply_extrinsic("root",
                                         "tee_worker.update_whitelist", mr)
            node.runtime.apply_extrinsic("root",
                                         "tee_worker.pin_ias_signer",
                                         kp.public)
            node.runtime.fund("sminer_reward_pool", 10_000 * D)
        cert = issue_cert(kp, "ias-signer", signer_kp.public)
        report, rsig = issue_report(signer_kp, mr, b"tee-pk", "tee0")
        tee_node = world.nodes[homes["tee0"]]
        # BLS-less TEE: verdicts go unsealed (empty bls_pk is accepted
        # at registration) — pure-Python pairings would dominate the
        # simulation's run time for no extra coverage here
        tee_node.submit_extrinsic("tee0", "tee_worker.register", "stash0",
                                  b"tp", b"tee-pk", report, rsig, (cert,),
                                  b"", b"")
        for j in range(self.n_miners):
            m = f"m{j}"
            world.nodes[homes[m]].submit_extrinsic(
                m, "sminer.regnstk", m, b"p" + m.encode(), 2000 * D)
        world.run_rounds(2)

        gws = [OssGateway(world.nodes[homes[f"gw{j}"]], f"gw{j}", pipe)
               for j in range(self.n_gateways)]
        tee = TeeAgent(tee_node, "tee0", key, cfg.blocks_per_fragment)
        miners = []
        for j in range(self.n_miners):
            cls = AdversarialMiner if j in self.adversarial_miners \
                else MinerAgent
            miners.append(cls(world.nodes[homes[f"m{j}"]], f"m{j}",
                              gws, pipe, clock=world.clock))
        for m in miners:
            m.setup_fillers(tee, self.fillers_per_miner)
        world.run_rounds(2)
        alice_node = world.nodes[homes["gw0"]]
        alice_node.submit_extrinsic("alice", "storage_handler.buy_space",
                                    self.buy_gib)
        for j in range(self.n_gateways):
            alice_node.submit_extrinsic("alice", "oss.authorize", f"gw{j}")
        world.run_rounds(1)
        gws[0].node.submit_extrinsic("gw0", "file_bank.create_bucket",
                                     "alice", "photos")
        world.run_rounds(1)

        for m in miners:
            world.nodes[world._idx[m.node.name]].offchain_agents.append(m)
        tee_node.offchain_agents.append(tee)
        for i in range(world.n_validators):
            world.nodes[i].offchain_agents.append(
                ValidatorOcw(f"v{i}", world.spec.session_key(f"v{i}")))
        world.agents = {a.account: a for a in miners}
        world.agents.update({g.account: g for g in gws})
        world.agents["tee0"] = tee
        world.gateways = gws
        world.miners = miners
        world.tee = tee


@functools.lru_cache(maxsize=8)
def _sim_rsa_keypair(bits: int, seed: int):
    """Seeded RSA keygen is deterministic but prime-search slow; every
    same-seed world shares the pair."""
    from ..crypto.rsa import generate_rsa_keypair

    return generate_rsa_keypair(bits, seed=seed)


class AdversarialMiner(_offchain.MinerAgent):
    """Serves audits from CORRUPTED storage: the fetched fragment
    passes the transfer integrity check, then every block gets a byte
    flipped before it lands on disk — the transfer report looks clean,
    the stored bytes do not match the on-chain hash, and the next
    service audit's proof folds over the corrupt bytes. Audit
    soundness demands the TEE verdict comes back service=False."""

    def _transfer(self, gw, frag_hash):
        blob = super()._transfer(gw, frag_hash)
        if blob is None:
            return None
        # corrupt EVERY 64-byte PoDR2 block: challenges sample a block
        # subset, and a single flipped byte escapes rounds that don't
        # draw its block — whole-fragment corruption makes the audit
        # failure deterministic, which the soundness invariant needs
        return (np.frombuffer(blob, np.uint8) ^ 0xA5).tobytes()
