"""Chain-plane observability: consensus health, the storage-market
ledger, and byzantine anomaly detection.

The port's own copy of ``cess_tpu/obs/chainwatch.py`` (it imports the
port's ``obs/flight`` and ``obs/trace``, never the JAX package). The
port carries no chain: :func:`node_state` and :func:`market_state` are
duck-typed readers of a node (``head()``, ``chain``, ``headers``,
``finality``, ``keystore``, ``runtime``) and of a chain state
(``iter_prefix``, ``events_of``), so they read the JAX package's
``Node`` and runtime state without importing it.

- :class:`ConsensusWatch`: per-node consensus health from
  :func:`node_state` dicts: head vs finalized height and the lag
  between them, reorg depth (inferred by diffing the canonical-hash
  tail between scans), forks, own-vote-lock ages, slot and era, and an
  equivocation detector (two distinct block hashes claimed by one
  author for one slot, or a conflicting vote pair the finality gadget
  recorded), whose evidence records carry what
  ``offences.report_equivocation`` keys on.
- :class:`MarketWatch`: the storage-market ledger, recomputed each scan
  from chain state: per-miner audit pass/fail with a windowed failure
  spike, declared-vs-audited capacity drift (the fake-capacity
  heuristic), restoral-order accounting and space totals.
- :class:`ChainAnomalyDetector`: edge-triggered ok/bad transitions per
  (class, key), announced like ``FleetBoard``'s: a ``chain.anomaly``
  span plus a ``("chain", "anomaly")`` flight note, FIFO outside the
  detector lock. Classes: ``finality-stall``, ``deep-reorg``,
  ``equivocation``, ``audit-failure-spike``.

:class:`ChainWatch` composes the three behind a scan/seal API shaped
like :class:`~cess_tpu_torch.obs.fleet.FleetPlane`, and folds per-node
finality lag into an attached fleet plane's straggler windows.

Zero cost when off: the module installs no hooks. Determinism: no
wallclock, no entropy; :meth:`ChainWatch.witness` equals the JAX
package's on the same inputs.
"""
from __future__ import annotations

import collections
import json
import threading

from ..constants import FRAGMENT_SIZE
from . import flight as _flight
from . import trace as _trace

# Finality-lag health grading (blocks of lag = head - finalized).
# A healthy sim world finalizes within a round or two; a stalled
# quorum grows lag by ~1/round, so warn trips a few rounds into a
# partition and burning marks a long outage.
LAG_WARN = 3
LAG_BURNING = 9
# Anomaly thresholds.
STALL_LAG = 4        # finality-stall when lag reaches this
DEEP_REORG = 3       # deep-reorg when one scan-to-scan reorg >= this
SPIKE_WINDOW = 8     # audit verdicts per miner considered for a spike
SPIKE_FAILS = 3      # fails inside the window => audit-failure-spike
TAIL = 32            # canonical-hash tail kept per node (reorg diffing)
EQUIVOCATION_WINDOW = 64   # block-number window scanned for doubles


def lag_state(lag: int) -> str:
    """Grade one node's finality lag for the fleet SLO board."""
    if lag > LAG_BURNING:
        return "burning"
    if lag > LAG_WARN:
        return "warn"
    return "ok"


def node_state(node) -> dict:
    """Build one consensus-state dict from a live node (the JAX
    package's ``network.Node``): the unit :meth:`ChainWatch.ingest_state`
    consumes and what rides the fleet gossip frame under the ``"chain"``
    key. Duck-typed: the port carries no chain."""
    head = node.head()
    headn = int(head.number)
    chain = node.chain
    tail = {}
    for n in range(max(0, headn - TAIL), headn + 1):
        tail[str(n)] = chain[n].hash().hex()
    blocks = []
    floor = headn - EQUIVOCATION_WINDOW
    for h, hdr in node.headers.items():
        if hdr.claim is not None and hdr.number > floor:
            blocks.append([hdr.author, int(hdr.claim.slot), h.hex()])
    blocks.sort()
    gadget = node.finality
    locks = []
    for account in sorted(node.keystore):
        for rnd in gadget.locked_rounds(account, headn):
            locks.append([account, int(rnd)])
    votes = []
    for va, vb in gadget.equivocations:
        votes.append([va.voter, int(va.round),
                      va.target_hash.hex(), vb.target_hash.hex()])
    votes.sort()
    return {
        "head": headn,
        "finalized": int(node.finalized),
        "slot": int(head.claim.slot) if head.claim is not None else 0,
        "era": int(node.runtime.staking.current_era()),
        "forks": len(node.headers) - len(chain),
        "tail": tail,
        "blocks": blocks,
        "locks": locks,
        "vote_equivocations": votes,
    }


def market_state(st, *, fragment_size: int) -> dict:
    """Build one market-ledger dict from a chain ``State`` — chain
    state is replicated, so ONE node's runtime (the sim gateway, the
    live node itself) feeds the whole ledger. Recomputed from the
    retained event window each scan: idempotent, no cursors."""
    miners: dict = {}
    for (who,), info in sorted(st.iter_prefix("sminer", "miner")):
        audited = 0
        for _k, _v in st.iter_prefix("file_bank", "frag_of_miner", who):
            audited += fragment_size
        miners[who] = {
            "idle": int(info.idle_space),
            "service": int(info.service_space),
            "lock": int(info.lock_space),
            "state": str(info.state),
            "audited": audited,
        }
    verdicts: dict = {}
    for e in st.events_of("audit", "VerifyResult"):
        d = dict(e.data)
        both = bool(d.get("idle")) and bool(d.get("service"))
        verdicts.setdefault(str(d.get("miner")), []).append(int(both))
    generated = len(st.events_of("file_bank", "GenerateRestoralOrder"))
    claims = len(st.events_of("file_bank", "ClaimRestoralOrder"))
    completed = len(st.events_of("file_bank", "RestoralComplete"))
    open_orders = claimed = 0
    for _k, order in st.iter_prefix("file_bank", "restoral"):
        open_orders += 1
        if getattr(order, "miner", None):
            claimed += 1
    return {
        "miners": miners,
        "verdicts": verdicts,
        "restoral": {
            "open": open_orders, "claimed": claimed,
            "generated": generated, "claims": claims,
            "completed": completed,
        },
    }


class ConsensusWatch:
    """Per-node consensus health, count-sequenced. Fed one
    state dict (:func:`node_state` shape) per node per scan; keeps
    the canonical-hash tail from the previous scan to infer reorgs
    and a (author, slot) -> hashes map to detect double-signing."""

    def __init__(self, *, lock_horizon: int = 32,
                 evidence_cap: int = 256):
        self._mu = threading.Lock()
        self.lock_horizon = int(lock_horizon)
        self._scans = 0
        self._views: dict[str, dict] = {}
        self._tails: dict[str, dict[int, str]] = {}
        self._claims: dict[tuple, set] = {}
        self._evidence: collections.deque = collections.deque(
            maxlen=evidence_cap)
        self._evidence_keys: set = set()
        self._reorgs = 0
        self._max_reorg_depth = 0

    def observe(self, instance: str, state: dict) -> None:
        """Ingest one node's consensus state. Malformed input (a
        hostile or version-skewed gossip peer) is dropped whole —
        never fatal, never partially applied."""
        if not isinstance(state, dict):
            return
        try:
            view, tail = self._digest(str(instance), dict(state))
        except (TypeError, ValueError, KeyError, AttributeError):
            return
        with self._mu:
            self._scans += 1
            inst = str(instance)
            prev = self._tails.get(inst)
            depth = self._reorg_depth(prev, tail)
            if depth:
                self._reorgs += 1
                if depth > self._max_reorg_depth:
                    self._max_reorg_depth = depth
            view["reorg_depth"] = depth
            self._tails[inst] = tail
            self._views[inst] = view
            for author, slot, hex_hash in view.pop("_blocks"):
                key = (author, slot)
                seen = self._claims.setdefault(key, set())
                if hex_hash not in seen:
                    seen.add(hex_hash)
                    if len(seen) >= 2:
                        self._record_evidence({
                            "kind": "block-equivocation",
                            "offender": author, "round": slot,
                            "hashes": sorted(seen),
                        })
            for voter, rnd, ha, hb in view.pop("_votes"):
                self._record_evidence({
                    "kind": "vote-equivocation",
                    "offender": voter, "round": rnd,
                    "hashes": sorted((ha, hb)),
                })

    @staticmethod
    def _digest(instance: str, state: dict) -> tuple[dict, dict]:
        head = int(state["head"])
        finalized = int(state["finalized"])
        tail = {int(n): str(h) for n, h in dict(state["tail"]).items()}
        blocks = [(str(a), int(s), str(h))
                  for a, s, h in state.get("blocks", ())]
        votes = [(str(v), int(r), str(ha), str(hb))
                 for v, r, ha, hb in state.get("vote_equivocations", ())]
        ages = [head - int(r) for _a, r in state.get("locks", ())]
        return ({
            "head": head,
            "finalized": finalized,
            "lag": head - finalized,
            "slot": int(state.get("slot", 0)),
            "era": int(state.get("era", 0)),
            "forks": int(state.get("forks", 0)),
            "locks": len(ages),
            "max_lock_age": max(ages, default=0),
            "_blocks": blocks,
            "_votes": votes,
        }, tail)

    @staticmethod
    def _reorg_depth(prev, tail) -> int:
        """Depth of the reorg between two canonical-hash tails: how
        many blocks below the OLD head changed hash (0 = extension)."""
        if not prev:
            return 0
        old_head = max(prev)
        if tail.get(old_head) in (None, prev[old_head]):
            return 0
        common = 0
        for n in sorted(set(prev) & set(tail)):
            if prev[n] == tail[n]:
                common = n
        return old_head - common

    def _record_evidence(self, record: dict) -> None:
        key = (record["kind"], record["offender"], record["round"])
        if key in self._evidence_keys:
            return
        self._evidence_keys.add(key)
        self._evidence.append(record)

    # -- reading -------------------------------------------------------------
    def views(self) -> dict:
        with self._mu:
            return {inst: dict(v) for inst, v in self._views.items()}

    def evidence(self) -> tuple:
        with self._mu:
            return tuple(dict(e) for e in self._evidence)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "scans": self._scans,
                "lock_horizon": self.lock_horizon,
                "reorgs": self._reorgs,
                "max_reorg_depth": self._max_reorg_depth,
                "nodes": {inst: dict(v)
                          for inst, v in sorted(self._views.items())},
                "equivocations": [dict(e) for e in self._evidence],
            }


class MarketWatch:
    """The storage-market ledger. One :func:`market_state` dict per
    scan replaces the previous ledger view — chain state is already
    cumulative, so recompute-and-replace is idempotent and needs no
    event cursors."""

    def __init__(self, *, spike_window: int = SPIKE_WINDOW,
                 spike_fails: int = SPIKE_FAILS):
        self._mu = threading.Lock()
        self.spike_window = int(spike_window)
        self.spike_fails = int(spike_fails)
        self._scans = 0
        self._miners: dict[str, dict] = {}
        self._restoral = {"open": 0, "claimed": 0, "generated": 0,
                          "claims": 0, "completed": 0}

    def observe(self, market: dict) -> None:
        if not isinstance(market, dict):
            return
        try:
            miners, restoral = self._digest(dict(market))
        except (TypeError, ValueError, KeyError, AttributeError):
            return
        with self._mu:
            self._scans += 1
            self._miners = miners
            self._restoral = restoral

    def _digest(self, market: dict) -> tuple[dict, dict]:
        verdicts = {str(m): [int(bool(v)) for v in vs]
                    for m, vs in dict(market.get("verdicts", {})).items()}
        miners = {}
        for who, info in dict(market.get("miners", {})).items():
            service = int(info["service"])
            audited = int(info.get("audited", 0))
            vs = verdicts.get(str(who), [])
            window = vs[-self.spike_window:]
            fails = window.count(0)
            miners[str(who)] = {
                "idle": int(info["idle"]),
                "service": service,
                "lock": int(info.get("lock", 0)),
                "state": str(info.get("state", "")),
                "audited": audited,
                # fake-capacity heuristic: declared service space not
                # evidenced by stored fragments
                "drift": service - audited,
                "fake_capacity": bool(service > 0
                                      and audited * 2 < service),
                "passes": sum(vs),
                "fails": len(vs) - sum(vs),
                "spike": bool(fails >= self.spike_fails),
            }
        r = dict(market.get("restoral", {}))
        restoral = {k: int(r.get(k, 0))
                    for k in ("open", "claimed", "generated",
                              "claims", "completed")}
        return miners, restoral

    # -- reading -------------------------------------------------------------
    def spikes(self) -> tuple:
        with self._mu:
            return tuple(sorted(m for m, v in self._miners.items()
                                if v["spike"]))

    def snapshot(self) -> dict:
        with self._mu:
            miners = {m: dict(v)
                      for m, v in sorted(self._miners.items())}
            restoral = dict(self._restoral)
            scans = self._scans
        return {
            "scans": scans,
            "miners": miners,
            "restoral": restoral,
            "space": {
                "idle": sum(v["idle"] for v in miners.values()),
                "service": sum(v["service"] for v in miners.values()),
                "pledged": sum(v["lock"] for v in miners.values()),
                "audited": sum(v["audited"] for v in miners.values()),
                "drift": sum(v["drift"] for v in miners.values()),
            },
            "spikes": sorted(m for m, v in miners.items()
                             if v["spike"]),
        }


class ChainAnomalyDetector:
    """Edge-triggered ok↔bad state per (class, key) with a bounded
    count-sequenced transition log. Transitions announce FIFO under
    ``_announce_mu`` OUTSIDE the detector lock — a ``chain.anomaly``
    span plus a ``("chain", "anomaly")`` flight note per edge, which
    obs/incident.py turns into one incident per NEW bad edge."""

    CLASSES = ("finality-stall", "deep-reorg", "equivocation",
               "audit-failure-spike")

    def __init__(self, *, log_cap: int = 512):
        self._mu = threading.Lock()
        self._seq = 0
        self._anomalies = 0
        self._state: dict[tuple, str] = {}
        self._log: collections.deque = collections.deque(maxlen=log_cap)
        # whichever thread holds the announce lock drains everything
        self._announce_mu = threading.RLock()
        self._pending: collections.deque = collections.deque()

    def update(self, cls: str, key: str, bad: bool, **detail) -> None:
        to = "bad" if bad else "ok"
        with self._mu:
            old = self._state.get((cls, key), "ok")
            if old == to:
                return
            self._state[(cls, key)] = to
            self._seq += 1
            if bad:
                self._anomalies += 1
            self._log.append((self._seq, cls, key, old, to))
            self._pending.append((cls, key, old, to, dict(detail)))
        self._drain_announcements()

    def _drain_announcements(self) -> None:
        with self._announce_mu:
            while True:
                with self._mu:
                    if not self._pending:
                        return
                    item = self._pending.popleft()
                self._announce(*item)

    def _announce(self, cls: str, key: str, old: str, to: str,
                  detail: dict) -> None:
        with _trace.span("chain.anomaly", sys="chain", cls=cls,
                         key=key, frm=old, to=to):
            pass
        _flight.note("chain", "anomaly", cls=cls, key=key,
                     frm=old, to=to, **detail)

    # -- reading -------------------------------------------------------------
    def transition_log(self) -> tuple:
        with self._mu:
            return tuple(self._log)

    def active(self) -> dict:
        with self._mu:
            out: dict = {}
            for (cls, key), st in sorted(self._state.items()):
                if st == "bad":
                    out.setdefault(cls, []).append(key)
            return out

    def snapshot(self) -> dict:
        with self._mu:
            state = dict(self._state)
            return {
                "seq": self._seq,
                "anomalies": self._anomalies,
                "active": {
                    cls: [k for (c, k), st in sorted(state.items())
                          if c == cls and st == "bad"]
                    for cls in self.CLASSES},
                "transitions": [list(t) for t in self._log],
            }

    def witness(self) -> bytes:
        """Canonical bytes of the transition log + active set. Two
        same-seed sim runs must return identical bytes."""
        with self._mu:
            canon = {
                "transitions": [list(t) for t in self._log],
                "active": sorted([c, k]
                                 for (c, k), st in self._state.items()
                                 if st == "bad"),
            }
        return json.dumps(canon, sort_keys=True,
                          separators=(",", ":")).encode()


class ChainWatch:
    """The chain plane: ConsensusWatch + MarketWatch +
    ChainAnomalyDetector behind a scan/seal API shaped like
    :class:`~cess_tpu_torch.obs.fleet.FleetPlane`. Scans ingest state;
    :meth:`seal_round` runs the detectors over the latest views (and
    folds per-node finality lag into an attached fleet plane's
    straggler windows) — component locks only, never held across the
    announce path."""

    def __init__(self, instance: str = "node", *,
                 lock_horizon: int = 32,
                 stall_lag: int = STALL_LAG,
                 deep_reorg: int = DEEP_REORG,
                 spike_window: int = SPIKE_WINDOW,
                 spike_fails: int = SPIKE_FAILS,
                 fragment_size: int = FRAGMENT_SIZE):
        self.instance = str(instance)
        self.stall_lag = int(stall_lag)
        self.deep_reorg = int(deep_reorg)
        self.fragment_size = int(fragment_size)
        self.consensus = ConsensusWatch(lock_horizon=lock_horizon)
        self.market = MarketWatch(spike_window=spike_window,
                                  spike_fails=spike_fails)
        self.anomalies = ChainAnomalyDetector()
        self._mu = threading.Lock()
        self._rounds = 0
        self._fleet = None

    def attach_fleet(self, plane) -> None:
        """Fold per-node finality lag into a fleet plane's straggler
        windows at every seal (the SLO-class fold rides the gossip
        frame itself — see :meth:`self_slo`)."""
        self._fleet = plane

    # -- ingestion -----------------------------------------------------------
    def ingest_state(self, instance: str, state: dict) -> None:
        self.consensus.observe(str(instance), state)

    def ingest_market(self, market: dict) -> None:
        self.market.observe(market)

    def ingest_frame(self, frame) -> None:
        """Chain-health side of one fleet gossip frame (the 3-tuple
        ``(instance, exposition, slo_json)``): the sender folds its
        :func:`node_state` dict into the slo dict under ``"chain"``.
        Anything malformed is dropped whole — a hostile peer cannot
        poison the plane."""
        try:
            inst, _expo, slo_json = frame
            slo = json.loads(slo_json)
        except (TypeError, ValueError):
            return
        if not isinstance(slo, dict):
            return
        chain = slo.get("chain")
        if isinstance(chain, dict):
            self.ingest_state(str(inst), chain)

    def scan_node(self, node, instance: str | None = None) -> None:
        """One full scan of a live node: consensus state plus the
        market ledger from its (replicated) runtime state."""
        inst = self.instance if instance is None else str(instance)
        self.ingest_state(inst, node_state(node))
        self.ingest_market(market_state(
            node.runtime.state, fragment_size=self.fragment_size))

    def self_slo(self, node) -> dict:
        """What the sender folds into its fleet gossip frame's slo
        dict: the raw consensus state under ``"chain"`` plus a
        ``finality_lag`` SLO class so every receiver's FleetBoard
        folds this node's lag into its worst/quorum views."""
        state = node_state(node)
        lag = state["head"] - state["finalized"]
        return {"chain": state,
                "targets": {"finality_lag": {"state": lag_state(lag),
                                             "lag": lag}}}

    # -- sealing -------------------------------------------------------------
    def seal_round(self) -> int:
        with self._mu:
            self._rounds += 1
            rnd = self._rounds
        views = self.consensus.views()
        det = self.anomalies
        for inst in sorted(views):
            v = views[inst]
            det.update("finality-stall", inst,
                       v["lag"] >= self.stall_lag,
                       lag=v["lag"], head=v["head"],
                       finalized=v["finalized"])
            det.update("deep-reorg", inst,
                       v["reorg_depth"] >= self.deep_reorg,
                       depth=v["reorg_depth"], head=v["head"])
        for ev in self.consensus.evidence():
            det.update("equivocation",
                       f"{ev['offender']}@{ev['round']}", True,
                       evidence=ev["kind"], offender=ev["offender"],
                       round=ev["round"])
        market = self.market.snapshot()
        for who, m in market["miners"].items():
            det.update("audit-failure-spike", who, m["spike"],
                       fails=m["fails"], passes=m["passes"])
        plane = self._fleet
        if plane is not None:
            for inst in sorted(views):
                plane.stragglers.observe(inst, "finality_lag",
                                         float(views[inst]["lag"]))
        return rnd

    # -- introspection -------------------------------------------------------
    @property
    def rounds(self) -> int:
        with self._mu:
            return self._rounds

    def metrics(self) -> dict:
        """Flat ``cess_chain_*`` gauges for node/metrics.py. The
        consensus gauges read this node's OWN view when present (a
        live node always scans itself), else the worst across views
        (the sim plane watches every node)."""
        with self._mu:
            rounds = self._rounds
        views = self.consensus.views()
        own = views.get(self.instance)
        if own is None and views:
            own = max(views.values(), key=lambda v: v["lag"])
        consensus = self.consensus.snapshot()
        market = self.market.snapshot()
        anomalies = self.anomalies.snapshot()
        m = {
            "cess_chain_rounds": float(rounds),
            "cess_chain_nodes": float(len(views)),
            "cess_chain_reorgs_total": float(consensus["reorgs"]),
            "cess_chain_reorg_depth_max":
                float(consensus["max_reorg_depth"]),
            "cess_chain_equivocations_total":
                float(len(consensus["equivocations"])),
            "cess_chain_anomalies_total":
                float(anomalies["anomalies"]),
            "cess_chain_stalled_nodes":
                float(len(anomalies["active"]["finality-stall"])),
            "cess_chain_market_miners":
                float(len(market["miners"])),
            "cess_chain_audit_fail_spikes":
                float(len(market["spikes"])),
            "cess_chain_capacity_drift_bytes":
                float(market["space"]["drift"]),
            "cess_chain_restoral_open":
                float(market["restoral"]["open"]),
        }
        if own is not None:
            m["cess_chain_head"] = float(own["head"])
            m["cess_chain_finalized"] = float(own["finalized"])
            m["cess_chain_finality_lag"] = float(own["lag"])
            m["cess_chain_forks"] = float(own["forks"])
            m["cess_chain_lock_age_max"] = float(own["max_lock_age"])
        return m

    def snapshot(self) -> dict:
        """The ``cess_chainStatus`` payload."""
        with self._mu:
            rounds = self._rounds
        return {
            "instance": self.instance,
            "rounds": rounds,
            "consensus": self.consensus.snapshot(),
            "market": self.market.snapshot(),
            "anomalies": self.anomalies.snapshot(),
        }

    def witness(self) -> bytes:
        """THE chain-plane replay witness: consensus views + evidence
        + market ledger + anomaly transition log, canonical JSON
        bytes. Two same-seed sim runs must return identical bytes."""
        canon = {
            "consensus": self.consensus.snapshot(),
            "market": self.market.snapshot(),
            "transitions": [list(t)
                            for t in self.anomalies.transition_log()],
        }
        return json.dumps(canon, sort_keys=True,
                          separators=(",", ":")).encode()
