"""Remediation plane: detector edges -> journaled recovery actions.

The port's own copy of ``cess_tpu/serve/remediate.py`` (it imports the
port's ``obs/flight``, never the JAX package). A count-sequenced policy
engine subscribes to the flight-note edges the detectors announce and
maps each to an action through seams that already exist:

- perf regression     -> pin the class to the reference backend
                         (``HealthMonitor.hold_open`` on the engine's
                         breaker), ``release`` on recovery;
- breaker trip        -> latch the tripped monitor held, re-probe
                         after a cooldown;
- fleet straggler     -> quarantine the lane: hold its per-lane
                         breakers so ``DevicePool`` placement avoids it
                         and its in-flight work drains to siblings;
- chain equivocation  -> file ``offences.report_equivocation`` from the
                         node's own vote evidence;
- repair-ingress      -> flip a miner's ``repair_mode`` between
  regression             "symbols" and whole fragments;
- custody at-risk     -> rebuild the segment's unhealthy fragments.

The chain-half seams (``bind_node``, ``bind_miners``,
``bind_custody``) are duck-typed: the port carries no node and no
miner agent, and binds the JAX package's in the tests.

Every decision goes through a declarative :class:`Policy` table
(trigger edge -> guard -> action -> release condition) with per-policy
count-based rate limits and cooldowns, and lands in a bounded journal
that is the replay witness: the plane reads no clock and draws no
entropy, so the same edges give a byte-identical ``witness()``, acting
or ``dry_run`` (``applied`` is not part of it). A policy that fires,
releases and re-fires inside its cooldown is flapping: the plane
journals a ``flap`` entry and notes ``("remediation", "flap")``.

Lock discipline: decisions are made under the plane's ``_mu``; seam
calls (``hold_open``/``release``, ``submit_extrinsic``,
``set_repair_mode``) and flight notes happen after it is released. The
plane's lock may nest over a HealthMonitor's, never the reverse.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import threading
from typing import Any

from ..obs import flight as _flight

__all__ = ["Policy", "RemediationPlane", "default_policies"]

# action verbs a Policy row may name; engage/disengage semantics live
# in RemediationPlane._apply
ACTIONS = ("pin-reference", "quarantine-lane", "file-offence",
           "flip-repair-mode", "proactive-repair")

# one-shot actions complete at fire time (nothing to hold, nothing to
# release); the rest stay "engaged" until their release condition
_ONE_SHOT = frozenset(("file-offence",))

# class -> backend monitor name; mirrors SubmissionEngine._BACKEND_OF
# (read from the bound engine when one is attached)
_CLASS_BACKEND = {"encode": "codec", "decode": "codec",
                  "repair": "codec", "tag": "audit", "prove": "audit",
                  "verify_batch": "audit", "verify_agg": "audit"}

# detector notes folded into the evidence map (snapshot context for
# humans; never actions by themselves)
_EVIDENCE = frozenset((("slo", "transition"), ("breaker", "trip"),
                       ("breaker", "hold"), ("breaker", "release"),
                       ("breaker", "recover"), ("perf", "regression"),
                       ("chain", "anomaly"), ("fleet", "outlier"),
                       ("repair", "fallback"), ("repair", "mode"),
                       ("custody", "at_risk"), ("custody", "lost")))


@dataclasses.dataclass(frozen=True)
class Policy:
    """One declarative remediation rule: trigger edge -> guard ->
    action -> release condition.

    ``trigger`` is a ``(subsystem, kind)`` flight-note edge; ``match``
    is the guard — ``((field, value), ...)`` pairs the note's detail
    must carry verbatim. ``key_field`` names the detail field whose
    value keys the engagement (one engagement per key); empty means
    the policy itself is the key. ``release_on``/``release_match``
    name the edge that releases an engagement ("recovered");
    ``release_after`` is the count-based re-probe fallback: after that
    many plane ticks the engagement releases unconditionally (0 =
    never auto-release). ``cooldown`` is the minimum tick gap between
    fires per key; ``max_fires`` the lifetime cap per policy — both
    COUNT-based, never wall-clock."""

    name: str
    trigger: tuple
    action: str
    match: tuple = ()
    key_field: str = ""
    release_on: tuple = ()
    release_match: tuple = ()
    release_after: int = 8
    cooldown: int = 4
    max_fires: int = 64
    enabled: bool = True

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown action {self.action!r}; "
                             f"choose from {ACTIONS}")
        if self.cooldown < 0 or self.max_fires < 1 \
                or self.release_after < 0:
            raise ValueError("cooldown/release_after must be >= 0 and "
                             "max_fires >= 1")

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d["trigger"] = list(self.trigger)
        d["match"] = [list(p) for p in self.match]
        d["release_on"] = list(self.release_on)
        d["release_match"] = [list(p) for p in self.release_match]
        return d


def default_policies() -> tuple:
    """The shipped policy table — one row per detector altitude."""
    return (
        # PerfWatchdog edge: live GiB/s collapsed vs the measured
        # baseline. Pin the class to the reference backend; release on
        # the recovery edge, or re-probe after release_after ticks
        # (while pinned the watchdog only sees the reference path, so
        # a count-based re-probe is the only honest recovery check).
        Policy(name="perf-pin", trigger=("perf", "regression"),
               match=(("to", "regressed"),), key_field="metric",
               action="pin-reference",
               release_on=("perf", "regression"),
               release_match=(("to", "ok"),),
               release_after=8, cooldown=4, max_fires=64),
        # A window-tripped breaker keeps paying probe failures against
        # a dead backend; latch it held, re-probe after the cooldown.
        Policy(name="breaker-pin", trigger=("breaker", "trip"),
               match=(), key_field="name", action="pin-reference",
               release_after=12, cooldown=8, max_fires=64),
        # Fleet straggler: hold the lane's per-device breakers so
        # placement avoids it and DevicePool.requeue drains in-flight
        # work to siblings; re-probe after release_after ticks.
        Policy(name="straggler-quarantine",
               trigger=("fleet", "outlier"), match=(),
               key_field="instance", action="quarantine-lane",
               release_after=16, cooldown=8, max_fires=32),
        # Chainwatch equivocation edge: file the offence on-chain from
        # the node's own signed vote evidence. One-shot; the on-chain
        # AlreadyReported dedup backstops the per-key cooldown.
        Policy(name="equivocation-report",
               trigger=("chain", "anomaly"),
               match=(("cls", "equivocation"),), key_field="key",
               action="file-offence", release_after=0,
               cooldown=1_000_000, max_fires=32),
        # Repair-ingress regression (sampled by tick(), synthesized as
        # a ("remediation", "ingress") edge): symbol-mode repairs are
        # ingressing more than the configured bound per recovered byte
        # — flip the miner to whole-fragment mode, flip back to
        # re-probe after release_after ticks.
        Policy(name="repair-ingress",
               trigger=("remediation", "ingress"), match=(),
               key_field="miner", action="flip-repair-mode",
               release_after=12, cooldown=6, max_fires=32),
        # Custody at-risk edge (obs/custody.py): a segment's erasure
        # margin fell to the detector threshold — proactively rebuild
        # its unhealthy fragments through the regenerating symbol path
        # (1.0 fragment-equivalents of ingress per rebuild) BEFORE the
        # k-th fragment dies. Engaged until the margin-recovered edge
        # releases it; each tick in between re-attempts the rebuild
        # (the filed restoral order only applies one block later).
        Policy(name="custody-repair", trigger=("custody", "at_risk"),
               match=(("to", "bad"),), key_field="key",
               action="proactive-repair",
               release_on=("custody", "at_risk"),
               release_match=(("to", "ok"),),
               release_after=8, cooldown=2, max_fires=64),
    )


def _match(pairs: tuple, detail: dict) -> bool:
    for field, value in pairs:
        if detail.get(field) != value:
            return False
    return True


def _canon_detail(detail: dict) -> dict:
    """JSON-canonical copy of a note detail: strings/ints/bools pass
    through, floats round to 3 places, everything else reprs — the
    journal is part of the replay witness, so every value must
    serialize byte-identically."""
    out = {}
    for k in sorted(detail):
        v = detail[k]
        if isinstance(v, bool) or isinstance(v, (str, int)):
            out[str(k)] = v
        elif isinstance(v, float):
            out[str(k)] = round(v, 3)
        else:
            out[str(k)] = repr(v)
    return out


class RemediationPlane:
    """Count-sequenced policy engine over the flight-note edge stream.

    Wire-up: ``recorder.add_listener(plane.on_note)`` feeds the edges;
    ``bind_engine``/``bind_node``/``bind_miners`` attach the action
    seams; a driver (the sim round loop, the net author loop) calls
    ``tick()`` once per observation round — edges observed since the
    last tick are decided and applied there, in arrival order, so the
    edge->action latency is exactly one observation round and the
    journal order is a pure function of the input edge order."""

    def __init__(self, seed: bytes = b"", policies=None, *,
                 dry_run: bool = False, journal_cap: int = 256,
                 edge_cap: int = 256, reporter: str = "root",
                 ingress_bound: float = 1.5):
        if journal_cap < 1 or edge_cap < 1:
            raise ValueError("journal_cap/edge_cap must be >= 1")
        pols = tuple(default_policies() if policies is None
                     else policies)
        names = [p.name for p in pols]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate policy names: {names}")
        self._seed = bytes(seed)
        self._policies = pols
        self.dry_run = bool(dry_run)
        self._reporter = reporter
        self._ingress_bound = float(ingress_bound)
        self._by_trigger: dict[tuple, list] = {}
        self._by_release: dict[tuple, list] = {}
        for p in pols:
            self._by_trigger.setdefault(tuple(p.trigger), []).append(p)
            if p.release_on:
                self._by_release.setdefault(
                    tuple(p.release_on), []).append(p)
        self._by_name = {p.name: p for p in pols}
        self._mu = threading.Lock()
        self._count = 0                 # plane ticks (observation rounds)
        self._journal: collections.deque = collections.deque(
            maxlen=journal_cap)
        self._journal_total = 0
        self._edges: collections.deque = collections.deque(
            maxlen=edge_cap)
        self._edge_total = 0
        self._pending_fire: list = []   # (policy, key, edge_id, detail)
        self._pending_release: list = []            # (policy, key)
        self._engaged: dict[tuple, dict] = {}       # (policy, key) ->
        self._fires: dict[str, int] = {}            # policy -> count
        self._last_fire: dict[tuple, int] = {}      # (policy, key) -> tick
        self._released_at: dict[tuple, int] = {}    # (policy, key) -> tick
        self._health: dict[str, dict] = {"slo": {}, "breaker": {},
                                         "perf": {}, "chain": {},
                                         "fleet": {}, "repair": {},
                                         "custody": {}}
        self._engine = None
        self._node = None
        self._custody = None
        self._miners: dict[str, Any] = {}
        self._intended_mode: dict[str, str] = {}
        self._ingress_last: dict[str, tuple] = {}
        self._applied = 0
        self._skipped = 0
        self._suppressed = 0
        self._releases = 0
        self._flaps = 0

    # -- seam binding --------------------------------------------------------
    def bind_engine(self, engine) -> None:
        """Attach the submission engine whose monitors (and pool lane
        breakers) pin/quarantine actions act through."""
        with self._mu:
            self._engine = engine

    def bind_node(self, node) -> None:
        """Attach the node whose finality evidence and extrinsic
        surface the file-offence action uses."""
        with self._mu:
            self._node = node

    def bind_custody(self, plane) -> None:
        """Attach the custody plane (obs/custody.py) whose
        at-risk-segment repair targets the proactive-repair action
        rebuilds through the bound miners."""
        with self._mu:
            self._custody = plane

    def bind_miners(self, miners) -> None:
        """Attach the miner agents whose repair_mode the ingress
        policy may flip. The plane tracks each miner's INTENDED mode
        itself (seeded from the live attribute here) so dry-run
        decisions evolve identically to acting ones."""
        with self._mu:
            for m in miners:
                acct = m.account
                self._miners[acct] = m
                self._intended_mode[acct] = m.repair_mode
                self._ingress_last[acct] = (
                    int(m.repair_ingress_bytes),
                    int(m.repair_recovered_bytes))

    # -- the edge stream (FlightRecorder listener) ---------------------------
    def on_note(self, seq: int, subsystem: str, kind: str,
                detail: dict) -> None:
        """Journal-listener entry point: record matching trigger and
        release edges for the next tick. Never acts here — the noting
        thread may sit inside another subsystem's announce path."""
        trig = (subsystem, kind)
        pols = self._by_trigger.get(trig)
        rels = self._by_release.get(trig)
        if pols is None and rels is None and trig not in _EVIDENCE:
            return
        with self._mu:
            self._observe_evidence_locked(subsystem, kind, detail)
            for p in pols or ():
                if not p.match or _match(p.match, detail):
                    self._record_edge_locked(p, detail, int(seq))
            for p in rels or ():
                if _match(p.release_match, detail):
                    key = str(detail.get(p.key_field, p.name)) \
                        if p.key_field else p.name
                    self._pending_release.append((p.name, key))

    def _record_edge_locked(self, p: Policy, detail: dict,
                     seq: int) -> None:
        """Caller holds ``_mu``. Every guard-passing trigger edge is
        recorded — including for a DISABLED policy, which is exactly
        what the ``remediation-coverage`` invariant catches (an edge
        the table matched but nobody journaled a decision for)."""
        key = str(detail.get(p.key_field, p.name)) if p.key_field \
            else p.name
        self._edge_total += 1
        self._edges.append({"id": self._edge_total, "seq": seq,
                            "tick": self._count, "policy": p.name,
                            "key": key})
        if p.enabled:
            self._pending_fire.append(
                (p.name, key, self._edge_total,
                 _canon_detail(detail)))

    def _observe_evidence_locked(self, subsystem: str, kind: str,
                          detail: dict) -> None:
        """Caller holds ``_mu``: fold detector notes into the bounded
        per-subsystem evidence map (snapshot context only)."""
        h = self._health.get(subsystem)
        if h is None:
            return
        if subsystem == "slo":
            h[str(detail.get("cls", "?"))] = str(detail.get("to", "?"))
        elif subsystem == "breaker":
            h[str(detail.get("name", "?"))] = kind
        elif subsystem == "perf":
            h[str(detail.get("metric", "?"))] = str(
                detail.get("to", "?"))
        elif subsystem == "chain":
            h[str(detail.get("key", "?"))] = str(
                detail.get("to", detail.get("cls", "?")))
        elif subsystem == "fleet":
            h[str(detail.get("instance", "?"))] = str(
                detail.get("metric", "?"))
        elif subsystem == "repair":
            h[str(detail.get("miner", "?"))] = str(
                detail.get("to", kind))
        elif subsystem == "custody":
            h[str(detail.get("key", "?"))] = \
                f"{kind}:{detail.get('to', '?')}"
        while len(h) > 64:           # bounded: evict oldest insertion
            h.pop(next(iter(h)))

    # -- the decision round --------------------------------------------------
    def tick(self) -> int:
        """Advance one observation round: sample the repair-ingress
        ratios, decide every pending release and fire in arrival
        order, then apply the decided actions OUTSIDE the plane lock
        (adaptive.py discipline). Returns the number of journal
        entries this round."""
        todo: list = []
        notes: list = []
        pumps: list = []
        with self._mu:
            self._count += 1
            self._sample_ingress_locked()
            # releases decide before fires so a recover-edge and a
            # fresh trigger landing in the same round re-engage (and
            # register as a flap when inside the cooldown window)
            for pname, key in self._pending_release:
                self._decide_release_locked(pname, key, "recovered", todo,
                                     notes)
            self._pending_release = []
            for (pname, key), eng in sorted(self._engaged.items()):
                p = self._by_name[pname]
                if p.release_after > 0 and \
                        self._count - eng["fired_tick"] \
                        >= p.release_after:
                    self._decide_release_locked(pname, key, "re-probe", todo,
                                         notes)
            # engagements that survived the release pass pump one
            # rebuild attempt per tick: the fire-time attempt usually
            # only FILES the restoral order (applied a block later),
            # so the engagement retries until the margin-recovered
            # edge releases it. Decisions are unaffected (no journal
            # entry), so a dry run's witness stays byte-identical.
            if not self.dry_run:
                pumps = [key for (pname, key), eng
                         in sorted(self._engaged.items())
                         if eng["action"] == "proactive-repair"]
            entries = 0
            for pname, key, edge_id, detail in self._pending_fire:
                self._decide_fire_locked(pname, key, edge_id, detail, todo,
                                  notes)
                entries += 1
            self._pending_fire = []
        for key in pumps:
            self._proactive_repair(key)
        for kind, args in todo:
            ok = self._apply(kind, args)
            args[0]["applied"] = ok
            if ok:
                self._applied += 1
            else:
                self._skipped += 1
        for kind, detail in notes:
            _flight.note("remediation", kind, **detail)
        return entries

    def _journal_entry_locked(self, event: str, policy: str, action: str,
                       key: str, reason: str, edge: int,
                       detail: dict) -> dict:
        """Caller holds ``_mu``. ``applied`` is bookkeeping for humans
        (dry-run vs acting) and is excluded from the witness."""
        self._journal_total += 1
        ent = {"seq": self._journal_total, "tick": self._count,
               "event": event, "policy": policy, "action": action,
               "key": key, "reason": reason, "edge": edge,
               "detail": detail, "applied": False}
        self._journal.append(ent)
        return ent

    def _decide_fire_locked(self, pname: str, key: str, edge_id: int,
                     detail: dict, todo: list, notes: list) -> None:
        p = self._by_name[pname]
        ekey = (pname, key)
        fired = self._fires.get(pname, 0)
        if fired >= p.max_fires:
            reason = "rate-limit"
        elif ekey in self._engaged:
            reason = "engaged"
        elif self._count - self._last_fire.get(ekey, -p.cooldown - 1) \
                <= p.cooldown:
            reason = "cooldown"
        else:
            reason = ""
        if reason:
            self._journal_entry_locked("suppress", pname, p.action, key,
                                reason, edge_id, detail)
            self._suppressed += 1
            return
        self._fires[pname] = fired + 1
        self._last_fire[ekey] = self._count
        ent = self._journal_entry_locked("fire", pname, p.action, key, "",
                                  edge_id, detail)
        if p.action not in _ONE_SHOT:
            self._engaged[ekey] = {"fired_tick": self._count,
                                   "edge": edge_id,
                                   "action": p.action}
        if p.action == "flip-repair-mode":
            self._intended_mode[key] = "fragments"
        todo.append((("engage", p.action), (ent, key, pname, detail)))
        notes.append(("action", {"policy": pname, "action": p.action,
                                 "key": key}))
        rel = self._released_at.get(ekey)
        if rel is not None and self._count - rel <= p.cooldown:
            self._journal_entry_locked("flap", pname, p.action, key,
                                "refire-inside-cooldown", edge_id, {})
            self._flaps += 1
            notes.append(("flap", {"policy": pname,
                                   "action": p.action, "key": key,
                                   "gap": self._count - rel}))

    def _decide_release_locked(self, pname: str, key: str, reason: str,
                        todo: list, notes: list) -> None:
        p = self._by_name.get(pname)
        eng = self._engaged.pop((pname, key), None)
        if p is None or eng is None:
            return
        self._released_at[(pname, key)] = self._count
        self._releases += 1
        if p.action == "flip-repair-mode":
            self._intended_mode[key] = "symbols"
        ent = self._journal_entry_locked("release", pname, p.action, key,
                                  reason, eng["edge"], {})
        todo.append((("release", p.action), (ent, key, pname, {})))
        notes.append(("release", {"policy": pname, "action": p.action,
                                  "key": key, "reason": reason}))

    def _sample_ingress_locked(self) -> None:
        """Caller holds ``_mu``. The repair-ingress edge is SAMPLED
        from the miners' accounting counters rather than subscribed —
        there is no detector note for it — and synthesized through the
        same edge path every note-driven policy uses. The mode gate
        reads the plane's INTENDED mode, not the live attribute, so a
        dry run's decisions match the acting run's."""
        pols = [p for p in self._by_trigger.get(
            ("remediation", "ingress"), ())]
        if not pols or not self._miners:
            return
        for acct in sorted(self._miners):
            if self._intended_mode.get(acct) != "symbols":
                continue
            m = self._miners[acct]
            ing = int(m.repair_ingress_bytes)
            rec = int(m.repair_recovered_bytes)
            last_ing, last_rec = self._ingress_last.get(acct, (0, 0))
            self._ingress_last[acct] = (ing, rec)
            d_rec = rec - last_rec
            if d_rec <= 0:
                continue
            ratio = round((ing - last_ing) / d_rec, 3)
            if ratio <= self._ingress_bound:
                continue
            detail = {"miner": acct, "ratio": ratio,
                      "bound": self._ingress_bound}
            for p in pols:
                self._record_edge_locked(p, detail, 0)

    # -- action seams (called OUTSIDE the plane lock) ------------------------
    def _apply(self, kind: tuple, args: tuple) -> bool:
        step, action = kind
        ent, key, pname, detail = args
        if self.dry_run:
            return False
        engage = step == "engage"
        if action == "pin-reference":
            mons = self._pin_monitors(key)
        elif action == "quarantine-lane":
            mons = self._lane_monitors(key)
        elif action == "file-offence":
            return self._file_offence(key)
        elif action == "flip-repair-mode":
            return self._flip_mode(key, engage)
        elif action == "proactive-repair":
            if not engage:
                return True          # release: nothing held
            return self._proactive_repair(key)
        else:
            return False
        for mon in mons:
            if engage:
                mon.hold_open(reason=f"remediation:{pname}")
            else:
                mon.release()
        return bool(mons)

    def _pin_monitors(self, key: str) -> list:
        """Resolve a pin key — a monitor name (``codec``,
        ``audit.d1``), an op class, or a watchdog metric name — to the
        HealthMonitor(s) to latch."""
        eng = self._engine
        if eng is None:
            return []
        mons = dict(eng.monitors)
        pool = getattr(eng, "pool", None)
        if pool is not None:
            for lane in pool.lanes:
                for backend, mon in lane.monitors.items():
                    mons[f"{backend}.d{lane.index}"] = mon
        if key in mons:
            return [mons[key]]
        cls = key
        prof = getattr(eng, "profile", None)
        tracked = getattr(prof, "tracked", None) or {}
        for c in sorted(tracked):
            if tracked[c] == key:
                cls = c
                break
        backend = getattr(eng, "_BACKEND_OF", _CLASS_BACKEND).get(cls)
        return [mons[backend]] if backend in mons else []

    def _lane_monitors(self, key: str) -> list:
        """A quarantine key names a pool lane (``d<i>``, or any
        instance name ending in ``d<i>``); holding every per-backend
        breaker on that lane makes placement avoid it and drains its
        in-flight batches through DevicePool.requeue. A key that names
        a foreign host resolves to nothing — quarantining another
        machine is an operator action, and the journal still records
        the intent."""
        eng = self._engine
        pool = getattr(eng, "pool", None) if eng is not None else None
        if pool is None:
            return []
        tail = key.rsplit("d", 1)
        if len(tail) != 2 or not tail[1].isdigit():
            return []
        idx = int(tail[1])
        for lane in pool.lanes:
            if lane.index == idx:
                return [lane.monitors[b]
                        for b in sorted(lane.monitors)]
        return []

    def _file_offence(self, key: str) -> bool:
        """Match an equivocation anomaly key (``offender@round``)
        against the node's own signed vote evidence and file the
        offence. The chainwatch evidence record carries only hashes;
        the actual Vote pair — verifiable on-chain — lives in the
        finality gadget's equivocation list."""
        node = self._node
        if node is None or "@" not in key:
            return False
        offender, _, rnd_s = key.rpartition("@")
        if not rnd_s.isdigit():
            return False
        rnd = int(rnd_s)
        fin = getattr(node, "finality", None)
        pairs = list(getattr(fin, "equivocations", ()) or ())
        for va, vb in pairs:
            if va.voter == offender and va.round == rnd \
                    and va.target_hash != vb.target_hash:
                try:
                    node.submit_extrinsic(
                        self._reporter, "offences.report_equivocation",
                        va, vb)
                except Exception:
                    # AlreadyReported / BadOrigin: the evidence path
                    # worked, the chain said no — journaled either way
                    return False
                return True
        return False

    def _proactive_repair(self, key: str) -> bool:
        """Rebuild one at-risk segment's unhealthy fragments through
        the existing MinerAgent repair seams. For a silently-dead
        custodian (nobody filed the loss) the plane files the restoral
        order itself — it applies one block later, so the engagement's
        per-tick pump finishes the rebuild next round. Rescuers run
        the regenerating symbol chain: 1.0 fragment-equivalents of
        ingress per rebuilt fragment."""
        with self._mu:
            plane = self._custody
            node = self._node
            miners = [self._miners[a] for a in sorted(self._miners)]
        if plane is None or node is None or not miners:
            return False
        rt = node.runtime
        progressed = False
        for tgt in plane.repair_targets(key):
            frag = bytes.fromhex(tgt["frag"])
            holder = tgt["holder"]
            if rt.file_bank.restoral_order(frag) is None:
                if holder is not None:
                    node.submit_extrinsic(
                        holder, "file_bank.generate_restoral_order",
                        bytes.fromhex(tgt["file"]), frag)
                    progressed = True
                continue
            rescuer = next(
                (m for m in miners
                 if m.account != holder and frag not in m.store
                 and plane.holder_alive(m.account)), None)
            if rescuer is None:
                continue
            if rescuer.repair_mode != "symbols":
                rescuer.set_repair_mode("symbols")
                with self._mu:
                    self._intended_mode[rescuer.account] = "symbols"
            if rescuer.try_repair(frag, miners):
                progressed = True
        return progressed

    def _flip_mode(self, key: str, engage: bool) -> bool:
        miner = self._miners.get(key)
        if miner is None:
            return False
        miner.set_repair_mode("fragments" if engage else "symbols")
        return True

    # -- introspection -------------------------------------------------------
    @property
    def count(self) -> int:
        with self._mu:
            return self._count

    def policies(self) -> tuple:
        return self._policies

    def edge_log(self) -> list:
        """Every guard-passing trigger edge observed (bounded), for
        the sim's ``remediation-coverage`` invariant."""
        with self._mu:
            return [dict(e) for e in self._edges]

    def journal(self, limit: int | None = None) -> list:
        with self._mu:
            entries = [dict(e) for e in self._journal]
        return entries[-limit:] if limit else entries

    def engagements(self) -> dict:
        with self._mu:
            return {f"{p}:{k}": dict(v)
                    for (p, k), v in sorted(self._engaged.items())}

    def intended_mode(self, account: str) -> str | None:
        with self._mu:
            return self._intended_mode.get(account)

    def witness(self) -> bytes:
        """Canonical bytes of the action journal — the replay
        contract: same seed (=> same edge stream) => byte-identical,
        acting or dry-run (``applied`` is excluded)."""
        with self._mu:
            entries = [{k: e[k] for k in
                        ("seq", "tick", "event", "policy", "action",
                         "key", "reason", "edge", "detail")}
                       for e in self._journal]
            payload = {"seed": self._seed.hex(),
                       "total": self._journal_total,
                       "journal": entries}
        return json.dumps(payload, sort_keys=True,
                          separators=(",", ":")).encode()

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "dry_run": self.dry_run,
                "count": self._count,
                "policies": [p.row() for p in self._policies],
                "engaged": {f"{p}:{k}": dict(v) for (p, k), v
                            in sorted(self._engaged.items())},
                "fires": dict(sorted(self._fires.items())),
                "journal": [dict(e) for e in self._journal],
                "edges_total": self._edge_total,
                "journal_total": self._journal_total,
                "health": {s: dict(h)
                           for s, h in sorted(self._health.items())},
                "counters": {"applied": self._applied,
                             "skipped": self._skipped,
                             "suppressed": self._suppressed,
                             "releases": self._releases,
                             "flaps": self._flaps},
            }

    def metrics(self) -> dict:
        with self._mu:
            return {
                "cess_remediation_policies": len(self._policies),
                "cess_remediation_ticks_total": self._count,
                "cess_remediation_edges_total": self._edge_total,
                "cess_remediation_fires_total":
                    sum(self._fires.values()),
                "cess_remediation_suppressed_total": self._suppressed,
                "cess_remediation_actions_applied_total":
                    self._applied,
                "cess_remediation_releases_total": self._releases,
                "cess_remediation_flaps_total": self._flaps,
                "cess_remediation_engaged": len(self._engaged),
                "cess_remediation_dry_run": int(self.dry_run),
            }
