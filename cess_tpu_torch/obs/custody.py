"""Durability plane: per-segment custody lineage and erasure margins.

The port's own copy of ``cess_tpu/obs/custody.py`` (it imports the
port's ``obs/flight`` and ``obs/trace``, never the JAX package):

* :class:`CustodyLedger`: a bounded, count-sequenced ledger of lineage
  events fed by ``("custody", ...)`` flight notes (gateway encode and
  dispatch, per-row custody transfers, audit verdicts, repair
  completions) and by the chain's open restoral orders; every event
  lands in a per-fragment timeline.
* :class:`DurabilityScorer`: folds the ledger against each segment's
  (k, m) geometry into a live erasure margin::

      margin = (# healthy fragments) - k
      healthy = not lost AND (holder unknown  # still gateway custody
                              OR (holder alive AND last audit passed))

  plus a fleet-wide margin histogram; pure folds of count-sequenced
  state.
* :class:`CustodyDetector`: the edge-triggered ok/bad state machine
  (``ChainAnomalyDetector``'s shape): ``at_risk`` when a margin falls
  to the threshold, ``lost`` when it goes negative, and
  ``market-divergence`` when the market's fake-capacity heuristic
  disagrees with the ledger's audits. Each transition announces a
  ``custody.<cls>`` span and a ``("custody", <cls>)`` flight note, the
  edge the remediation plane's ``custody-repair`` policy acts on.

Zero cost when off: the plane exists only when armed. No wallclock, no
entropy: :meth:`CustodyPlane.witness` equals the JAX package's on the
same note stream.
"""
from __future__ import annotations

import collections
import json
import threading

from . import flight as _flight
from . import trace as _trace

# at_risk fires while margin <= threshold: with the default 1 a
# segment announces one whole erasure BEFORE the last spare dies
AT_RISK_MARGIN = 1


def _hex(v) -> str:
    return v.hex() if isinstance(v, (bytes, bytearray)) else str(v)


class CustodyLedger:
    """Bounded per-fragment lineage timelines plus the custody state
    the scorer folds: segment geometry, current holder, last audit
    verdict per miner and the chain-reported loss set. Events carry
    the ledger's own count sequence (never wallclock)."""

    def __init__(self, *, timeline_cap: int = 32,
                 fragment_cap: int = 4096, log_cap: int = 2048):
        self._mu = threading.Lock()
        self._seq = 0
        self._events_total = 0
        self.timeline_cap = int(timeline_cap)
        self.fragment_cap = int(fragment_cap)
        # frag hex -> deque of event dicts (the per-fragment timeline)
        self._timelines: dict[str, collections.deque] = {}
        # frag hex -> current custodian account (None = gateway)
        self._holder: dict[str, str | None] = {}
        # frag hex -> "file:index" segment key
        self._frag_seg: dict[str, str] = {}
        # seg key -> {"file", "index", "k", "m", "frags": [hex, ...]}
        self._segments: dict[str, dict] = {}
        # miner -> latest audit verdict {"round", "service", "idle"}
        self._verdicts: dict[str, dict] = {}
        self._lost: set[str] = set()
        # flat count-sequenced event log (the witness spine)
        self._log: collections.deque = collections.deque(maxlen=log_cap)

    # -- recording (listener thread) -----------------------------------------
    def _event_locked(self, frag: str, kind: str, **detail) -> None:
        if frag not in self._timelines:
            if len(self._timelines) >= self.fragment_cap:
                return                      # bounded: drop new tails
            self._timelines[frag] = collections.deque(
                maxlen=self.timeline_cap)
        self._seq += 1
        self._events_total += 1
        self._timelines[frag].append({"seq": self._seq, "kind": kind,
                                      **detail})
        self._log.append((self._seq, kind, frag,
                          tuple(sorted(detail.items()))))

    def record_dispatch(self, owner: str, file_hex: str, k: int,
                        m: int, segments) -> None:
        """One gateway upload: ``segments`` is the declared seg_list
        — ``[(seg_hash, (frag_hash, ...)), ...]`` — straight off the
        ``("custody", "dispatch")`` note."""
        with self._mu:
            for index, (_seg_hash, frags) in enumerate(segments):
                key = f"{file_hex}:{index}"
                frag_hexes = [_hex(h) for h in frags]
                self._segments[key] = {"file": file_hex, "index": index,
                                       "k": int(k), "m": int(m),
                                       "frags": frag_hexes}
                for row, fh in enumerate(frag_hexes):
                    self._frag_seg[fh] = key
                    self._holder.setdefault(fh, None)
                    self._event_locked(fh, "dispatch", owner=owner,
                                       file=file_hex, segment=index,
                                       row=row)

    def record_transfer(self, miner: str, file_hex: str, row: int,
                        frags) -> None:
        with self._mu:
            for h in frags:
                fh = _hex(h)
                self._holder[fh] = miner
                self._event_locked(fh, "transfer", miner=miner,
                                   row=int(row))

    def record_verdict(self, miner: str, rnd: int, service: bool,
                       idle: bool, frags) -> None:
        with self._mu:
            self._verdicts[miner] = {"round": int(rnd),
                                     "service": bool(service),
                                     "idle": bool(idle)}
            for h in frags:
                fh = _hex(h)
                if fh in self._frag_seg:
                    self._event_locked(fh, "verdict", miner=miner,
                                       round=int(rnd),
                                       service=bool(service),
                                       idle=bool(idle))

    def record_repair(self, miner: str, frag, mode: str,
                      ingress: int) -> None:
        with self._mu:
            fh = _hex(frag)
            self._holder[fh] = miner
            self._lost.discard(fh)
            self._event_locked(fh, "repair", miner=miner,
                               mode=str(mode), ingress=int(ingress))

    def observe_restorals(self, frags) -> None:
        """Chain-reported losses: the open restoral-order set, scraped
        from runtime state once per round. New entries event as
        ``restoral``; completions are covered by the repair note."""
        with self._mu:
            now = {_hex(h) for h in frags}
            for fh in sorted(now - self._lost):
                if fh in self._frag_seg:
                    self._event_locked(fh, "restoral")
            self._lost = now

    # -- reading -------------------------------------------------------------
    def timeline(self, frag) -> tuple:
        with self._mu:
            return tuple(dict(e)
                         for e in self._timelines.get(_hex(frag), ()))

    def view(self) -> dict:
        """One consistent copy of the custody state the scorer folds."""
        with self._mu:
            return {
                "segments": {k: dict(v, frags=list(v["frags"]))
                             for k, v in self._segments.items()},
                "holder": dict(self._holder),
                "verdicts": {m: dict(v)
                             for m, v in self._verdicts.items()},
                "lost": set(self._lost),
            }

    def sizes(self) -> dict:
        with self._mu:
            return {"events_total": self._events_total,
                    "fragments": len(self._timelines),
                    "segments": len(self._segments),
                    "timeline_cap": self.timeline_cap,
                    "fragment_cap": self.fragment_cap}

    def log(self) -> tuple:
        with self._mu:
            return tuple(self._log)


class DurabilityScorer:
    """Pure fold: ledger view + holder-liveness map -> per-segment
    erasure margins and the fleet histogram. Stateless, so the sim
    invariant can re-run the exact fold against a fresh ledger view
    and compare it with raw world storage."""

    @staticmethod
    def healthy(view: dict, alive: dict, frag_hex: str) -> bool:
        if frag_hex in view["lost"]:
            return False
        holder = view["holder"].get(frag_hex)
        if holder is None:
            return True                 # still gateway custody
        if not alive.get(holder, True):
            return False
        v = view["verdicts"].get(holder)
        return v is None or bool(v["service"])

    @classmethod
    def fold(cls, view: dict, alive: dict) -> dict:
        margins: dict[str, int] = {}
        for key in sorted(view["segments"]):
            seg = view["segments"][key]
            good = sum(1 for fh in seg["frags"]
                       if cls.healthy(view, alive, fh))
            margins[key] = good - seg["k"]
        return margins

    @staticmethod
    def histogram(margins: dict) -> dict:
        hist: dict[str, int] = {}
        for m in margins.values():
            b = "neg" if m < 0 else ("3plus" if m >= 3 else str(m))
            hist[b] = hist.get(b, 0) + 1
        return {b: hist.get(b, 0)
                for b in ("neg", "0", "1", "2", "3plus")}


class CustodyDetector:
    """Edge-triggered ok/bad state per (class, key) with a bounded
    count-sequenced transition log — ChainAnomalyDetector's shape.
    Transitions announce FIFO under ``_announce_mu`` OUTSIDE the
    detector lock: a ``custody.<cls>`` span plus a
    ``("custody", <cls>)`` flight note per edge."""

    CLASSES = ("at_risk", "lost", "market-divergence")

    def __init__(self, *, log_cap: int = 512):
        self._mu = threading.Lock()
        self._seq = 0
        self._edges = 0
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
                self._edges += 1
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
        with _trace.span(f"custody.{cls}", sys="custody", key=key,
                         frm=old, to=to):
            pass
        _flight.note("custody", cls, key=key, frm=old, to=to, **detail)

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
                "edges": self._edges,
                "active": {
                    cls: [k for (c, k), st in sorted(state.items())
                          if c == cls and st == "bad"]
                    for cls in self.CLASSES},
                "transitions": [list(t) for t in self._log],
            }

    def witness(self) -> bytes:
        with self._mu:
            canon = {
                "transitions": [list(t) for t in self._log],
                "active": sorted([c, k]
                                 for (c, k), st in self._state.items()
                                 if st == "bad"),
            }
        return json.dumps(canon, sort_keys=True,
                          separators=(",", ":")).encode()


class CustodyPlane:
    """Ledger + scorer + detector behind the house plane API.

    Arm it by subscribing :meth:`on_note` to the flight recorder (the
    seams' ``("custody", ...)`` notes feed the ledger) and calling
    :meth:`seal_round` once per observation round after feeding
    :meth:`observe_alive` / :meth:`observe_restorals`. Surfaces:
    ``cess_custodyStatus`` (:meth:`snapshot`), ``cess_custody_*``
    gauges (:meth:`metrics`), the remediation plane's repair targets
    (:meth:`repair_targets`) and the replay witness
    (:meth:`witness`)."""

    def __init__(self, instance: str = "node", *,
                 at_risk_margin: int = AT_RISK_MARGIN,
                 timeline_cap: int = 32, fragment_cap: int = 4096):
        self.instance = str(instance)
        self.at_risk_margin = int(at_risk_margin)
        self.ledger = CustodyLedger(timeline_cap=timeline_cap,
                                    fragment_cap=fragment_cap)
        self.detector = CustodyDetector()
        self._mu = threading.Lock()
        self._rounds = 0
        self._alive: dict[str, bool] = {}
        self._margins: dict[str, int] = {}

    # -- ingestion (flight-recorder listener) --------------------------------
    def on_note(self, seq: int, subsystem: str, kind: str,
                detail: dict) -> None:
        if subsystem != "custody":
            return
        if kind == "dispatch":
            self.ledger.record_dispatch(str(detail["owner"]),
                                        _hex(detail["file"]),
                                        detail["k"], detail["m"],
                                        detail["segments"])
        elif kind == "transfer":
            self.ledger.record_transfer(str(detail["miner"]),
                                        _hex(detail["file"]),
                                        detail["row"], detail["frags"])
        elif kind == "verdict":
            self.ledger.record_verdict(str(detail["miner"]),
                                       detail["round"],
                                       detail["service"],
                                       detail["idle"], detail["frags"])
        elif kind == "repair":
            self.ledger.record_repair(str(detail["miner"]),
                                      detail["frag"], detail["mode"],
                                      detail["ingress"])
        # detector announcements (at_risk/lost/market-divergence) are
        # also ("custody", ...) notes: ours, not lineage — ignored

    # -- per-round feeds ------------------------------------------------------
    def observe_alive(self, alive: dict) -> None:
        """Holder-liveness map {account: bool} for the next seal; on a
        live node the plane defaults every holder to alive."""
        with self._mu:
            self._alive = {str(k): bool(v) for k, v in alive.items()}

    def observe_restorals(self, frags) -> None:
        self.ledger.observe_restorals(frags)

    def holder_alive(self, acct: str) -> bool:
        """Last-fed liveness for an account (unknown = alive)."""
        with self._mu:
            return self._alive.get(str(acct), True)

    def fold_margins(self) -> dict:
        """Recompute per-segment margins from the CURRENT ledger view
        (the exact fold :meth:`seal_round` runs) without touching the
        sealed state — the custody-ledger-consistent invariant
        re-derives against this."""
        with self._mu:
            alive = dict(self._alive)
        return DurabilityScorer.fold(self.ledger.view(), alive)

    def seal_round(self) -> dict:
        """Fold margins and run the detector over them (edges announce
        outside every lock). Returns the sealed margins."""
        margins = self.fold_margins()
        with self._mu:
            self._margins = dict(margins)
            self._rounds += 1
        for key in sorted(margins):
            m = margins[key]
            self.detector.update("at_risk", key,
                                 m <= self.at_risk_margin, margin=m)
            self.detector.update("lost", key, m < 0, margin=m)
        return margins

    def cross_check_market(self, market: dict) -> None:
        """MarketWatch vs ledger (satellite): a miner the
        fake-capacity heuristic flags whose fragments still audit-pass
        in the ledger — or the inverse, a market-clean miner whose
        last ledger verdict failed — is a ``market-divergence`` edge
        keyed by the miner."""
        view = self.ledger.view()
        held: dict[str, int] = {}
        for holder in view["holder"].values():
            if holder is not None:
                held[holder] = held.get(holder, 0) + 1
        miners = market.get("miners", {})
        for who in sorted(miners):
            flagged = bool(miners[who].get("fake_capacity"))
            v = view["verdicts"].get(who)
            holds = held.get(who, 0) > 0
            if flagged and holds and v is not None and v["service"]:
                self.detector.update("market-divergence", who, True,
                                     reason="market-flags-audit-clean",
                                     frags=held[who])
            elif not flagged and holds and v is not None \
                    and not v["service"]:
                self.detector.update("market-divergence", who, True,
                                     reason="audit-fail-market-clean",
                                     frags=held[who])
            else:
                self.detector.update("market-divergence", who, False)

    # -- remediation feed ------------------------------------------------------
    def repair_targets(self, seg_key: str) -> tuple:
        """The unhealthy fragments of one segment, for the proactive
        repair action: ``({"file", "frag", "holder"}, ...)`` sorted by
        fragment hex. ``holder`` is the last custodian (the account a
        restoral order must be generated for)."""
        view = self.ledger.view()
        seg = view["segments"].get(str(seg_key))
        if seg is None:
            return ()
        with self._mu:
            alive = dict(self._alive)
        out = []
        for fh in sorted(seg["frags"]):
            if not DurabilityScorer.healthy(view, alive, fh):
                out.append({"file": seg["file"], "frag": fh,
                            "holder": view["holder"].get(fh)})
        return tuple(out)

    # -- surfaces --------------------------------------------------------------
    def margins(self) -> dict:
        with self._mu:
            return dict(self._margins)

    def segment_timeline(self, seg_key: str) -> dict:
        """Every fragment timeline of one segment — what incident
        bundles embed for a custody trigger."""
        view = self.ledger.view()
        seg = view["segments"].get(str(seg_key))
        if seg is None:
            return {}
        return {fh: [dict(e) for e in self.ledger.timeline(fh)]
                for fh in seg["frags"]}

    def metrics(self) -> dict:
        with self._mu:
            margins = dict(self._margins)
            rounds = self._rounds
        sizes = self.ledger.sizes()
        hist = DurabilityScorer.histogram(margins)
        active = self.detector.active()
        out = {
            "cess_custody_rounds": rounds,
            "cess_custody_segments": sizes["segments"],
            "cess_custody_fragments": sizes["fragments"],
            "cess_custody_ledger_events_total": sizes["events_total"],
            "cess_custody_margin_min": min(margins.values())
            if margins else 0,
            "cess_custody_segments_at_risk": len(active.get("at_risk",
                                                            ())),
            "cess_custody_segments_lost": len(active.get("lost", ())),
            "cess_custody_market_divergence": len(
                active.get("market-divergence", ())),
            "cess_custody_anomaly_edges": self.detector.snapshot()
            ["edges"],
        }
        for b, n in hist.items():
            out[f"cess_custody_margin_hist_{b}"] = n
        return out

    def snapshot(self) -> dict:
        """The ``cess_custodyStatus`` payload: geometry + margins +
        per-fragment custody rows per segment, the margin histogram,
        the at-risk/lost lists, the detector state and every bounded
        per-fragment timeline."""
        view = self.ledger.view()
        with self._mu:
            margins = dict(self._margins)
            alive = dict(self._alive)
            rounds = self._rounds
        segments = {}
        for key in sorted(view["segments"]):
            seg = view["segments"][key]
            segments[key] = {
                "file": seg["file"], "index": seg["index"],
                "k": seg["k"], "m": seg["m"],
                "margin": margins.get(key),
                "frags": [{
                    "hash": fh,
                    "holder": view["holder"].get(fh),
                    "healthy": DurabilityScorer.healthy(view, alive,
                                                        fh),
                    "lost": fh in view["lost"],
                } for fh in seg["frags"]],
            }
        active = self.detector.active()
        return {
            "instance": self.instance,
            "rounds": rounds,
            "at_risk_margin": self.at_risk_margin,
            "ledger": self.ledger.sizes(),
            "segments": segments,
            "histogram": DurabilityScorer.histogram(margins),
            "at_risk": list(active.get("at_risk", ())),
            "lost": list(active.get("lost", ())),
            "market_divergence": list(active.get("market-divergence",
                                                 ())),
            "anomalies": self.detector.snapshot(),
            "timelines": {fh: [dict(e)
                               for e in self.ledger.timeline(fh)]
                          for fh in sorted(view["holder"])},
        }

    def witness(self) -> bytes:
        """Canonical bytes of the flat ledger event log, the sealed
        margins and the detector transitions. Two same-seed sim runs
        must return identical bytes."""
        with self._mu:
            margins = dict(self._margins)
            rounds = self._rounds
        canon = {
            "rounds": rounds,
            "events": [[s, k, f, [list(p) for p in d]]
                       for (s, k, f, d) in self.ledger.log()],
            "margins": margins,
            "transitions": [list(t)
                            for t in self.detector.transition_log()],
        }
        return json.dumps(canon, sort_keys=True,
                          separators=(",", ":")).encode()
