"""TCP gossip transport: nodes as separate OS processes.

The reference's node talks libp2p — block announcement, tx
propagation, GRANDPA vote gossip, and catch-up sync between processes
(the reference's node/src/service.rs:259-274,508-537). This module is
the framework-native equivalent over plain TCP: length-prefixed
canonical-codec frames carrying (msg_type, payload) tuples,
bounded-degree peering, flood gossip with a generational seen-set, and
a walk-back sync request for missed blocks. The in-process ``Network``
driver and this transport run the SAME ``Node``: consensus, fork
choice and finality live in the node; this layer only moves bytes.

Topology is degree-limited (the libp2p role, service.rs:259-274):
each node dials its ``degree//2`` ring successors in sorted port
order (deterministic, so the union graph is a connected ring with
chords), accepts at most ``degree`` inbound connections, and every
connection owns a bounded outbound queue drained by a dedicated
sender thread — a stalled peer socket fills its queue and gets
dropped; it can never wedge the node lock shared with authoring/RPC.

Fault injection (``FaultPolicy``) drops or reorders outbound messages
deterministically — the gossip layer must converge anyway via sync
requests (tested in tests/test_net.py with real processes).

Wire frame: [4-byte LE length][codec bytes]; payload tuples:
  ("tx", SignedExtrinsic)          tx propagation
  ("block", Block)                 block announcement (body included)
  ("vote", Vote)                   finality vote gossip
  ("status", (head_n, head_hash, finalized))  keepalive / sync trigger
  ("sync_request", from_number)    catch-up ask
  ("sync_response", (Block, ...))  canonical tail (capped)
  ("just", Justification)         finality proof propagation
  ("warp_request", 0)              checkpoint-sync ask (fresh nodes)
  ("warp_response", (snapshot_payload_bytes, Justification))
                                   snapshot + finality countersignatures,
                                   verified against the GENESIS-derived
                                   authority set (never the snapshot's
                                   own), and only accepted while a
                                   warp_request is outstanding on the
                                   same connection
  ("peers", (port, ...))           peer exchange (discovery): each side
                                   shares its known listen ports; the
                                   ring-successor rule picks which get
                                   dialed
  ("contact", Contact)             DHT bootstrap: advertises this
                                   node's (gossip_port, dht_port) to
                                   seed routing tables
  ("traced", (trace_id, span_id, inner_frame))
                                   trace envelope (cess_tpu_torch/obs): only
                                   emitted while a tracer is armed;
                                   receivers unwrap and handle the
                                   inner frame under a net.recv span
                                   that joins the sender's distributed
                                   trace (gossip dedup keys on the
                                   INNER frame, so the span context
                                   never splits the seen-set)
  ("fleet", (instance, exposition, slo_json))
                                   fleet observability gossip
                                   (obs/fleet.py): only emitted while
                                   a fleet plane is armed (node.cli
                                   --fleet), every FLEET_EVERY slots;
                                   receivers with a plane buffer the
                                   peer's scrape for their next round,
                                   everyone else drops it. Never
                                   re-gossiped. With a chain watch
                                   armed (node.cli --chainwatch) the
                                   frame's slo dict also carries the
                                   sender's consensus state under a
                                   "chain" key (obs/chainwatch.py) —
                                   chain health rides the SAME gossip,
                                   no extra frame kind.

Authority discovery is STRUCTURED (cess_tpu_torch/node/dht.py): a Kademlia
DHT on a second OS-assigned port answers single-shot find_node /
find_value / store RPCs; validators periodically publish
session-key-signed address records keyed by authority id, and
``discover_authority`` resolves any authority in O(log n) routed
lookups without flooding — the reference's authority-discovery worker
over libp2p Kademlia (service.rs:508-537).
"""
from __future__ import annotations

import dataclasses
import queue
import socket
import struct
import threading
import time

from .. import codec
from ..chain.state import DispatchError
from ..crypto import ed25519
from ..obs import trace as obs_trace
from ..resilience import faults
from . import dht as dht_mod

_LEN = struct.Struct("<I")
MAX_FRAME = 64 * 1024 * 1024
SYNC_BATCH = 64
SYNC_LOOKBACK = 8   # re-request a short tail to cover small forks
WARP_THRESHOLD = 50  # finalized blocks behind which a fresh node warps
SEEN_CAP = 8192      # generational dedup-set rotation threshold
ERRORS_CAP = 256
SEND_QUEUE_CAP = 256    # outbound frames buffered per connection
SEND_TIMEOUT = 5.0      # stalled-socket kill switch (seconds)
FLEET_EVERY = 4         # slots between fleet scrape gossip rounds


@dataclasses.dataclass
class FaultPolicy:
    """Deterministic outbound faults for tests: drop every Nth
    message, optionally delay each send."""

    drop_every: int = 0     # 0 = never drop
    delay_s: float = 0.0
    _counter: int = 0

    def allow(self) -> bool:
        self._counter += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        return not (self.drop_every and self._counter % self.drop_every == 0)


class _Conn:
    """One TCP connection with a bounded outbound queue drained by its
    own sender thread. ``send`` never blocks the caller: a full queue
    (stalled peer) drops the frame; a send stalled past SEND_TIMEOUT
    kills the connection."""

    def __init__(self, sock: socket.socket, inbound: bool = False):
        self.sock = sock
        self.alive = True
        self.inbound = inbound
        self.warp_requested = False   # gate for warp_response acceptance
        self.dropped = 0
        self.rx = 0                   # frames received (dial liveness)
        self._q: queue.Queue[bytes | None] = queue.Queue(SEND_QUEUE_CAP)
        self._sender = threading.Thread(target=self._drain, daemon=True)
        self._sender.start()

    def send(self, raw: bytes) -> None:
        if not self.alive:
            return
        try:
            self._q.put_nowait(_LEN.pack(len(raw)) + raw)
        except queue.Full:
            self.dropped += 1   # overflow drop: slow peer loses frames

    def _drain(self) -> None:
        # send-ONLY stall timeout: settimeout() would poison the recv
        # side of the shared socket (recv must block indefinitely on an
        # idle link), so arm SO_SNDTIMEO for the kernel send path alone
        try:
            self.sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                struct.pack("ll", int(SEND_TIMEOUT),
                            int(SEND_TIMEOUT % 1 * 1_000_000)))
        except OSError:
            pass   # platform without SO_SNDTIMEO: bounded queue still caps
        while True:
            frame = self._q.get()
            if frame is None or not self.alive:
                return
            try:
                self.sock.sendall(frame)
            except (OSError, ValueError):
                self.close()
                return

    def close(self) -> None:
        # one-shot monotonic bool: both the drain thread (send error)
        # and external callers only ever store False, a single
        # GIL-atomic write with no read-modify-write — a lock would
        # buy nothing (pinned by tests/test_lint.py)
        # cesslint: disable=race
        self.alive = False
        try:
            self._q.put_nowait(None)   # unblock the sender thread
        except queue.Full:
            pass
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def _read_frame(sock: socket.socket) -> bytes | None:
    head = b""
    while len(head) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(head))
        if not chunk:
            return None
        head += chunk
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        return None
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class NodeService:
    """One node process: TCP listener + outbound peers + slot-timed
    authoring loop, all feeding a single Node under one lock."""

    def __init__(self, node, port: int, peers: list[int],
                 host: str = "127.0.0.1", slot_time: float = 0.2,
                 genesis_time: float = 0.0,
                 faults: FaultPolicy | None = None,
                 degree: int = 8, discovery_interval: float = 0.25):
        self.node = node
        # discovery runs as its OWN schedulable loop at this cadence
        # (not piggybacked on authoring slots): mesh formation then
        # converges in a bounded number of rounds regardless of slot
        # timing or host load — the seam the deterministic chain-
        # topology test (tests/test_net.py) drives
        self.discovery_interval = discovery_interval
        # all processes must agree on slot numbering (slot is signed
        # into VRF claims and drives epoch derivation): slots count
        # from a SHARED genesis wall-clock instant, not process start
        self.genesis_time = genesis_time
        self.host = host
        self.port = port
        self.peer_ports = peers
        self.slot_time = slot_time
        self.faults = faults
        self.degree = max(2, degree)
        self.lock = threading.RLock()
        self.conns: list[_Conn] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        # gossip dedup: generational pair of sets — membership checks
        # both, inserts go to the young set, rotation at SEEN_CAP keeps
        # memory bounded on a long-running node
        self._seen: set[bytes] = set()
        self._seen_old: set[bytes] = set()
        # peer-exchange state lives here (NOT start()): inbound frames
        # can arrive before start() finishes its own assignments
        self._known_peers: set[int] = set(peers)
        self._dialing: set[int] = set()
        # dead-peer cooling: a port that keeps failing is excluded from
        # ring-successor selection until its retry time, so the ring
        # SLIDES past crashed nodes instead of letting dead runs
        # partition the gossip graph (full-mesh robustness, kept)
        self._cooling: dict[int, float] = {}
        self.max_peers = 64   # discovery cap: bounds the learned set
        self.errors: list[str] = []      # swallowed faults, for tests/ops
        self.msgs_sent = 0               # transport telemetry (tests)
        self._warp_tries = 0
        self._warp_backoff = 0.0
        self._listener: socket.socket | None = None
        # authority discovery: Kademlia DHT on a second, OS-assigned
        # port (service.rs:508-537 role); wired up in start()
        self.dht_port = 0
        self.kad: dht_mod.Kademlia | None = None
        self._dht_listener: socket.socket | None = None
        self._publish_serial = 0
        self._next_publish = 0.0
        self._next_dht_maint = 0.0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port))
        srv.listen(16)
        self._listener = srv
        # DHT RPC listener: OS-assigned port, advertised via the
        # "contact" frame and inside signed authority records
        dsrv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        dsrv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        dsrv.bind((self.host, 0))
        dsrv.listen(16)
        self._dht_listener = dsrv
        self.dht_port = dsrv.getsockname()[1]
        self.kad = dht_mod.Kademlia(
            dht_mod.Contact(port=self.port, dht_port=self.dht_port),
            self._verify_record)
        self._spawn(self._dht_accept_loop, dsrv)
        self._spawn(self._accept_loop, srv)
        self._redial()
        self._spawn(self._discovery_loop)
        self._spawn(self._author_loop)

    def _dial_targets(self) -> list[int]:
        """Ring-successor selection: the ``degree//2`` known LIVE ports
        that cyclically follow our own in sorted order (ports in their
        cooling window after repeated failures are skipped, so the
        ring advances past dead nodes). Every node dialing its
        successors yields a connected ring with chords at bounded
        per-node degree (out = degree//2, in <= degree//2 + slack
        under the same rule) — the structured-discovery stand-in for
        the reference's Kademlia DHT (service.rs:508-537)."""
        now = time.time()
        with self.lock:
            for p, until in list(self._cooling.items()):
                if now >= until:
                    del self._cooling[p]
            known = sorted(p for p in self._known_peers
                           if p != self.port and p not in self._cooling)
        if not known:
            return []
        d = max(1, self.degree // 2)
        after = [p for p in known if p > self.port]
        ring = after + [p for p in known if p < self.port]
        return ring[:d]

    def _redial(self) -> None:
        for p in self._dial_targets():
            with self.lock:
                if p in self._dialing:
                    continue
                self._dialing.add(p)
            self._spawn(self._dial_loop, p)

    def _discover(self, ports) -> None:
        """Peer exchange: learn listen ports, then let the ring rule
        decide which to dial. Bounded by max_peers — an
        unauthenticated frame must not grow state without limit."""
        for p in ports:
            if not (isinstance(p, int) and not isinstance(p, bool)
                    and 0 < p < 65536 and p != self.port):
                continue
            with self.lock:
                if len(self._known_peers) >= self.max_peers \
                        or p in self._known_peers:
                    continue
                self._known_peers.add(p)
        self._redial()

    def _discovery_loop(self) -> None:
        """The discovery round, on its own schedulable cadence: sweep
        dead-peer coolings + re-dial ring targets, and RE-ADVERTISE the
        known peer set on every live connection. Peer exchange is
        idempotent (receivers cap + dedup), so repetition turns mesh
        formation from a race against connection setup into a bounded
        number of deterministic rounds — a frame lost while a link was
        half-up is re-offered next round."""
        while not self._stop.wait(self.discovery_interval):
            self._redial()
            with self.lock:
                known = (self.port, *sorted(self._known_peers))
            for conn in list(self.conns):
                if conn.alive:
                    self._send(conn, ("peers", known))

    def stop(self) -> None:
        self._stop.set()
        for srv in (self._listener, self._dht_listener):
            if srv is not None:
                try:
                    srv.close()
                except OSError:
                    pass
        for c in list(self.conns):
            c.close()
        for t in self._threads:
            t.join(timeout=2.0)

    def _spawn(self, fn, *args) -> None:
        t = threading.Thread(target=fn, args=args, daemon=True)
        t.start()
        # prune finished threads (per-request DHT handlers and publish
        # cycles spawn continually; the join list must stay bounded);
        # the prune REBINDS the list, so an unguarded concurrent
        # append from another loop could vanish from the join list
        with self.lock:
            if len(self._threads) > 64:
                self._threads = [x for x in self._threads
                                 if x.is_alive()]
            self._threads.append(t)

    def _record_error(self, msg: str) -> None:
        # append+trim is two ops; recv loops and the author loop both
        # report here
        with self.lock:
            self.errors.append(msg)
            del self.errors[:-ERRORS_CAP]

    # -- connections --------------------------------------------------------
    def _accept_loop(self, srv: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = srv.accept()
            except OSError:
                return
            alive = [c for c in self.conns if c.alive]
            in_alive = sum(1 for c in alive if c.inbound)
            # inbound cap with ONE slack slot over the steady-state
            # in-degree (degree//2): a late joiner not yet in anyone's
            # ring must be able to land its first connection and get
            # its port gossiped — a hard cap at `degree` would lock
            # it out forever once the ring saturates. Total live
            # connections are therefore bounded by degree + 1.
            if in_alive > self.degree // 2 \
                    or len(alive) >= self.degree + 1:
                self._spawn(self._refuse, sock)
                continue
            conn = _Conn(sock, inbound=True)
            self.conns.append(conn)
            self._spawn(self._recv_loop, conn)

    def _refuse(self, sock: socket.socket) -> None:
        """Close an inbound connection over the cap, after a peer
        exchange: the dialer gets this node's peer set in one "peers"
        frame, and the "peers" frame it sends on connecting (its own
        port first) is read, so the two learn each other's peers. A late
        joiner bootstrapped on full nodes alone would otherwise learn no
        other peer, and no node would learn its port, for as long as
        they stay full (the reference closes without a word; a node of
        either package sends and handles these frames as any peer
        exchange)."""
        try:
            with self.lock:
                known = (self.port, *sorted(self._known_peers))
            sock.settimeout(1.0)
            raw = codec.encode(("peers", known))
            sock.sendall(_LEN.pack(len(raw)) + raw)
            for _ in range(3):       # the dialer's status, peers, contact
                frame = _read_frame(sock)
                if frame is None:
                    return
                kind, payload = codec.decode(frame)
                if kind == "traced":
                    kind, payload = payload[2]
                if kind == "peers" and isinstance(payload, tuple):
                    self._discover(payload)
                    return
        except (OSError, codec.CodecError, ValueError, TypeError,
                IndexError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    DIAL_FAILS_MAX = 20     # consecutive failures before cooling
    COOL_SECONDS = 5.0      # how long a dead port sits out of the ring

    def _dial_loop(self, port: int) -> None:
        """Keep one outbound connection to a ring peer alive (retry
        while it remains a ring target). A port that keeps failing —
        connect refused, or connections that die before delivering a
        single frame (e.g. a peer refusing us at its inbound cap) —
        goes into cooling and the ring re-targets around it."""
        fails = 0
        while not self._stop.is_set():
            if port not in self._dial_targets():
                with self.lock:
                    self._dialing.discard(port)
                return   # ring moved (new peers learned): stop dialing
            if fails >= self.DIAL_FAILS_MAX:
                with self.lock:
                    self._cooling[port] = time.time() + self.COOL_SECONDS
                    self._dialing.discard(port)
                self._redial()   # pick the next live successor
                return
            try:
                sock = socket.create_connection((self.host, port),
                                                timeout=2.0)
                sock.settimeout(None)
            except OSError:
                fails += 1
                # same schedulable wait seam as _discovery_loop: a
                # stop() wakes the backoff immediately instead of
                # draining a bare sleep
                if self._stop.wait(0.05):
                    return
                continue
            conn = _Conn(sock)
            self.conns.append(conn)
            self._send_status(conn)
            with self.lock:
                known = (self.port, *sorted(self._known_peers))
            self._send(conn, ("peers", known))
            if self.kad is not None:
                self._send(conn, ("contact", self.kad.self_contact))
            self._recv_loop(conn)   # blocks until closed
            if conn in self.conns:
                self.conns.remove(conn)
            # a refusal delivers one "peers" frame (_refuse): only a
            # connection that delivered more was a live one
            fails = 0 if conn.rx > 1 else fails + 1
            if self._stop.wait(0.05):
                return

    def _recv_loop(self, conn: _Conn) -> None:
        while not self._stop.is_set() and conn.alive:
            try:
                raw = _read_frame(conn.sock)
            except OSError:
                break
            if raw is None:
                break
            conn.rx += 1
            try:
                msg = codec.decode(raw)
                self._handle(msg, conn)
            except (codec.CodecError, ValueError, DispatchError,
                    TypeError, KeyError, AttributeError, IndexError):
                # malformed or stale traffic from a peer must never
                # kill the service
                continue
        conn.close()
        if conn in self.conns:
            self.conns.remove(conn)

    # -- sending ------------------------------------------------------------
    @staticmethod
    def _envelope(msg):
        """Trace envelope (cess_tpu_torch/obs): with a tracer armed, gossip
        frames travel as ``("traced", (trace_id, span_id, inner))`` so
        the receiving node's handling span joins the sender's
        distributed trace — a challenge -> prove -> verify round
        becomes ONE trace across nodes. With no tracer armed the frame
        is untouched (wire compatibility + zero cost)."""
        ctx = obs_trace.context()
        if ctx is None:
            return msg
        return ("traced", (ctx[0], ctx[1], msg))

    def _send(self, conn: _Conn, msg) -> None:
        if self.faults is not None and not self.faults.allow():
            return
        if not faults.allow("net.send"):
            return   # seeded chaos drop (cess_tpu_torch/resilience/faults.py)
        with self.lock:
            self.msgs_sent += 1
        conn.send(codec.encode(self._envelope(msg)))

    def _mark_seen(self, digest: bytes) -> None:
        # the generation swap rebinds both sets; two threads swapping
        # concurrently would drop a whole dedup generation
        with self.lock:
            self._seen.add(digest)
            if len(self._seen) >= SEEN_CAP:
                self._seen_old = self._seen
                self._seen = set()

    def _was_seen(self, digest: bytes) -> bool:
        return digest in self._seen or digest in self._seen_old

    def broadcast(self, msg, mark_seen: bool = True) -> None:
        raw = codec.encode(msg)
        if mark_seen:
            import hashlib

            self._mark_seen(hashlib.sha256(raw).digest())
        env = self._envelope(msg)
        if env is not msg:
            # dedup identity stays the INNER frame (hash above) so a
            # message wrapped with different span contexts still
            # dedups; only the wire bytes carry the envelope
            raw = codec.encode(env)
        for conn in list(self.conns):
            if conn.alive:
                if self.faults is not None and not self.faults.allow():
                    continue
                if not faults.allow("net.send"):
                    continue   # seeded chaos drop, per conn like faults
                with self.lock:
                    self.msgs_sent += 1
                conn.send(raw)

    def _send_status(self, conn: _Conn) -> None:
        with self.lock:
            head = self.node.head()
            msg = ("status", (head.number, head.hash(),
                              self.node.finalized))
        self._send(conn, msg)

    # -- gossip handlers ----------------------------------------------------
    def _handle(self, msg, conn: _Conn) -> None:
        import hashlib

        kind, payload = msg
        if kind == "traced":
            # trace envelope (see _envelope): unwrap, then handle the
            # inner frame under a recv span that joins the sender's
            # trace. A node without an armed tracer just unwraps.
            remote_tid, remote_sid, inner = payload
            tracer = obs_trace.armed_tracer()
            if tracer is None:
                self._handle(inner, conn)
                return
            with tracer.start(f"net.recv:{inner[0]}", sys="net",
                              remote=(remote_tid, remote_sid),
                              current=True):
                self._handle(inner, conn)
            return
        raw_hash = hashlib.sha256(codec.encode(msg)).digest()
        if kind in ("tx", "block", "vote", "just"):
            if self._was_seen(raw_hash):
                return
            self._mark_seen(raw_hash)
        if kind == "tx":
            with self.lock:
                try:
                    self.node.submit_signed(payload)
                except DispatchError:
                    return   # invalid or duplicate: do not re-gossip
            self.broadcast(msg, mark_seen=False)
        elif kind == "block":
            ok = self._import(payload, conn)
            if ok:
                self.broadcast(msg, mark_seen=False)
                self._after_chain_move()
        elif kind == "vote":
            with self.lock:
                self.node.finality.on_vote(payload)
            self.broadcast(msg, mark_seen=False)
        elif kind == "just":
            with self.lock:
                if payload.target_number > self.node.finalized \
                        and self.node.finality.verify_justification(payload):
                    self.node.finality.justifications[payload.round] = payload
                    self.node.on_justification(payload)
        elif kind == "peers":
            if isinstance(payload, tuple):
                self._discover(payload)
        elif kind == "contact":
            # DHT bootstrap: gossip neighbors seed each other's routing
            # tables; one reciprocal reply, then the tables grow through
            # lookups (Kademlia's implicit maintenance)
            if self.kad is not None \
                    and isinstance(payload, dht_mod.Contact) \
                    and payload.port != self.port:
                self.kad.note(payload)
                if not getattr(conn, "contact_sent", False):
                    conn.contact_sent = True
                    self._send(conn, ("contact", self.kad.self_contact))
        elif kind == "fleet":
            # fleet observability gossip (obs/fleet.py): a peer's
            # scrape contribution, buffered into the local plane's
            # next round when one is armed (node.cli --fleet) —
            # one attribute load + None check otherwise. Malformed
            # payloads are dropped inside ingest_frame; never
            # re-gossiped (point-in-time data, not chain state).
            plane = getattr(self.node, "fleet", None)
            if plane is not None:
                plane.ingest_frame(payload)
            # the frame's slo dict may carry the sender's consensus
            # state under a "chain" key: hand the SAME frame to an
            # armed chain watch (obs/chainwatch.py) so peer finality
            # lag feeds the anomaly detectors too
            watch = getattr(self.node, "chainwatch", None)
            if watch is not None:
                watch.ingest_frame(payload)
        elif kind == "status":
            peer_head, _, peer_fin = payload
            now = time.time()
            offer_just = None
            with self.lock:
                ours = self.node.head().number
                warp_viable = (ours == 0 and peer_fin > WARP_THRESHOLD
                               and self._warp_tries < 3)
                fire_warp = warp_viable and now >= self._warp_backoff
                if fire_warp:
                    # one attempt per backoff window, not per status
                    # tick — a large snapshot takes time to arrive
                    self._warp_tries += 1
                    self._warp_backoff = now + 1.0
                if peer_fin < self.node.finalized:
                    # finality healing, pull side: a peer behind on
                    # finality gets our newest justification directly
                    # (it finalizes ancestors transitively)
                    offer_just = \
                        self.node.finality.newest_justification()
            if offer_just is not None:
                self._send(conn, ("just", offer_just))
            if fire_warp:
                # fresh node far behind a finalized peer: checkpoint
                # sync instead of replaying the whole chain; bounded
                # attempts then fall back to full replay sync
                conn.warp_requested = True
                self._send(conn, ("warp_request", 0))
            elif peer_head > ours and not warp_viable:
                self._send(conn, ("sync_request",
                                  max(1, ours - SYNC_LOOKBACK)))
        elif kind == "warp_request":
            from . import store as _store

            with self.lock:
                if not self.node.finality.justifications:
                    return
                rnd = max(self.node.finality.justifications)
                just = self.node.finality.justifications[rnd]
                payload_bytes = _store.snapshot_payload(self.node)
            self._send(conn, ("warp_response", (payload_bytes, just)))
        elif kind == "warp_response":
            snap_bytes, just = payload
            from .finality import Justification

            if not conn.warp_requested:
                return   # unsolicited snapshot push: refuse
            conn.warp_requested = False
            if not isinstance(snap_bytes, bytes) \
                    or not isinstance(just, Justification):
                return
            with self.lock:
                self._try_warp(snap_bytes, just)
        elif kind == "sync_request":
            with self.lock:
                blocks = []
                for n in range(payload, payload + SYNC_BATCH):
                    b = self.node.block_bodies.get(n)
                    if b is None:
                        break
                    blocks.append(b)
            if blocks:
                self._send(conn, ("sync_response", tuple(blocks)))
        elif kind == "sync_response":
            moved = False
            for b in payload:
                if self._import(b, conn):
                    moved = True
            if moved:
                self._after_chain_move()

    def _import(self, block, conn: _Conn) -> bool:
        want_sync_from = None
        with self.lock:
            try:
                self.node.import_block(block)
                return True
            except ValueError as e:
                if "unknown parent" in str(e):
                    if self.node.head().number == 0 \
                            and self._warp_tries < 3:
                        # fresh node with warp still plausible: stay
                        # quiet — the status exchange (every slot)
                        # drives checkpoint-vs-replay policy in ONE
                        # place; requesting a replay here would race
                        # the in-flight snapshot adoption
                        pass
                    else:
                        want_sync_from = max(
                            1, self.node.head().number - SYNC_LOOKBACK)
                ok = False
        # send OUTSIDE the node lock: a stalled peer must not hold it
        if want_sync_from is not None:
            self._send(conn, ("sync_request", want_sync_from))
        return ok

    def _try_warp(self, snap_bytes: bytes, just) -> bool:
        """Verify + adopt a checkpoint (caller holds the lock): the ONE
        shared trust path, store.verify_and_adopt_warp — justification
        verified against OUR genesis-derived authority set (never the
        snapshot's own), genesis-anchored header chain, state-root-
        proven KV. Fails closed (-> full replay sync) if the authority
        set has rotated since genesis."""
        from . import store as _store
        from .network import Node as _Node

        node = self.node
        return _store.verify_and_adopt_warp(
            node, snap_bytes, just,
            lambda: _Node(node.spec, f"{node.name}-warp", {}))

    def _after_chain_move(self) -> None:
        """Cast + gossip finality votes and any new justification.
        Signing happens OUTSIDE the node lock (up to VOTE_TAIL slow
        pure-python signatures after a sync batch must not stall
        recv/RPC/authoring)."""
        with self.lock:
            # a justification may have arrived before its block did;
            # now that the chain moved, act on any that became usable
            self.node.finality.apply_pending()
            jobs = self.node.finality.vote_jobs()
        votes = self.node.finality.sign_jobs(jobs)
        with self.lock:
            self.node.finality.ingest_own(votes)
            fin = self.node.finalized
            just = self.node.finality.justifications.get(fin)
        for v in votes:
            self.broadcast(("vote", v))
        if just is not None:
            self.broadcast(("just", just))

    # -- authoring ----------------------------------------------------------
    def _author_loop(self) -> None:
        """Wall-clock slots shared across processes on one host: each
        process independently computes the slot index, authors when its
        key wins, commits immediately and gossips — competing blocks
        are resolved by fork choice at import, votes settle finality."""
        last_slot = -1
        while not self._stop.is_set():
            slot = int((time.time() - self.genesis_time) / self.slot_time)
            if slot < 1:
                time.sleep(self.slot_time / 10)
                continue
            if slot == last_slot:
                time.sleep(self.slot_time / 10)
                continue
            last_slot = slot
            blk = None
            with self.lock:
                new_beats = self.node.queue_heartbeats()
                try:
                    blk = self.node.try_author(slot)
                    if blk is not None:
                        self.node.commit_proposal()
                except Exception as e:   # noqa: BLE001 — author loop must survive
                    self._record_error(f"author slot {slot}: {e!r}")
                    if self.node._proposal is not None:
                        self.node.abort_proposal()
                    blk = None
            for xt in new_beats:
                # a validator that never wins a slot still needs its
                # heartbeat IN PEERS' blocks — gossip it like any tx
                self.broadcast(("tx", xt))
            if blk is not None:
                self.broadcast(("block", blk))
                self._after_chain_move()
            for conn in list(self.conns):
                if conn.alive:
                    self._send_status(conn)
            # fleet observability (obs/fleet.py): every FLEET_EVERY
            # slots an armed plane gossips this node's scrape to
            # peers and seals a local round over whatever peers
            # gossiped in since the last one. Disarmed cost: one
            # attribute load + None check per slot.
            # chain-plane observability (obs/chainwatch.py): every
            # FLEET_EVERY slots an armed watch scans this node's own
            # chain + market state and seals a detector round (also
            # folding per-node finality lag into an attached fleet
            # plane's straggler windows). Disarmed cost: one
            # attribute load + None check per slot.
            watch = getattr(self.node, "chainwatch", None)
            if watch is not None and slot % FLEET_EVERY == 0:
                try:
                    with self.lock:
                        watch.scan_node(self.node)
                    watch.seal_round()
                except Exception as e:   # noqa: BLE001 — best-effort
                    # observability must never kill authoring
                    self._record_error(
                        f"chainwatch round slot {slot}: {e!r}")
            plane = getattr(self.node, "fleet", None)
            if plane is not None and slot % FLEET_EVERY == 0:
                try:
                    with self.lock:
                        frame = plane.self_frame()
                    if frame is not None:
                        self.broadcast(("fleet", frame), mark_seen=False)
                        plane.ingest_frame(frame)
                    plane.seal_round()
                except Exception as e:   # noqa: BLE001 — peer frames
                    # must never kill authoring (ingest validates, but
                    # the observability plane is best-effort anyway)
                    self._record_error(f"fleet round slot {slot}: {e!r}")
            # finality healing: gossip is fire-and-forget and sync
            # re-fetches blocks, never votes — a vote relayed into a
            # partially-formed mesh is lost forever, which stalls
            # finality and feeds the conflicting-quorum window the
            # vote lock (finality._locked) guards. Re-offer own
            # unfinalized votes + the newest justification each slot;
            # receivers dedup, so repetition costs bytes only.
            with self.lock:
                own_votes = self.node.finality.own_unfinalized_votes()
                newest_just = self.node.finality.newest_justification()
                fin = self.node.finalized
            for v in own_votes:
                self.broadcast(("vote", v), mark_seen=False)
            if newest_just is not None \
                    and newest_just.target_number >= fin:
                self.broadcast(("just", newest_just), mark_seen=False)
            # periodic authority-record publication, off this thread
            # (publication does blocking DHT RPCs; authoring must not)
            now = time.time()
            if now >= self._next_publish \
                    and not getattr(self, "_publishing", False):
                with self.lock:
                    self._next_publish = now + 10 * self.slot_time
                    self._publishing = True
                self._spawn(self._publish_once)
            # DHT upkeep: record expiry + stale-bucket refresh lookups
            # (libp2p Kademlia's periodic maintenance), off this thread
            if now >= self._next_dht_maint \
                    and not getattr(self, "_dht_mainting", False):
                with self.lock:
                    self._next_dht_maint = now + 20 * self.slot_time
                    self._dht_mainting = True
                self._spawn(self._dht_maintenance)

    # -- authority discovery (Kademlia; service.rs:508-537 role) -------------
    def _verify_record(self, rec: "dht_mod.AuthorityRecord") -> bool:
        """A record is valid iff its authority is in the CURRENT
        authority set and the signature verifies against that
        authority's on-chain session key — the registry finality votes
        already trust."""
        if not (isinstance(rec.authority, str)
                and isinstance(rec.signature, bytes)
                and isinstance(rec.port, int) and 0 < rec.port < 65536
                and isinstance(rec.dht_port, int)
                and 0 < rec.dht_port < 65536
                and isinstance(rec.serial, int) and rec.serial >= 0):
            return False
        with self.lock:
            if rec.authority not in self.node.authorities:
                return False
            pub = self.node.runtime.state.get("system", "session_key",
                                              rec.authority)
        if pub is None:
            return False
        return ed25519.verify(pub, rec.signing_payload(), rec.signature)

    def _dht_accept_loop(self, srv: socket.socket) -> None:
        """One short-lived request/response exchange per connection —
        DHT RPCs never occupy gossip inbound slots."""
        while not self._stop.is_set():
            try:
                sock, _ = srv.accept()
            except OSError:
                return
            self._spawn(self._dht_serve_one, sock)

    def _dht_serve_one(self, sock: socket.socket) -> None:
        try:
            sock.settimeout(2.0)
            raw = _read_frame(sock)
            if raw is None or self.kad is None:
                return
            resp = self.kad.handle(codec.decode(raw))
            raw_out = codec.encode(resp)
            sock.sendall(_LEN.pack(len(raw_out)) + raw_out)
        except (OSError, codec.CodecError, ValueError, TypeError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _dht_call(self, contact: "dht_mod.Contact", req,
                  timeout: float = 1.0):
        """Client half of one DHT RPC; None on any failure."""
        try:
            with socket.create_connection((self.host, contact.dht_port),
                                          timeout=timeout) as sock:
                sock.settimeout(timeout)
                raw = codec.encode(req)
                sock.sendall(_LEN.pack(len(raw)) + raw)
                resp = _read_frame(sock)
            return None if resp is None else codec.decode(resp)
        except (OSError, codec.CodecError, ValueError, TypeError):
            return None

    def _iter_lookup(self, key: bytes, want_value: bool):
        """Iterative Kademlia lookup: query the ALPHA closest unqueried
        contacts per round, absorb returned contacts, stop when no
        round improves. Returns (record | None, closest_contacts)."""
        kad = self.kad
        shortlist = {c.port: c for c in kad.closest(key)}
        queried: set[int] = set()
        op = "find_value" if want_value else "find_node"
        # Kademlia termination: stop only once every still-unqueried
        # shortlist contact has been asked (bounded by MAX_QUERIED, not
        # by a no-new-contacts heuristic — a round that adds nothing
        # may still leave the record-holder unqueried)
        MAX_QUERIED = 4 * dht_mod.K
        while len(queried) < MAX_QUERIED and not self._stop.is_set():
            cands = sorted(
                (c for c in shortlist.values() if c.port not in queried),
                key=lambda c: dht_mod.distance(c.node_id(), key))
            cands = cands[:dht_mod.ALPHA]
            if not cands:
                break
            for c in cands:
                if self._stop.is_set():
                    break
                queried.add(c.port)
                resp = self._dht_call(c, (op, kad.self_contact, key))
                if not (isinstance(resp, tuple) and len(resp) == 2):
                    continue
                kad.note(c)
                if resp[0] == "value" and want_value:
                    if kad.store_record(resp[1]):   # verifies
                        return resp[1], list(shortlist.values())
                    continue                        # forged: keep looking
                if resp[0] == "nodes" and isinstance(resp[1], tuple):
                    for n in resp[1][:2 * dht_mod.K]:
                        if isinstance(n, dht_mod.Contact) \
                                and n.port != self.port \
                                and n.port not in shortlist:
                            shortlist[n.port] = n
                            kad.note(n)
        closest = sorted(shortlist.values(),
                         key=lambda c: dht_mod.distance(c.node_id(), key))
        return None, closest[:dht_mod.K]

    def _publish_once(self) -> None:
        try:
            self.publish_authorities()
        finally:
            with self.lock:
                self._publishing = False

    def _dht_maintenance(self) -> None:
        try:
            if self.kad is None:
                return
            self.kad.expire()
            for target in self.kad.refresh_targets():
                if self._stop.is_set():
                    return
                self._iter_lookup(target, want_value=False)
        finally:
            with self.lock:
                self._dht_mainting = False

    def publish_authorities(self) -> None:
        """Publish a signed address record for every authority whose
        session key this node operates, to the K closest nodes (the
        reference's authority-discovery publish half)."""
        if self.kad is None:
            return
        with self.lock:
            serial = self._publish_serial = max(self._publish_serial + 1,
                                                int(time.time()))
            mine = [a for a in self.node.keystore
                    if a in self.node.authorities]
        for account in mine:
            # sign with the key the node actually HOLDS (finality signs
            # with keystore values too): the on-chain registry peers
            # verify against can rotate away from the dev-spec
            # derivation, and a spec-derived signature would then fail
            # _verify_record on every peer
            rec = dht_mod.sign_record(self.node.keystore[account],
                                      account, self.port, self.dht_port,
                                      serial)
            self.kad.store_record(rec)          # serve it ourselves too
            _, closest = self._iter_lookup(dht_mod.record_key(account),
                                           want_value=False)
            for c in closest[:dht_mod.K]:
                if self._stop.is_set():
                    return
                self._dht_call(c, ("store", self.kad.self_contact, rec))

    def discover_authority(self, authority: str
                           ) -> "dht_mod.AuthorityRecord | None":
        """Resolve an authority's address through the DHT (verified
        record or None); a hit also feeds the gossip ring's peer set."""
        if self.kad is None:
            return None
        key = dht_mod.record_key(authority)
        rec = self.kad.record(key)
        if rec is None:
            rec, _ = self._iter_lookup(key, want_value=True)
        if rec is not None:
            self.kad.note(rec.contact())
            self._discover([rec.port])
        return rec

    # -- client surface ------------------------------------------------------
    def submit(self, xt) -> None:
        with self.lock:
            self.node.submit_signed(xt)
        self.broadcast(("tx", xt))
