"""Kademlia-style authority discovery (the reference's
authority-discovery worker over the libp2p Kademlia DHT,
the reference's node/src/service.rs:508-537).

The reference publishes each validator's signed address record into a
DHT keyed by authority id, so validators find each other without any
of them being globally known. This module is the framework-native
equivalent, transport-agnostic (cess_tpu_torch/node/net.py wires it to
short-lived TCP request/response sockets):

- node ids and record keys live in a 256-bit XOR metric space
  (sha256), contacts sort into per-prefix buckets capped at K with
  oldest-out eviction, lookups walk toward the target iteratively.
- an ``AuthorityRecord`` is signed by the authority's SESSION key (the
  same registry finality votes verify against, system.set_session_key)
  and carries a monotonic serial — newest-serial-wins on store, so a
  re-published address supersedes stale ones and a replayed old record
  cannot roll a fresh one back.
- storage is verified-on-arrival and bounded (STORE_CAP), so an
  unauthenticated peer cannot grow memory or plant records for
  non-authorities.

The gossip ring (net.py) keeps block/tx/vote propagation connected;
this layer answers the *directory* question — "where does authority X
listen?" — with O(log n) routed hops instead of flooding.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

from .. import codec
from ..crypto import ed25519

K = 8          # bucket size == store/lookup replication
ALPHA = 3      # lookup concurrency (serialized per round here)
ID_BITS = 256
STORE_CAP = 512
# stored records expire after TTL unless republished (libp2p Kademlia's
# provider-record expiry role: a retired authority's address does not
# linger forever); publishers re-publish every ~10 slots, far inside it
RECORD_TTL = 600.0
# a bucket untouched this long gets a synthetic-target lookup (Kademlia
# bucket refresh: keeps far buckets populated through churn)
BUCKET_REFRESH_INTERVAL = 60.0
RECORD_SIGNING_CONTEXT = b"cess-tpu/authority-record-v1:"


def node_id(port: int) -> bytes:
    """A node's DHT identity; derived from its canonical gossip port
    (the in-repo analog of deriving it from the libp2p peer id)."""
    return hashlib.sha256(b"cess-dht-node:%d" % port).digest()


def record_key(authority: str) -> bytes:
    return hashlib.sha256(b"cess-dht-authority:"
                          + authority.encode()).digest()


def distance(a: bytes, b: bytes) -> int:
    return int.from_bytes(a, "big") ^ int.from_bytes(b, "big")


@codec.register
@dataclasses.dataclass(frozen=True)
class Contact:
    port: int         # gossip listen port == node identity
    dht_port: int     # where this node answers DHT RPCs

    def node_id(self) -> bytes:
        return node_id(self.port)


@codec.register
@dataclasses.dataclass(frozen=True)
class AuthorityRecord:
    authority: str
    port: int
    dht_port: int
    serial: int       # publisher-monotonic; newest wins
    signature: bytes  # session-key signature

    def signing_payload(self) -> bytes:
        return RECORD_SIGNING_CONTEXT + codec.encode(
            (self.authority, self.port, self.dht_port, self.serial))

    def contact(self) -> Contact:
        return Contact(port=self.port, dht_port=self.dht_port)


def sign_record(key: ed25519.SigningKey, authority: str, port: int,
                dht_port: int, serial: int) -> AuthorityRecord:
    rec = AuthorityRecord(authority=authority, port=port,
                          dht_port=dht_port, serial=serial, signature=b"")
    return dataclasses.replace(rec,
                               signature=key.sign(rec.signing_payload()))


class Kademlia:
    """Routing table + verified record store + request handler. Thread
    safe; ``verify_record(rec) -> bool`` is supplied by the node layer
    (checks the session-key signature AND that the authority is in the
    current set)."""

    def __init__(self, self_contact: Contact, verify_record,
                 k: int = K, record_ttl: float = RECORD_TTL,
                 refresh_interval: float = BUCKET_REFRESH_INTERVAL):
        self.self_contact = self_contact
        self.self_id = self_contact.node_id()
        self.verify_record = verify_record
        self.k = k
        self.record_ttl = record_ttl
        self.refresh_interval = refresh_interval
        self._buckets: list[list[Contact]] = [[] for _ in range(ID_BITS)]
        self._touched: list[float] = [time.time()] * ID_BITS
        self._store: dict[bytes, AuthorityRecord] = {}
        self._stored_at: dict[bytes, float] = {}
        self._lock = threading.Lock()

    # -- routing table ------------------------------------------------------
    def _bucket_of(self, nid: bytes) -> list[Contact] | None:
        d = distance(self.self_id, nid)
        if d == 0:
            return None
        return self._buckets[d.bit_length() - 1]

    def note(self, c: Contact) -> None:
        """Learn/refresh a contact: move-to-tail on re-sight, oldest
        evicted past k (plain LRU; no liveness probe at test scale)."""
        if not (isinstance(c, Contact) and 0 < c.port < 65536
                and 0 < c.dht_port < 65536):
            return
        with self._lock:
            b = self._bucket_of(c.node_id())
            if b is None:
                return
            d = distance(self.self_id, c.node_id())
            self._touched[d.bit_length() - 1] = time.time()
            for i, have in enumerate(b):
                if have.port == c.port:
                    del b[i]
                    break
            b.append(c)
            if len(b) > self.k:
                del b[0]

    def contacts(self) -> list[Contact]:
        with self._lock:
            return [c for b in self._buckets for c in b]

    def closest(self, key: bytes, n: int | None = None) -> list[Contact]:
        """The n known contacts closest to key (XOR metric)."""
        return sorted(self.contacts(),
                      key=lambda c: distance(c.node_id(), key))[:n or self.k]

    # -- record store -------------------------------------------------------
    def store_record(self, rec, now: float | None = None) -> bool:
        """Verify + keep (newest serial wins); False if rejected. A
        re-store of the SAME record refreshes its TTL clock (that is
        what periodic republication is for)."""
        if not isinstance(rec, AuthorityRecord) \
                or not self.verify_record(rec):
            return False
        now = time.time() if now is None else now
        key = record_key(rec.authority)
        with self._lock:
            self._expire_locked(now)
            have = self._store.get(key)
            if have is not None and have.serial >= rec.serial:
                if have.serial == rec.serial and have == rec:
                    self._stored_at[key] = now    # republish: new TTL
                    return True
                return False
            if have is None and len(self._store) >= STORE_CAP:
                return False
            self._store[key] = rec
            self._stored_at[key] = now
        return True

    def record(self, key: bytes,
               now: float | None = None) -> AuthorityRecord | None:
        now = time.time() if now is None else now
        with self._lock:
            at = self._stored_at.get(key)
            if at is not None and now - at > self.record_ttl:
                del self._store[key]
                del self._stored_at[key]
                return None
            return self._store.get(key)

    def expire(self, now: float | None = None) -> int:
        """Drop every record past its TTL; returns how many went."""
        now = time.time() if now is None else now
        with self._lock:
            return self._expire_locked(now)

    def _expire_locked(self, now: float) -> int:
        stale = [k for k, at in self._stored_at.items()
                 if now - at > self.record_ttl]
        for k in stale:
            del self._store[k]
            del self._stored_at[k]
        return len(stale)

    def refresh_targets(self, now: float | None = None) -> list[bytes]:
        """One synthetic lookup target per STALE non-empty bucket (id
        with exactly that bucket's bit differing from ours — any
        lookup toward it exercises the bucket). Marks returned buckets
        touched; the caller runs the lookups."""
        now = time.time() if now is None else now
        out = []
        self_int = int.from_bytes(self.self_id, "big")
        with self._lock:
            for i, b in enumerate(self._buckets):
                if b and now - self._touched[i] > self.refresh_interval:
                    out.append((self_int ^ (1 << i)).to_bytes(
                        ID_BITS // 8, "big"))
                    self._touched[i] = now
        return out

    # -- request handling ---------------------------------------------------
    def handle(self, req):
        """One DHT RPC: (op, sender_contact, arg) -> response tuple.
        Every request teaches us the sender (Kademlia's implicit
        table maintenance)."""
        if not (isinstance(req, tuple) and len(req) == 3):
            return ("err", "bad request")
        op, sender, arg = req
        if isinstance(sender, Contact):
            self.note(sender)
        if op == "find_node" and isinstance(arg, bytes) \
                and len(arg) == ID_BITS // 8:
            return ("nodes", tuple(self.closest(arg)))
        if op == "find_value" and isinstance(arg, bytes) \
                and len(arg) == ID_BITS // 8:
            rec = self.record(arg)
            if rec is not None:
                return ("value", rec)
            return ("nodes", tuple(self.closest(arg)))
        if op == "store":
            return ("ok", self.store_record(arg))
        if op == "ping":
            return ("pong", self.self_contact)
        return ("err", "unknown op")
