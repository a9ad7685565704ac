"""WebSocket push subscriptions (the EthPubSub role, reference
node/src/rpc.rs:229-328 wiring EthPubSubApiServer over jsonrpsee's WS
transport).

A minimal RFC 6455 server endpoint mounted at ``GET /ws`` on the
JSON-RPC HTTP server: handshake, masked client text frames in,
unmasked server text frames out, ping/pong, close. Over it speaks
JSON-RPC 2.0 with:

  eth_subscribe ["newHeads"] | ["logs", criteria]  -> subscription id
  eth_unsubscribe [id]                             -> bool

and pushes ``eth_subscription`` notifications. Delivery is POLLED off
the node head (no cross-thread hooks into consensus): each connection
thread checks for new blocks every POLL_S while waiting for client
frames, so push latency is ~POLL_S and a dead client costs one thread
+ one socket until it times out. Log criteria reuse the EthFilter
normalizer, so validation/semantics match eth_newFilter exactly; the
cursor is reorg-checked the same way (rewind to finalized, redeliver)."""
from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct

_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
POLL_S = 0.15
SEND_TIMEOUT_S = 10.0      # slow readers get a real stall budget, not
                           # the 150 ms poll tick (review finding)
MAX_WS_FRAME = 1 << 20


class _Gone(Exception):
    """Peer unreachable mid-send: unwind the connection quietly."""


def accept_key(client_key: str) -> str:
    return base64.b64encode(
        hashlib.sha1(client_key.encode() + _GUID).digest()).decode()


class SockReader:
    """recv() facade that drains a prefix buffer first — frames the
    client PIPELINED behind the HTTP upgrade were already pulled into
    the handler's buffered reader and must not be lost."""

    def __init__(self, sock: socket.socket, initial: bytes = b""):
        self.sock = sock
        self.buf = initial

    def recv(self, n: int) -> bytes:
        if self.buf:
            out, self.buf = self.buf[:n], self.buf[n:]
            return out
        return self.sock.recv(n)


def read_frame(sock) -> tuple[int, bytes] | None:
    """One frame -> (opcode, payload); None on close/EOF; raises
    socket.timeout only while IDLE (before any header byte), so the
    caller's poll loop wakes without tearing the connection down.
    Client frames MUST be masked (RFC 6455 §5.1)."""
    hdr = _read_exact(sock, 2, idle_timeout_ok=True)
    if hdr is None:
        return None
    b0, b1 = hdr
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    length = b1 & 0x7F
    if length == 126:
        ext = _read_exact(sock, 2)
        if ext is None:
            return None
        length = struct.unpack(">H", ext)[0]
    elif length == 127:
        ext = _read_exact(sock, 8)
        if ext is None:
            return None
        length = struct.unpack(">Q", ext)[0]
    if length > MAX_WS_FRAME or not masked:
        return None
    mask = _read_exact(sock, 4)
    if mask is None:
        return None
    payload = _read_exact(sock, length)
    if payload is None:
        return None
    return opcode, bytes(b ^ mask[i % 4] for i, b in enumerate(payload))


def _read_exact(sock, n: int,
                idle_timeout_ok: bool = False) -> bytes | None:
    """n bytes or None. socket.timeout is an OSError subclass, so it
    needs explicit handling: with no bytes buffered and
    ``idle_timeout_ok`` it propagates (poll-loop wakeup); mid-frame it
    retries a bounded number of short waits before giving up on the
    stalled peer."""
    buf = b""
    stalls = 0
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if not buf and idle_timeout_ok:
                raise
            stalls += 1
            if stalls > 200:       # ~30 s at POLL_S: dead mid-frame
                return None
            continue
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def write_frame(sock: socket.socket, payload: bytes,
                opcode: int = 0x1) -> None:
    n = len(payload)
    if n < 126:
        hdr = bytes([0x80 | opcode, n])
    elif n < 1 << 16:
        hdr = bytes([0x80 | opcode, 126]) + struct.pack(">H", n)
    else:
        hdr = bytes([0x80 | opcode, 127]) + struct.pack(">Q", n)
    sock.sendall(hdr + payload)


def serve_connection(server, handler) -> None:
    """Run one upgraded WS connection until close. ``server`` is the
    RpcServer (lock + node + criteria normalizer); ``handler`` the
    http request handler whose socket we take over."""
    sock = handler.connection
    sock.settimeout(POLL_S)
    reader = SockReader(sock, getattr(handler, "ws_initial", b""))
    subs: dict[str, dict] = {}     # id -> {kind, crit, cursor, hash}

    def send_raw(payload: bytes, opcode: int = 0x1) -> None:
        # every send swaps to the send budget and back; any failure
        # raises _Gone so each call site unwinds the same way
        sock.settimeout(SEND_TIMEOUT_S)
        try:
            write_frame(sock, payload, opcode)
        except OSError as e:
            raise _Gone from e
        finally:
            try:
                sock.settimeout(POLL_S)
            except OSError:
                pass

    def send_json(obj) -> None:
        send_raw(json.dumps(obj).encode())

    def snapshot_head():
        with server.lock:
            head = server.node.head()
            return head.number, head.hash()

    try:
        _serve(server, reader, subs, send_raw, send_json, snapshot_head)
    except _Gone:
        return


def _serve(server, sock, subs, send_raw, send_json, snapshot_head):
    seq = 0
    while True:
        # 1) pump any due notifications
        _push_updates(server, subs, send_json)
        # 2) wait briefly for a client frame
        try:
            frame = read_frame(sock)
        except socket.timeout:
            continue
        except OSError:
            return
        if frame is None:
            return
        opcode, payload = frame
        if opcode == 0x8:                    # close
            try:
                send_raw(b"", opcode=0x8)
            except _Gone:
                pass
            return
        if opcode == 0x9:                    # ping -> pong
            send_raw(payload, opcode=0xA)
            continue
        if opcode != 0x1:
            continue
        try:
            req = json.loads(payload)
            rid = req.get("id")
            method = req.get("method", "")
            params = req.get("params", [])
        except (json.JSONDecodeError, UnicodeDecodeError, AttributeError):
            continue
        if method == "eth_subscribe" and isinstance(params, list) \
                and params:
            kind = params[0]
            if kind == "newHeads":
                crit = None
            elif kind == "logs":
                flt = params[1] if len(params) > 1 \
                    and isinstance(params[1], dict) else {}
                try:
                    crit = server._norm_criteria(flt)
                except (ValueError, TypeError) as e:
                    send_json({"jsonrpc": "2.0", "id": rid, "error": {
                        "code": -32602,
                        "message": f"bad criteria: {e}"}})
                    continue
            else:
                send_json({"jsonrpc": "2.0", "id": rid, "error": {
                    "code": -32602,
                    "message": f"unknown subscription {kind!r}"}})
                continue
            if len(subs) >= 64:
                send_json({"jsonrpc": "2.0", "id": rid, "error": {
                    "code": -32000, "message": "subscription cap"}})
                continue
            seq += 1
            sid = hex(seq)
            num, hsh = snapshot_head()
            subs[sid] = {"kind": kind, "crit": crit, "cursor": num,
                         "hash": hsh}
            send_json({"jsonrpc": "2.0", "id": rid, "result": sid})
        elif method == "eth_unsubscribe" and isinstance(params, list) \
                and params:
            ok = subs.pop(params[0], None) is not None
            send_json({"jsonrpc": "2.0", "id": rid, "result": ok})
        else:
            send_json({"jsonrpc": "2.0", "id": rid, "error": {
                "code": -32601, "message": f"unknown {method!r}"}})


def _push_updates(server, subs: dict, send_json) -> None:
    """Deliver new heads/logs since each subscription's cursor; the
    cursor is reorg-checked like EthFilter polls (rewind to finalized
    and redeliver rather than silently skip)."""
    if not subs:
        return
    from .rpc import _encode

    with server.lock:
        node = server.node
        for sid, sub in subs.items():
            since, head = server.cursor_window(node, sub["cursor"],
                                               sub["hash"])
            if since >= head.number:
                continue
            if sub["kind"] == "newHeads":
                out = [{"number": n,
                        "hash": "0x" + node.chain[n].hash().hex(),
                        "parentHash": "0x" + node.chain[n].parent.hex(),
                        "author": node.chain[n].author}
                       for n in range(since + 1, head.number + 1)]
            else:
                out = [_encode(lg) for lg in
                       server._eth_logs(node.runtime, sub["crit"],
                                        frm=since + 1)]
            sub["cursor"], sub["hash"] = head.number, head.hash()
            sub["_due"] = out
    # send OUTSIDE the node lock: a slow client must not stall the node
    for sid, sub in list(subs.items()):
        for item in sub.pop("_due", []):
            send_json({"jsonrpc": "2.0", "method": "eth_subscription",
                       "params": {"subscription": sid, "result": item}})
