"""Observability: Prometheus-style metrics + structured block logs.

The reference threads a Prometheus registry through tx-pool, consensus
and RPC and streams telemetry
(the reference's node/src/service.rs:109-151,227-234). Here the same
operational signals, framework-native:

- ``render_metrics(node)``: Prometheus text exposition of chain
  height / finality / tx pool / storage economy / audit state —
  served at ``GET /metrics`` by the RPC server and by the TCP
  service's status surface.
- ``BlockLogger``: structured per-block JSON lines (the
  ``log::info!`` + telemetry analog), attachable as an offchain
  agent.
"""
from __future__ import annotations

import json
import sys
import time


def collect(node) -> dict[str, float]:
    rt = node.runtime
    st = rt.state
    ch = rt.audit.challenge()
    m = {
        "cess_block_height": node.head().number,
        "cess_finalized_height": node.finalized,
        "cess_tx_pool_size": len(node.tx_pool),
        "cess_known_blocks": len(node.headers),
        "cess_authorities": len(node.authorities),
        "cess_spec_version": st.get("system", "spec_version", default=0),
        "cess_era": rt.staking.current_era(),
        "cess_total_idle_space_bytes":
            rt.storage_handler.total_idle_space(),
        "cess_total_service_space_bytes":
            rt.storage_handler.total_service_space(),
        "cess_miner_count": st.count_prefix("sminer", "miner"),
        "cess_tee_worker_count": st.count_prefix("tee_worker", "worker"),
        "cess_challenge_active": 0 if ch is None else 1,
        "cess_challenge_pending_miners":
            0 if ch is None else len(ch.miners),
    }
    # event-derived counters over the retained history window
    verifies = st.events_of("audit", "VerifyResult")
    m["cess_audit_pass_total"] = sum(
        1 for e in verifies
        if dict(e.data).get("idle") and dict(e.data).get("service"))
    m["cess_audit_fail_total"] = len(verifies) - m["cess_audit_pass_total"]
    m["cess_offences_total"] = len(st.events_of("offences"))
    m["cess_extrinsic_failed_total"] = len(
        st.events_of("system", "ExtrinsicFailed"))
    # submission-engine counters (cess_tpu_torch/serve): queue depth, batch
    # occupancy, pad waste, latency percentiles per op class — merged
    # into the same exposition when a node has an engine attached
    engine = getattr(node, "engine", None)
    if engine is not None:
        m.update(engine.stats_metrics())
    # telemetry-stream delivery counters (satellite: drops and sends
    # were previously silent — a dead collector looked identical to a
    # healthy one from the node's own metrics)
    for agent in getattr(node, "offchain_agents", ()):
        counters = getattr(agent, "telemetry_counters", None)
        if callable(counters):
            m.update(counters())
    # tracer ring-buffer evictions (ISSUE 6 satellite): a wrapped span
    # ring silently turned exports into a window — now the drop count
    # rides the scrape beside everything else
    tracer = _node_tracer(node)
    if tracer is not None:
        m["cess_trace_spans_dropped_total"] = float(tracer.dropped)
    # chain-plane observability gauges (obs/chainwatch.py): finality
    # lag / reorg / equivocation / market-ledger health when a
    # ChainWatch plane is armed (node.cli --chainwatch)
    chainwatch = getattr(node, "chainwatch", None)
    if chainwatch is not None:
        m.update(chainwatch.metrics())
    # remediation-plane gauges (serve/remediate.py): policy fires,
    # suppressions, live engagements, flaps when a RemediationPlane is
    # armed (node.cli --remediate)
    remediation = getattr(node, "remediation", None)
    if remediation is not None:
        m.update(remediation.metrics())
    # durability-plane gauges (obs/custody.py): ledger sizes, the
    # erasure-margin minimum + histogram, at-risk/lost counts when a
    # CustodyPlane is armed (node.cli --custody)
    custody = getattr(node, "custody", None)
    if custody is not None:
        m.update(custody.metrics())
    return m


def _node_tracer(node):
    """The tracer whose counters this node's scrape reports: the
    node-pinned one (node.cli --trace), else the process-armed tracer,
    else None (same resolution order as the cess_traceDump RPC)."""
    from ..obs import trace

    tracer = getattr(node, "tracer", None)
    return tracer if tracer is not None else trace.armed_tracer()


def render_metrics(node) -> str:
    """Prometheus text exposition format 0.0.4.

    TYPE lines are per-family and honest: monotonic ``*_total`` series
    declare ``counter`` (they used to claim ``gauge``, which breaks
    rate() semantics downstream), latency families from the engine
    render as real cumulative ``histogram`` buckets
    (``_bucket{le=...}``/``_sum``/``_count``), everything else stays
    ``gauge``. Labeled families (the ``cess_slo_*`` per-class gauges
    and ``cess_tenant_*`` series from an SLO board) render with
    escaped label values and exactly ONE TYPE line per family, however
    many label sets it carries. tests/test_metrics.py round-trips this
    output."""
    from ..obs import prom

    lines = []
    for name, value in sorted(collect(node).items()):
        kind = "counter" if name.endswith("_total") else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")
    # build-info gauge (standard Prometheus practice): constant 1 with
    # the identifying facts as labels — joinable against every other
    # family, and MetricFederator relabels it like any other series
    info_labels = {"instance": node.name,
                   "version": str(_spec_version(node))}
    lines.append("# TYPE cess_build_info gauge")
    lines.append(f"cess_build_info{prom.format_labels(info_labels)} 1")
    engine = getattr(node, "engine", None)
    if engine is not None:
        for family, hist in sorted(engine.stats_histograms().items()):
            lines.extend(prom.render_histogram(family, hist))
        # labeled gauge/counter families (SLO board): group by family
        # so the TYPE line appears once, then every label set
        declared = set()
        # stable-sorted by family: the exposition format wants every
        # line of a family in one contiguous group
        for family, kind, labels, value in sorted(
                engine.labeled_series(), key=lambda s: s[0]):
            if family not in declared:
                declared.add(family)
                lines.append(f"# TYPE {family} {kind}")
            lines.append(f"{family}{prom.format_labels(labels)} {value}")
        # labeled histogram families (per-tenant latency): same
        # one-TYPE-line discipline across label sets
        hist_declared = set()
        for family, labels, hist in engine.labeled_histograms():
            lines.extend(prom.render_histogram(
                family, hist, labels=labels,
                type_line=family not in hist_declared))
            hist_declared.add(family)
    return "\n".join(lines) + "\n"


class TelemetryStream:
    """Push telemetry to an external endpoint (the reference's
    telemetry worker streaming to telemetry.polkadot.io-style
    collectors, the reference's node/src/service.rs:227-234): one JSON
    line per imported block over a persistent TCP connection to
    ``host:port``.

    Connection failures NEVER affect the node: on_block only enqueues
    into a bounded queue; ALL network IO (blocking connects to
    firewalled hosts included — a 1 s SYN timeout on the import thread
    would eat the slot budget, review-caught) runs on a dedicated
    sender thread, and a full queue drops the oldest records.

    Delivery is COUNTED, not silent: every record that reaches the
    endpoint increments ``sent``, every record lost (queue overflow,
    endpoint down, broken connection) increments ``dropped``, and both
    ride the /metrics exposition as ``cess_telemetry_sent_total`` /
    ``cess_telemetry_dropped_total`` — so a dead collector is visible
    from the node's own scrape. With a tracer armed
    (cess_tpu_torch/obs), each record also carries the session trace id, so
    an external collector's rows can be joined against a trace dump."""

    RECONNECT_COOLDOWN = 5.0
    QUEUE_CAP = 256

    def __init__(self, endpoint: str):
        import queue
        import threading

        host, _, port = endpoint.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        # delivery counters, single-writer each so no lock is needed:
        # sent/dropped belong to the sender thread, overflow drops to
        # the import thread (a shared `+= 1` from both threads is a
        # read-modify-write race that loses counts under GIL
        # preemption); scrapes sum them read-only
        self.sent = 0
        self.dropped = 0
        self._overflow_dropped = 0
        self._q: "queue.Queue[dict | None]" = queue.Queue(self.QUEUE_CAP)
        self._sock = None
        self._next_try = 0.0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def telemetry_counters(self) -> dict[str, float]:
        """Merged into the node /metrics exposition (collect())."""
        return {"cess_telemetry_sent_total": float(self.sent),
                "cess_telemetry_dropped_total":
                    float(self.dropped + self._overflow_dropped)}

    def on_block(self, node) -> None:
        head = node.head()
        rec = {
            "ts": round(time.time(), 3),
            "node": node.name,
            "chain": node.spec.chain_id,
            "best": head.number,
            "best_hash": head.hash().hex(),
            "finalized": node.finalized,
            "txcount": len(node.tx_pool),
            "authorities": len(node.authorities),
            "version": _spec_version(node),
        }
        _stamp_trace(rec)
        import queue

        try:
            self._q.put_nowait(rec)
        except queue.Full:
            try:                       # drop the OLDEST, keep current
                self._q.get_nowait()
                self._overflow_dropped += 1
                self._q.put_nowait(rec)
            except queue.Empty:
                pass

    # -- sender thread -------------------------------------------------------
    def _run(self) -> None:
        while True:
            rec = self._q.get()
            if rec is None:
                # the worker owns the socket exclusively: tear it
                # down HERE, not in close() — a join timeout must
                # never leave two threads touching _sock/_next_try
                self._drop_conn()
                return
            sock = self._connect()
            if sock is None:
                self.dropped += 1      # endpoint down: record dropped
                continue
            try:
                sock.sendall((json.dumps(rec) + "\n").encode())
                self.sent += 1
            except OSError:
                self.dropped += 1
                self._drop_conn()

    def _connect(self):
        import socket

        now = time.time()
        if self._sock is None and now >= self._next_try:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=1.0)
            except OSError:
                self._next_try = now + self.RECONNECT_COOLDOWN
        return self._sock

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._next_try = time.time() + self.RECONNECT_COOLDOWN

    def close(self, timeout: float = 2.0) -> None:
        """Flush queued records (best effort) and stop the sender."""
        import queue

        try:
            self._q.put(None, timeout=timeout)
        except queue.Full:
            pass
        self._worker.join(timeout=timeout)


def _spec_version(node) -> int:
    from ..chain import migrations

    return migrations.spec_version(node.runtime.state)


def _stamp_trace(rec: dict) -> None:
    """With a tracer armed (cess_tpu_torch/obs), stamp the record with the
    trace id its head block was imported under, so telemetry rows and
    block logs join against an exported trace dump. No-op otherwise."""
    from ..obs import trace

    tracer = trace.armed_tracer()
    if tracer is not None:
        rec["trace_id"] = tracer.trace_id


class BlockLogger:
    """Offchain-agent-shaped structured logger: one JSON line per
    imported/authored block (height, hash, author, events, pool)."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr

    def on_block(self, node) -> None:
        head = node.head()
        rec = {
            "ts": round(time.time(), 3),
            "node": node.name,
            "block": head.number,
            "hash": head.hash().hex()[:16],
            "author": head.author,
            "finalized": node.finalized,
            "events": len(node.runtime.state.events),
            "tx_pool": len(node.tx_pool),
        }
        _stamp_trace(rec)
        print(json.dumps(rec), file=self.stream, flush=True)
