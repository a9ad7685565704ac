"""Multi-device serving plane: the device-pool scheduler that spreads the
submission engine's batches over several devices.

The port's counterpart of ``cess_tpu/serve/pool.py``. Without a pool
the engine runs every batch on one device; :class:`DevicePool` gives it
a :class:`DeviceLane` for each device:

- each lane has its own worker thread, which launches on the lane's own
  CUDA stream and synchronizes it before any future of its batch
  resolves; its own breakers, one per engine backend, named
  ``codec.d<i>`` / ``audit.d<i>`` beside the engine's; its own
  ``AuditBackend`` view on the lane's device; and its own slice of the
  program cache (``SubmissionEngine._key`` grows a ``("device", i)``
  component on the pool path, so a program prepared for lane 0 is never
  handed lane 3's batch);
- one deliberate difference from the TPU package: each lane also gets
  its own **codec view**, a codec of the engine codec's kind, k, m and
  strategy on the lane's device. The TPU package shares one
  device-agnostic codec and places each batch with
  ``jax.default_device``; the port's codecs are pinned to a device, so
  a shared codec would put every lane's batch on the engine's device;
- placement is deficit-weighted on in-flight rows: the least-loaded lane
  wins and ties break by lane index (no wall clock, no entropy). Every
  placement appends to a bounded, count-sequenced log, the replay
  witness;
- a lane whose dispatch fails, or whose breaker denies admission,
  hands its batch whole to a healthy sibling (``requeue``); the engine's
  member salvage and CPU degradation run only once every sibling has
  been tried. While a lane's breaker is open every ``probe_every``-th
  placement of that op class is offered back to it as a recovery probe;
- :meth:`DevicePool.stream_entry` points a ``StreamingIngest`` at an
  ``(n_lanes, 1)`` mesh of the lanes, the seg slices copied on the
  lanes' streams.

A device may back several lanes: ``DevicePool(["cpu"] * 3)`` runs the
pool on the host (torch has one CPU device), and a card listed twice
runs two lanes on one card. Lanes on one device take turns: each batch
holds its device's lock (``SubmissionEngine`` keeps one per device), as
a graph capture must exclude every launch on its card.

The pool changes WHERE a batch runs, never what it computes: results are
byte-equal to the single-device engine's and the direct calls'. An
engine built without ``pool=`` takes the single-device path unchanged.

Thread-safety: every pool and lane counter is guarded by the one pool
lock; breaker state lives in the monitors. The flight notes
``pool.requeue`` and ``pool.escape`` are written with the pool lock
released.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any

import torch

from ..obs import flight as _flight

PLACEMENT_LOG = 4096     # bounded placement-log window (replay witness)


class DeviceLane:
    """One device's worker lane inside the pool: the device, its CUDA
    stream (None on the CPU), its per-backend breakers, its codec and
    AuditBackend views, a pending-batch queue and the load and served
    counters placement reads. The mutable fields are guarded by the
    owning pool's lock."""

    __slots__ = ("index", "device", "stream", "codec", "audit", "monitors",
                 "pending", "thread", "batches", "rows", "requeues",
                 "inflight_rows")

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.device = device
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self.codec = None                   # lane-pinned codec view
        self.audit = None                   # lane-pinned AuditBackend
        self.monitors: dict[str, Any] = {}  # backend -> HealthMonitor
        self.pending: collections.deque = collections.deque()
        self.thread: threading.Thread | None = None
        self.batches = 0          # batches this lane completed
        self.rows = 0             # real rows across those batches
        self.requeues = 0         # batches received from a sick sibling
        self.inflight_rows = 0    # placement's deficit counter

    def breaker_state(self, backend: str | None) -> str:
        """This lane's breaker state for an op class's backend:
        "closed" when unmonitored (no resilience configured)."""
        mon = self.monitors.get(backend)
        return "closed" if mon is None else mon.state

    def scope(self):
        """The lane worker's launch context: its device and its stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack


def lane_codec(codec, device: torch.device):
    """A codec of ``codec``'s kind, geometry and strategy on ``device``."""
    return type(codec)(codec.k, codec.m, device=device,
                       strategy=codec.strategy)


class DevicePool:
    """See module doc. Construct over explicit devices (``["cpu"] * n`` on
    the host, a card listed more than once) or the first ``n`` CUDA
    devices (``n`` of 0 or None: all; raises without a card), then pass
    to ``make_engine(pool=...)``: the engine binds the pool, which builds
    the per-lane breakers and views and starts the lane workers."""

    def __init__(self, devices=None, n: int | None = None,
                 probe_every: int = 8):
        from ..parallel.mesh import resolve_devices

        devices = resolve_devices(devices)
        if n:
            devices = devices[:n]
        if probe_every < 1:
            raise ValueError("probe_every must be >= 1")
        self.lanes = [DeviceLane(i, d) for i, d in enumerate(devices)]
        self.probe_every = probe_every
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._engine = None
        self._closed = False
        self._seq = 0             # placement sequence (count, not time)
        # the replay witness: (seq, op, members, rows, lane, reason)
        self._log: collections.deque = \
            collections.deque(maxlen=PLACEMENT_LOG)
        self._probe_tick: dict[str, int] = {}   # op -> placements seen

    @property
    def n_devices(self) -> int:
        return len(self.lanes)

    def devices(self) -> list:
        return [lane.device for lane in self.lanes]

    # -- engine binding ------------------------------------------------------
    def bind(self, engine) -> None:
        """Wire the pool into an engine (``SubmissionEngine.__init__``):
        per-lane breakers from the engine's resilience monitor factory
        (registered as ``<backend>.d<i>`` beside the engine's own), a
        lane-pinned codec and AuditBackend view per lane, and one worker
        thread per lane. A pool serves exactly one engine."""
        with self._mu:
            if self._engine is not None:
                raise ValueError("DevicePool already bound to an engine")
            if self._closed:
                raise ValueError("DevicePool is shut down")
            self._engine = engine
        res = engine.resilience
        if res is not None:
            for lane in self.lanes:
                for backend in engine.monitors:
                    mon = res.monitor()
                    mon.name = f"{backend}.d{lane.index}"
                    lane.monitors[backend] = mon
                    res.stats.register_monitor(mon.name, mon)
        for lane in self.lanes:
            if engine.codec is not None:
                lane.codec = lane_codec(engine.codec, lane.device)
            if engine.audit is not None:
                from ..ops.audit_backend import AuditBackend

                # same key, lane device: an AuditBackend pins every op to
                # its own device
                lane.audit = AuditBackend(engine.audit.key, lane.device)
        for lane in self.lanes:
            lane.thread = threading.Thread(
                target=self._worker, args=(lane,), daemon=True,
                name=f"cess-pool-lane-{lane.index}")
            lane.thread.start()

    # -- placement -----------------------------------------------------------
    def dispatch(self, batch) -> None:
        """Place one drained batch on a lane (engine batcher thread).
        The engine already counted it in flight; the lane worker settles
        it through ``engine._batch_done``."""
        op = batch[0].key[0]
        rows = sum(r.rows for r in batch)
        with self._cond:
            if self._closed or self._engine is None:
                raise RuntimeError("device pool is not serving")
            lane, reason = self._place_locked(op, rows, frozenset())
            lane.inflight_rows += rows
            self._seq += 1
            self._log.append((self._seq, op, len(batch), rows,
                              lane.index, reason))
            lane.pending.append((batch, set()))
            self._cond.notify_all()

    def requeue(self, batch, lane: DeviceLane, tried: set) -> bool:
        """Hand a failing lane's batch to a healthy sibling (the engine's
        ``_run_batch`` on the pool path, on a dispatch failure or a
        breaker denial). ``tried`` gathers the lanes that already failed
        the batch, so it never bounces forever. Returns False when no
        healthy untried sibling exists: the caller falls back to the
        engine's salvage and degradation."""
        eng = self._engine
        tried.add(lane.index)
        op = batch[0].key[0]
        rows = sum(r.rows for r in batch)
        backend = eng._BACKEND_OF.get(op) if eng is not None else None
        with self._cond:
            if self._closed:
                return False
            sibs = [ln for ln in self.lanes
                    if ln.index not in tried
                    and ln.breaker_state(backend) == "closed"]
            if not sibs:
                return False
            target = self._least_loaded(sibs)
            target.inflight_rows += rows
            target.requeues += 1
            self._seq += 1
            self._log.append((self._seq, op, len(batch), rows,
                              target.index, "requeue"))
            target.pending.append((batch, tried))
            self._cond.notify_all()
        # journal with the pool lock released (incident listeners read
        # engine and pool snapshots)
        _flight.note("pool", "requeue", op=op, rows=rows,
                     src=lane.index, dst=target.index)
        return True

    def _place_locked(self, op: str, rows: int, tried) -> tuple:
        """Pick the lane for a fresh placement (pool lock held):
        least-loaded on in-flight rows, ties by lane index. Lanes whose
        breaker for the op's backend is open are avoided, except that
        every ``probe_every``-th placement of an op class goes to the
        least-loaded open lane as a recovery probe (its breaker decides
        whether to admit it); held lanes are never probed. With every
        breaker open the least-loaded lane is picked anyway: its denial
        path degrades."""
        eng = self._engine
        backend = eng._BACKEND_OF.get(op) if eng is not None else None
        lanes = [ln for ln in self.lanes if ln.index not in tried]
        healthy = [ln for ln in lanes
                   if ln.breaker_state(backend) == "closed"]
        tripped = [ln for ln in lanes
                   if ln.breaker_state(backend) == "open"]
        if healthy and tripped:
            tick = self._probe_tick.get(op, 0) + 1
            self._probe_tick[op] = tick
            if tick % self.probe_every == 0:
                return self._least_loaded(tripped), "probe"
        if healthy:
            return self._least_loaded(healthy), "least-loaded"
        return self._least_loaded(lanes), "all-open"

    @staticmethod
    def _least_loaded(lanes: list) -> DeviceLane:
        return min(lanes, key=lambda ln: (ln.inflight_rows, ln.index))

    # -- lane workers --------------------------------------------------------
    def _worker(self, lane: DeviceLane) -> None:
        with lane.scope():
            while True:
                with self._cond:
                    while not lane.pending and not self._closed:
                        self._cond.wait()
                    if not lane.pending:
                        return            # closed and drained
                    batch, tried = lane.pending.popleft()
                rows = sum(r.rows for r in batch)
                handed_off = False
                try:
                    # the engine's batch runner does the rest: breaker
                    # gating, the lane's device lock, salvage, resolving
                    # the futures. True: the batch went to a sibling
                    handed_off = bool(self._engine._run_batch(
                        batch, lane=lane, tried=tried))
                except BaseException as e:
                    # an escape kills this lane's worker: journal it first
                    _flight.note("pool", "escape", lane=lane.index,
                                 error=repr(e))
                    raise
                finally:
                    with self._cond:
                        lane.inflight_rows -= rows
                        if not handed_off:
                            lane.batches += 1
                            lane.rows += rows
                    if not handed_off:
                        self._engine._batch_done()

    # -- StreamingIngest placement -------------------------------------------
    def stream_entry(self, pipeline, batch: int,
                     pair_ids: bool = False) -> dict:
        """The ``(program, put, put_ids)`` kwargs that point a
        StreamingIngest at this pool's lanes: each staged batch's seg
        slices go to the lanes' devices on the lanes' streams
        (``parallel/mesh.py`` ``pool_stream_entry``). ``batch`` must be
        divisible by the lane count."""
        from ..parallel.mesh import pool_stream_entry

        streams = [lane.stream for lane in self.lanes]
        return pool_stream_entry(
            pipeline, self.devices(), batch, pair_ids,
            streams=None if None in streams else streams)

    # -- introspection / lifecycle -------------------------------------------
    def placement_log(self) -> tuple:
        """The bounded placement log: ``(seq, op, members, rows, lane,
        reason)`` rows, count-sequenced; the same offered sequence gives
        the same log."""
        with self._mu:
            return tuple(self._log)

    def snapshot(self) -> dict:
        with self._mu:
            lanes = []
            for lane in self.lanes:
                lanes.append({
                    "device": lane.index,
                    "platform": lane.device.type,
                    "batches": lane.batches,
                    "rows": lane.rows,
                    "requeues": lane.requeues,
                    "inflight_rows": lane.inflight_rows,
                    "breakers": {b: m.state
                                 for b, m in lane.monitors.items()},
                })
            return {"n_devices": len(self.lanes),
                    "placements": self._seq,
                    "lanes": lanes}

    def metrics(self) -> dict[str, float]:
        """Flat per-lane gauges, the ``cess_engine_device_*`` family
        (merged by ``EngineStats.metrics``)."""
        snap = self.snapshot()
        out = {"cess_engine_device_count": float(snap["n_devices"]),
               "cess_engine_device_placements": float(snap["placements"])}
        for lane in snap["lanes"]:
            i = lane["device"]
            for name in ("batches", "rows", "requeues", "inflight_rows"):
                out[f"cess_engine_device_{i}_{name}"] = float(lane[name])
            for backend, state in lane["breakers"].items():
                out[f"cess_engine_device_{i}_{backend}_open"] = \
                    0.0 if state == "closed" else 1.0
        return out

    def close(self, timeout: float | None = 5.0) -> None:
        """Stop the lane workers after they drain their pending batches
        (``SubmissionEngine.close`` calls this)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for lane in self.lanes:
            t = lane.thread
            if t is not None:
                t.join(timeout)
