"""Double-buffered host-to-device streaming ingest for encode + tag.

The port's counterpart of ``cess_tpu/serve/stream.py``. A gateway
ingests a STREAM of 16 MiB segments from the host; serializing each
batch's transfer against its compute throws away what the kernels won.
:class:`StreamingIngest` drives the pipeline's fused encode + tag
program (``StoragePipeline.fused_program``) over host segments:

- on the card, each batch is staged once: its rows are copied into one
  of ``depth`` pinned host buffers of [batch, segment_size] uint8, made
  when a first chunk needs one (rows that already lie in pinned memory,
  a slice of a pinned source, are copied from where they lie and need
  none), and the host-to-device copy of the real
  rows into one of ``depth`` device buffers is issued non-blocking on a
  side ``torch.cuda.Stream``, followed by an event. The compute stream (the
  caller's current stream) waits on that event, runs the program and
  records the batch's completion event. So batch i+1's copy overlaps
  batch i's kernels;
- at most ``depth`` batches are in flight: the window is enforced
  BEFORE the next batch is staged, and ``drain_one`` blocks on the
  oldest batch's own completion event (counted as ``stall_s``). Slot
  i % depth is restaged only after batch i - depth was drained, so its
  pinned buffer is reused only after its copy completed and its device
  buffer only after the kernels that read it completed. The device
  buffers live for the run and are never handed back to the caching
  allocator while a stream still uses them;
- the ragged final batch is padded with zero segments to the batch
  shape (on the card, by zeroing the device buffer's pad rows) and
  sliced back (every op is row-independent);
- default ids are the arange over the GLOBAL row index, exactly the
  direct path's default over the whole array;
- every stage is counted in :class:`~.stats.StreamStats` and exported
  through an attached engine's ``cess_engine_stream_*`` metrics;
- the TPU package's seams: a ``stream.run`` span over the run and a
  ``stream.batch`` span a batch (``obs/trace.py``, on the attached
  engine's tracer or the armed one), and the fault sites ``stream.h2d``
  (before a batch is staged) and ``stream.dispatch`` (before its program
  is launched); a staging or launch failure finishes its batch span
  with the error, notes ``stream``/``escape`` in the flight journal and
  surfaces to the consumer.

The attached engine's control planes see the stream as the class
``stream``: its SLO board gets each batch's latency (and a failed
batch's, as a failure) charged to ``tenant``, and its profile plane the
batch's bytes, its pad rows (the ragged tail's, in the same pad ledger
as the engine's bucket padding) and its ``h2d_s`` and ``dispatch_s``.
The one timing difference from the TPU package's driver: on the card
the launch returns before the copy and the kernels ran, so both feeds
are taken when the batch's completion event is reached (at its drain),
from the start of its staging: the latency is the time until the batch
was done, not until it was launched, and ``dispatch_s`` the rest of it
after the host staging. On the CPU the batch is done when its program
returns, and that is the time taken.

On the CPU the program runs on the host tensors as they are: no pinned
buffer, no side stream, no copy. Results equal the direct per-step
path bit for bit on both MAC limb widths, ragged tail included.

A mesh or a device pool takes over the device side, as in
the TPU package: ``program``, ``put`` and ``put_ids`` override the
program and the staging (``parallel/mesh.py`` ``stream_entry`` builds
the three for a mesh), and ``pool=`` derives them from
``DevicePool.stream_entry``, explicit overrides winning. The pinned
staging stays: ``put`` receives the batch's pinned host chunk (its pad
rows zeroed) and ``put_ids`` the batch's host ids; a pool's ``put``
copies each lane's seg slice to the lane's device on the lane's stream.
A mesh program's results are ``ShardedTensor``s, complete when drained;
``ingest`` gathers them.
"""
from __future__ import annotations

import collections
import time
from typing import Iterator

import numpy as np
import torch

from ..obs import flight as _flight
from ..obs import trace
from ..parallel.mesh import ShardedTensor
from ..resilience import faults
from .stats import StreamStats


def _as_host_array(source):
    """A whole-source 2-D array-like as a host array in ONE fetch (a
    CUDA tensor is fetched once, a CPU tensor, pinned or not, kept as
    it lies); anything else (a chunk iterable) passes through."""
    if isinstance(source, torch.Tensor):
        return source.cpu() if source.dim() == 2 else source
    if not isinstance(source, np.ndarray) \
            and getattr(source, "ndim", None) == 2:
        return np.asarray(source)
    return source


def _rebatch(source, batch: int) -> Iterator:
    """Yield [<=batch, seg] host chunks from an array (numpy or a CPU
    tensor: slices, no copy) or an iterable of row chunks (a network
    receive loop hands arbitrary-sized pieces)."""
    source = _as_host_array(source)
    if isinstance(source, (np.ndarray, torch.Tensor)):
        for start in range(0, source.shape[0], batch):
            yield source[start:start + batch]
        return
    pending: list[np.ndarray] = []
    rows = 0
    for piece in source:
        piece = np.asarray(piece)
        if piece.ndim == 1:
            piece = piece[None]
        pending.append(piece)
        rows += piece.shape[0]
        while rows >= batch:
            buf = np.concatenate(pending, axis=0) if len(pending) > 1 \
                else pending[0]
            yield buf[:batch]
            rest = buf[batch:]
            pending = [rest] if rest.shape[0] else []
            rows = rest.shape[0]
    if rows:
        yield np.concatenate(pending, axis=0) if len(pending) > 1 \
            else pending[0]


def _pad_host(chunk: torch.Tensor, rows: int) -> torch.Tensor:
    """A host chunk as a contiguous [rows, ...] tensor, zero rows added."""
    chunk = chunk.contiguous()
    if chunk.shape[0] == rows:
        return chunk
    return torch.cat([chunk, chunk.new_zeros(
        (rows - chunk.shape[0],) + tuple(chunk.shape[1:]))])


def _completion(out: dict, dev: torch.device) -> list:
    """Events that fire once a batch's results are complete: each
    sharded result's own (one a card holding a piece), else one on the
    pipeline device's current stream; none on the CPU."""
    events = [ev for v in out.values() if isinstance(v, ShardedTensor)
              for ev in v.record()]
    if not events and dev.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return events


def _whole(x) -> torch.Tensor:
    """A batch result as one tensor (a sharded result gathered)."""
    return x.gather() if isinstance(x, ShardedTensor) else x


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    pad = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


class StreamingIngest:
    """See module doc. One instance per stream source; safe to reuse
    for consecutive runs (counters accumulate; the pinned and device
    buffers are kept).

    pipeline: the StoragePipeline whose fused program to drive.
    batch:    segments per device batch.
    depth:    in-flight window (2 = double buffering: one batch's copy
              beside the previous batch's kernels).
    stats:    a StreamStats to count into (default: a new one).
    program:  override the device program (fn(data, ids) -> dict with
              "fragments" and "tags"): the mesh entry passes its sharded
              step here.
    put / put_ids: override the staging of a batch's [batch,
              segment_size] host chunk and its host ids (default: the
              ingest's own copy to the pipeline's device).
    pool:     optional DevicePool: the (program, put, put_ids) of
              ``pool.stream_entry``, each batch's seg axis spread over
              the lanes; explicit overrides win; ``batch`` must be
              divisible by the lane count.
    engine:   optional SubmissionEngine to export stats through.
    tenant:   optional per-tenant accounting tag: with an attached
              engine carrying an SLO board, each batch is charged to it
              under the class ``stream``.
    """

    def __init__(self, pipeline, batch: int, *, depth: int = 2,
                 program=None, put=None, put_ids=None, stats=None,
                 engine=None, tenant: str | None = None, pool=None):
        if batch < 1 or depth < 1:
            raise ValueError(f"bad stream shape: batch={batch}, "
                             f"depth={depth}")
        if pool is not None and program is None:
            entry = pool.stream_entry(pipeline, batch)
            program = entry["program"]
            put = put or entry["put"]
            put_ids = put_ids or entry["put_ids"]
        self.pipeline = pipeline
        self.batch = batch
        self.depth = depth
        self.stats = stats or StreamStats()
        self._program = program
        self._put = put
        self._put_ids = put_ids
        self._engine = engine
        self.tenant = tenant
        self._slots = None          # device buffers, one a slot, on the card
        self._pinned = [None] * depth   # pinned host buffers, made on first use
        self._filled = [0] * depth      # rows of each holding a chunk's data
        self._copy_stream = None
        if engine is not None:
            engine.attach_stream(self.stats)

    def detach(self) -> None:
        """Stop contributing to the attached engine's merged
        cess_engine_stream_* gauges (idempotent; no-op without an
        engine)."""
        if self._engine is not None:
            self._engine.detach_stream(self.stats)
            self._engine = None

    # ------------------------------------------------------------------
    def run(self, segments, fragment_ids=None) -> Iterator[dict]:
        """Stream host segments through the device; yield per-batch
        ``{"fragments", "tags", "rows"}`` dicts of tensors on the
        pipeline's device (ragged tail sliced to its real rows), each
        complete on the device when yielded.

        segments: [N, segment_size] uint8 host array (numpy or a CPU
        tensor, ideally pinned), a CUDA tensor (fetched once), or an
        iterable of row chunks (rebatched). fragment_ids: optional
        [N, k+m] or [N, k+m, 2] array (requires an array source); None
        uses the arange over the global row index.

        Input validation happens HERE, at call time, so a bad call fails
        at its own site rather than at the consumer's first next()."""
        if fragment_ids is not None:
            segments = _as_host_array(segments)
            if not isinstance(segments, (np.ndarray, torch.Tensor)) \
                    or segments.ndim != 2:
                raise ValueError(
                    "fragment_ids requires an [N, segment_size] array "
                    "segment source, not a chunked/iterator source")
            fragment_ids = fragment_ids.cpu().numpy() \
                if isinstance(fragment_ids, torch.Tensor) \
                else np.asarray(fragment_ids)
            if fragment_ids.dtype.kind == "u":    # uint32 words as values
                fragment_ids = fragment_ids.astype(np.int64)
            if fragment_ids.shape[0] != segments.shape[0]:
                raise ValueError("fragment_ids rows != segments rows")
        return self._run(segments, fragment_ids)

    def _tracer_now(self):
        """Tracer serving this run: the attached engine's own, else the
        process-armed tracer, else None."""
        if self._engine is not None and self._engine.tracer is not None:
            return self._engine.tracer
        return trace.armed_tracer()

    def _staging(self, dev: torch.device, seg: int):
        """The ``depth`` device buffers and the copy stream, made at
        first use on the card and kept."""
        shape = (self.batch, seg)
        if self._slots is None or self._slots[0].shape != shape \
                or self._slots[0].device != dev:
            self._slots = [torch.empty(shape, dtype=torch.uint8, device=dev)
                           for _ in range(self.depth)]
            self._copy_stream = torch.cuda.Stream(dev)

    def _pinned_slot(self, slot: int, seg: int) -> torch.Tensor:
        """Slot ``slot``'s pinned host buffer of [batch, seg], made when
        the first chunk that does not lie in pinned memory needs it."""
        shape = (self.batch, seg)
        if self._pinned[slot] is None or self._pinned[slot].shape != shape:
            self._pinned[slot] = torch.empty(shape, dtype=torch.uint8,
                                             pin_memory=True)
            self._filled[slot] = self.batch     # unwritten: not yet zero
        return self._pinned[slot]

    def _host_chunk(self, chunk: torch.Tensor, n: int, real: int,
                    cuda: bool) -> torch.Tensor:
        """Batch ``n``'s [batch, seg] host chunk for a ``put``: on the
        card, pinned (a full pinned chunk as it lies, else the slot's
        pinned buffer with its pad rows zeroed, those an earlier chunk
        left unzeroed only); on the CPU, padded."""
        if not cuda:
            return _pad_host(chunk, self.batch)
        if real == self.batch and chunk.is_pinned() and chunk.is_contiguous():
            return chunk
        slot = n % self.depth
        buf = self._pinned_slot(slot, chunk.shape[1])
        buf[:real].copy_(chunk)
        buf[real:self._filled[slot]].zero_()
        self._filled[slot] = real
        return buf

    def _stage(self, chunk: torch.Tensor, n: int, real: int) -> torch.Tensor:
        """Batch ``n``'s rows in its slot's device buffer: pinned rows go
        over the bus as they lie, others through the slot's pinned
        buffer; the copy runs on the side stream and the compute stream
        waits on its event."""
        slot = n % self.depth
        staged = self._slots[slot]
        src = chunk
        if not chunk.is_pinned():
            src = self._pinned_slot(slot, chunk.shape[1])[:real]
            src.copy_(chunk)
        with torch.cuda.stream(self._copy_stream):
            # only the real rows cross the bus; the ragged tail's pad
            # rows are zeroed on the card
            staged[:real].copy_(src, non_blocking=True)
            if real < self.batch:
                staged[real:].zero_()
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        torch.cuda.current_stream(staged.device).wait_event(copied)
        return staged

    def _run(self, segments, fragment_ids) -> Iterator[dict]:
        pipe = self.pipeline
        cfg = pipe.config
        rows = cfg.k + cfg.m
        dev = pipe.device
        cuda = dev.type == "cuda"
        program = self._program or pipe.fused_program()
        st = self.stats
        t_run = time.perf_counter()
        inflight: collections.deque = collections.deque()
        run_span = trace.NOOP_SPAN
        batches = stalls = 0
        if cuda and self._put is None:
            self._staging(dev, cfg.segment_size)

        def drain_one():
            nonlocal stalls
            out, real, done, bt0, h2d, launched = inflight.popleft()
            t0 = time.perf_counter()
            for ev in done:
                ev.synchronize()
            finished = time.perf_counter()
            stall = finished - t0
            st.stall_s += stall
            stalls += 1
            # the planes' feeds, at completion (module docstring): on
            # the CPU the batch was done when its program returned
            eng = self._engine
            if eng is not None and (eng.slo is not None
                                    or eng.profile is not None):
                busy = (finished if done else launched) - bt0
                if eng.slo is not None:
                    eng.slo.observe("stream", busy, tenant=self.tenant,
                                    rows=real)
                if eng.profile is not None:
                    eng.profile.on_stream(
                        batch=self.batch, rows=real,
                        nbytes=real * cfg.segment_size, h2d_s=h2d,
                        dispatch_s=busy - h2d)
            if run_span is not trace.NOOP_SPAN:
                run_span.event("stall", s=round(stall, 6))
            if real < self.batch:
                out = {k: v[:real] for k, v in out.items()}
            out["rows"] = real
            return out

        try:
            tracer = self._tracer_now()
            if tracer is not None:
                run_span = tracer.start("stream.run", sys="stream",
                                        batch=self.batch, depth=self.depth)
            seg_off = 0
            for chunk in _rebatch(segments, self.batch):
                # enforce the in-flight window BEFORE staging the next
                # batch: at most ``depth`` batches are ever enqueued
                while len(inflight) >= self.depth:
                    yield drain_one()
                chunk = torch.as_tensor(chunk)
                if chunk.dtype != torch.uint8:
                    chunk = chunk.to(torch.uint8)
                real = chunk.shape[0]
                pad = self.batch - real
                st.padded_segments += pad
                if fragment_ids is not None:
                    ids = _pad_rows(fragment_ids[seg_off:seg_off + real],
                                    self.batch)
                elif self._put_ids is not None:
                    ids = np.arange(seg_off * rows,
                                    (seg_off + self.batch) * rows,
                                    dtype=np.int64)
                else:
                    ids = torch.arange(seg_off * rows,
                                       (seg_off + self.batch) * rows,
                                       dtype=torch.int64, device=dev)
                bspan = trace.NOOP_SPAN if tracer is None \
                    else tracer.start("stream.batch", sys="stream",
                                      parent=run_span, rows=real, pad=pad)
                try:
                    bt0 = t0 = time.perf_counter()
                    faults.inject("stream.h2d")        # chaos seam: staging
                    if self._put is not None:
                        seg_in = self._put(self._host_chunk(chunk, batches,
                                                            real, cuda))
                    elif cuda:
                        seg_in = self._stage(chunk, batches, real)
                    else:
                        seg_in = _pad_host(chunk, self.batch)
                    ids = self._put_ids(ids) if self._put_ids is not None \
                        else torch.as_tensor(ids).to(dev)
                    h2d = time.perf_counter() - t0
                    st.h2d_s += h2d
                    t0 = time.perf_counter()
                    faults.inject("stream.dispatch")   # chaos seam: launch
                    out = program(seg_in, ids)
                    done = _completion(out, dev)
                except BaseException as e:
                    # the batch span lands in the ring with its error and
                    # the journal notes the escape before it surfaces
                    bspan.set(error=repr(e)).finish()
                    # a stream that died burns the stream SLO's budget
                    eng = self._engine
                    if eng is not None and eng.slo is not None:
                        eng.slo.observe("stream", time.perf_counter() - bt0,
                                        ok=False, tenant=self.tenant,
                                        rows=real)
                    _flight.note("stream", "escape", error=repr(e))
                    raise
                launched = time.perf_counter()
                dispatch = launched - t0
                st.dispatch_s += dispatch
                st.hist.observe(h2d + dispatch)
                if bspan is not trace.NOOP_SPAN:
                    bspan.finish(h2d_s=round(h2d, 6),
                                 dispatch_s=round(dispatch, 6))
                st.batches += 1
                batches += 1
                st.segments += real
                st.bytes_in += real * cfg.segment_size
                seg_off += self.batch
                inflight.append((out, real, done, bt0, h2d, launched))
            while inflight:
                yield drain_one()
        finally:
            st.wall_s += time.perf_counter() - t_run
            if run_span is not trace.NOOP_SPAN:
                run_span.finish(batches=batches, stalls=stalls)

    def ingest(self, segments, fragment_ids=None) -> dict:
        """Run the whole stream and concatenate the per-batch results:
        the ``forward``-shaped output without managing the generator."""
        outs = list(self.run(segments, fragment_ids))
        if not outs:
            raise ValueError("empty segment stream")
        return {name: torch.cat([_whole(o[name]) for o in outs])
                for name in ("fragments", "tags")}
