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
  through an attached engine's ``cess_engine_stream_*`` metrics.

On the CPU the program runs on the host tensors as they are: no pinned
buffer, no side stream, no copy. Results equal the direct per-step
path bit for bit on both MAC limb widths, ragged tail included.
"""
from __future__ import annotations

import collections
import time
from typing import Iterator

import numpy as np
import torch

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
    engine:   optional SubmissionEngine to export stats through.
    """

    def __init__(self, pipeline, batch: int, *, depth: int = 2,
                 stats=None, engine=None):
        if batch < 1 or depth < 1:
            raise ValueError(f"bad stream shape: batch={batch}, "
                             f"depth={depth}")
        self.pipeline = pipeline
        self.batch = batch
        self.depth = depth
        self.stats = stats or StreamStats()
        self._engine = engine
        self._slots = None          # device buffers, one a slot, on the card
        self._pinned = None         # pinned host buffers, made on first use
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

    def _staging(self, dev: torch.device, seg: int):
        """The ``depth`` device buffers and the copy stream, made at
        first use on the card and kept."""
        shape = (self.batch, seg)
        if self._slots is None or self._slots[0].shape != shape \
                or self._slots[0].device != dev:
            self._slots = [torch.empty(shape, dtype=torch.uint8, device=dev)
                           for _ in range(self.depth)]
            self._pinned = [None] * self.depth
            self._copy_stream = torch.cuda.Stream(dev)
        return self._slots, self._copy_stream

    def _pinned_slot(self, slot: int) -> torch.Tensor:
        """Slot ``slot``'s pinned host buffer, made when the first chunk
        that does not lie in pinned memory needs it."""
        if self._pinned[slot] is None:
            self._pinned[slot] = torch.empty(self._slots[slot].shape,
                                             dtype=torch.uint8,
                                             pin_memory=True)
        return self._pinned[slot]

    def _run(self, segments, fragment_ids) -> Iterator[dict]:
        pipe = self.pipeline
        cfg = pipe.config
        rows = cfg.k + cfg.m
        dev = pipe.device
        cuda = dev.type == "cuda"
        program = pipe.fused_program()
        st = self.stats
        t_run = time.perf_counter()
        inflight: collections.deque = collections.deque()
        if cuda:
            slots, copy_stream = self._staging(dev, cfg.segment_size)
            compute = torch.cuda.current_stream(dev)

        def drain_one():
            out, real, done = inflight.popleft()
            t0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            st.stall_s += time.perf_counter() - t0
            if real < self.batch:
                out = {k: v[:real] for k, v in out.items()}
            out["rows"] = real
            return out

        try:
            seg_off = n_batches = 0
            for chunk in _rebatch(segments, self.batch):
                # enforce the in-flight window BEFORE staging the next
                # batch: at most ``depth`` batches are ever enqueued
                while len(inflight) >= self.depth:
                    yield drain_one()
                chunk = torch.as_tensor(chunk)
                if chunk.dtype != torch.uint8:
                    chunk = chunk.to(torch.uint8)
                real = chunk.shape[0]
                if real < self.batch:
                    st.padded_segments += self.batch - real
                if fragment_ids is None:
                    ids = torch.arange(seg_off * rows,
                                       (seg_off + self.batch) * rows,
                                       dtype=torch.int64, device=dev)
                else:
                    ids = torch.as_tensor(_pad_rows(
                        fragment_ids[seg_off:seg_off + real],
                        self.batch)).to(dev)
                t0 = time.perf_counter()
                done = None
                if cuda:
                    slot = n_batches % self.depth
                    staged = slots[slot]
                    src = chunk
                    if not chunk.is_pinned():
                        src = self._pinned_slot(slot)[:real]
                        src.copy_(chunk)
                    with torch.cuda.stream(copy_stream):
                        # only the real rows cross the bus; the ragged
                        # tail's pad rows are zeroed on the card
                        staged[:real].copy_(src, non_blocking=True)
                        if real < self.batch:
                            staged[real:].zero_()
                        copied = torch.cuda.Event()
                        copied.record(copy_stream)
                    compute.wait_event(copied)
                    seg_in = staged
                else:
                    seg_in = chunk.contiguous()
                    if real < self.batch:
                        seg_in = torch.cat([seg_in, seg_in.new_zeros(
                            (self.batch - real,) + tuple(seg_in.shape[1:]))])
                h2d = time.perf_counter() - t0
                st.h2d_s += h2d
                t0 = time.perf_counter()
                out = program(seg_in, ids)
                if cuda:
                    done = torch.cuda.Event()
                    done.record(compute)
                dispatch = time.perf_counter() - t0
                st.dispatch_s += dispatch
                st.hist.observe(h2d + dispatch)
                st.batches += 1
                n_batches += 1
                st.segments += real
                st.bytes_in += real * cfg.segment_size
                seg_off += self.batch
                inflight.append((out, real, done))
            while inflight:
                yield drain_one()
        finally:
            st.wall_s += time.perf_counter() - t_run

    def ingest(self, segments, fragment_ids=None) -> dict:
        """Run the whole stream and concatenate the per-batch results:
        the ``forward``-shaped output without managing the generator."""
        outs = list(self.run(segments, fragment_ids))
        if not outs:
            raise ValueError("empty segment stream")
        return {"fragments": torch.cat([o["fragments"] for o in outs]),
                "tags": torch.cat([o["tags"] for o in outs])}
