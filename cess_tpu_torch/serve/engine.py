"""The device submission engine: dynamic micro-batching for the RS and
PoDR2 hot paths.

The port's counterpart of ``cess_tpu/serve/engine.py``. Every off-chain
actor reaches the card through it: gateways encode uploads, miners
prove challenges and repair, TEEs tag and verify. Instead of one small
synchronous call each, callers ``submit_*`` and get an
:class:`EngineFuture`; per-class bounded queues hold the requests
(policy.py: backpressure, class priority, deadlines); one batcher
thread drains a class on a size or delay trigger, coalesces requests
that share a key (op, geometry, challenge round) into one device batch,
pads the batch's rows to a power-of-two bucket (buckets.py), runs it
through the ``ErasureCodec`` / ``AuditBackend`` gates and slices the
result back per request. Counters land in stats.py under the TPU
package's ``cess_engine_*`` names.

Results equal the direct calls bit for bit: every coalesced op is
row-independent, and padding adds zero rows (or zero aggregation
coefficients ``r``, whose terms are exact modular zeros) that are
sliced off. The stacked classes run as one batched call each, through
the ``AuditBackend`` gate with a leading mission axis: ``prove``
gathers every mission's challenged blocks (only those are read; the
full fragments are never copied on the host) and proves the
``[R, F_bucket]`` stack over them, each mission folded with its ``r``;
``verify_agg`` checks every mission, the PRF of all their ids at the
challenged blocks coming from one ``prf_blocks`` launch.

Payloads and results (the zero-copy contract, in torch terms):

- a tensor payload stays where it lies, and its result comes back as a
  tensor on the engine's device;
- a numpy payload gets numpy back, even coalesced in one batch with
  tensor payloads; the batch is assembled on the engine's device with
  one host-to-device copy for each host member;
- field elements come back as int32 (the port's rule); numpy submitters
  may pass the TPU package's uint32 arrays, which the engine reads as
  values.

Streams. Batches run on the engine device's default stream: the
batcher thread enters ``torch.cuda.device(engine.device)`` for its whole
life and never sets a stream, so the kernel wrappers, which launch on
the calling thread's current stream, launch there. A CUDA payload may
have been written on another stream of the submitting thread, so each
submit records an event on the submitter's current stream and the
batch's stream waits on it before reading. Every batch is synchronized
(an event recorded after it, then waited on) before any of its futures
resolves: a future means the batch completed, the latency counters
measure submit to completion, and a device fault rejects the batch's
futures instead of resolving them with poisoned tensors. Because the
engine holds its references to the payloads until that point, a payload
tensor is never freed while the batch still reads it. A failed batch
rejects every member's future with the op's error; nothing reruns it on
the CPU.

The TPU engine's opt-in planes (resilience, tracing, SLO and adaptive
control, admission, the device pool, profiling) are not ported yet, and
the constructor takes no argument for them.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import threading
import time
from typing import Any

import numpy as np
import torch

from ..ops import audit_backend as ab
from ..ops import pfield as pf
from ..ops import podr2
from ..ops import rs
from .buckets import ProgramCache, bucket_rows
from .policy import (CLASSES, AdmissionPolicy, EngineClosed,
                     EngineSaturated, EngineTimeout)
from .stats import EngineStats

_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int64): torch.int64}


class EngineFuture:
    """Result handle for a submitted request (threading-based: the
    engine serves plain synchronous agents, not an event loop)."""

    __slots__ = ("_event", "_value", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._exc: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """Block until resolved. Raises the request's failure
        (EngineTimeout on deadline cancellation, the op's error on a
        batch failure) or EngineTimeout if ``timeout`` elapses first."""
        if not self._event.wait(timeout):
            raise EngineTimeout(f"no result within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._value

    # engine-internal
    def _resolve(self, value) -> None:
        self._value = value
        self._event.set()

    def _reject(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()


@dataclasses.dataclass
class _Request:
    cls: str                 # op class (policy.CLASSES)
    key: tuple               # coalescing key: op + geometry + round aux
    rows: int                # device rows this request contributes
    arrays: dict             # normalized payloads (numpy or tensors)
    aux: dict                # shared parameters (idx/nu/present/...)
    enqueue_t: float
    deadline: float | None
    future: EngineFuture
    squeeze: bool = False    # 2-D submit: drop the batch axis on return
    device: bool = False     # tensor payload: the result is a tensor
    ready: Any = None        # CUDA event on the submitter's stream


def _host(x) -> np.ndarray:
    """A host copy of a small round parameter (indices, coefficients)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _round_digest(num_blocks: int, idx: np.ndarray, nu: np.ndarray) -> bytes:
    """Coalescing identity of a challenge round's derived parameters."""
    h = hashlib.sha256(int(num_blocks).to_bytes(8, "little"))
    h.update(idx.tobytes())
    h.update(nu.tobytes())
    return h.digest()[:16]


def _round(idx, nu) -> tuple[np.ndarray, np.ndarray]:
    return (np.ascontiguousarray(_host(idx), dtype=np.int64).reshape(-1),
            np.ascontiguousarray(_host(nu), dtype=np.int64).reshape(-1))


def _norm(arr, dtype):
    """A payload in the engine's dtype WITHOUT moving it: a tensor stays
    a tensor on its device (cast there when needed); anything else
    becomes a contiguous, writable numpy array (uint32 values read as
    int64 values)."""
    if isinstance(arr, torch.Tensor):
        want = _TORCH_DTYPE[np.dtype(dtype)]
        return arr if arr.dtype == want else arr.to(want)
    a = np.ascontiguousarray(np.asarray(arr, dtype=dtype))
    return a if a.flags.writeable else a.copy()


def _take_blocks(a, idx: np.ndarray):
    """a[:, idx] on the host for numpy, on the tensor's device otherwise."""
    if isinstance(a, torch.Tensor):
        return a[:, torch.as_tensor(idx, device=a.device)]
    return a[:, idx]


class SubmissionEngine:
    """See module docstring. Construct via :func:`make_engine` or pass
    an ``ErasureCodec`` (``ops.rs.TorchCodec`` or ``ops.regen.RegenCodec``)
    and/or an ``AuditBackend`` (``ops.audit_backend``) directly; both
    must live on one device, the engine's."""

    def __init__(self, codec=None, audit=None,
                 policy: AdmissionPolicy | None = None):
        if codec is None and audit is None:
            raise ValueError("engine needs a codec and/or audit backend")
        devices = {g.device for g in (codec, audit) if g is not None}
        if len(devices) != 1:
            raise ValueError(f"codec and audit backend on different "
                             f"devices: {sorted(map(str, devices))}")
        self.device: torch.device = devices.pop()
        self.codec = codec
        self.audit = audit
        self.policy = policy or AdmissionPolicy()
        self.stats = EngineStats()
        self.programs = ProgramCache(self.stats)
        self._queues: dict[str, collections.deque[_Request]] = {
            c: collections.deque() for c in CLASSES}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # held around every batch and around warm_repair's graph
        # captures: a capture must not overlap the batcher's launches
        self._device_mu = threading.Lock()
        self._closed = False
        self._flushing = 0       # active flush() calls force draining
        self._inflight = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cess-submission-engine")
        self._thread.start()

    # ------------------------------------------------------------------
    # submission API: each submit_* returns an EngineFuture; the
    # same-named plain method is the blocking convenience form.
    # ------------------------------------------------------------------

    # -- encode (ErasureCodec) ----------------------------------------
    def submit_encode(self, data, timeout: float | None = None
                      ) -> EngineFuture:
        """data [B, k, n] (or [k, n]) uint8 -> future of [B, k+m, n]."""
        self._need_codec()
        data, squeeze = self._norm_shards(data, self.codec.k)
        key = ("encode", data.shape[1], data.shape[2])
        return self._submit("encode", key, data.shape[0], {"data": data},
                            {}, timeout, squeeze)

    def encode(self, data, timeout: float | None = None):
        return self.submit_encode(data, timeout=timeout).result()

    # -- decode / repair (ErasureCodec) --------------------------------
    def submit_reconstruct(self, survivors, present, missing=None,
                           timeout: float | None = None) -> EngineFuture:
        """survivors [B, k, n] (or [k, n]) rows ordered as ``present``
        -> future of the recovered [B, len(missing), n] shards."""
        self._need_codec()
        present = tuple(int(i) for i in present)
        if missing is None:
            missing = tuple(i for i in range(self.codec.k + self.codec.m)
                            if i not in present)
        missing = tuple(int(i) for i in missing)
        survivors, squeeze = self._norm_shards(survivors, len(present))
        key = ("repair", "reconstruct", present, missing,
               survivors.shape[2])
        return self._submit("repair", key, survivors.shape[0],
                            {"survivors": survivors},
                            {"present": present, "missing": missing},
                            timeout, squeeze)

    def reconstruct(self, survivors, present, missing=None,
                    timeout: float | None = None):
        return self.submit_reconstruct(survivors, present, missing,
                                       timeout=timeout).result()

    def submit_decode_data(self, survivors, present,
                           timeout: float | None = None) -> EngineFuture:
        self._need_codec()
        present = tuple(int(i) for i in present)
        survivors, squeeze = self._norm_shards(survivors, len(present))
        key = ("repair", "decode", present, (), survivors.shape[2])
        return self._submit("repair", key, survivors.shape[0],
                            {"survivors": survivors},
                            {"present": present}, timeout, squeeze)

    def decode_data(self, survivors, present,
                    timeout: float | None = None):
        return self.submit_decode_data(survivors, present,
                                       timeout=timeout).result()

    def submit_repair_symbol(self, pairs, coeff: int,
                             timeout: float | None = None) -> EngineFuture:
        """pairs [B, 2, n] (or [2, n]) uint8 (accumulator, fragment)
        rows -> future of the folded [B, 1, n] partial sums (acc ^
        coeff * fragment), the helper hop of the regenerating repair
        chain. Needs a codec with the symbol surface
        (``ops.regen.RegenCodec``)."""
        self._need_codec()
        if not hasattr(self.codec, "fold_symbol"):
            raise ValueError(
                "repair symbols need a regenerating codec; build the "
                "engine with rs_backend='regen'")
        coeff = int(coeff)
        pairs, squeeze = self._norm_shards(pairs, 2)
        key = ("repair", "symbol", (coeff,), (), pairs.shape[2])
        return self._submit("repair", key, pairs.shape[0],
                            {"survivors": pairs}, {"coeff": coeff},
                            timeout, squeeze)

    def repair_symbol(self, pairs, coeff: int,
                      timeout: float | None = None):
        return self.submit_repair_symbol(pairs, coeff,
                                         timeout=timeout).result()

    # -- tag (AuditBackend, TEE role) ----------------------------------
    def submit_tag(self, fragment_ids, fragments,
                   timeout: float | None = None) -> EngineFuture:
        """ids [F, 2] (lo, hi) words, fragments [F, bytes] uint8 ->
        future of tags [F, blocks, limbs] int32."""
        self._need_audit()
        ids = _norm(fragment_ids, np.int64)
        frags = _norm(fragments, np.uint8)
        if ids.ndim != 2 or ids.shape[1] != 2 or frags.ndim != 2 \
                or ids.shape[0] != frags.shape[0]:
            raise ValueError("expected ids [F, 2] and fragments [F, bytes]")
        key = ("tag", frags.shape[1])
        return self._submit("tag", key, frags.shape[0],
                            {"ids": ids, "fragments": frags}, {}, timeout)

    def tag_fragments(self, fragment_ids, fragments,
                      timeout: float | None = None):
        return self.submit_tag(fragment_ids, fragments,
                               timeout=timeout).result()

    # -- prove (miner role) --------------------------------------------
    def submit_prove_aggregate(self, fragments, tags, idx, nu, r,
                               sectors: int | None = None,
                               timeout: float | None = None
                               ) -> EngineFuture:
        """One miner's aggregated proof over its held set: fragments
        [F, bytes], tags [F, blocks, limbs], coefficients r [F] ->
        future of (mu [sectors], sigma [limbs]) int32. Requests of the
        SAME round (same idx/nu) coalesce into one F-padded batch; r's
        zero padding adds exact modular zeros to the fold."""
        self._need_audit()
        frags = _norm(fragments, np.uint8)
        tag_arr = _norm(tags, np.int64)
        r_arr = _norm(r, np.int64)
        if frags.ndim != 2 or tag_arr.ndim != 3 or r_arr.ndim != 1 \
                or not frags.shape[0] == tag_arr.shape[0] == r_arr.shape[0]:
            raise ValueError("expected fragments [F, bytes], tags "
                             "[F, blocks, limbs], r [F]")
        idx, nu = _round(idx, nu)
        sectors = podr2.SECTORS if sectors is None else int(sectors)
        key = ("prove", frags.shape[1], tag_arr.shape[1], tag_arr.shape[2],
               sectors, _round_digest(tag_arr.shape[1], idx, nu))
        return self._submit("prove", key, frags.shape[0],
                            {"fragments": frags, "tags": tag_arr,
                             "r": r_arr},
                            {"idx": idx, "nu": nu, "sectors": sectors},
                            timeout)

    def prove_aggregate(self, fragments, tags, idx, nu, r,
                        sectors: int | None = None,
                        timeout: float | None = None):
        return self.submit_prove_aggregate(fragments, tags, idx, nu, r,
                                           sectors, timeout=timeout).result()

    # -- verify (TEE role) ---------------------------------------------
    def submit_verify_batch(self, fragment_ids, num_blocks, idx, nu,
                            mu, sigma, timeout: float | None = None
                            ) -> EngineFuture:
        """Per-fragment checks: ids [F, 2], mu [F, sectors], sigma
        [F, limbs] -> future of bool [F]. Coalesces along F across
        requests of the same round."""
        self._need_audit()
        ids = _norm(fragment_ids, np.int64)
        mu = _norm(mu, np.int64)
        sigma = _norm(sigma, np.int64)
        if ids.ndim != 2 or mu.ndim != 2 or sigma.ndim != 2 \
                or not ids.shape[0] == mu.shape[0] == sigma.shape[0]:
            raise ValueError("expected ids [F, 2], mu [F, s], sigma "
                             "[F, limbs]")
        idx, nu = _round(idx, nu)
        key = ("verify_batch", int(num_blocks), mu.shape[1], sigma.shape[1],
               _round_digest(num_blocks, idx, nu))
        return self._submit("verify", key, ids.shape[0],
                            {"ids": ids, "mu": mu, "sigma": sigma},
                            {"idx": idx, "nu": nu,
                             "num_blocks": int(num_blocks)}, timeout)

    def verify_batch(self, fragment_ids, num_blocks, idx, nu, mu, sigma,
                     timeout: float | None = None):
        return self.submit_verify_batch(fragment_ids, num_blocks, idx, nu,
                                        mu, sigma, timeout=timeout).result()

    def submit_verify_aggregate(self, fragment_ids, num_blocks, idx, nu,
                                r, mu, sigma,
                                timeout: float | None = None
                                ) -> EngineFuture:
        """One aggregated-proof check (the TEE's per-mission verify):
        ids [F, 2], r [F], mu [sectors], sigma [limbs] -> future of
        bool. Missions of the same round coalesce: each owed set is
        padded to a shared F bucket with r = 0 rows and every mission's
        PRF at the challenged blocks comes from one ``prf_blocks``
        launch."""
        self._need_audit()
        ids = _norm(fragment_ids, np.int64).reshape(-1, 2)
        r_arr = _norm(r, np.int64)
        mu = _norm(mu, np.int64)
        sigma = _norm(sigma, np.int64)
        if r_arr.ndim != 1 or ids.shape[0] != r_arr.shape[0] \
                or mu.ndim != 1 or sigma.ndim != 1:
            raise ValueError("expected ids [F, 2], r [F], mu [s], "
                             "sigma [limbs]")
        idx, nu = _round(idx, nu)
        key = ("verify_agg", int(num_blocks), mu.shape[0], sigma.shape[0],
               _round_digest(num_blocks, idx, nu))
        return self._submit("verify", key, ids.shape[0],
                            {"ids": ids, "r": r_arr, "mu": mu,
                             "sigma": sigma},
                            {"idx": idx, "nu": nu,
                             "num_blocks": int(num_blocks)}, timeout)

    def verify_aggregate(self, fragment_ids, num_blocks, idx, nu, r, mu,
                         sigma, timeout: float | None = None) -> bool:
        return bool(self.submit_verify_aggregate(
            fragment_ids, num_blocks, idx, nu, r, mu, sigma,
            timeout=timeout).result())

    # ------------------------------------------------------------------
    # lifecycle / introspection
    # ------------------------------------------------------------------
    def warm_repair(self, patterns, n: int, buckets=(1, 2)) -> None:
        """Prepare the repair-class programs of the given erasure
        patterns, so that a restoral claim pays kernel time, never
        matrix builds or graph captures.

        patterns: iterable of (present, missing) row tuples; n: shard
        byte width; buckets: row counts to warm, each rounded up to its
        power-of-two bucket (the default covers a solo one-row claim
        and two coalescing; warm the buckets the callers' row counts
        land in). For each, the codec's ``warm_reconstruct`` captures
        the reconstruct of the padded bucket shape (a CUDA graph on the
        card) and the program cache is filled under the exact key
        ``_op_repair`` reads; with a regenerating codec the helper
        folds of every coefficient the single-missing patterns need are
        warmed too (``RegenCodec.warm_fold``). Captures run on this
        thread while the batcher is held between batches; no other
        thread should launch work on the card meanwhile (CUDA's global
        capture mode)."""
        self._need_codec()
        warm = getattr(self.codec, "warm_reconstruct", None)
        patterns = [(tuple(int(i) for i in p), tuple(int(i) for i in mi))
                    for p, mi in patterns]
        with self._device_mu, self._device_scope():
            for present, missing in patterns:
                for b in buckets:
                    bucket = bucket_rows(b)
                    shape = (bucket, len(present), n)
                    meta = self._codec_meta(self.codec, "repair", present,
                                            missing, shape)
                    if warm is not None:
                        warm(present, missing, shape)
                    self.programs.get(
                        ("repair", present, missing, n, bucket) + meta,
                        lambda p=present, mi=missing:
                            (lambda a: self.codec.reconstruct(a, p, mi)))
            warm_fold = getattr(self.codec, "warm_fold", None)
            if warm_fold is None:
                return
            from ..ops import regen

            coeffs: set[int] = set()
            for present, missing in patterns:
                if len(missing) == 1:
                    coeffs.update(regen.repair_coeffs(
                        self.codec.k, self.codec.m, present, missing))
            coeffs.discard(0)
            for c in sorted(coeffs):
                for b in buckets:
                    bucket = bucket_rows(b)
                    meta = self._codec_meta(self.codec, "symbol", (c,), (),
                                            (bucket, 2, n))
                    warm_fold(c, (bucket, 2, n))
                    self.programs.get(
                        ("symbol", c, n, bucket) + meta,
                        lambda cc=c:
                            (lambda a: self.codec.fold_symbol(a, cc)))

    def attach_stream(self, stream_stats) -> None:
        """Register a streaming ingest's StreamStats so its stage
        counters ride the ``cess_engine_stream_*`` metrics (summed over
        every attached stream: detach one when its source is
        done)."""
        with self._lock:
            self.stats.streams.append(stream_stats)

    def detach_stream(self, stream_stats) -> None:
        """Unregister a stream's StreamStats (identity match); unknown
        stats objects are ignored."""
        with self._lock:
            try:
                self.stats.streams.remove(stream_stats)
            except ValueError:
                pass

    def stats_snapshot(self) -> dict:
        with self._lock:
            return self.stats.snapshot(
                {c: len(q) for c, q in self._queues.items()})

    def stats_metrics(self) -> dict[str, float]:
        with self._lock:
            return self.stats.metrics(
                {c: len(q) for c, q in self._queues.items()})

    def stats_histograms(self) -> dict:
        """Latency histogram families (name -> obs.prom.Histogram); each
        snapshots itself consistently, so no engine lock is needed."""
        return self.stats.histograms()

    def flush(self, timeout: float | None = None) -> bool:
        """Force-drain everything queued and wait until it resolves (no
        waiting out the coalescing delay). Returns False if the timeout
        elapses first; queued work keeps draining regardless."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._flushing += 1
            self._cond.notify_all()
            try:
                while any(self._queues.values()) or self._inflight:
                    left = None if deadline is None \
                        else deadline - time.monotonic()
                    if left is not None and left <= 0:
                        return False
                    self._cond.wait(left)
            finally:
                self._flushing -= 1
        return True

    def close(self, timeout: float | None = 5.0) -> None:
        """Drain pending requests, then stop the batcher. Subsequent
        submits raise EngineClosed. If the drain outlives ``timeout``,
        every request still QUEUED is rejected with EngineClosed, so no
        caller blocks forever; a batch already in flight still
        resolves."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            with self._cond:
                for cls, q in self._queues.items():
                    while q:
                        r = q.popleft()
                        self.stats.classes[cls].failed += 1
                        r.future._reject(EngineClosed(
                            "engine shut down before this request ran"))

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _need_codec(self) -> None:
        if self.codec is None:
            raise ValueError("engine has no ErasureCodec configured")

    def _need_audit(self) -> None:
        if self.audit is None:
            raise ValueError("engine has no AuditBackend configured")

    @staticmethod
    def _norm_shards(data, rows: int):
        arr = _norm(data, np.uint8)
        squeeze = arr.ndim == 2
        if squeeze:
            arr = arr[None]
        if arr.ndim != 3 or arr.shape[1] != rows:
            raise ValueError(f"expected [B, {rows}, n] shards, got "
                             f"{tuple(arr.shape)}")
        return arr, squeeze

    def _device_scope(self):
        return torch.cuda.device(self.device) \
            if self.device.type == "cuda" else contextlib.nullcontext()

    def _submit(self, cls: str, key: tuple, rows: int, arrays: dict,
                aux: dict, timeout: float | None,
                squeeze: bool = False) -> EngineFuture:
        if rows < 1:
            raise ValueError(f"empty {cls} request (0 rows)")
        now = time.monotonic()
        if timeout is None:
            timeout = self.policy.default_timeout
        tensors = [a for a in arrays.values() if isinstance(a, torch.Tensor)]
        ready = None
        cuda = [t for t in tensors if t.is_cuda]
        if cuda:
            # the batch reads the payload on the engine's stream: mark
            # where the submitter's stream has written it
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(cuda[0].device))
        fut = EngineFuture()
        req = _Request(cls=cls, key=key, rows=rows, arrays=arrays, aux=aux,
                       enqueue_t=now,
                       deadline=None if timeout is None else now + timeout,
                       future=fut, squeeze=squeeze, device=bool(tensors),
                       ready=ready)
        with self._cond:
            if self._closed:
                raise EngineClosed("engine is shut down")
            st = self.stats.classes[cls]
            if len(self._queues[cls]) >= self.policy.queue_cap:
                st.saturated += 1
                raise EngineSaturated(
                    f"{cls} queue full ({self.policy.queue_cap})")
            st.submitted += 1
            self._queues[cls].append(req)
            self._cond.notify_all()
        return fut

    # -- batcher thread -------------------------------------------------
    def _run(self) -> None:
        with self._device_scope():
            while True:
                with self._cond:
                    while True:
                        now = time.monotonic()
                        self._expire(now)
                        cls = self._ready_class(now)
                        if cls is not None:
                            batch = self._drain(cls)
                            self._inflight += 1
                            break
                        if self._closed:
                            self._cond.notify_all()
                            return
                        self._cond.wait(self._wake_timeout(now))
                try:
                    if batch:
                        with self._device_mu:
                            self._run_batch(batch)
                finally:
                    with self._cond:
                        self._inflight -= 1
                        self._cond.notify_all()

    def _expire(self, now: float) -> None:
        """Cancel EVERY queued request whose deadline passed, in every
        class (lock held). Running before readiness checks means a dead
        request in a quiet class cancels promptly even while other
        classes carry traffic, never trips a spurious drain, and stops
        counting against its queue's cap."""
        for cls, q in self._queues.items():
            if not any(r.deadline is not None and r.deadline <= now
                       for r in q):
                continue
            st = self.stats.classes[cls]
            keep = []
            for r in q:
                if r.deadline is not None and r.deadline <= now:
                    st.timeouts += 1
                    r.future._reject(EngineTimeout(
                        f"{cls} request deadline expired before "
                        "batching"))
                else:
                    keep.append(r)
            q.clear()
            q.extend(keep)

    def _ready_class(self, now: float) -> str | None:
        """Class to drain now, or None to keep waiting. A drain happens
        when ANY class trips a trigger (size in requests or rows, the
        oldest request's max_delay, an active flush, or shutdown); then
        the HIGHEST-PRIORITY non-empty class goes first, whichever class
        tripped: a just-arrived verification preempts the bulk encode
        whose delay expired."""
        pol = self.policy
        first_nonempty = None
        for cls in CLASSES:               # priority order
            q = self._queues[cls]
            if not q:
                continue
            if first_nonempty is None:
                first_nonempty = cls
            if (self._closed or self._flushing
                    or len(q) >= pol.max_batch_requests
                    or q[0].enqueue_t + pol.max_delay <= now
                    or sum(r.rows for r in q) >= pol.max_batch_rows):
                return first_nonempty
        return None

    def _wake_timeout(self, now: float) -> float | None:
        wake = None
        for q in self._queues.values():
            for r in q:
                t = r.enqueue_t + self.policy.max_delay
                if r.deadline is not None:
                    t = min(t, r.deadline)
                wake = t if wake is None else min(wake, t)
        if wake is None:
            return None
        return max(wake - now, 0.0)

    # ops that pad every request's OWN row axis to the batch-wide
    # bucket (stacked, not concatenated): cap the bucket spread so one
    # huge request cannot multiply the device work of its small peers
    _STACKED_OPS = ("prove", "verify_agg")
    PAD_SPREAD = 4

    def _drain(self, cls: str) -> list[_Request]:
        """Pop one coalescible batch (lock held): the oldest request and
        the queued requests sharing its key, up to the request and row
        budgets; the rest stay queued in order."""
        q = self._queues[cls]
        if not q:
            return []
        first = q[0]
        stacked = first.key[0] in self._STACKED_OPS
        anchor_bucket = bucket_rows(first.rows)
        pol = self.policy
        batch, rest, rows = [first], [], first.rows
        for r in list(q)[1:]:
            fits = (r.key == first.key
                    and len(batch) < pol.max_batch_requests
                    and rows + r.rows <= pol.max_batch_rows)
            if fits and stacked:
                b = bucket_rows(r.rows)
                fits = (b <= self.PAD_SPREAD * anchor_bucket
                        and anchor_bucket <= self.PAD_SPREAD * b)
            if fits:
                batch.append(r)
                rows += r.rows
            else:
                rest.append(r)
        q.clear()
        q.extend(rest)
        return batch

    def _run_batch(self, batch: list[_Request]) -> None:
        """Run one coalesced batch; an op failure rejects every member's
        future with the op's error."""
        cls = batch[0].cls
        runner = getattr(self, f"_op_{batch[0].key[0]}")
        try:
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                for r in batch:
                    if r.ready is not None:
                        stream.wait_event(r.ready)
            results, device_rows = runner(batch)
        except Exception as e:        # op failure
            with self._lock:
                self.stats.classes[cls].failed += len(batch)
            for r in batch:
                r.future._reject(e)
            return
        self._account_batch(batch, device_rows)
        for r, out in zip(batch, results):
            r.future._resolve(out)

    def _account_batch(self, batch: list[_Request], device_rows: int) -> None:
        done = time.monotonic()
        real_rows = sum(r.rows for r in batch)
        with self._lock:
            st = self.stats.classes[batch[0].cls]
            st.batches += 1
            st.batched_requests += len(batch)
            st.rows += real_rows
            st.padded_rows += max(device_rows - real_rows, 0)
            st.completed += len(batch)
            for r in batch:
                lat = done - r.enqueue_t
                st.latencies.append(lat)
                st.hist.observe(lat)

    # -- op runners (batcher thread only) -------------------------------
    def _sync(self) -> None:
        """Wait for the work enqueued so far on the batch's stream."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()

    def _rows(self, arrs: list, rows: int, dtype) -> torch.Tensor:
        """Coalesce payloads along axis 0 into a [rows, ...] tensor on
        the engine's device, zero-padded: one copy for each member (from
        the host for numpy members); a lone tensor member that already
        fills the bucket on the device is used as it lies."""
        first = arrs[0]
        if len(arrs) == 1 and isinstance(first, torch.Tensor) \
                and first.shape[0] == rows and first.device == self.device \
                and first.dtype == dtype:
            return first.contiguous()
        out = torch.empty((rows,) + tuple(first.shape[1:]), dtype=dtype,
                          device=self.device)
        off = 0
        for a in arrs:
            out[off:off + a.shape[0]].copy_(torch.as_tensor(a))
            off += a.shape[0]
        if off < rows:
            out[off:].zero_()
        return out

    def _stacked(self, arrs: list, rb: int, fb: int, dtype) -> torch.Tensor:
        """Stack per-request [F_i, ...] payloads into a zero-padded
        [rb, fb, ...] tensor on the engine's device."""
        first = arrs[0]
        out = torch.zeros((rb, fb) + tuple(first.shape[1:]), dtype=dtype,
                          device=self.device)
        for i, a in enumerate(arrs):
            out[i, :a.shape[0]].copy_(torch.as_tensor(a))
        return out

    def _split_rows(self, batch: list[_Request], out: torch.Tensor) -> list:
        """Slice a batch result back per request: tensor submitters get
        views of the device result, host submitters numpy (an all-host
        batch is fetched once). Synchronized before any future
        resolves (module docstring)."""
        self._sync()
        host = None
        if not any(r.device for r in batch):
            host = out.cpu().numpy()
        results, off = [], 0
        for r in batch:
            if r.device:
                piece = out[off:off + r.rows]
            elif host is not None:
                piece = host[off:off + r.rows]
            else:
                piece = out[off:off + r.rows].cpu().numpy()
            results.append(piece[0] if r.squeeze else piece)
            off += r.rows
        return results

    @staticmethod
    def _codec_meta(codec, kind, present=(), missing=(), shape=()) -> tuple:
        """Cost-model components of a program-cache key: codecs under
        strategy "xor"/"auto" report which lowering serves this (kind,
        pattern, shape) and the estimate that picked it; dense codecs
        give ()."""
        meta = getattr(codec, "program_meta", None)
        if meta is None:
            return ()
        return meta(kind, present=present, missing=missing, shape=shape)

    def _op_encode(self, batch):
        codec = self.codec
        total = sum(r.rows for r in batch)
        bucket = bucket_rows(total)
        data = self._rows([r.arrays["data"] for r in batch], bucket,
                          torch.uint8)
        _, k, n = data.shape
        meta = self._codec_meta(codec, "encode", shape=(bucket, k, n))
        prog = self.programs.get(("encode", k, n, bucket) + meta,
                                 lambda: codec.encode)
        out = prog(data)[:total]
        return self._split_rows(batch, out), bucket

    def _op_repair(self, batch):
        codec = self.codec
        kind = batch[0].key[1]
        aux = batch[0].aux
        total = sum(r.rows for r in batch)
        bucket = bucket_rows(total)
        surv = self._rows([r.arrays["survivors"] for r in batch], bucket,
                          torch.uint8)
        n = surv.shape[2]
        if kind == "reconstruct":
            present, missing = aux["present"], aux["missing"]
            meta = self._codec_meta(codec, "repair", present, missing,
                                    (bucket, len(present), n))
            prog = self.programs.get(
                ("repair", present, missing, n, bucket) + meta,
                lambda: (lambda a: codec.reconstruct(a, present, missing)))
        elif kind == "symbol":
            coeff = aux["coeff"]
            meta = self._codec_meta(codec, "symbol", (coeff,), (),
                                    (bucket, 2, n))
            prog = self.programs.get(
                ("symbol", coeff, n, bucket) + meta,
                lambda: (lambda a: codec.fold_symbol(a, coeff)))
        else:
            present = aux["present"]
            meta = self._codec_meta(codec, "decode", present, (),
                                    (bucket, len(present), n))
            prog = self.programs.get(
                ("decode", present, n, bucket) + meta,
                lambda: (lambda a: codec.decode_data(a, present)))
        out = prog(surv)[:total]
        return self._split_rows(batch, out), bucket

    def _op_tag(self, batch):
        audit = self.audit
        total = sum(r.rows for r in batch)
        bucket = bucket_rows(total)
        ids = self._rows([r.arrays["ids"] for r in batch], bucket,
                         torch.int64)
        frags = self._rows([r.arrays["fragments"] for r in batch], bucket,
                           torch.uint8)
        prog = self.programs.get(("tag", frags.shape[1], bucket),
                                 lambda: audit.tag_fragments)
        out = prog(ids, frags)[:total]
        return self._split_rows(batch, out), bucket

    def _round_tensors(self, aux: dict) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(aux["idx"]).to(self.device),
                torch.as_tensor(aux["nu"]).to(self.device))

    def _op_verify_batch(self, batch):
        audit = self.audit
        aux = batch[0].aux
        total = sum(r.rows for r in batch)
        bucket = bucket_rows(total)
        ids = self._rows([r.arrays["ids"] for r in batch], bucket,
                         torch.int64)
        mu = self._rows([r.arrays["mu"] for r in batch], bucket, torch.int64)
        sigma = self._rows([r.arrays["sigma"] for r in batch], bucket,
                           torch.int64)

        def build():
            idx, nu = self._round_tensors(aux)
            num_blocks = aux["num_blocks"]
            return lambda i, u, s: audit.verify_batch(i, num_blocks, idx,
                                                      nu, u, s)

        prog = self.programs.get(("verify_batch", batch[0].key, bucket),
                                 build)
        out = prog(ids, mu, sigma)[:total]
        return self._split_rows(batch, out), bucket

    def _op_verify_agg(self, batch):
        audit = self.audit
        aux = batch[0].aux
        fb = bucket_rows(max(r.rows for r in batch))
        rb = bucket_rows(len(batch))
        ids = self._stacked([r.arrays["ids"] for r in batch], rb, fb,
                            torch.int64)
        rs_ = self._stacked([r.arrays["r"] for r in batch], rb, fb,
                            torch.int64)
        mu = self._rows([r.arrays["mu"][None] for r in batch], rb,
                        torch.int64)
        sigma = self._rows([r.arrays["sigma"][None] for r in batch], rb,
                           torch.int64)

        def build():
            idx, nu = self._round_tensors(aux)
            num_blocks = aux["num_blocks"]
            return lambda i, rr, u, s: audit.verify_aggregate(
                i, num_blocks, idx, nu, rr, u, s)

        prog = self.programs.get(("verify_agg", batch[0].key, fb, rb), build)
        ok = prog(ids, rs_, mu, sigma).cpu()
        return [bool(ok[i]) for i in range(len(batch))], rb * fb

    def _op_prove(self, batch):
        audit = self.audit
        aux = batch[0].aux
        fb = bucket_rows(max(r.rows for r in batch))
        rb = bucket_rows(len(batch))
        idx, sectors = aux["idx"], aux["sectors"]
        lanes = sectors * pf.BYTES_PER_ELEM
        blocks = batch[0].arrays["tags"].shape[1]
        # only the challenged blocks are read: gather them per mission
        # (on the host for numpy missions, on the device for tensors)
        # and stack [R, F_bucket, c * lanes] on the device
        sel = self._stacked(
            [_take_blocks(r.arrays["fragments"].reshape(r.rows, blocks,
                                                        lanes), idx
                          ).reshape(r.rows, -1)
             for r in batch], rb, fb, torch.uint8)
        tsel = self._stacked([_take_blocks(r.arrays["tags"], idx)
                              for r in batch], rb, fb, torch.int64)
        rs_ = self._stacked([r.arrays["r"] for r in batch], rb, fb,
                            torch.int64)

        def build():
            _, nu = self._round_tensors(aux)
            return lambda f, t, rr: audit.prove_aggregate(f, t, None, nu, rr,
                                                          sectors)

        prog = self.programs.get(("prove", batch[0].key, fb, rb), build)
        mu, sigma = prog(sel, tsel, rs_)
        self._sync()
        host = None
        results = []
        for i, r in enumerate(batch):
            if r.device:
                results.append((mu[i], sigma[i]))
                continue
            if host is None:
                host = (mu.cpu().numpy(), sigma.cpu().numpy())
            results.append((host[0][i], host[1][i]))
        return results, rb * fb


def make_engine(k: int | None = None, m: int | None = None, *,
                rs_backend: str | None = None, strategy: str | None = None,
                podr2_key=None, audit_backend: str | None = None,
                policy: AdmissionPolicy | None = None) -> SubmissionEngine:
    """Build an engine over the two gates.

    k/m select the ErasureCodec geometry (None: no codec, the engine
    serves only the audit classes); podr2_key enables the audit classes.
    rs_backend and audit_backend are the gates' backends
    (``ops.rs.make_codec``, ``ops.audit_backend.make_audit_backend``):
    None, "auto" and "cuda" put the engine on the card and raise when
    there is none; "cpu" is the explicit host choice. This differs on
    purpose from the TPU package, whose ``make_engine`` defaults to its
    CPU reference: an entry point of the port runs on the card unless
    asked for the CPU. strategy: the codec's GF lowering.
    """
    codec = None
    if k is not None:
        codec = rs.make_codec(k, m, rs_backend, strategy)
    audit = None
    if podr2_key is not None:
        audit = ab.make_audit_backend(podr2_key, audit_backend)
    return SubmissionEngine(codec, audit, policy)
