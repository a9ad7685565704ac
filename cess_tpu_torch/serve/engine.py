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
tensor is never freed while the batch still reads it. An engine on the
card loads the kernel library when it is built, so a failed compile,
link or load (``_build.KernelBuildError``) raises there.

Resilience (opt-in, ``resilience=ResilienceConfig(...)``, the port's
copy of the TPU engine's plane). Without it a failed batch rejects every
member's future with the op's error and nothing reruns it. With it the
engine

- retries saturated blocking submits with deterministic backoff inside
  the request's ONE deadline budget (``resilience/retry.py``);
- isolates batch failures: a failed coalesced batch re-runs each member
  alone once, so a poisoned request cannot fail its batch-mates;
- health-gates each backend ("codec", "audit"): a breaker tripped by
  the error window serves the batch's host members on the CPU
  references (the codec's ``rs_ref.ReferenceCodec`` or, for a
  ``RegenCodec``, ``regen.RegenReference``; the audit's
  ``make_audit_backend(key, "cpu")``), whose bytes equal the card's,
  under their own program-cache keys (``key + ("cpu-fallback",)``), and
  probes its way back;
- never moves a card member's work to the host: on an engine on the
  card a tensor member (its result lives on the card) is never
  degraded; while its breaker is open it is refused with
  ``EngineUnavailable``, and when its attempt on the card failed it is
  rejected with that attempt's error;
- never degrades a ``KernelBuildError``: it reaches every member's
  future as it is;
- counts it all as ``cess_resilience_*`` (``degraded_batches`` for the
  batches a tripped breaker sent to the CPU, ``fallback_batches`` for
  the members a failed attempt sent there).

The ``engine.dispatch`` fault site sits on every non-degraded attempt.
A degraded batch runs on the batcher thread under the device lock like
every batch, holds host members only (numpy payloads, or any member of
an engine on the CPU) and hands back numpy for numpy members. Its path
makes no CUDA call, so with the CUDA context itself dead (a sticky
device error) the engine still serves its numpy members.

Tracing (opt-in, ``tracer=`` or a process-armed ``obs.trace`` tracer).
Each request carries an ``engine.<cls>`` span from submit to resolve
(opened on the submitter's thread, carried on the request and finished
on the batcher's); each batch an ``engine.batch`` span under its first
member's and a ``device.<op>`` span under that, both naming the
``backend`` ("primary" or "cpu-fallback"); salvage re-runs and
fallbacks annotate them. ``Tracer(device_annotations=True)`` wraps each
dispatch in ``torch.profiler.record_function("cess:<op>")``. Breaker
trips and recoveries, saturation and a batcher escape are noted in the
flight journal (``obs/flight.py``) with the engine lock released.

Device pool (opt-in, ``pool=``, ``serve/pool.py``). The batcher hands
each drained batch to the pool, whose chosen lane runs it on its own
device and CUDA stream with the lane's breakers, codec and AuditBackend
views and its own slice of the program cache (``_key`` grows a
``("device", i)`` component; degraded keys stay device-free). A denied
or failed lane hands the batch whole to a sibling (``pool.requeue``)
before any salvage; the fault sites ``engine.dispatch.d<i>`` and
``engine.dispatch.<cls>.d<i>`` sit beside ``engine.dispatch`` on a
lane's attempt. The engine keeps one device lock per device, held around
every batch on it and by ``warm_repair``'s graph captures (which hold
them all): lanes on one device take turns, lanes on different devices do
not wait for each other. A tensor member's result lies on the device of
the lane that computed it. A card member is never computed on the host:
with every lane sick it is refused as on the single-device path.

Control planes (opt-in, the port's copies of the TPU engine's). Every
submit takes a ``tenant=`` tag. With an ``obs.slo.SloBoard`` (``slo=``)
every resolved, failed, refused or expired request feeds the board's
burn-rate windows and per-tenant accounting, and the drain's anchor
becomes weighted-fair across the tenants queued in a class (the tenant
with the fewest served device rows goes first; the board's tenant cap
and overflow bucket apply), so one heavy uploader cannot starve another
tenant's differently keyed work. With a ``serve.adaptive.
AdaptiveBatchPolicy`` (``adaptive=``) the batcher reads each class's
max_delay and request and row budgets from it (``_knobs``) instead of
the static policy. With an ``AdmissionController`` (``admission=``;
:func:`make_engine` builds one when both a board and a tuner are given)
sheddable submits are refused with ``EngineShed`` (counted as the
class's ``shed``, marked by an ``outcome="shed"`` span and an
``("engine", "shed")`` journal note) while a protected class burns, and
the codec breaker is held open: the held breaker serves numpy codec
members on the CPU reference and refuses card members with
``EngineUnavailable``, no kernel launched, as any open breaker does.
With an ``obs.profile.ProfilePlane`` (``profile=``) every dispatch is
accounted per (class, bucket, lane), its pad rows land in the pad
ledger, each program-cache miss in the compile ledger, and an anchored
watchdog judges the encode GiB/s. The planes are fed with the engine
lock released and before the batch's futures resolve; the timings they
get are submit (or batch start) to completion, the batch having been
synchronized. With none of them configured each hook is one attribute
load and a ``None`` check and nothing is allocated.
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

from .. import _build
from ..obs import flight as _flight
from ..obs import trace
from ..ops import audit_backend as ab
from ..ops import pfield as pf
from ..ops import podr2
from ..ops import rs
from ..resilience import faults
from ..resilience.retry import Budget
from .buckets import ProgramCache, bucket_rows
from .policy import (CLASSES, AdmissionPolicy, EngineClosed,
                     EngineSaturated, EngineShed, EngineTimeout,
                     EngineUnavailable)
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
    # request span (obs/trace.py), submit to resolve: opened on the
    # submitter's thread and finished on the batcher's, so it rides
    # here (contextvars do not cross threads); NOOP_SPAN untraced
    span: Any = trace.NOOP_SPAN
    # per-tenant accounting tag (obs/slo.py); None when untagged
    tenant: str | None = None


def _host(x) -> np.ndarray:
    """A host copy of a small round parameter (indices, coefficients)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _round_digest(num_blocks: int, idx: np.ndarray, nu: np.ndarray) -> bytes:
    """Coalescing identity of a challenge round's derived parameters,
    hashed in the TPU package's challenge dtypes (int32 indices, uint32
    coefficients), so a round's program keys, and so the profile's
    compile ledger, read alike in both packages."""
    h = hashlib.sha256(int(num_blocks).to_bytes(8, "little"))
    h.update(idx.astype(np.int32).tobytes())
    h.update(nu.astype(np.uint32).tobytes())
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


def _payload_bytes(a) -> int:
    """A payload's bytes as the protocol carries them: bytes are bytes,
    and every other payload (ids, tags, field elements, coefficients)
    holds 32-bit words that the port widens to int64 only because CPU
    torch has no uint32; each counts 4 bytes, as in the TPU package."""
    if isinstance(a, torch.Tensor):
        return a.numel() * (1 if a.dtype == torch.uint8 else 4)
    return a.size * (1 if a.dtype == np.uint8 else 4)


def _take_blocks(a, idx: np.ndarray):
    """a[:, idx] on the host for numpy, on the tensor's device otherwise."""
    if isinstance(a, torch.Tensor):
        return a[:, torch.as_tensor(idx, device=a.device)]
    return a[:, idx]


class SubmissionEngine:
    """See module docstring. Construct via :func:`make_engine` or pass
    an ``ErasureCodec`` (``ops.rs.TorchCodec`` or ``ops.regen.RegenCodec``)
    and/or an ``AuditBackend`` (``ops.audit_backend``) directly; both
    must live on one device, the engine's. ``resilience``: an optional
    ``resilience.ResilienceConfig``; ``tracer``: an optional
    ``obs.trace.Tracer`` (else the process-armed one, if any); ``pool``:
    an optional ``serve.pool.DevicePool`` to spread batches over;
    ``slo``, ``adaptive``, ``admission``, ``profile``: the control planes
    (module docstring)."""

    # op class -> which backend's breaker gates it; "decode" (a repair
    # op) names the codec for the remediation plane's pin keys
    _BACKEND_OF = {"encode": "codec", "repair": "codec", "decode": "codec",
                   "tag": "audit", "verify_batch": "audit",
                   "verify_agg": "audit", "prove": "audit"}

    def __init__(self, codec=None, audit=None,
                 policy: AdmissionPolicy | None = None,
                 resilience=None, tracer=None, slo=None, adaptive=None,
                 admission=None, pool=None, profile=None):
        if codec is None and audit is None:
            raise ValueError("engine needs a codec and/or audit backend")
        devices = {g.device for g in (codec, audit) if g is not None}
        if len(devices) != 1:
            raise ValueError(f"codec and audit backend on different "
                             f"devices: {sorted(map(str, devices))}")
        self.device: torch.device = devices.pop()
        if self.device.type == "cuda":
            # a kernel that cannot build or load fails the constructor,
            # never a batch a breaker could absorb
            _build.library()
        self.codec = codec
        self.audit = audit
        self.tracer = tracer
        self.policy = policy or AdmissionPolicy()
        self.stats = EngineStats()
        self.programs = ProgramCache(self.stats)
        # the control planes (module docstring); None: each hook is one
        # attribute load and a None check, and nothing is allocated
        self.slo = slo
        self.adaptive = adaptive
        self.admission = admission
        self.profile = profile
        self.stats.slo = slo
        self.stats.adaptive = adaptive
        self.stats.profile = profile
        if profile is not None:
            self.programs.profile = profile
        # per-(class, tenant) served device rows: the weighted-fair
        # drain's deficit counters (engine lock; filled only with a board)
        self._tenant_rows: dict[str, dict[str, int]] = {}
        self.resilience = resilience
        self.monitors: dict[str, Any] = {}
        self._fallback_codec = None
        self._fallback_audit = None
        if resilience is not None:
            self.stats.resilience = resilience.stats
            if codec is not None:
                # the host references carry no fault site (ops/rs.py)
                from ..ops import regen, rs_ref

                ref = regen.RegenReference if hasattr(codec, "fold_symbol") \
                    else rs_ref.ReferenceCodec
                self._fallback_codec = ref(codec.k, codec.m)
                self.monitors["codec"] = resilience.monitor()
            if audit is not None:
                self._fallback_audit = ab.make_audit_backend(audit.key, "cpu")
                self.monitors["audit"] = resilience.monitor()
            for name, mon in self.monitors.items():
                mon.name = name           # flight-journal identity
                resilience.stats.register_monitor(name, mon)
        if admission is not None:
            # after the monitors exist: the controller latches the codec
            # breaker for its degrade response (no resilience, no
            # breaker: shed-only admission)
            admission.bind(self)
        self._queues: dict[str, collections.deque[_Request]] = {
            c: collections.deque() for c in CLASSES}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # one lock a device, held around every batch on it and (all of
        # them) around warm_repair's graph captures: a capture must not
        # overlap a launch on its card
        self._device_mu = threading.Lock()      # the engine device's
        self._device_locks = {self.device: self._device_mu}
        for dev in [] if pool is None else pool.devices():
            self._device_locks.setdefault(dev, threading.Lock())
        self._closed = False
        self._flushing = 0       # active flush() calls force draining
        self._inflight = 0
        # the multi-device serving plane (serve/pool.py, opt-in): bound
        # after the monitors exist, so each lane builds its breakers
        self.pool = pool
        self.stats.pool = pool
        if pool is not None:
            pool.bind(self)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cess-submission-engine")
        self._thread.start()

    # ------------------------------------------------------------------
    # submission API: each submit_* returns an EngineFuture; the
    # same-named plain method is the blocking convenience form. Every
    # one takes ``tenant``, the accounting tag of the SLO plane.
    # ------------------------------------------------------------------

    # -- encode (ErasureCodec) ----------------------------------------
    def submit_encode(self, data, timeout: float | None = None,
                      tenant: str | None = None) -> EngineFuture:
        """data [B, k, n] (or [k, n]) uint8 -> future of [B, k+m, n]."""
        self._need_codec()
        data, squeeze = self._norm_shards(data, self.codec.k)
        key = ("encode", data.shape[1], data.shape[2])
        return self._submit("encode", key, data.shape[0], {"data": data},
                            {}, timeout, squeeze, tenant)

    def encode(self, data, timeout: float | None = None,
               tenant: str | None = None):
        return self._blocking("encode", self.submit_encode, data,
                              timeout=timeout, tenant=tenant)

    # -- decode / repair (ErasureCodec) --------------------------------
    def submit_reconstruct(self, survivors, present, missing=None,
                           timeout: float | None = None,
                           tenant: str | None = None) -> EngineFuture:
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
                            timeout, squeeze, tenant)

    def reconstruct(self, survivors, present, missing=None,
                    timeout: float | None = None,
                    tenant: str | None = None):
        return self._blocking("repair", self.submit_reconstruct, survivors,
                              present, missing, timeout=timeout,
                              tenant=tenant)

    def submit_decode_data(self, survivors, present,
                           timeout: float | None = None,
                           tenant: str | None = None) -> EngineFuture:
        self._need_codec()
        present = tuple(int(i) for i in present)
        survivors, squeeze = self._norm_shards(survivors, len(present))
        key = ("repair", "decode", present, (), survivors.shape[2])
        return self._submit("repair", key, survivors.shape[0],
                            {"survivors": survivors},
                            {"present": present}, timeout, squeeze, tenant)

    def decode_data(self, survivors, present,
                    timeout: float | None = None,
                    tenant: str | None = None):
        return self._blocking("repair", self.submit_decode_data, survivors,
                              present, timeout=timeout, tenant=tenant)

    def submit_repair_symbol(self, pairs, coeff: int,
                             timeout: float | None = None,
                             tenant: str | None = None) -> EngineFuture:
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
                            timeout, squeeze, tenant)

    def repair_symbol(self, pairs, coeff: int,
                      timeout: float | None = None,
                      tenant: str | None = None):
        return self._blocking("repair", self.submit_repair_symbol, pairs,
                              coeff, timeout=timeout, tenant=tenant)

    # -- tag (AuditBackend, TEE role) ----------------------------------
    def submit_tag(self, fragment_ids, fragments,
                   timeout: float | None = None,
                   tenant: str | None = None) -> EngineFuture:
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
                            {"ids": ids, "fragments": frags}, {}, timeout,
                            tenant=tenant)

    def tag_fragments(self, fragment_ids, fragments,
                      timeout: float | None = None,
                      tenant: str | None = None):
        return self._blocking("tag", self.submit_tag, fragment_ids,
                              fragments, timeout=timeout, tenant=tenant)

    # -- prove (miner role) --------------------------------------------
    def submit_prove_aggregate(self, fragments, tags, idx, nu, r,
                               sectors: int | None = None,
                               timeout: float | None = None,
                               tenant: str | None = None) -> EngineFuture:
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
                            timeout, tenant=tenant)

    def prove_aggregate(self, fragments, tags, idx, nu, r,
                        sectors: int | None = None,
                        timeout: float | None = None,
                        tenant: str | None = None):
        return self._blocking("prove", self.submit_prove_aggregate,
                              fragments, tags, idx, nu, r, sectors,
                              timeout=timeout, tenant=tenant)

    # -- verify (TEE role) ---------------------------------------------
    def submit_verify_batch(self, fragment_ids, num_blocks, idx, nu,
                            mu, sigma, timeout: float | None = None,
                            tenant: str | None = None) -> EngineFuture:
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
                             "num_blocks": int(num_blocks)}, timeout,
                            tenant=tenant)

    def verify_batch(self, fragment_ids, num_blocks, idx, nu, mu, sigma,
                     timeout: float | None = None,
                     tenant: str | None = None):
        return self._blocking("verify", self.submit_verify_batch,
                              fragment_ids, num_blocks, idx, nu, mu, sigma,
                              timeout=timeout, tenant=tenant)

    def submit_verify_aggregate(self, fragment_ids, num_blocks, idx, nu,
                                r, mu, sigma,
                                timeout: float | None = None,
                                tenant: str | None = None) -> EngineFuture:
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
                             "num_blocks": int(num_blocks)}, timeout,
                            tenant=tenant)

    def verify_aggregate(self, fragment_ids, num_blocks, idx, nu, r, mu,
                         sigma, timeout: float | None = None,
                         tenant: str | None = None) -> bool:
        return bool(self._blocking(
            "verify", self.submit_verify_aggregate, fragment_ids,
            num_blocks, idx, nu, r, mu, sigma, timeout=timeout,
            tenant=tenant))

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
        thread while the batcher and every lane are held between batches;
        no other thread should launch work on the card meanwhile (CUDA's
        global capture mode). With a pool, every lane's slice of the
        cache is warmed too: its codec view prepares the same programs
        on its device, under the lane's keys."""
        self._need_codec()
        patterns = [(tuple(int(i) for i in p), tuple(int(i) for i in mi))
                    for p, mi in patterns]
        # the engine's own programs, then each lane's
        owners = [(self.codec, None)] + [
            (lane.codec, lane) for lane in
            (self.pool.lanes if self.pool is not None else ())]
        with contextlib.ExitStack() as held:
            for dev in sorted(self._device_locks, key=str):
                held.enter_context(self._device_locks[dev])
            for codec, lane in owners:
                with self._device_scope(codec.device):
                    self._warm_codec(codec, lane, patterns, n, buckets)

    def _warm_codec(self, codec, lane, patterns, n: int, buckets) -> None:
        """``warm_repair`` for one codec: the engine's (``lane`` None) or a
        lane's view, under the keys ``_op_repair`` reads for it."""
        warm = getattr(codec, "warm_reconstruct", None)
        for present, missing in patterns:
            for b in buckets:
                bucket = bucket_rows(b)
                shape = (bucket, len(present), n)
                meta = self._codec_meta(codec, "repair", present, missing,
                                        shape)
                if warm is not None:
                    warm(present, missing, shape)
                self.programs.get(
                    self._key(("repair", present, missing, n, bucket), False,
                              lane) + meta,
                    lambda c=codec, p=present, mi=missing:
                        (lambda a: c.reconstruct(a, p, mi)))
        warm_fold = getattr(codec, "warm_fold", None)
        if warm_fold is None:
            return
        from ..ops import regen

        coeffs: set[int] = set()
        for present, missing in patterns:
            if len(missing) == 1:
                coeffs.update(regen.repair_coeffs(codec.k, codec.m, present,
                                                  missing))
        coeffs.discard(0)
        for c in sorted(coeffs):
            for b in buckets:
                bucket = bucket_rows(b)
                meta = self._codec_meta(codec, "symbol", (c,), (),
                                        (bucket, 2, n))
                warm_fold(c, (bucket, 2, n))
                self.programs.get(
                    self._key(("symbol", c, n, bucket), False, lane) + meta,
                    lambda cd=codec, cc=c:
                        (lambda a: cd.fold_symbol(a, cc)))

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

    def labeled_series(self) -> list:
        """Labeled exposition series, ``(family, kind, labels, value)``,
        from the SLO board (``cess_slo_*`` per-class gauges,
        ``cess_tenant_*`` counters); empty without one."""
        return [] if self.slo is None else self.slo.series()

    def labeled_histograms(self) -> list:
        """Labeled histogram families, ``(family, labels, Histogram)``:
        the per-tenant latency distributions; empty without a board."""
        return [] if self.slo is None else self.slo.tenant_histograms()

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
        if self.pool is not None:
            # the batcher drained what it will drain; the lane workers
            # finish their pending batches, then stop
            self.pool.close(timeout)
        if self._thread.is_alive():
            with self._cond:
                for cls, q in self._queues.items():
                    while q:
                        r = q.popleft()
                        self.stats.classes[cls].failed += 1
                        r.future._reject(EngineClosed(
                            "engine shut down before this request ran"))
                        r.span.set(outcome="closed").finish()

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _need_codec(self) -> None:
        if self.codec is None:
            raise ValueError("engine has no ErasureCodec configured")

    def _need_audit(self) -> None:
        if self.audit is None:
            raise ValueError("engine has no AuditBackend configured")

    def _blocking(self, cls: str, submit, *args,
                  timeout: float | None = None, tenant: str | None = None):
        """The blocking form behind encode()/tag_fragments()/...: without
        resilience submit().result() verbatim. With it, EngineSaturated
        submits retry under the configured backoff inside ONE deadline
        budget: every attempt's queue deadline and wait are the budget's
        REMAINING time, so retrying never extends the caller's
        deadline."""
        res = self.resilience
        if res is None:
            return submit(*args, timeout=timeout, tenant=tenant).result()
        if timeout is None:
            timeout = self.policy.default_timeout
        budget = Budget(timeout)

        def attempt(b):
            left = b.remaining()
            return submit(*args, timeout=left, tenant=tenant).result(left)

        return res.retry.call(attempt, retry_on=(EngineSaturated,),
                              budget=budget, token=cls, stats=res.stats,
                              cls=cls)

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

    def _device_scope(self, device: torch.device | None = None):
        device = self.device if device is None else device
        return torch.cuda.device(device) \
            if device.type == "cuda" else contextlib.nullcontext()

    def _tracer_now(self):
        """The engine's own tracer, else the process-armed one, else
        None (every span hook then touches the no-op singleton)."""
        return self.tracer if self.tracer is not None \
            else trace.armed_tracer()

    def _submit(self, cls: str, key: tuple, rows: int, arrays: dict,
                aux: dict, timeout: float | None, squeeze: bool = False,
                tenant: str | None = None) -> EngineFuture:
        if rows < 1:
            raise ValueError(f"empty {cls} request (0 rows)")
        now = time.monotonic()
        if timeout is None:
            timeout = self.policy.default_timeout
        # SLO-gated admission (serve/adaptive.py), before anything is
        # queued or allocated: a shed is an explicit EngineShed
        adm = self.admission
        if adm is not None:
            reason = adm.admit(cls, timeout, tenant,
                               queued=len(self._queues[cls]))
            if reason is not None:
                with self._lock:
                    self.stats.classes[cls].shed += 1
                # a marker span (the flight recorder pins outcome="shed")
                # and a journal note, both outside the engine lock: the
                # shed-storm bundle reads stats_snapshot()
                tracer = self._tracer_now()
                if tracer is not None:
                    with tracer.start(f"engine.{cls}", sys="engine", cls=cls,
                                      rows=rows, op=key[0], outcome="shed",
                                      reason=reason) as sp:
                        if tenant is not None:
                            sp.set(tenant=tenant)
                _flight.note("engine", "shed", cls=cls, reason=reason,
                             tenant=tenant)
                raise EngineShed(f"{cls} request shed: {reason}")
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
                       ready=ready, tenant=tenant)
        tracer = self._tracer_now()
        if tracer is not None:
            # finished when the request resolves, fails, expires or is
            # refused, on whichever thread that happens
            req.span = tracer.start(  # cesslint: disable=span-balance — finished at resolve/reject/expire/close (cross-thread span)
                f"engine.{cls}", sys="engine", cls=cls, rows=rows,
                op=key[0])
            if tenant is not None:
                req.span.set(tenant=tenant)
        saturated = False
        with self._cond:
            if self._closed:
                req.span.set(outcome="closed").finish()
                raise EngineClosed("engine is shut down")
            st = self.stats.classes[cls]
            if len(self._queues[cls]) >= self.policy.queue_cap:
                st.saturated += 1
                saturated = True
            else:
                st.submitted += 1
                self._queues[cls].append(req)
                self._cond.notify_all()
        if saturated:
            # span and journal outside the engine lock: journal
            # listeners may read engine snapshots
            req.span.set(outcome="saturated").finish()
            _flight.note("engine", "saturated", cls=cls)
            raise EngineSaturated(
                f"{cls} queue full ({self.policy.queue_cap})")
        return fut

    # -- batcher thread -------------------------------------------------
    def _run(self) -> None:
        with self._device_scope():
            while True:
                batch: list[_Request] = []
                breaches: list[tuple] = []
                with self._cond:
                    while True:
                        now = time.monotonic()
                        self._expire(now, breaches)
                        if breaches:
                            break
                        cls = self._ready_class(now)
                        if cls is not None:
                            batch = self._drain(cls)
                            self._inflight += 1
                            break
                        if self._closed:
                            self._cond.notify_all()
                            return
                        self._cond.wait(self._wake_timeout(now))
                if breaches:
                    # expired requests burn the SLO budget: fed with the
                    # engine lock released (board listeners take breaker
                    # locks); no batch was drained, so go round again
                    slo = self.slo
                    for bcls, lat, tenant, rows in breaches:
                        slo.observe(bcls, lat, ok=False, tenant=tenant,
                                    rows=rows)
                    continue
                pool = self.pool
                if pool is not None:
                    # the pool's chosen lane runs the batch and settles
                    # the in-flight count through _batch_done
                    try:
                        pool.dispatch(batch)
                    except BaseException as e:
                        _flight.note("engine", "escape", error=repr(e))
                        self._batch_done()
                        raise
                    continue
                try:
                    if batch:
                        self._run_batch(batch)
                except BaseException as e:
                    # member failures are settled inside _run_batch; an
                    # error escaping it kills the batcher: journal it
                    _flight.note("engine", "escape", error=repr(e))
                    raise
                finally:
                    self._batch_done()

    def _batch_done(self) -> None:
        """Settle one drained batch's in-flight count: the batcher's
        inline path, or a pool lane once the batch's futures are
        settled."""
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    def _knobs(self, cls: str) -> tuple[float, int, int]:
        """(max_delay, max_batch_requests, max_batch_rows) for this class:
        the adaptive tuner's live values when there is one, else the
        static policy's; the one seam through which the tuner steers the
        batcher."""
        ad = self.adaptive
        if ad is not None:
            return ad.knobs(cls)
        pol = self.policy
        return pol.max_delay, pol.max_batch_requests, pol.max_batch_rows

    def _expire(self, now: float, breaches: list) -> None:
        """Cancel EVERY queued request whose deadline passed, in every
        class (lock held). Running before readiness checks means a dead
        request in a quiet class cancels promptly even while other
        classes carry traffic, never trips a spurious drain, and stops
        counting against its queue's cap. A timed-out request is an SLO
        breach, but the board is never fed under the engine lock: with a
        board, breaches are collected into ``breaches`` for the caller
        to observe after releasing it (empty without one)."""
        slo = self.slo
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
                    r.span.set(outcome="timeout").finish()
                    if slo is not None:
                        breaches.append((cls, now - r.enqueue_t, r.tenant,
                                         r.rows))
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
        first_nonempty = None
        for cls in CLASSES:               # priority order
            q = self._queues[cls]
            if not q:
                continue
            if first_nonempty is None:
                first_nonempty = cls
            max_delay, max_reqs, max_rows = self._knobs(cls)
            if (self._closed or self._flushing
                    or len(q) >= max_reqs
                    or q[0].enqueue_t + max_delay <= now
                    or sum(r.rows for r in q) >= max_rows):
                return first_nonempty
        return None

    def _wake_timeout(self, now: float) -> float | None:
        wake = None
        for cls, q in self._queues.items():
            if not q:
                continue
            max_delay = self._knobs(cls)[0]
            for r in q:
                t = r.enqueue_t + max_delay
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

    def _anchor_index(self, cls: str, q) -> int:
        """Which queued request anchors the next batch (lock held).
        Without a board: the oldest. With one: weighted-fair across the
        tenants queued, the OLDEST request of the tenant with the fewest
        served device rows (ties by name: deterministic), so a heavy
        uploader's backlog cannot indefinitely pre-empt another tenant's
        differently keyed work in the same class."""
        if self.slo is None or len(q) < 2:
            return 0
        served = self._tenant_rows.get(cls, {})
        first_of: dict[str, int] = {}
        for i, r in enumerate(q):
            t = self._fair_key(r.tenant, served)
            if t not in first_of:
                first_of[t] = i
        if len(first_of) < 2:
            return 0
        tenant = min(first_of, key=lambda t: (served.get(t, 0), t))
        return first_of[tenant]

    def _fair_key(self, tenant: str | None, served: dict) -> str:
        """A tenant's deficit-counter key: its own name while in the
        board's cap, the board's overflow bucket once ``max_tenants``
        names exist. The ONE aliasing rule of both sides:
        ``_account_batch`` charges served rows under it and
        ``_anchor_index`` reads deficits through it."""
        t = tenant or ""
        if t not in served and len(served) >= self.slo.max_tenants:
            from ..obs.slo import OVERFLOW

            return OVERFLOW
        return t

    def _drain(self, cls: str) -> list[_Request]:
        """Pop one coalescible batch (lock held): the anchor request (the
        oldest, or the fair-queued tenant's oldest: ``_anchor_index``)
        and the queued requests sharing its key, up to the class's
        request and row budgets; the rest stay queued in order."""
        q = self._queues[cls]
        if not q:
            return []
        idx = self._anchor_index(cls, q)
        first = q[idx]
        stacked = first.key[0] in self._STACKED_OPS
        anchor_bucket = bucket_rows(first.rows)
        _, max_reqs, max_rows = self._knobs(cls)
        batch, rest, rows = [first], [], first.rows
        for i, r in enumerate(q):
            if i == idx:
                continue
            fits = (r.key == first.key
                    and len(batch) < max_reqs
                    and rows + r.rows <= max_rows)
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

    def _device_annotation(self, tracer, op: str):
        """With ``device_annotations`` on, a batch dispatch runs inside
        ``torch.profiler.record_function("cess:<op>")``, so a profiler
        trace lines up with the framework's spans."""
        if tracer is None or not tracer.device_annotations:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"cess:{op}")

    def _wait_ready(self, batch: list[_Request], dev: torch.device) -> None:
        """The batch's stream on ``dev`` waits on each CUDA member's
        submit event."""
        events = [r.ready for r in batch if r.ready is not None]
        if events and dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            for e in events:
                stream.wait_event(e)

    def _run_batch(self, batch: list[_Request], lane=None,
                   tried=None) -> bool:
        """Run one coalesced batch under its device's lock. ``lane`` is
        None on the single-device path; on the pool path it is the
        ``DeviceLane`` whose worker runs the batch (on the lane's stream):
        the lane's breakers gate it, it runs on the lane's device, and a
        denied or failed lane hands it whole to a healthy sibling
        (``tried``: the lanes that already failed it). Returns True when
        the batch was handed off so: its futures are the sibling's to
        settle.

        Without resilience an op failure rejects every member's future
        with the op's error; with it the batch is gated by its backend's
        breaker (an open one serves its host members on the CPU reference
        and refuses its card members) and a failure is salvaged member by
        member (``_salvage_batch``). A ``KernelBuildError`` is never
        handed off, salvaged, degraded or counted against a breaker."""
        mu = self._device_mu if lane is None \
            else self._device_locks[lane.device]
        with mu:
            return self._run_batch_locked(batch, lane, tried)

    def _run_batch_locked(self, batch: list[_Request], lane, tried) -> bool:
        cls = batch[0].cls
        op = batch[0].key[0]
        runner = getattr(self, f"_op_{op}")
        res = self.resilience
        mons = self.monitors if lane is None else lane.monitors
        mon = mons.get(self._BACKEND_OF[op])
        if tried is None:
            tried = set()
        degraded = res is not None and res.fallback and mon is not None \
            and not mon.allow()
        if degraded and lane is not None \
                and self.pool.requeue(batch, lane, tried):
            return True
        if degraded:
            batch = self._refuse_card_members(batch, EngineUnavailable(
                f"{self._BACKEND_OF[op]} breaker open: a payload on the "
                "card is not served on the host"))
            if not batch:
                return False
            res.stats.note_degraded(cls)
        backend = "cpu-fallback" if degraded else "primary"
        tracer = self._tracer_now()
        bspan = trace.NOOP_SPAN
        if tracer is not None:
            bspan = tracer.start(  # cesslint: disable=span-balance — finished on both the success and error paths below
                "engine.batch", sys="engine", parent=batch[0].span, op=op,
                cls=cls, members=len(batch), rows=sum(r.rows for r in batch),
                degraded=degraded, backend=backend)
            for r in batch:
                r.span.event("batched", batch_span=bspan.span_id,
                             members=len(batch))
        t0 = time.monotonic()
        try:
            # current=True: the device span is the batcher's active span
            # for the dispatch, so fault firings annotate it
            with self._device_annotation(tracer, op), \
                    (trace.NOOP_SPAN if tracer is None else tracer.start(
                        f"device.{op}", sys="device", parent=bspan,
                        current=True, op=op, degraded=degraded,
                        backend=backend,
                        **({} if lane is None else {"device": lane.index}))):
                if not degraded:
                    faults.inject("engine.dispatch")   # chaos seam
                    if lane is not None:
                        # one lane's seam, and one class's on one lane
                        faults.inject(f"engine.dispatch.d{lane.index}")
                        faults.inject(f"engine.dispatch.{cls}.d{lane.index}")
                self._wait_ready(batch, self._batch_device(degraded, lane))
                results, device_rows = self._call(runner, batch, degraded,
                                                  lane)
        except Exception as e:        # op failure
            build = isinstance(e, _build.KernelBuildError)
            if mon is not None and not degraded and not build:
                mon.record_error()
            bspan.set(error=repr(e)).finish()
            if lane is not None and not degraded and not build \
                    and self.pool.requeue(batch, lane, tried):
                # the batch moves WHOLE to a healthy sibling; salvage runs
                # only once every sibling has failed it
                return True
            if res is not None and not build:
                self._salvage_batch(runner, batch, e, mon, degraded, lane)
                return False
            with self._lock:
                self.stats.classes[cls].failed += len(batch)
            fail_t = time.monotonic()
            for r in batch:
                r.future._reject(e)
                r.span.set(outcome="error", error=repr(e)).finish()
                self._observe_failure(r, fail_t)
            return False
        if mon is not None and not degraded:
            mon.record_success(time.monotonic() - t0)
        self._account_batch(batch, device_rows, bspan, lane=lane, t0=t0)
        bspan.finish()
        for r, out in zip(batch, results):
            r.future._resolve(out)
            if r.span is not trace.NOOP_SPAN:
                r.span.set(outcome="ok").finish()
        return False

    @staticmethod
    def _call(runner, batch: list[_Request], degraded: bool, lane):
        """Run ``runner`` on ``batch``. The runner is a monkeypatch seam:
        on the single-device primary path it is called with the batch
        alone."""
        if lane is not None:
            return runner(batch, degraded, lane)
        return runner(batch, True) if degraded else runner(batch)

    def _salvage_batch(self, runner, batch: list[_Request],
                       primary_exc: BaseException, mon,
                       degraded: bool, lane=None) -> None:
        """A batch failed with resilience configured: re-run each member
        ALONE once (a poisoned request must not fail its batch-mates),
        then, if its attempt on the card failed and fallback is allowed,
        serve a host member on the CPU reference; a card member is
        rejected with its attempt's error. Resolves or rejects every
        future."""
        res = self.resilience
        cls = batch[0].cls
        tracer = self._tracer_now()
        if len(batch) > 1:
            res.stats.note_batch_requeues(len(batch))
        # solo re-runs use the card only while its breaker is closed (or
        # the failed batch was degraded already): re-probing a device
        # whose recovery probe just failed, once per member, would
        # multiply the outage's latency by the batch size
        solo = len(batch) > 1 \
            and (degraded or mon is None or mon.state == "closed")
        for r in batch:
            out = None
            exc = primary_exc
            if solo:
                r.span.event("salvage.solo")
                try:
                    if not degraded:
                        faults.inject("engine.dispatch")
                        if lane is not None:
                            faults.inject(f"engine.dispatch.d{lane.index}")
                    self._wait_ready([r], self._batch_device(degraded, lane))
                    out, rows = self._call(runner, [r], degraded, lane)
                except Exception as e:  # noqa: BLE001 (member isolation)
                    exc = e
                    if mon is not None and not degraded \
                            and not isinstance(e, _build.KernelBuildError):
                        mon.record_error()
                else:
                    if mon is not None and not degraded:
                        mon.record_success(0.0)
            if out is None and not degraded and res.fallback \
                    and mon is not None and not self._on_card(r) \
                    and not isinstance(exc, _build.KernelBuildError):
                try:
                    with (trace.NOOP_SPAN if tracer is None
                          else tracer.start("resilience.fallback",
                                            sys="resilience", parent=r.span,
                                            current=True, cls=cls,
                                            backend="cpu-fallback")):
                        out, rows = self._call(runner, [r], True, lane)
                    res.stats.note_fallback(cls)
                except Exception as e:  # noqa: BLE001 (reported below)
                    exc = e
            if out is None:
                with self._lock:
                    self.stats.classes[cls].failed += 1
                r.future._reject(exc)
                r.span.set(outcome="error", error=repr(exc)).finish()
                self._observe_failure(r, time.monotonic())
            else:
                self._account_batch([r], rows, lane=lane)
                r.future._resolve(out[0])
                r.span.set(outcome="ok").finish()

    def _on_card(self, r: _Request) -> bool:
        """A tensor member of an engine on the card: its payload and its
        result live on the card, so its work never moves to the host."""
        return r.device and self.device.type == "cuda"

    def _refuse_card_members(self, batch: list[_Request],
                             exc: BaseException) -> list[_Request]:
        """Reject the card members of a batch bound for the CPU
        references with ``exc``; return the host members."""
        card = [r for r in batch if self._on_card(r)]
        if card:
            with self._lock:
                self.stats.classes[batch[0].cls].failed += len(card)
            fail_t = time.monotonic()
            for r in card:
                r.future._reject(exc)
                r.span.set(outcome="error", error=repr(exc)).finish()
                self._observe_failure(r, fail_t)
        return [r for r in batch if not self._on_card(r)]

    def _observe_failure(self, r: _Request, now: float) -> None:
        """Feed one rejected request into the SLO windows (failures burn
        the error budget); one None check without a board."""
        slo = self.slo
        if slo is not None:
            slo.observe(r.cls, now - r.enqueue_t, ok=False, tenant=r.tenant,
                        rows=r.rows)

    def _account_batch(self, batch: list[_Request], device_rows: int,
                       batch_span=trace.NOOP_SPAN, lane=None,
                       t0: float | None = None) -> None:
        """Count a served batch, then feed the planes: ``done`` is after
        the batch's synchronize (``_split_rows``, ``_op_prove``), so each
        latency and ``dispatch_s = done - t0`` include the device work.
        ``lane``: the pool lane that ran it (its index keys the profile's
        account)."""
        done = time.monotonic()
        real_rows = sum(r.rows for r in batch)
        cls = batch[0].cls
        with self._lock:
            st = self.stats.classes[cls]
            st.batches += 1
            st.batched_requests += len(batch)
            st.rows += real_rows
            st.padded_rows += max(device_rows - real_rows, 0)
            st.completed += len(batch)
            for r in batch:
                lat = done - r.enqueue_t
                st.latencies.append(lat)
                st.hist.observe(lat)
            if self.slo is not None:
                # the weighted-fair drain's deficit counters (bounded:
                # past the cap a new tenant shares the overflow bucket)
                served = self._tenant_rows.setdefault(cls, {})
                for r in batch:
                    t = self._fair_key(r.tenant, served)
                    served[t] = served.get(t, 0) + r.rows
        # the planes' feeds with the engine lock released (their owners
        # have their own locks; board listeners take breaker locks)
        slo = self.slo
        if slo is not None:
            for r in batch:
                slo.observe(cls, done - r.enqueue_t, ok=True,
                            tenant=r.tenant, rows=r.rows)
        ad = self.adaptive
        if ad is not None:
            for r in batch:
                ad.note(cls, done - r.enqueue_t, len(batch))
        prof = self.profile
        if prof is not None:
            prof.on_batch(
                cls, device_rows, 0 if lane is None else lane.index,
                rows=real_rows, padded=max(device_rows - real_rows, 0),
                requests=len(batch),
                nbytes=sum(_payload_bytes(a) for r in batch
                           for a in r.arrays.values()),
                queue_s=sum(done - r.enqueue_t for r in batch),
                dispatch_s=0.0 if t0 is None else done - t0)
        # span attributes only when the spans are real
        if batch_span is not trace.NOOP_SPAN:
            pad = max(device_rows - real_rows, 0)
            pad_waste = round(pad / device_rows if device_rows else 0.0, 4)
            batch_span.set(device_rows=device_rows, pad_waste=pad_waste)
            for r in batch:
                r.span.set(occupancy=len(batch), pad_waste=pad_waste,
                           batch_span=batch_span.span_id,
                           latency_s=round(done - r.enqueue_t, 6))

    # -- op runners (batcher thread only) -------------------------------
    # Each runs ``(batch, degraded=False)``; a degraded batch assembles
    # its inputs on the host and runs the CPU reference backends.

    @staticmethod
    def _sync(dev: torch.device) -> None:
        """Wait for the work enqueued so far on the batch's stream (the
        calling thread's current stream on ``dev``: the batcher's default
        stream, or a lane's own)."""
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            done.synchronize()

    def _home(self, lane) -> torch.device:
        """Where a batch runs when not degraded, and where a tensor
        member's result lies: the engine's device, or the lane's."""
        return self.device if lane is None else lane.device

    def _batch_device(self, degraded: bool, lane=None) -> torch.device:
        return torch.device("cpu") if degraded else self._home(lane)

    def _rs_backend(self, degraded: bool, lane=None):
        """The codec serving this batch: the CPU reference when degraded,
        else the lane's codec view on the pool path (the port's codecs
        are pinned to a device; serve/pool.py), else the engine's."""
        if degraded:
            return self._fallback_codec
        return self.codec if lane is None else lane.codec

    def _audit_backend(self, degraded: bool, lane=None):
        """The AuditBackend serving this batch, as ``_rs_backend``."""
        if degraded:
            return self._fallback_audit
        return self.audit if lane is None else lane.audit

    @staticmethod
    def _key(key: tuple, degraded: bool, lane=None) -> tuple:
        """Degraded programs cache under their own keys: a breaker flip
        never hands a card program (a CUDA graph replay from
        ``warm_repair``) a host batch, nor a host program a card one. On
        the pool path a key grows the lane's ``("device", i)`` component
        for the same reason (degraded keys stay device-free: the CPU
        reference's program is shared by every lane)."""
        if degraded:
            return key + ("cpu-fallback",)
        if lane is not None:
            return key + (("device", lane.index),)
        return key

    def _rows(self, arrs: list, rows: int, dtype,
              dev: torch.device) -> torch.Tensor:
        """Coalesce payloads along axis 0 into a [rows, ...] tensor on
        ``dev``, zero-padded: one copy for each member; a lone tensor
        member that already fills the bucket on ``dev`` is used as it
        lies."""
        first = arrs[0]
        if len(arrs) == 1 and isinstance(first, torch.Tensor) \
                and first.shape[0] == rows and first.device == dev \
                and first.dtype == dtype:
            return first.contiguous()
        out = torch.empty((rows,) + tuple(first.shape[1:]), dtype=dtype,
                          device=dev)
        off = 0
        for a in arrs:
            out[off:off + a.shape[0]].copy_(torch.as_tensor(a))
            off += a.shape[0]
        if off < rows:
            out[off:].zero_()
        return out

    def _stacked(self, arrs: list, rb: int, fb: int, dtype,
                 dev: torch.device) -> torch.Tensor:
        """Stack per-request [F_i, ...] payloads into a zero-padded
        [rb, fb, ...] tensor on ``dev``."""
        first = arrs[0]
        out = torch.zeros((rb, fb) + tuple(first.shape[1:]), dtype=dtype,
                          device=dev)
        for i, a in enumerate(arrs):
            out[i, :a.shape[0]].copy_(torch.as_tensor(a))
        return out

    @staticmethod
    def _as_member(r: _Request, piece, home: torch.device):
        """A result piece in the member's domain: a tensor on ``home``
        (``_home``) for a tensor member, numpy for a numpy one."""
        if r.device:
            return torch.as_tensor(piece).to(home)
        if isinstance(piece, torch.Tensor):
            return piece.cpu().numpy()
        return piece

    def _split_rows(self, batch: list[_Request], out, lane=None) -> list:
        """Slice a batch result (a tensor, or numpy from a host
        reference) back per request in each member's domain; an
        all-host batch is fetched once. A result on the card is
        synchronized before any future resolves (module docstring)."""
        if isinstance(out, torch.Tensor) and out.is_cuda:
            self._sync(out.device)
            if not any(r.device for r in batch):
                out = out.cpu().numpy()
        home = self._home(lane)
        results, off = [], 0
        for r in batch:
            piece = self._as_member(r, out[off:off + r.rows], home)
            results.append(piece[0] if r.squeeze else piece)
            off += r.rows
        return results

    @staticmethod
    def _codec_meta(codec, kind, present=(), missing=(), shape=()) -> tuple:
        """Cost-model components of a program-cache key: codecs under
        strategy "xor"/"auto" report which lowering serves this (kind,
        pattern, shape) and the estimate that picked it; dense codecs
        and the host references give ()."""
        meta = getattr(codec, "program_meta", None)
        if meta is None:
            return ()
        return meta(kind, present=present, missing=missing, shape=shape)

    def _op_encode(self, batch, degraded=False, lane=None):
        codec = self._rs_backend(degraded, lane)
        total = sum(r.rows for r in batch)
        bucket = bucket_rows(total)
        data = self._rows([r.arrays["data"] for r in batch], bucket,
                          torch.uint8, self._batch_device(degraded, lane))
        _, k, n = data.shape
        meta = self._codec_meta(codec, "encode", shape=(bucket, k, n))
        prog = self.programs.get(
            self._key(("encode", k, n, bucket), degraded, lane) + meta,
            lambda: codec.encode)
        out = prog(data)[:total]
        return self._split_rows(batch, out, lane), bucket

    def _op_repair(self, batch, degraded=False, lane=None):
        codec = self._rs_backend(degraded, lane)
        kind = batch[0].key[1]
        aux = batch[0].aux
        total = sum(r.rows for r in batch)
        bucket = bucket_rows(total)
        surv = self._rows([r.arrays["survivors"] for r in batch], bucket,
                          torch.uint8, self._batch_device(degraded, lane))
        n = surv.shape[2]
        if kind == "reconstruct":
            present, missing = aux["present"], aux["missing"]
            meta = self._codec_meta(codec, "repair", present, missing,
                                    (bucket, len(present), n))
            prog = self.programs.get(
                self._key(("repair", present, missing, n, bucket),
                          degraded, lane) + meta,
                lambda: (lambda a: codec.reconstruct(a, present, missing)))
        elif kind == "symbol":
            coeff = aux["coeff"]
            meta = self._codec_meta(codec, "symbol", (coeff,), (),
                                    (bucket, 2, n))
            prog = self.programs.get(
                self._key(("symbol", coeff, n, bucket), degraded,
                          lane) + meta,
                lambda: (lambda a: codec.fold_symbol(a, coeff)))
        else:
            present = aux["present"]
            meta = self._codec_meta(codec, "decode", present, (),
                                    (bucket, len(present), n))
            prog = self.programs.get(
                self._key(("decode", present, n, bucket), degraded,
                          lane) + meta,
                lambda: (lambda a: codec.decode_data(a, present)))
        out = prog(surv)[:total]
        return self._split_rows(batch, out, lane), bucket

    def _op_tag(self, batch, degraded=False, lane=None):
        audit = self._audit_backend(degraded, lane)
        dev = self._batch_device(degraded, lane)
        total = sum(r.rows for r in batch)
        bucket = bucket_rows(total)
        ids = self._rows([r.arrays["ids"] for r in batch], bucket,
                         torch.int64, dev)
        frags = self._rows([r.arrays["fragments"] for r in batch], bucket,
                           torch.uint8, dev)
        prog = self.programs.get(
            self._key(("tag", frags.shape[1], bucket), degraded, lane),
            lambda: audit.tag_fragments)
        out = prog(ids, frags)[:total]
        return self._split_rows(batch, out, lane), bucket

    @staticmethod
    def _round_tensors(aux: dict, dev) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(aux["idx"]).to(dev),
                torch.as_tensor(aux["nu"]).to(dev))

    def _op_verify_batch(self, batch, degraded=False, lane=None):
        audit = self._audit_backend(degraded, lane)
        dev = self._batch_device(degraded, lane)
        aux = batch[0].aux
        total = sum(r.rows for r in batch)
        bucket = bucket_rows(total)
        ids = self._rows([r.arrays["ids"] for r in batch], bucket,
                         torch.int64, dev)
        mu = self._rows([r.arrays["mu"] for r in batch], bucket, torch.int64,
                        dev)
        sigma = self._rows([r.arrays["sigma"] for r in batch], bucket,
                           torch.int64, dev)

        def build():
            idx, nu = self._round_tensors(aux, dev)
            num_blocks = aux["num_blocks"]
            return lambda i, u, s: audit.verify_batch(i, num_blocks, idx,
                                                      nu, u, s)

        prog = self.programs.get(
            self._key(("verify_batch", batch[0].key, bucket), degraded,
                      lane),
            build)
        out = prog(ids, mu, sigma)[:total]
        return self._split_rows(batch, out, lane), bucket

    # The stacked classes call ``podr2`` itself with a leading mission
    # axis, as the TPU engine's stacked runners do: they cross no
    # ``podr2.<op>`` fault site of the gate, only ``engine.dispatch``.

    def _op_verify_agg(self, batch, degraded=False, lane=None):
        audit = self._audit_backend(degraded, lane)
        dev = self._batch_device(degraded, lane)
        aux = batch[0].aux
        fb = bucket_rows(max(r.rows for r in batch))
        rb = bucket_rows(len(batch))
        ids = self._stacked([r.arrays["ids"] for r in batch], rb, fb,
                            torch.int64, dev)
        rs_ = self._stacked([r.arrays["r"] for r in batch], rb, fb,
                            torch.int64, dev)
        mu = self._rows([r.arrays["mu"][None] for r in batch], rb,
                        torch.int64, dev)
        sigma = self._rows([r.arrays["sigma"][None] for r in batch], rb,
                           torch.int64, dev)

        def build():
            idx, nu = self._round_tensors(aux, dev)
            num_blocks = aux["num_blocks"]
            return lambda i, rr, u, s: podr2.verify_aggregate(
                audit.key, i, num_blocks, idx, nu, rr, u, s)

        prog = self.programs.get(
            self._key(("verify_agg", batch[0].key, fb, rb), degraded, lane),
            build)
        ok = prog(ids, rs_, mu, sigma).cpu()
        return [bool(ok[i]) for i in range(len(batch))], rb * fb

    def _op_prove(self, batch, degraded=False, lane=None):
        dev = self._batch_device(degraded, lane)
        aux = batch[0].aux
        fb = bucket_rows(max(r.rows for r in batch))
        rb = bucket_rows(len(batch))
        idx, sectors = aux["idx"], aux["sectors"]
        lanes = sectors * pf.BYTES_PER_ELEM
        blocks = batch[0].arrays["tags"].shape[1]
        # only the challenged blocks are read: gather them per mission
        # (on the host for numpy missions, on the device for tensors)
        # and stack [R, F_bucket, c * lanes] on the batch's device
        sel = self._stacked(
            [_take_blocks(r.arrays["fragments"].reshape(r.rows, blocks,
                                                        lanes), idx
                          ).reshape(r.rows, -1)
             for r in batch], rb, fb, torch.uint8, dev)
        tsel = self._stacked([_take_blocks(r.arrays["tags"], idx)
                              for r in batch], rb, fb, torch.int64, dev)
        rs_ = self._stacked([r.arrays["r"] for r in batch], rb, fb,
                            torch.int64, dev)

        def build():
            _, nu = self._round_tensors(aux, dev)
            return lambda f, t, rr: podr2.prove_aggregate(f, t, None, nu, rr,
                                                          sectors)

        prog = self.programs.get(
            self._key(("prove", batch[0].key, fb, rb), degraded, lane),
            build)
        mu, sigma = prog(sel, tsel, rs_)
        if mu.is_cuda:
            self._sync(mu.device)
        home = self._home(lane)
        host = None
        results = []
        for i, r in enumerate(batch):
            if r.device:
                results.append((self._as_member(r, mu[i], home),
                                self._as_member(r, sigma[i], home)))
                continue
            if host is None:
                host = (mu.cpu().numpy(), sigma.cpu().numpy())
            results.append((host[0][i], host[1][i]))
        return results, rb * fb


def make_engine(k: int | None = None, m: int | None = None, *,
                rs_backend: str | None = None, strategy: str | None = None,
                podr2_key=None, audit_backend: str | None = None,
                policy: AdmissionPolicy | None = None, resilience=None,
                tracer=None, slo=None, adaptive=None, admission=None,
                pool=None, profile=None) -> SubmissionEngine:
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
    resilience: an optional ``resilience.ResilienceConfig`` (retry on
    saturation, member isolation, breaker-gated CPU degradation; the
    module doc's Resilience paragraph). tracer: an optional
    ``obs.trace.Tracer`` for request, batch and device spans; without
    one the engine still honours a process-armed tracer. pool: the
    multi-device serving plane (``serve/pool.py``): a built
    ``DevicePool``, True (every CUDA device; raises without a card) or a
    lane count N (the first N CUDA devices, or N ``"cpu"`` lanes when
    the gates are on the CPU); None, 0 and False: the single-device
    path, unchanged. slo: an optional ``obs.slo.SloBoard`` (burn-rate
    monitors, tenant accounting, the weighted-fair drain). adaptive: an
    ``serve.adaptive.AdaptiveBatchPolicy``, or True to build one seeded
    from ``policy`` and steered by the board's targets (needs ``slo``).
    admission: an ``AdmissionController``; built from the board and the
    tuner when both are given and it is None (False: none). profile: an
    optional ``obs.profile.ProfilePlane`` (per-shape accounts, the pad
    and compile ledgers, and, anchored on a baseline measured on the
    card, the throughput watchdog).
    """
    codec = None
    if k is not None:
        codec = rs.make_codec(k, m, rs_backend, strategy)
    audit = None
    if podr2_key is not None:
        audit = ab.make_audit_backend(podr2_key, audit_backend)
    if adaptive is True:
        if slo is None:
            # a tuner with no board has no targets to steer toward and
            # would never adjust a knob
            raise ValueError("adaptive=True needs an slo= board "
                             "(its targets steer the knob tuner)")
        from .adaptive import AdaptiveBatchPolicy

        adaptive = AdaptiveBatchPolicy(policy, board=slo)
    if admission is None and slo is not None and adaptive is not None:
        from .adaptive import AdmissionController

        admission = AdmissionController(slo, adaptive)
    if pool and not hasattr(pool, "bind"):
        from .pool import DevicePool

        gate = codec if codec is not None else audit
        if pool is not True and gate is not None \
                and gate.device.type == "cpu":
            pool = DevicePool(["cpu"] * int(pool))
        else:
            pool = DevicePool(n=None if pool is True else int(pool))
    return SubmissionEngine(codec, audit, policy, resilience=resilience,
                            tracer=tracer, slo=slo, adaptive=adaptive,
                            admission=admission or None, pool=pool or None,
                            profile=profile)
