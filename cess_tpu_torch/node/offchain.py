"""Off-chain agents: OSS gateway, storage miner, TEE, validator OCW,
and the device steps they run.

The counterpart of ``cess_tpu/node/offchain.py``. The agents are in-process
around a ``node.network.Node`` and speak to the chain only through
extrinsics, events and the fragment transfer channel; each one's
``on_block`` runs after every imported block:

- ``OssGateway.upload``: segments, encodes and tags on the device
  (``upload_batch``), declares on chain, serves the fragments;
- ``MinerAgent``: fetches its rows, reports the transfer, proves each
  challenge over the bytes it holds (``build_proof``), repairs restoral
  orders by whole fragments or by regenerating symbol chains;
- ``TeeAgent``: certifies and tags fillers, verifies queued proofs
  (``verify_owed``) and seals each verdict with its BLS key;
- ``ValidatorOcw``: proposes the challenge snapshot and mines the
  unsigned election (host only).

Each agent takes the reference's ``engine=`` (and the miner ``retry=``
and ``clock=``); the fault seams ``offchain.fetch``,
``offchain.fetch_bytes``, ``offchain.symbol`` and
``offchain.symbol_bytes``, the spans ``offchain.upload``, ``.transfer``,
``.prove``, ``.verify`` and ``.repair`` and the custody notes are the
reference's. The agents run where their pipeline and key lie.

The device steps take and return host arrays and bytes, so an agent on
either side of the package boundary can call them:

- ``HostPodr2``: the ``podr2`` surface the agents read (constants,
  ``keys_equal``, ``fragment_id_from_hash``, ``tag_fragments``,
  ``gen_challenge``, ``aggregate_coeffs``, ``prove_aggregate``,
  ``verify_aggregate``), numpy in and numpy out in the dtypes the TPU
  package's results have on the host, computed on one device.
- ``AgentPipeline``: a host-facing ``StoragePipeline``; ``encode_step``
  leaves the fragments on the device behind a ``DeviceFragments`` handle
  that ``tag_step`` reads without uploading them again.
- ``host_codec``: an lru-cached codec with numpy in and numpy out.
- ``upload_batch``, ``prove_owed``, ``verify_owed``, ``certify_fillers``,
  ``warm_restoral``, ``repair_via_fragments``, ``repair_symbol`` and
  ``repair_via_symbols``: the agents' device steps, each with an optional
  port engine (``serve.SubmissionEngine``) and ``tenant=``; ``Proof``,
  ``proof_wire_bytes`` and ``build_proof``: the proof's wire bytes.

Every entry point runs on the card unless given ``device="cpu"`` (or,
for an agent, a pipeline and key on the CPU).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import codec
from .._device import resolve_device
from ..models.pipeline import PipelineConfig, StoragePipeline
from ..obs import flight as _flight
from ..obs import trace
from ..ops import pfield as pf
from ..ops import podr2, regen
from ..ops.rs import TorchCodec
from ..resilience import faults
from .hashing import filler_bytes, fragment_hash


def _tensor(x, device: torch.device, dtype: torch.dtype | None = None
            ) -> torch.Tensor:
    """A tensor on ``device``: a tensor is moved, anything else is read
    with ``np.asarray`` (a JAX array included) and copied over; uint32
    values become int64."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        elif not a.flags.writeable:
            a = a.copy()
        x = torch.from_numpy(a)
    return x.to(device) if dtype is None else x.to(device, dtype)


def _field(x: torch.Tensor) -> np.ndarray:
    """Field elements (int32 tensor, every value below p) as host uint32,
    the dtype the TPU package's results have on the host."""
    return x.cpu().numpy().astype(np.uint32)


def _ids(hashes) -> np.ndarray:
    """[F, 2] uint32 PoDR2 ids of fragment hashes."""
    return np.stack([podr2.fragment_id_from_hash(h) for h in hashes])


class HostPodr2:
    """The ``cess_tpu.ops.podr2`` surface that the off-chain agents read,
    on one device with host arrays in and out.

    Inputs are tensors, numpy, or any object with ``__array__`` (a JAX
    CPU array): it is read with ``np.asarray``, so this class imports no
    jax. Results are numpy in the dtypes ``np.asarray`` gives the TPU
    package's results (uint32 tags, mu, sigma, coefficients and nu,
    int32 indices), or a Python ``bool`` for a verdict.

    ``key_adapter``: an optional callable that turns a foreign key object
    (the TPU package's key) into a port ``Podr2Key``, for a caller that
    holds only such keys."""

    SECTORS = podr2.SECTORS
    BLOCK_BYTES = podr2.BLOCK_BYTES
    LIMBS = podr2.LIMBS
    PROOF_BYTES = podr2.PROOF_BYTES
    Podr2Key = podr2.Podr2Key
    fragment_id_from_hash = staticmethod(podr2.fragment_id_from_hash)

    def __init__(self, device=None, key_adapter=None):
        self.device = resolve_device(device)
        self.key_adapter = key_adapter

    def port_key(self, key) -> podr2.Podr2Key:
        """``key`` as a port key on this device: a port key as it is, any
        other through ``key_adapter`` (a TypeError without one)."""
        if isinstance(key, podr2.Podr2Key):
            return key.to(self.device)
        if self.key_adapter is None:
            raise TypeError(f"{type(key).__name__} is not a port Podr2Key; "
                            "pass key_adapter= to convert it")
        return self.key_adapter(key).to(self.device)

    def keys_equal(self, a, b) -> bool:
        return podr2.keys_equal(self.port_key(a), self.port_key(b))

    def tag_fragments(self, key, fragment_ids, fragments) -> np.ndarray:
        """ids [F, 2] (or [F]), fragments [F, bytes] uint8 -> tags [F,
        blocks, limbs] uint32."""
        frags = _tensor(fragments, self.device, torch.uint8)
        return _field(podr2.tag_fragments(self.port_key(key),
                                          np.asarray(fragment_ids), frags))

    def gen_challenge(self, seed, num_blocks: int, count: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
        """(indices [c] int32, nu [c] uint32), derived on the host."""
        idx, nu = podr2.gen_challenge(seed, num_blocks, count, device="cpu")
        return idx.numpy().astype(np.int32), nu.numpy().astype(np.uint32)

    def aggregate_coeffs(self, seed: bytes, fragment_ids) -> np.ndarray:
        """r [F] uint32 for ids [F, 2]."""
        return _field(podr2.aggregate_coeffs(seed, np.asarray(fragment_ids),
                                             device=self.device))

    def prove_aggregate(self, fragments, tags, idx, nu, r,
                        sectors: int = podr2.SECTORS
                        ) -> tuple[np.ndarray, np.ndarray]:
        """(mu [sectors], sigma [limbs]) uint32 over fragments [F, bytes]
        and tags [F, blocks, limbs]."""
        dev = self.device
        mu, sigma = podr2.prove_aggregate(
            _tensor(fragments, dev, torch.uint8),
            _tensor(tags, dev, torch.int32), _tensor(idx, dev, torch.int64),
            _tensor(nu, dev, torch.int32), _tensor(r, dev, torch.int32),
            sectors)
        return _field(mu), _field(sigma)

    def verify_aggregate(self, key, fragment_ids, num_blocks: int, idx, nu,
                         r, mu, sigma) -> bool:
        dev = self.device
        return bool(podr2.verify_aggregate(
            self.port_key(key), np.asarray(fragment_ids), num_blocks,
            _tensor(idx, dev, torch.int64), _tensor(nu, dev, torch.int64),
            _tensor(r, dev, torch.int64), _tensor(mu, dev, torch.int64),
            _tensor(sigma, dev, torch.int64)))


class DeviceFragments:
    """Fragments [B, k+m, n] uint8 that an encode left on the device.

    The handle keeps the tensor alive for ``AgentPipeline.tag_step``,
    which reads it where it lies. ``np.asarray(handle)`` fetches it into
    host memory once and hands back that read-only copy ever after;
    ``fetches`` counts the copies made (at most 1)."""

    dtype = np.dtype(np.uint8)

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self.fetches = 0
        self._host = None
        self._lock = threading.Lock()

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.tensor.shape)

    def numpy(self) -> np.ndarray:
        with self._lock:
            if self._host is None:
                self._host = self.tensor.cpu().numpy()
                self._host.flags.writeable = False
                self.fetches += 1
            return self._host

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        if dtype is not None and np.dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return a.copy() if copy else a


class AgentPipeline:
    """The storage pipeline as the agents use it: ``config``,
    ``podr2_key``, a settable ``engine`` (refused when its geometry or key
    differs, as ``StoragePipeline`` refuses it), and the two steps with
    host arrays in and out. ``fragment_uploads`` counts the ``tag_step``
    calls whose fragments had to be copied to the device."""

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 podr2_key: podr2.Podr2Key | None = None, device=None,
                 engine=None):
        self.pipeline = StoragePipeline(config, podr2_key=podr2_key,
                                        device=device, engine=engine)
        self.fragment_uploads = 0
        self._lock = threading.Lock()

    @property
    def config(self) -> PipelineConfig:
        return self.pipeline.config

    @property
    def podr2_key(self) -> podr2.Podr2Key:
        return self.pipeline.podr2_key

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    @property
    def engine(self):
        return self.pipeline.engine

    @engine.setter
    def engine(self, engine) -> None:
        self.pipeline.engine = engine

    def encode_step(self, segments, tenant: str | None = None
                    ) -> DeviceFragments:
        """Segments [B, segment_size] uint8 -> the handle of their
        fragments [B, k+m, fragment_size] on the device."""
        return DeviceFragments(self.pipeline.encode_step(
            _tensor(segments, self.device, torch.uint8), tenant=tenant))

    def tag_step(self, fragments, fragment_ids=None,
                 tenant: str | None = None) -> np.ndarray:
        """Tags [B, k+m, blocks, limbs] uint32 of a ``DeviceFragments``
        handle (read on the device) or of host fragments. ``fragment_ids``
        as for ``StoragePipeline.tag_step``: [B, k+m, 2] hash word pairs
        in production."""
        if isinstance(fragments, DeviceFragments):
            frags = fragments.tensor
        else:
            if not (isinstance(fragments, torch.Tensor)
                    and fragments.device == self.device):
                with self._lock:
                    self.fragment_uploads += 1
            frags = _tensor(fragments, self.device, torch.uint8)
        if fragment_ids is not None \
                and not isinstance(fragment_ids, torch.Tensor):
            fragment_ids = np.asarray(fragment_ids)
        return _field(self.pipeline.tag_step(frags, fragment_ids,
                                             tenant=tenant))


class HostCodec:
    """A port codec (``TorchCodec``) with numpy in and numpy out."""

    def __init__(self, codec: TorchCodec):
        self.codec = codec
        self.k, self.m = codec.k, codec.m

    @property
    def device(self) -> torch.device:
        return self.codec.device

    @property
    def warm_hits(self) -> int:
        return self.codec.warm_hits

    def _in(self, x) -> torch.Tensor:
        return _tensor(x, self.codec.device, torch.uint8)

    def encode(self, data) -> np.ndarray:
        return self.codec.encode(self._in(data)).cpu().numpy()

    def reconstruct(self, survivors, present, missing=None) -> np.ndarray:
        return self.codec.reconstruct(self._in(survivors), present,
                                      missing).cpu().numpy()

    def decode_data(self, survivors, present) -> np.ndarray:
        return self.codec.decode_data(self._in(survivors),
                                      present).cpu().numpy()

    def warm_reconstruct(self, present, missing=None, shape=None) -> None:
        """Prepare the reconstruct of one pattern for survivors of exactly
        ``shape``: a later ``reconstruct`` of it replays (``warm_hits``)."""
        self.codec.warm_reconstruct(present, missing, shape)


class HostRegenCodec(HostCodec):
    """``HostCodec`` over a ``regen.RegenCodec``, with the symbol fold."""

    def fold_symbol(self, pairs, coeff: int) -> np.ndarray:
        """pairs [..., 2, n] (accumulator, fragment) -> [..., 1, n]."""
        return self.codec.fold_symbol(self._in(pairs), coeff).cpu().numpy()

    def warm_fold(self, coeff: int, shape) -> None:
        """Prepare the fold of one coefficient for pairs of exactly
        ``shape``: a later ``fold_symbol`` of it replays (``warm_hits``)."""
        self.codec.warm_fold(coeff, shape)


def host_codec(k: int, m: int, backend: str | None = None,
               strategy: str | None = None, device=None) -> HostCodec:
    """The codec the agents repair with, cached so that every caller with
    the same arguments on the same device (``warm_restoral``, then each
    repair) gets the same instance and its warm programs. ``backend``:
    None for the port's codec, "regen" for the regenerating codec
    (``HostRegenCodec``). ``device``: where it runs, the card by
    default."""
    if backend not in (None, "regen"):
        raise ValueError(f"unknown host codec backend {backend!r}")
    return _host_codec(k, m, backend == "regen", strategy,
                       resolve_device(device))


@functools.lru_cache(maxsize=None)
def _host_codec(k: int, m: int, regen_: bool, strategy: str | None,
                device: torch.device) -> HostCodec:
    if regen_:
        return HostRegenCodec(regen.RegenCodec(k, m, device, strategy))
    return HostCodec(TorchCodec(k, m, device, strategy))


# -- the gateway -------------------------------------------------------------
@dataclasses.dataclass
class Upload:
    """What a gateway upload computes before its on-chain declaration.
    ``seconds``: host clock of each stage; "encode" copies the segments to
    the device and launches the encode, "fetch" waits for it and copies
    the fragments out, "hash" derives identities and ids, "tag" ends with
    the tags on the host."""

    fragments: np.ndarray                  # [B, k+m, n] uint8
    tags: np.ndarray                       # [B, k+m, blocks, limbs] uint32
    ids: np.ndarray                        # [B, k+m, 2] uint32
    fragment_hashes: list[tuple[bytes, ...]]
    segment_hashes: list[bytes]
    file_hash: bytes
    fetches: int                           # device-to-host copies made
    seconds: dict[str, float]


def _hash_all(blobs) -> list[bytes]:
    """sha256 of each buffer; hashlib releases the interpreter lock on
    large buffers, so up to 8 threads hash them side by side."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(fragment_hash, blobs))


def upload_batch(pipeline: AgentPipeline, data, *,
                 tenant: str | None = None, file: str | None = None
                 ) -> Upload:
    """The device half of ``OssGateway.upload``: ``data`` (bytes or a
    uint8 array) zero-padded into segments, encoded, every fragment
    hashed into its identity and id, and tagged from the fragments the
    encode left on the device (they are fetched to the host once and
    never uploaded again). ``file``: the file name the span carries."""
    cfg = pipeline.config
    buf = np.frombuffer(data, dtype=np.uint8)
    size = buf.size
    pad = (-size) % cfg.segment_size
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    segments = buf.reshape(-1, cfg.segment_size)
    rows = cfg.k + cfg.m
    named = {} if file is None else {"file": file}
    with trace.span("offchain.upload", sys="offchain", **named,
                    segments=segments.shape[0], size=size):
        t0 = time.perf_counter()
        handle = pipeline.encode_step(segments, tenant=tenant)
        t1 = time.perf_counter()
        frags = np.asarray(handle)
        t2 = time.perf_counter()
        hashes = _hash_all([row for seg in frags for row in seg]
                           + list(segments))
        frag_hashes = [tuple(hashes[i * rows:(i + 1) * rows])
                       for i in range(segments.shape[0])]
        ids = _ids(hashes[:frags.shape[0] * rows]).reshape(
            frags.shape[0], rows, 2)
        t3 = time.perf_counter()
        tags = pipeline.tag_step(handle, ids, tenant=tenant)
        t4 = time.perf_counter()
        seconds = {"encode": t1 - t0, "fetch": t2 - t1, "hash": t3 - t2,
                   "tag": t4 - t3}
        file_hash = fragment_hash(b"".join(h for fs in frag_hashes
                                           for h in fs))
    return Upload(frags, tags, ids, frag_hashes,
                  hashes[frags.shape[0] * rows:], file_hash,
                  handle.fetches, seconds)


# -- the miner's proof and the TEE's check ------------------------------------
def prove_owed(seed: bytes, owed, store, tags, *, limbs: int | None = None,
               engine=None, tenant: str | None = None, device=None
               ) -> tuple[np.ndarray, np.ndarray]:
    """A miner's aggregated proof (mu [sectors], sigma [limbs]) uint32
    over the owed fragment hashes it holds, as ``build_proof`` computes it
    before the wire codec. ``store``: hash -> fragment bytes (or any
    buffer); ``tags``: hash -> [blocks, limbs]. A fragment no longer held
    contributes nothing, and the proof then fails the TEE's check; with
    none held the proof is all zero. Only the challenged blocks and their
    tags are gathered on the host and go to the device (or the engine's
    prove queue)."""
    held = sum(1 for h in owed if h in store)
    with trace.span("offchain.prove", sys="offchain", owed=len(owed),
                    held=held):
        return _prove(seed, owed, store, tags, limbs, engine, tenant,
                      device)


def _prove(seed, owed, store, tags, limbs, engine, tenant, device
           ) -> tuple[np.ndarray, np.ndarray]:
    held = [h for h in owed if h in store]
    if limbs is None:
        limbs = np.asarray(next(iter(tags.values()))).shape[-1] if tags \
            else podr2.LIMBS
    if not held:
        return (np.zeros((podr2.SECTORS,), np.uint32),
                np.zeros((limbs,), np.uint32))
    ops = HostPodr2(device)
    blocks = np.asarray(tags[held[0]]).shape[0]
    idx, nu = ops.gen_challenge(seed, blocks)
    r = ops.aggregate_coeffs(seed, _ids(held))
    sel = np.stack([np.frombuffer(store[h], np.uint8).reshape(
        blocks, -1)[idx] for h in held]).reshape(len(held), -1)
    tsel = np.stack([np.asarray(tags[h])[idx] for h in held])
    order = np.arange(len(idx), dtype=np.int32)
    if engine is not None and engine.audit is not None:
        mu, sigma = engine.prove_aggregate(sel, tsel, order, nu, r,
                                           tenant=tenant)
    else:
        mu, sigma = ops.prove_aggregate(sel, tsel, order, nu, r)
    return (np.ascontiguousarray(np.asarray(mu), dtype=np.uint32),
            np.ascontiguousarray(np.asarray(sigma), dtype=np.uint32))


@codec.register
@dataclasses.dataclass(frozen=True)
class Proof:
    """The aggregated PoDR2 proof on the wire: one (mu, sigma) folded over
    every owed fragment. Both fields are fixed-width uint32 arrays, so
    the codec's bytes are constant in the number of fragments; the chain
    caps them at SIGMA_MAX. Registered under the reference's class name,
    so the bytes equal the reference's."""
    mu: np.ndarray              # [sectors] uint32
    sigma: np.ndarray           # [limbs] uint32 F_p^limbs element


def proof_wire_bytes(limbs: int | None = None,
                     sectors: int = podr2.SECTORS) -> int:
    """The framed wire size of an aggregated proof (``podr2.PROOF_BYTES``
    of payload plus the codec's constant framing), from an actual
    encode."""
    if limbs is None:
        limbs = podr2.LIMBS
    return len(codec.encode(Proof(
        mu=np.zeros((sectors,), np.uint32),
        sigma=np.zeros((limbs,), np.uint32))))


def build_proof(seed: bytes, owed, store, tags, limbs: int | None = None,
                engine=None, tenant: str | None = None, *,
                device=None) -> bytes:
    """A miner's aggregated proof over the owed set as wire bytes:
    ``prove_owed`` (on the card, or the engine's prove queue) followed by
    the codec. Fragments the miner no longer holds contribute nothing,
    and the proof then fails the TEE's check."""
    mu, sigma = prove_owed(seed, owed, store, tags, limbs=limbs,
                           engine=engine, tenant=tenant, device=device)
    return codec.encode(Proof(mu=mu, sigma=sigma))


def verify_owed(key: podr2.Podr2Key, blocks: int, seed: bytes, owed, mu,
                sigma, *, idx=None, nu=None, engine=None,
                tenant: str | None = None, device=None) -> bool:
    """The TEE's check of a decoded proof against the owed fragment
    hashes, as ``TeeAgent._verify`` makes it after the wire codec: mu and
    sigma must be uint32 arrays of [SECTORS] and [key.limbs] with sigma
    below p, an empty owed set passes only an all-zero proof, and
    otherwise the aggregated equation must hold. ``idx``/``nu``: the
    round's challenge, derived from ``seed`` when not given. An engine
    whose audit key is not ``key`` is refused (ValueError), as the TEE
    refuses it: its verdict would hold under another key."""
    if engine is not None and engine.audit is not None \
            and not podr2.keys_equal(engine.audit.key, key):
        raise ValueError("engine AuditBackend key differs from the "
                         "verifier's PoDR2 key")
    with trace.span("offchain.verify", sys="offchain",
                    owed=len(owed)) as span:
        ok = _verify(key, blocks, seed, owed, mu, sigma, idx, nu, engine,
                     tenant, device)
        span.set(ok=ok)
    return ok


def _verify(key, blocks, seed, owed, mu, sigma, idx, nu, engine, tenant,
            device) -> bool:
    if not (isinstance(mu, np.ndarray) and mu.shape == (podr2.SECTORS,)
            and mu.dtype == np.uint32 and isinstance(sigma, np.ndarray)
            and sigma.shape == (key.limbs,) and sigma.dtype == np.uint32
            and bool((sigma < pf.P).all())):
        return False
    if not owed:
        return not sigma.any() and not mu.any()
    ops = HostPodr2(device)
    if idx is None:
        idx, nu = ops.gen_challenge(seed, blocks)
    ids = _ids(owed)
    r = ops.aggregate_coeffs(seed, ids)
    if engine is not None and engine.audit is not None:
        return engine.verify_aggregate(ids, blocks, np.asarray(idx),
                                       np.asarray(nu), r, mu, sigma,
                                       tenant=tenant)
    return ops.verify_aggregate(key, ids, blocks, idx, nu, r, mu, sigma)


def certify_fillers(key: podr2.Podr2Key, miner: str, indices, blobs,
                    blocks: int, *, device=None
                    ) -> tuple[list[bytes], np.ndarray]:
    """The TEE's filler certification before its signature: each blob
    must be the canonical full-size filler of (miner, index); returns
    their hashes and tags [F, blocks, limbs] uint32."""
    indices, blobs = list(indices), list(blobs)
    size = blocks * podr2.BLOCK_BYTES
    if len(indices) != len(blobs) or len(set(indices)) != len(indices):
        raise ValueError("indices/blobs mismatch")
    for i, blob in zip(indices, blobs):
        if len(blob) != size or blob != filler_bytes(miner, i, size):
            raise ValueError(f"filler {i} content not canonical")
    return _tag_blobs(key, blobs, device)


def _tag_blobs(key, blobs, device) -> tuple[list[bytes], np.ndarray]:
    """The hashes of ``blobs`` and their tags [F, blocks, limbs] uint32."""
    hashes = [fragment_hash(b) for b in blobs]
    tags = HostPodr2(device).tag_fragments(
        key, _ids(hashes),
        np.stack([np.frombuffer(b, dtype=np.uint8) for b in blobs]))
    return hashes, tags


# -- repair -------------------------------------------------------------------
def warm_restoral(k: int, m: int, fragment_size: int, *, engine=None,
                  device=None) -> None:
    """Prepare the repair of each lost row from the k lowest other rows
    (the survivors a repair assembles when every peer holds its
    fragment), as ``MinerAgent.warm_restoral`` does: in the engine's
    program cache (the 1-row bucket), else on ``host_codec(k, m,
    device=device)``, the instance ``repair_via_fragments`` uses."""
    rows = k + m
    patterns = [(tuple(j for j in range(rows) if j != row)[:k], (row,))
                for row in range(rows)]
    if engine is not None and engine.codec is not None:
        engine.warm_repair(patterns, fragment_size, buckets=(1,))
        return
    codec = host_codec(k, m, device=device)
    for present, missing in patterns:
        codec.warm_reconstruct(present, missing, (k, fragment_size))


def repair_via_fragments(k: int, m: int, survivors, present, row: int, *,
                         engine=None, tenant: str | None = None,
                         device=None) -> bytes:
    """Whole-fragment repair: lost row ``row`` rebuilt from k survivor
    fragments (bytes or buffers, in the order of ``present``), through
    the engine's repair queue or ``host_codec(k, m, device=device)``.
    The caller checks the result against the fragment's hash."""
    present = tuple(present)
    with trace.span("offchain.repair", sys="offchain", row=row,
                    survivors=len(present), mode="fragments"):
        return _rebuild(k, m, survivors, present, row, engine, tenant,
                        device)


def _rebuild(k, m, survivors, present, row, engine, tenant, device
             ) -> bytes:
    stacked = np.stack([np.frombuffer(s, dtype=np.uint8)
                        for s in survivors])
    if engine is not None and engine.codec is not None:
        rec = engine.reconstruct(stacked, present, (row,), tenant=tenant)
    else:
        rec = host_codec(k, m, device=device).reconstruct(
            stacked, present, (row,))
    return np.asarray(rec)[0].tobytes()


def repair_symbol(k: int, m: int, fragment, coeff: int, acc=None, *,
                  codec=None, engine=None, tenant: str | None = None,
                  device=None) -> np.ndarray | None:
    """One helper's hop of a regenerating repair of RS(k, m): ``acc ^
    coeff * fragment`` (acc None: zeros). None when the helper cannot
    serve: no fragment, or the hop dropped at seam ``offchain.symbol``.
    The result passes seam ``offchain.symbol_bytes``. Folds on the engine
    when its codec has ``fold_symbol``, else on ``codec`` or
    ``host_codec(k, m, "regen", device=device)``."""
    if fragment is None:
        return None
    if not faults.allow("offchain.symbol"):
        return None
    frag = np.frombuffer(fragment, dtype=np.uint8)
    acc = np.zeros_like(frag) if acc is None \
        else np.asarray(acc, dtype=np.uint8)
    pairs = np.stack([acc, frag])
    if engine is not None and engine.codec is not None \
            and hasattr(engine.codec, "fold_symbol"):
        sym = np.asarray(engine.repair_symbol(pairs, int(coeff),
                                              tenant=tenant))[0]
    else:
        codec = codec or host_codec(k, m, "regen", device=device)
        sym = codec.fold_symbol(pairs, int(coeff))[0]
    return np.asarray(faults.corrupt("offchain.symbol_bytes", sym),
                      dtype=np.uint8)


def repair_via_symbols(k: int, m: int, present, row: int, helpers, *,
                       codec=None, engine=None, tenant: str | None = None,
                       device=None) -> bytes | None:
    """Regenerating repair: each helper (its fragment bytes, or None, in
    the order of ``present``) folds its coefficient times its fragment
    into the travelling sum (``repair_symbol``, on the engine, ``codec``
    or ``host_codec(k, m, "regen", device=device)``), and the last sum is
    the lost row. None when the pattern has no chain or a hop refuses.
    The caller checks the result against the fragment's hash."""
    present = tuple(present)
    with trace.span("offchain.repair", sys="offchain", row=row,
                    survivors=len(present), mode="symbols"):
        try:
            coeffs = regen.repair_coeffs(k, m, present, (row,))
        except ValueError:
            return None
        acc = None
        for fragment, coeff in zip(helpers, coeffs):
            acc = repair_symbol(k, m, fragment, coeff, acc, codec=codec,
                                engine=engine, tenant=tenant, device=device)
            if acc is None:
                return None
        return acc.tobytes()


# -- the agents around a node -------------------------------------------------
# The reference's agent classes (``cess_tpu/node/offchain.py``) on the
# device steps above: each agent's ``on_block`` runs after every imported
# block and speaks to the chain only through extrinsics, events and the
# fragment transfer channel. Every device step runs where the agent's
# pipeline or key lies (the card unless they were built on the CPU), or on
# the engine it was given (``serve.SubmissionEngine``); results are the
# same bytes either way.

def _agent_pipeline(pipeline) -> AgentPipeline:
    """``pipeline`` as an ``AgentPipeline``: one as it is, a port
    ``StoragePipeline`` behind one (sharing its device, key and engine)."""
    if isinstance(pipeline, AgentPipeline):
        return pipeline
    if not isinstance(pipeline, StoragePipeline):
        raise TypeError(f"{type(pipeline).__name__} is not a port pipeline")
    wrapped = AgentPipeline.__new__(AgentPipeline)
    wrapped.pipeline = pipeline
    wrapped.fragment_uploads = 0
    wrapped._lock = threading.Lock()
    return wrapped


class OssGateway:
    """The user-facing gateway: chunk -> encode -> tag -> declare.

    Every engine submit an upload makes is tagged with the uploading
    owner's account (the per-tenant accounting of ``obs/slo.py``).
    ``last_upload``: the ``Upload`` of the newest upload, with its
    stages' host seconds."""

    def __init__(self, node, account: str, pipeline):
        self.node = node
        self.account = account
        self.pipeline = _agent_pipeline(pipeline)
        self.fragment_store: dict[bytes, bytes] = {}   # hash -> bytes
        self.tag_store: dict[bytes, np.ndarray] = {}   # hash -> [blocks] u32
        self.last_upload: Upload | None = None

    def upload(self, owner: str, bucket: str, file_name: str,
               data: bytes) -> bytes:
        """Segment, encode and tag on the device (``upload_batch``);
        declare on chain; keep the fragments for the miners to fetch.
        Returns the file hash."""
        from ..chain.file_bank import UserBrief

        cfg = self.pipeline.config
        up = upload_batch(self.pipeline, data, tenant=owner, file=file_name)
        self.last_upload = up
        for i, hashes in enumerate(up.fragment_hashes):
            for j, h in enumerate(hashes):
                self.fragment_store[h] = up.fragments[i, j].tobytes()
                self.tag_store[h] = up.tags[i, j]
        seg_list = list(zip(up.segment_hashes, up.fragment_hashes))
        self.node.submit_extrinsic(
            self.account, "file_bank.upload_declaration", up.file_hash,
            seg_list, UserBrief(owner, file_name, bucket), len(data))
        # custody lineage: one encode and dispatch event per upload
        _flight.note("custody", "dispatch", owner=owner, file=up.file_hash,
                     k=cfg.k, m=cfg.m, segments=seg_list)
        return up.file_hash


SLOW_FILLER_WORK = 2048   # sequential hashes per 512-B block (cost knob)


def filler_seed_commitment(secret: bytes) -> bytes:
    """The on-chain commitment to a miner's filler seed."""
    return hashlib.sha256(b"cess-filler-seed:" + secret).digest()


def slow_filler_bytes(secret: bytes, index: int, size: int,
                      work: int = SLOW_FILLER_WORK) -> bytes:
    """Secret-seeded filler content: each 512-byte block ends a
    ``work``-step sequential hash chain over (secret, index, block), so
    the network cannot derive it and the miner cannot cheaply regenerate
    challenged blocks inside an audit window. The TEE tags it once at
    certification; audits verify against the tags."""
    block_bytes = 512
    out = bytearray()
    for j in range(-(-size // block_bytes)):
        state = hashlib.sha256(
            b"cess-pois-filler:" + secret + index.to_bytes(8, "little")
            + j.to_bytes(8, "little")).digest()
        for _ in range(work):          # the sequential cost
            state = hashlib.sha256(state).digest()
        for c in range(block_bytes // 32):   # cheap expansion
            out += hashlib.sha256(state + c.to_bytes(4, "little")).digest()
    return bytes(out[:size])


class MinerAgent:
    """A storage miner: fetches its rows of each deal, reports the
    transfer, answers each challenge with aggregated proofs over the bytes
    it really holds (drop ``store`` entries to lose data), and repairs
    restoral orders from its peers' rows.

    ``retry``: a ``resilience.RetryPolicy`` for fragment transfers (None:
    one attempt); ``clock``: any object with ``sleep(seconds)`` for the
    retry backoff (None: the wall clock); ``engine``: proofs and repairs
    go through its prove and repair queues (geometry-checked).
    ``repair_mode``: "fragments" (k whole survivor rows in) or "symbols"
    (the regenerating chain through the helpers, one aggregate in)."""

    def __init__(self, node, account: str, gateways: list[OssGateway],
                 pipeline, engine=None, retry=None, clock=None):
        self.node = node
        self.account = account
        self.gateways = gateways
        self.pipeline = _agent_pipeline(pipeline)
        self.retry = retry
        self.clock = clock
        self.engine = None
        if engine is not None:
            self.attach_engine(engine)
        self.repair_mode = "fragments"
        self._mode_mu = threading.Lock()
        # ingress accounting: the bytes that crossed the wire into this
        # miner for a repair against the bytes it recovered
        self.repair_ingress_bytes = 0
        self.repair_recovered_bytes = 0
        self.repair_symbol_repairs = 0
        self.repair_whole_repairs = 0
        self.repair_fallbacks = 0
        self.store: dict[bytes, bytes] = {}        # fragment hash -> bytes
        self.tags: dict[bytes, np.ndarray] = {}
        self.filler_store: dict[bytes, bytes] = {}  # filler hash -> bytes
        self.filler_tags: dict[bytes, np.ndarray] = {}
        self._reported: set[bytes] = set()
        self._proved_round: int = -1

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    def attach_engine(self, engine) -> None:
        """Bind a submission engine; one whose codec geometry differs from
        the pipeline's is refused (ValueError)."""
        if engine is not None and engine.codec is not None \
                and (engine.codec.k, engine.codec.m) \
                != (self.pipeline.config.k, self.pipeline.config.m):
            raise ValueError(
                f"engine codec RS({engine.codec.k},{engine.codec.m}) != "
                f"miner pipeline RS({self.pipeline.config.k},"
                f"{self.pipeline.config.m})")
        self.engine = engine

    def set_repair_mode(self, mode: str) -> None:
        """Flip the repair dispatch mode (thread-safe); a change is noted
        to the flight recorder as ("repair", "mode")."""
        if mode not in ("symbols", "fragments"):
            raise ValueError(
                f"repair_mode must be 'symbols' or 'fragments', "
                f"got {mode!r}")
        with self._mode_mu:
            frm = self.repair_mode
            if frm == mode:
                return
            self.repair_mode = mode
        _flight.note("repair", "mode", miner=self.account, frm=frm,
                     to=mode)

    # -- fillers ------------------------------------------------------------
    def setup_fillers(self, tee: "TeeAgent", count: int) -> None:
        """``count`` fillers, certified and tagged by the TEE and
        registered on chain (idle space enters the ledger)."""
        size = self.pipeline.config.fragment_size
        blobs = [filler_bytes(self.account, i, size) for i in range(count)]
        hashes, tags, sig = tee.certify_fillers(self.account,
                                                list(range(count)), blobs)
        self._keep_fillers(hashes, blobs, tags)
        self.node.submit_extrinsic(self.account, "file_bank.upload_filler",
                                   tuple(hashes), tee.controller, sig)

    def _keep_fillers(self, hashes, blobs, tags) -> None:
        for h, blob, tag in zip(hashes, blobs, tags):
            self.filler_store[h] = blob
            self.filler_tags[h] = tag

    def commit_filler_seed(self, secret: bytes) -> None:
        """Submit the one-time seed commitment; it must be in a block
        before the TEE certifies against it."""
        self.node.submit_extrinsic(self.account,
                                   "sminer.commit_filler_seed",
                                   filler_seed_commitment(secret))

    def setup_fillers_pois(self, tee: "TeeAgent", count: int,
                           secret: bytes,
                           work: int = SLOW_FILLER_WORK) -> None:
        """Secret-seeded fillers: the TEE derives and certifies them
        against the on-chain commitment, then the batch is registered."""
        hashes, tags, sig, blobs = tee.certify_pois_fillers(
            self.account, secret, list(range(count)), work)
        self._keep_fillers(hashes, blobs, tags)
        self.node.submit_extrinsic(self.account, "file_bank.upload_filler",
                                   tuple(hashes), tee.controller, sig)

    # -- deal servicing -----------------------------------------------------
    def _fetch(self, frag_hash: bytes) -> bool:
        for gw in self.gateways:
            blob = self._transfer(gw, frag_hash)
            if blob is not None:
                self.store[frag_hash] = blob
                self.tags[frag_hash] = gw.tag_store[frag_hash]
                return True
        return False

    def _transfer(self, gw: OssGateway, frag_hash: bytes) -> bytes | None:
        """One gateway transfer: seam ``offchain.fetch`` drops it,
        ``offchain.fetch_bytes`` corrupts the payload; the bytes must hash
        to the on-chain identity, and the policy retries. Returns the
        verified bytes or None."""
        attempts = 1 if self.retry is None else self.retry.max_attempts
        for attempt in range(1, attempts + 1):
            if attempt > 1:
                (self.clock or time).sleep(
                    self.retry.delay_for(attempt - 1, token=frag_hash))
            if not faults.allow("offchain.fetch"):
                continue             # transfer dropped: transient
            blob = gw.fragment_store.get(frag_hash)
            if blob is None:
                return None          # the gateway lacks it: not transient
            blob = faults.corrupt("offchain.fetch_bytes", blob)
            if fragment_hash(blob) == frag_hash:
                return blob
        return None

    def on_block(self, node) -> None:
        rt = node.runtime
        for (fh,), deal in list(rt.state.iter_prefix("file_bank", "deal")):
            if self.account not in deal.assigned or fh in self._reported \
                    or self.account in deal.complete:
                continue
            row = deal.assigned.index(self.account)
            with trace.span("offchain.transfer", sys="offchain",
                            miner=self.account, file=fh):
                done = all(self._fetch(seg.fragment_hashes[row])
                           for seg in deal.segments)
            if done:
                node.submit_extrinsic(self.account,
                                      "file_bank.transfer_report", fh)
                self._reported.add(fh)
                _flight.note("custody", "transfer", miner=self.account,
                             file=fh, row=row,
                             frags=tuple(seg.fragment_hashes[row]
                                         for seg in deal.segments))
        ch = rt.audit.challenge()
        if ch is not None and not ch.cleared \
                and rt.state.block <= ch.challenge_deadline \
                and ch.start != self._proved_round \
                and any(s.miner == self.account for s in ch.miners):
            self._submit_proof(node, ch)
            self._proved_round = ch.start

    def _submit_proof(self, node, ch) -> None:
        """The idle and service proofs over the owed sets frozen in the
        challenge snapshot, each one aggregated (mu, sigma) on the wire."""
        seed = b"".join(ch.net.randoms)
        snap = next(s for s in ch.miners if s.miner == self.account)
        limbs = self.pipeline.podr2_key.limbs
        with trace.span("offchain.prove", sys="offchain",
                        miner=self.account, round=ch.start,
                        service=len(snap.service_frags),
                        idle=len(snap.fillers)):
            service, idle = (codec.encode(Proof(*_prove(
                seed, list(owed), store, tags, limbs, self.engine,
                self.account, self.device)))
                for owed, store, tags in (
                    (snap.service_frags, self.store, self.tags),
                    (snap.fillers, self.filler_store, self.filler_tags)))
            node.submit_extrinsic(self.account, "audit.submit_proof",
                                  idle, service)

    # -- restoral servicing -------------------------------------------------
    def warm_restoral(self) -> None:
        """Prepare the repair of each lost row from the k lowest other
        rows, in the engine's program cache or on the codec ``try_repair``
        uses (``warm_restoral`` above)."""
        cfg = self.pipeline.config
        warm_restoral(cfg.k, cfg.m, cfg.fragment_size, engine=self.engine,
                      device=self.device)

    def repair_symbol(self, frag_hash: bytes, coeff: int,
                      acc: np.ndarray | None = None) -> np.ndarray | None:
        """Helper side of a regenerating repair: fold this miner's
        fragment into the travelling sum (``acc ^ coeff * fragment``) and
        return it, or None when this helper cannot serve (fragment not
        held, seam ``offchain.symbol``). The outgoing sum passes seam
        ``offchain.symbol_bytes``; the rebuilder checks its hash."""
        cfg = self.pipeline.config
        return repair_symbol(cfg.k, cfg.m, self.store.get(frag_hash), coeff,
                             acc, engine=self.engine, tenant=self.account,
                             device=self.device)

    def _repair_via_symbols(self, seg, row: int,
                            present: tuple[int, ...],
                            holders: dict[int, "MinerAgent"],
                            cfg: PipelineConfig) -> bytes | None:
        """Walk the repair-symbol chain through the holders; only the last
        fragment-sized sum reaches this miner. None when a hop refuses."""
        try:
            coeffs = regen.repair_coeffs(cfg.k, cfg.m, present, (row,))
        except ValueError:
            return None
        acc = None
        for j, coeff in zip(present, coeffs):
            acc = holders[j].repair_symbol(seg.fragment_hashes[j],
                                           int(coeff), acc)
            if acc is None:
                return None
        # the sum crossed the wire whether or not it hashes clean
        self.repair_ingress_bytes += acc.nbytes
        return acc.tobytes()

    def _repair_via_fragments(self, seg, row: int,
                              present: tuple[int, ...],
                              holders: dict[int, "MinerAgent"],
                              cfg: PipelineConfig) -> bytes:
        """Whole-fragment repair: k survivor rows in, the lost row
        rebuilt on the engine's repair queue or the device's codec."""
        survivors = [holders[j].store[seg.fragment_hashes[j]]
                     for j in present]
        self.repair_ingress_bytes += sum(len(s) for s in survivors)
        return _rebuild(cfg.k, cfg.m, survivors, present, row, self.engine,
                        self.account, self.device)

    def try_repair(self, frag_hash: bytes, peers: list["MinerAgent"],
                   gateways: list[OssGateway] | None = None) -> bool:
        """Claim and repair a lost fragment from the peers' rows, then
        report completion. Under "symbols" a refused hop or an aggregate
        that fails its hash falls back to "fragments" (counted in
        ``repair_fallbacks`` and noted to the flight recorder). Either way
        the rebuilt bytes must hash to the on-chain identity before they
        are stored."""
        rt = self.node.runtime
        order = rt.file_bank.restoral_order(frag_hash)
        if order is None:
            return False
        f = rt.file_bank.file(order.file_hash)
        if f is None:
            return False
        seg = next(s for s in f.segments if frag_hash in s.fragment_hashes)
        row = seg.fragment_hashes.index(frag_hash)
        cfg = self.pipeline.config
        holders: dict[int, MinerAgent] = {}
        for j, h in enumerate(seg.fragment_hashes):
            if j == row:
                continue
            for peer in peers:
                if h in peer.store:
                    holders[j] = peer
                    break
            if len(holders) == cfg.k:
                break
        if len(holders) < cfg.k:
            return False
        present = tuple(holders)
        mode = self.repair_mode
        via_symbols = False
        ingress0 = self.repair_ingress_bytes
        with trace.span("offchain.repair", sys="offchain",
                        miner=self.account, row=row,
                        survivors=len(present), mode=mode):
            blob = None
            if mode == "symbols":
                blob = self._repair_via_symbols(seg, row, present,
                                                holders, cfg)
                if blob is not None and fragment_hash(blob) == frag_hash:
                    via_symbols = True
                else:
                    self.repair_fallbacks += 1
                    _flight.note("repair", "fallback",
                                 miner=self.account, row=row,
                                 reason="broken-chain" if blob is None
                                 else "bad-hash")
                    blob = None
            if blob is None:
                blob = self._repair_via_fragments(seg, row, present,
                                                  holders, cfg)
        if fragment_hash(blob) != frag_hash:
            return False
        self.store[frag_hash] = blob
        self.repair_recovered_bytes += len(blob)
        if via_symbols:
            self.repair_symbol_repairs += 1
        else:
            self.repair_whole_repairs += 1
        for peer in peers:
            if frag_hash in peer.tags:
                self.tags[frag_hash] = peer.tags[frag_hash]
                break
        else:
            for gw in (gateways or self.gateways):
                if frag_hash in gw.tag_store:
                    self.tags[frag_hash] = gw.tag_store[frag_hash]
                    break
        self.node.submit_extrinsic(self.account,
                                   "file_bank.claim_restoral_order",
                                   frag_hash)
        self.node.submit_extrinsic(self.account,
                                   "file_bank.restoral_order_complete",
                                   frag_hash)
        _flight.note("custody", "repair", miner=self.account,
                     frag=frag_hash,
                     mode="symbols" if via_symbols else "fragments",
                     ingress=self.repair_ingress_bytes - ingress0)
        return True


class TeeAgent:
    """Holds the PoDR2 secret; certifies fillers and verifies the queued
    proofs on the key's device (or the engine's verify queue, whose audit
    key must be this key). ``bls_seed``: the BLS master key every verdict
    is sealed with, registered on chain with its proof of possession."""

    def __init__(self, node, controller: str, key: podr2.Podr2Key,
                 blocks_per_fragment: int, bls_seed: bytes | None = None,
                 engine=None):
        from ..crypto import bls12381

        self.node = node
        self.controller = controller
        self.key = key
        self.blocks = blocks_per_fragment
        self.engine = engine
        if engine is not None and engine.audit is not None \
                and not podr2.keys_equal(engine.audit.key, key):
            raise ValueError("engine AuditBackend key is not this "
                             "TEE's PoDR2 key")
        self.account_key = node.spec.account_key(controller)
        self._submitted: set[tuple[str, int]] = set()
        if bls_seed is not None:
            self.bls_sk, self.bls_pk = bls12381.keygen(bls_seed)
        else:
            self.bls_sk, self.bls_pk = None, b""

    @property
    def device(self) -> torch.device:
        return self.key.alpha.device

    def bls_registration(self) -> tuple[bytes, bytes]:
        """(bls_pk, proof-of-possession) for tee_worker.register."""
        from ..crypto import bls12381

        if self.bls_sk is None:
            return b"", b""
        return self.bls_pk, bls12381.prove_possession(self.bls_sk,
                                                      self.bls_pk)

    # -- filler certification -----------------------------------------------
    def certify_fillers(self, miner: str, indices: list[int],
                        blobs: list[bytes]):
        """Check each blob is the canonical filler of (miner, index), tag
        it, and sign the hash batch bound to the miner's on-chain cert
        nonce (what ``file_bank.upload_filler`` verifies)."""
        hashes, tags = certify_fillers(self.key, miner, indices, blobs,
                                       self.blocks, device=self.device)
        return hashes, tags, self._sign(miner, hashes)

    def certify_pois_fillers(self, miner: str, secret: bytes,
                             indices: list[int],
                             work: int = SLOW_FILLER_WORK):
        """The secret-seeded variant: the seed must match the miner's
        on-chain commitment; the TEE derives, tags and signs the content.
        Returns (hashes, tags, sig, blobs)."""
        commitment = self.node.runtime.sminer.filler_seed_commitment_of(
            miner)
        if commitment is None \
                or filler_seed_commitment(secret) != commitment:
            raise ValueError("filler seed does not match the miner's "
                             "on-chain commitment")
        if len(set(indices)) != len(indices):
            raise ValueError("duplicate filler indices")
        expected_size = self.blocks * podr2.BLOCK_BYTES
        blobs = [slow_filler_bytes(secret, i, expected_size, work)
                 for i in indices]
        hashes, tags = _tag_blobs(self.key, blobs, self.device)
        return hashes, tags, self._sign(miner, hashes), blobs

    def _sign(self, miner: str, hashes: list[bytes]) -> bytes:
        from ..chain.file_bank import FileBank

        nonce = self.node.runtime.file_bank.filler_cert_nonce(miner)
        return self.account_key.sign(
            FileBank.FILLER_CERT_CONTEXT
            + codec.encode((miner, tuple(hashes), nonce)))

    # -- proof verification -------------------------------------------------
    def on_block(self, node) -> None:
        from ..chain import audit as audit_mod
        from ..crypto import bls12381

        rt = node.runtime
        missions = rt.state.get("audit", "unverify", self.controller,
                                default=())
        ch = rt.audit.challenge()
        if not missions or ch is None:
            return
        seed = b"".join(ch.net.randoms)
        idx, nu = HostPodr2(self.device).gen_challenge(seed, self.blocks)
        for mission in missions:
            if (mission.miner, ch.start) in self._submitted:
                continue  # result already queued, not yet applied
            snap = mission.snapshot   # owed sets frozen at round start
            with trace.span("offchain.verify", sys="offchain",
                            tee=self.controller, miner=mission.miner,
                            round=ch.start) as vspan:
                service_ok = self._verify(mission.service_proof,
                                          list(snap.service_frags), seed,
                                          idx, nu)
                idle_ok = self._verify(mission.idle_proof,
                                       list(snap.fillers), seed, idx, nu)
                vspan.set(service_ok=service_ok, idle_ok=idle_ok)
                self._submitted.add((mission.miner, ch.start))
                bls_sig = b""
                if self.bls_sk is not None:
                    bls_sig = bls12381.sign(
                        self.bls_sk, audit_mod.verdict_message(
                            self.controller,
                            audit_mod.mission_digest(mission),
                            idle_ok, service_ok))
                node.submit_extrinsic(self.controller,
                                      "audit.submit_verify_result",
                                      mission.miner, idle_ok, service_ok,
                                      bls_sig)
                _flight.note("custody", "verdict", miner=mission.miner,
                             round=ch.start, service=service_ok,
                             idle=idle_ok, frags=snap.service_frags)

    def _verify(self, blob, owed: list[bytes], seed: bytes,
                idx, nu) -> bool:
        """Decode the untrusted proof bytes and check them against the
        owed set; malformed bytes are a failed audit, never an
        exception."""
        try:
            proof = codec.decode(blob)
        except (codec.CodecError, TypeError, ValueError):
            return False
        if not isinstance(proof, Proof):
            return False
        # getattr: a partial TeeAgent (built with __new__) has no engine
        return _verify(self.key, self.blocks, seed, owed, proof.mu,
                       proof.sigma, idx, nu, getattr(self, "engine", None),
                       self.controller, self.device)


class ValidatorOcw:
    """The audit offchain worker: proposes the challenge snapshot signed
    with the validator's session key, and mines the unsigned election
    solution in its window."""

    def __init__(self, account: str, session_key):
        self.account = account
        self.session_key = session_key
        self._proposed_at: int = -1
        self._mined_era: int = -1

    def on_block(self, node) -> None:
        self._maybe_propose_challenge(node)
        self._maybe_mine_election(node)

    def _maybe_propose_challenge(self, node) -> None:
        from ..chain.audit import SESSION_SIGNING_CONTEXT, Audit

        rt = node.runtime
        if self.account not in rt.audit.keys():
            return
        if rt.audit.challenge() is not None:
            return
        if rt.state.block == self._proposed_at:
            return
        net, miners = rt.audit.generation_challenge()
        if not miners:
            return
        digest = Audit.snapshot_digest(net, miners)
        sig = self.session_key.sign(SESSION_SIGNING_CONTEXT + digest)
        node.submit_extrinsic(self.account, "audit.save_challenge_info",
                              net, miners, sig)
        self._proposed_at = rt.state.block

    def _maybe_mine_election(self, node) -> None:
        """Mine a solution over the stake-bounded snapshot admission
        verifies against, and submit it feeless with the session
        signature and its exact score."""
        from ..chain.election import score_of
        from ..chain.state import DispatchError
        from .consensus import elect_validators

        rt = node.runtime
        el = rt.election
        era = rt.state.block // el.era_blocks
        if not el.in_unsigned_phase() or era == self._mined_era:
            return
        if self.account not in rt.staking.validators():
            return
        stakes = el._candidates()
        credits = rt.credit.credits()
        maxv = el.max_validators or rt.config.max_validators
        solution = elect_validators(stakes, credits, maxv)
        if not solution:
            return
        score = score_of(solution, stakes, credits)
        queued = rt.state.get("election", "best_unsigned", default=None)
        if queued is not None and queued[2] >= score:
            self._mined_era = era       # someone already queued as good
            return
        sig = self.session_key.sign(
            el.unsigned_payload(tuple(solution), score, self.account))
        try:
            node.submit_extrinsic(self.account,
                                  "election.submit_unsigned",
                                  tuple(solution), score, sig)
        except DispatchError:
            pass   # raced by a peer's equal solution: fine
        self._mined_era = era
