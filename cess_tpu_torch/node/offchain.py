"""The device half of the off-chain agents: gateway upload, miner proof
and repair, TEE filler tags and proof checks, on the port's device.

The counterpart of what ``cess_tpu/node/offchain.py`` computes on the
device, and of its proof wire format (``Proof``, ``proof_wire_bytes``,
``build_proof``: the bytes a miner submits to ``chain.audit``). The
agents' classes (``OssGateway``, ``MinerAgent``, ``TeeAgent``,
``ValidatorOcw``) are not ported: they need a node. These functions take
and return host arrays and bytes, so an agent on either side of that
boundary can call them.

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
  port engine (``serve.SubmissionEngine``) and ``tenant=``.

Every entry point runs on the card unless given ``device="cpu"``. The
steps open the TPU package's spans (``offchain.upload``, ``.prove``,
``.verify``, ``.repair``) on ``obs.trace``, and ``repair_symbol`` carries
its fault seams ``offchain.symbol`` (drop) and ``offchain.symbol_bytes``
(corrupt) on ``resilience.faults``; both are no-ops unless armed.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import codec
from .._device import resolve_device
from ..models.pipeline import PipelineConfig, StoragePipeline
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
                 tenant: str | None = None) -> Upload:
    """The device half of ``OssGateway.upload``: ``data`` (bytes or a
    uint8 array) zero-padded into segments, encoded, every fragment
    hashed into its identity and id, and tagged from the fragments the
    encode left on the device (they are fetched to the host once and
    never uploaded again)."""
    cfg = pipeline.config
    buf = np.frombuffer(data, dtype=np.uint8)
    size = buf.size
    pad = (-size) % cfg.segment_size
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    segments = buf.reshape(-1, cfg.segment_size)
    rows = cfg.k + cfg.m
    with trace.span("offchain.upload", sys="offchain",
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
    held = [h for h in owed if h in store]
    if limbs is None:
        limbs = np.asarray(next(iter(tags.values()))).shape[-1] if tags \
            else podr2.LIMBS
    with trace.span("offchain.prove", sys="offchain", owed=len(owed),
                    held=len(held)):
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
        stacked = np.stack([np.frombuffer(s, dtype=np.uint8)
                            for s in survivors])
        if engine is not None and engine.codec is not None:
            rec = engine.reconstruct(stacked, present, (row,),
                                     tenant=tenant)
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
