"""Device mesh and the sharded storage-pipeline steps.

The counterpart of ``cess_tpu/parallel/mesh.py``. Axes:

- ``seg``: the segment batch axis (data parallel);
- ``byte``: the axis along each fragment's bytes and PoDR2 blocks. GF
  columns are independent, so encode shards cleanly; the proof
  aggregation (mu, sigma) reduces over this axis with
  ``ops.pfield.psum_mod``.

Where the TPU package runs one ``shard_map`` program, the port runs each
``(seg, byte)`` shard's work on that shard's device from one host
thread: the kernels launch asynchronously, so shards on different cards
run at the same time, and each shard reads the pipeline's parity tables,
XOR op list and key from a copy staged on its own device (made once,
kept by the step). Results stay where they were computed, in a
:class:`ShardedTensor`: the counterpart of a sharded ``jax.Array``.
``.gather()`` (or ``np.asarray``) assembles the global tensor on one
device; nothing in this module does so.

Topology invariance, the protocol contract: fragments, tags, proofs and
verdicts are bit-identical on every mesh shape. The TPU package computes
the PRF over the whole block range on every shard and slices out the
shard's range; here each shard evaluates it at its own block indices
``[off, off + blocks_local)``, passed to ``prf_blocks`` explicitly. The
two agree because the PRF is pointwise in the block index: f_k(id, b)
depends on id and b alone.

A mesh may list a device more than once. torch has one CPU device, so
``make_mesh(["cpu"] * 8, seg=4, byte=2)`` is the counterpart of the TPU
package's tests on 8 virtual CPU devices, and a card listed n times runs
the sharded code on one card.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..models.pipeline import StoragePipeline
from ..ops import pfield as pf
from ..ops import podr2

DATA_SPEC = ("seg", None, "byte")   # [B, k, n] segments (fragment-major)


def ids_spec(pair_ids: bool) -> tuple:
    """[B, k+m] scalar ids or [B, k+m, 2] id word pairs, by seg rows."""
    return ("seg", None, None) if pair_ids else ("seg", None)


def cuda_devices() -> list[torch.device]:
    """Every CUDA device, in index order; raises without a card (the port
    never falls back to the CPU: pass ``["cpu"] * n`` for that)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device present; pass devices=['cpu'] * n "
                           "to run on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_devices(devices=None) -> list[torch.device]:
    """``devices`` as a list of ``torch.device`` (None: ``cuda_devices()``);
    ValueError when it is empty."""
    if devices is None:
        devices = cuda_devices()
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("at least one device is needed")
    return devices


class Mesh:
    """A ``(seg, byte)`` grid of devices.

    ``devices[i, j]`` is a ``torch.device``, or None where the entry
    belongs to another process (``parallel/multihost.py``);
    ``owners[i, j]`` is the rank of the process that holds it and
    ``rank`` this process's. ``groups[i]`` is the process group of seg row
    i when its byte entries span processes, else None (the row reduces
    inside one process)."""

    def __init__(self, devices: np.ndarray, owners: np.ndarray | None = None,
                 rank: int = 0, groups: tuple | None = None):
        self.devices = devices
        self.owners = np.zeros(devices.shape, dtype=np.int64) \
            if owners is None else owners
        self.rank = rank
        self.groups = (None,) * devices.shape[0] if groups is None \
            else tuple(groups)

    @property
    def shape(self) -> dict[str, int]:
        return {"seg": self.devices.shape[0], "byte": self.devices.shape[1]}

    @property
    def complete(self) -> bool:
        """Whether every entry lies in this process."""
        return bool((self.owners == self.rank).all())

    def local_entries(self) -> list[tuple[int, int]]:
        """This process's entries, row by row."""
        seg, byte = self.devices.shape
        return [(i, j) for i in range(seg) for j in range(byte)
                if self.owners[i, j] == self.rank]

    def slices(self, spec: tuple, shape, i: int, j: int) -> tuple:
        """The slices of a global tensor of ``shape``, laid out by
        ``spec`` (an axis name or None for each dimension), that entry
        (i, j) holds."""
        out = []
        for dim, axis in zip(shape, spec):
            if axis is None:
                out.append(slice(0, dim))
                continue
            parts = self.shape[axis]
            if dim % parts:
                raise ValueError(f"dimension {dim} not divisible by the "
                                 f"{axis} axis ({parts})")
            step = dim // parts
            at = i if axis == "seg" else j
            out.append(slice(at * step, (at + 1) * step))
        return tuple(out)


def make_mesh(devices=None, seg: int | None = None, byte: int = 1) -> Mesh:
    """A ``(seg, byte)`` mesh over ``devices`` (default: every CUDA device
    in index order; raises without a card). Entries may repeat."""
    devices = cuda_devices() if devices is None \
        else [resolve_device(d) for d in devices]
    n = len(devices)
    if seg is None:
        seg = n // byte
    if seg < 1 or byte < 1 or seg * byte != n:
        raise ValueError(f"mesh {seg}x{byte} != {n} devices")
    grid = np.empty((seg, byte), dtype=object)
    for k, d in enumerate(devices):
        grid[k // byte, k % byte] = d
    return Mesh(grid)


class ShardedTensor:
    """A global tensor held as pieces on their mesh entries' devices.

    ``pieces`` maps a mesh entry (i, j) to ``(slices, tensor)``: the
    piece's place in the global tensor and the piece itself. A tensor
    replicated along the byte axis (ids) has a piece for every entry of a
    row; a per-row result (``ok``) one, on the row's first entry.
    ``complete`` is false when some pieces lie in other processes: then
    only ``pieces`` can be read."""

    def __init__(self, shape, pieces: dict, complete: bool = True):
        self.shape = torch.Size(shape)
        self.pieces = pieces
        self.complete = complete

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first piece's)."""
        if not self.complete:
            raise ValueError("some pieces of this tensor lie in other "
                             "processes; read the local ones in .pieces")
        first = next(iter(self.pieces.values()))[1]
        dev = first.device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=first.dtype, device=dev)
        for sl, t in self.pieces.values():
            out[sl].copy_(t)
        return out

    def numpy(self) -> np.ndarray:
        return self.gather("cpu").numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __getitem__(self, key) -> "ShardedTensor":
        """A slice of the leading axis (the stream trims its ragged
        tail so), its pieces cut where they lie."""
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError("a ShardedTensor takes one slice of its "
                            "leading axis")
        start, stop, _ = key.indices(self.shape[0])
        stop = max(start, stop)
        pieces = {}
        for e, (sl, t) in self.pieces.items():
            lo, hi = max(sl[0].start, start), min(sl[0].stop, stop)
            if lo < hi:
                pieces[e] = ((slice(lo - start, hi - start),) + sl[1:],
                             t[lo - sl[0].start:hi - sl[0].start])
        return ShardedTensor((stop - start,) + tuple(self.shape[1:]), pieces,
                             self.complete)

    def record(self) -> list:
        """A CUDA event on the current stream of each card holding a
        piece: the pieces are complete once every event has fired."""
        events = []
        for dev in {t.device for _, t in self.pieces.values()}:
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                events.append(ev)
        return events


def _to(src: torch.Tensor, dev: torch.device, stream=None) -> torch.Tensor:
    """``src`` as a contiguous tensor on ``dev``. With a CUDA ``stream``
    the copy runs there and the device's current stream waits for it;
    the destination is allocated on that stream and marked as used by
    the current one, so the allocator hands it out again only after the
    current stream's work on it is done. A host source that is not
    pinned (the stream's ids) is pinned first: a pageable copy would
    block the host until the stream's earlier copies are done."""
    if src.device == dev:
        return src.contiguous()
    if stream is None or dev.type != "cuda":
        return src.to(dev, non_blocking=True).contiguous()
    if not src.is_pinned():
        src = src.pin_memory()
    current = torch.cuda.current_stream(dev)
    with torch.cuda.stream(stream):
        out = torch.empty(src.shape, dtype=src.dtype, device=dev)
        out.copy_(src, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stream)
    current.wait_event(copied)
    out.record_stream(current)
    return out


def shard(x, mesh: Mesh, spec: tuple, *, origin: int = 0, shape=None,
          streams=None) -> ShardedTensor:
    """Lay ``x`` out over ``mesh`` by ``spec``: each local entry gets a
    contiguous copy of its slices on its device (a piece already on the
    entry's device is only made contiguous).

    ``x`` is the global tensor, or (``shape`` given, the global shape)
    this process's block of it starting at row ``origin`` of the leading
    axis: the counterpart of ``jax.make_array_from_process_local_data``.
    ``streams``: an optional ``[seg, byte]`` grid of CUDA streams to copy
    on (a device pool's lane streams)."""
    if isinstance(x, np.ndarray) and x.dtype.kind == "u" \
            and x.dtype.itemsize > 1:
        x = x.astype(np.int64)              # uint32 id words as values
    x = torch.as_tensor(x)
    shape = tuple(x.shape) if shape is None else tuple(shape)
    pieces = {}
    for i, j in mesh.local_entries():
        sl = mesh.slices(spec, shape, i, j)
        lo = sl[0].start - origin
        if lo < 0 or sl[0].stop - origin > x.shape[0]:
            raise ValueError(f"mesh entry {(i, j)} needs rows {sl[0].start}:"
                             f"{sl[0].stop}, which this process's block "
                             f"(from row {origin}, {x.shape[0]} rows) does "
                             "not hold")
        src = x[(slice(lo, lo + sl[0].stop - sl[0].start),) + sl[1:]]
        pieces[(i, j)] = (sl, _to(src, mesh.devices[i, j],
                                  None if streams is None else streams[i][j]))
    return ShardedTensor(shape, pieces, mesh.complete)


class _Staged:
    """The pipeline's parity tables, XOR op list and PoDR2 key staged on
    each device a shard runs on, once (the pipeline's own on its
    device): a shard never reads them from another device."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self._by_dev: dict = {}

    def __call__(self, dev: torch.device):
        hit = self._by_dev.get(dev)
        if hit is None:
            p = self.pipeline
            ops = getattr(p, "parity_ops", None)
            hit = ((p.parity_tables.to(dev),
                    None if ops is None else ops.to(dev)),
                   p.podr2_key.to(dev))
            self._by_dev[dev] = hit
        return hit


def _pair_ids(piece: torch.Tensor) -> torch.Tensor:
    """A seg row's ids piece ([b, rows] or [b, rows, 2]) as [F, 2] words."""
    flat = piece.reshape(-1, 2) if piece.dim() == 3 else piece.reshape(-1)
    return podr2.fragment_id_pairs(flat, piece.device)


def _encode_tag(pipeline, mesh: Mesh, staged: _Staged, data: ShardedTensor,
                ids: ShardedTensor) -> tuple[ShardedTensor, ShardedTensor]:
    """Each local shard: parity of its columns by the pipeline's lowering,
    then the tags of its blocks with the PRF at its own block range."""
    cfg = pipeline.config
    rows = cfg.k + cfg.m
    b, _, n = data.shape
    blocks_local = cfg.blocks_per_fragment // mesh.shape["byte"]
    frags, tags = {}, {}
    for (i, j), (sl, seg) in data.pieces.items():
        lowering, key = staged(seg.device)
        shards = pipeline._encode(seg, lowering)            # [b, rows, n_loc]
        bl, _, n_loc = shards.shape
        t = podr2.tag_fragments(key, _pair_ids(ids.pieces[(i, j)][1]),
                                shards.reshape(bl * rows, n_loc),
                                first_block=j * blocks_local)
        frags[(i, j)] = ((sl[0], slice(0, rows), sl[2]), shards)
        tags[(i, j)] = ((sl[0], slice(0, rows),
                         slice(j * blocks_local, (j + 1) * blocks_local),
                         slice(0, key.limbs)),
                        t.reshape(bl, rows, blocks_local, key.limbs))
    limbs = pipeline.alpha.shape[1]
    return (ShardedTensor((b, rows, n), frags, data.complete),
            ShardedTensor((b, rows, cfg.blocks_per_fragment, limbs), tags,
                          data.complete))


def _audit(pipeline, mesh: Mesh, staged: _Staged, frags: ShardedTensor,
           tags: ShardedTensor, ids: ShardedTensor, idx, nu) -> ShardedTensor:
    """Prove and verify each fragment at the challenged blocks: each shard
    proves the challenged blocks in its range (the others weighted 0),
    the byte axis reduces the partials with ``psum_mod`` (in-process,
    then over the row's process group where it spans processes), and the
    row's first local device verifies (``podr2.verify_batch``)."""
    cfg = pipeline.config
    sectors = cfg.sectors
    blocks_total = cfg.blocks_per_fragment
    blocks_local = blocks_total // mesh.shape["byte"]
    idx = _tensor(idx).to(torch.int64)
    nu = _tensor(nu)
    rounds: dict = {}

    def on(dev):
        if dev not in rounds:
            rounds[dev] = (idx.to(dev), nu.to(dev))
        return rounds[dev]

    ok = {}
    b, rows = frags.shape[:2]
    for i in range(mesh.shape["seg"]):
        parts, first = [], None
        for j in range(mesh.shape["byte"]):
            if (i, j) not in frags.pieces:
                continue
            sl, fr = frags.pieces[(i, j)]
            tg = tags.pieces[(i, j)][1]
            first = first or (j, sl, fr.device)
            ix, nu_d = on(fr.device)
            off = j * blocks_local
            mine = (ix >= off) & (ix < off + blocks_local)
            local = (ix - off).clamp(0, blocks_local - 1)
            w = torch.where(mine, nu_d.to(torch.int64), 0)
            f = fr.shape[0] * rows
            mu, sigma = podr2.prove_batch(
                fr.reshape(f, -1), tg.reshape(f, blocks_local, -1), local, w,
                sectors)
            parts.append(torch.cat([mu, sigma], dim=1))
        if not parts:
            continue
        j0, sl, dev = first
        total = pf.psum_mod(parts, mesh.groups[i])          # [F, s + limbs]
        key = staged(dev)[1]
        ix, nu_d = on(dev)
        verdict = podr2.verify_batch(key, _pair_ids(ids.pieces[(i, j0)][1]),
                                     blocks_total, ix, nu_d, total[:, :sectors],
                                     total[:, sectors:])
        ok[(i, j0)] = ((sl[0], slice(0, rows)),
                       verdict.reshape(-1, rows))
    return ShardedTensor((b, rows), ok, frags.complete)


def _tensor(x) -> torch.Tensor:
    """A tensor as it lies; anything else copied into a host tensor."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def _ndim(x) -> int:
    return len(x.shape) if hasattr(x, "shape") else np.ndim(x)


def _blocks_local(pipeline, mesh: Mesh) -> int:
    blocks = pipeline.config.blocks_per_fragment
    if blocks % mesh.shape["byte"]:
        raise ValueError(f"{blocks} blocks not divisible by byte axis "
                         f"{mesh.shape['byte']}")
    return blocks // mesh.shape["byte"]


def sharded_pipeline_step(pipeline: StoragePipeline, mesh: Mesh):
    """The full pipeline step sharded over (seg, byte).

    Per step: RS-encode the segment batch, PoDR2-tag every fragment,
    build each fragment's proof (mu, sigma) at the challenged blocks
    with the partials reduced over the byte axis, and verify it.

    ``step(data, ids, idx, nu)``: data [B, k, n] uint8 (fragment-major;
    B % seg == 0, n % (byte * block bytes) == 0) and ids [B, k+m]
    scalar ids (or [B, k+m, 2] word pairs), each a host or device
    tensor (laid out by ``shard``) or a ``ShardedTensor`` already laid
    out (``DATA_SPEC``, ``ids_spec``); the challenge (idx [c], nu [c])
    from ``podr2.gen_challenge``, a fresh one a round. Returns
    ``ShardedTensor``s ``(fragments [B, k+m, n], tags [B, k+m, blocks,
    limbs], ok [B, k+m] bool)``.

    ``step.audit(fragments, tags, ids, idx, nu)`` is the prove and
    verify half on fragments and tags already laid out (a TEE's
    re-check of stored shards): it returns ``ok``."""
    _blocks_local(pipeline, mesh)
    staged = _Staged(pipeline)

    def place(x, spec):
        return x if isinstance(x, ShardedTensor) else shard(x, mesh, spec)

    def audit(fragments, tags, ids, idx, nu):
        ids = place(ids, ids_spec(_ndim(ids) == 3))
        return _audit(pipeline, mesh, staged, fragments, tags, ids, idx, nu)

    def step(data, ids, idx, nu):
        data = place(data, DATA_SPEC)
        ids = place(ids, ids_spec(_ndim(ids) == 3))
        frags, tags = _encode_tag(pipeline, mesh, staged, data, ids)
        return frags, tags, _audit(pipeline, mesh, staged, frags, tags, ids,
                                   idx, nu)

    step.audit = audit
    return step


def sharded_stream_step(pipeline: StoragePipeline, mesh: Mesh,
                        pair_ids: bool = False):
    """The fused encode + tag step (no prove or verify) over (seg, byte),
    the program behind :func:`stream_entry`: ``run(data, ids) ->
    {"fragments": [B, k+m, n], "tags": [B, k+m, blocks, limbs]}`` as
    ``ShardedTensor``s, the ``StoragePipeline.forward`` shape contract.
    data [B, k, n] uint8, ids [B, k+m] (or [B, k+m, 2] with
    ``pair_ids``), each a tensor or a ``ShardedTensor``. Tags are
    bit-identical to the single-device fused forward on every mesh
    shape (module doc)."""
    _blocks_local(pipeline, mesh)
    staged = _Staged(pipeline)

    def run(data, ids):
        if not isinstance(data, ShardedTensor):
            data = shard(data, mesh, DATA_SPEC)
        if not isinstance(ids, ShardedTensor):
            ids = shard(ids, mesh, ids_spec(pair_ids))
        frags, tags = _encode_tag(pipeline, mesh, staged, data, ids)
        return {"fragments": frags, "tags": tags}

    return run


def stream_entry(pipeline: StoragePipeline, mesh: Mesh, batch: int,
                 pair_ids: bool = False, streams=None) -> dict:
    """The ``(program, put, put_ids)`` kwargs that point a
    ``StreamingIngest`` (``serve/stream.py``) at a mesh::

        ing = StreamingIngest(pipe, batch, **stream_entry(pipe, mesh, batch))

    ``put`` views each staged [batch, segment_size] host chunk (pinned on
    the card) as fragment-major [batch, k, fragment_size] and copies each
    entry's slices to its device (on ``streams``, a ``[seg, byte]`` grid
    of CUDA streams, when given); ``put_ids`` lays the id batch out by
    seg rows. The ingest itself stays topology-agnostic."""
    cfg = pipeline.config
    rows = cfg.k + cfg.m
    program = sharded_stream_step(pipeline, mesh, pair_ids)

    def put(chunk):
        chunk = torch.as_tensor(chunk).reshape(batch, cfg.k,
                                               cfg.fragment_size)
        return shard(chunk, mesh, DATA_SPEC, streams=streams)

    def put_ids(ids):
        ids = torch.as_tensor(np.asarray(ids).astype(np.int64))
        if pair_ids and ids.numel() != batch * rows * 2:
            # the ingest's default ids are a flat scalar arange: there is
            # no pair-shaped default, so demand explicit ids here, at the
            # layer whose contract is violated
            raise ValueError(
                "stream_entry(pair_ids=True) requires explicit "
                "[N, k+m, 2] fragment_ids passed to run()/ingest()")
        ids = ids.reshape((batch, rows, 2) if pair_ids else (batch, rows))
        # on the copy streams too: a copy on the compute stream would
        # wait for the previous batch's kernels
        return shard(ids, mesh, ids_spec(pair_ids), streams=streams)

    return {"program": program, "put": put, "put_ids": put_ids}


def pool_stream_entry(pipeline: StoragePipeline, devices, batch: int,
                      pair_ids: bool = False, streams=None) -> dict:
    """:func:`stream_entry` over a ``DevicePool``'s lane devices
    (``serve/pool.py``): an ``(n_lanes, 1)`` mesh in lane order, so each
    staged batch fans its segment axis across every lane; ``streams``:
    the lanes' CUDA streams, one a lane. ``batch`` must be divisible by
    the lane count; the byte axis stays 1, which divides any block
    count."""
    devices = list(devices)
    if batch % len(devices) != 0:
        raise ValueError(
            f"stream batch {batch} not divisible by the pool's "
            f"{len(devices)} lanes")
    mesh = make_mesh(devices, seg=len(devices), byte=1)
    grid = None if streams is None else [[s] for s in streams]
    return stream_entry(pipeline, mesh, batch, pair_ids, streams=grid)
