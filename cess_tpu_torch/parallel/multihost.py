"""Multi-host data plane: ``torch.distributed`` + a global mesh + corpus runs.

The counterpart of ``cess_tpu/parallel/multihost.py`` (BASELINE.json
config 5: a 1 TiB corpus across hosts):

- ``init_multihost``: one ``torch.distributed.init_process_group`` per
  host process, with the TPU package's bootstrap contract: the
  arguments, else ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
  ``JAX_PROCESS_ID`` (plain strings, so one launcher serves both
  packages); ``gloo`` on the CPU, ``nccl`` on the card;
- ``global_mesh``: the ``(seg, byte)`` mesh of ``parallel/mesh.py`` over
  every process's devices in process-major order, as ``jax.devices()``
  orders them. Each process computes only its own entries. A seg row
  whose byte entries span processes reduces its proof partials by
  ``all_reduce`` on a process group of the row's owners (built once,
  with the mesh); a row inside one process reduces in-process;
- ``run_corpus``: streams a corpus through the sharded step in global
  batches; each process feeds only its local slice (``mesh.shard`` with
  an origin, the counterpart of ``make_array_from_process_local_data``),
  so no process holds a whole batch.

Exercised in one process (``tests/test_torch_mesh.py``) and as two OS
processes on ``gloo`` (``tests/test_torch_multiproc.py``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator

import numpy as np
import torch

from .._device import resolve_device
from ..models.pipeline import StoragePipeline
from . import mesh as _mesh


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if _initialized() else 0


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> int:
    """Join the process group; returns the process count.

    A no-op returning 1 when nothing is configured (no address argument
    and no ``JAX_COORDINATOR_ADDRESS``). The address is ``host:port``
    (a ``tcp://`` rendezvous) or any ``init_method`` URL such as
    ``file:///path``. The backend is ``nccl`` where a card is present
    and ``gloo`` on a host without one."""
    coordinator_address = coordinator_address \
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return 1
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    _dist().init_process_group(backend, init_method=url,
                               world_size=num_processes, rank=process_id)
    return num_processes


def global_mesh(seg: int | None = None, byte: int = 1,
                devices=None) -> _mesh.Mesh:
    """The ``(seg, byte)`` mesh over every process's devices.

    ``devices``: this process's devices (default: every CUDA device;
    raises without a card). Every process calls this with the same
    ``seg`` and ``byte``; entries are process-major (all of process 0's,
    then process 1's, ...), and each process's ``devices`` are known
    only to it. Process groups for the seg rows that span processes are
    made here, by every process in the same order."""
    local = _mesh.cuda_devices() if devices is None \
        else [resolve_device(d) for d in devices]
    if not _initialized():
        return _mesh.make_mesh(local, seg=seg, byte=byte)
    dist = _dist()
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(local))
    n = sum(counts)
    if seg is None:
        seg = n // byte
    if seg < 1 or byte < 1 or seg * byte != n:
        raise ValueError(f"mesh {seg}x{byte} != {n} devices")
    rank = dist.get_rank()
    grid = np.empty((seg, byte), dtype=object)
    owners = np.empty((seg, byte), dtype=np.int64)
    k = 0
    for p, c in enumerate(counts):
        for d in range(c):
            grid[k // byte, k % byte] = local[d] if p == rank else None
            owners[k // byte, k % byte] = p
            k += 1
    groups = []
    for i in range(seg):
        ranks = sorted(set(owners[i].tolist()))
        group = dist.new_group(ranks) if len(ranks) > 1 else None
        groups.append(group if rank in ranks else None)
    return _mesh.Mesh(grid, owners, rank, groups)


@dataclasses.dataclass(frozen=True)
class CorpusPlan:
    """How a corpus streams through the mesh: global batches of
    ``batch_segments`` segments, each process contributing its local
    slice of the seg axis."""

    total_bytes: int
    segment_size: int
    batch_segments: int

    @property
    def total_segments(self) -> int:
        return -(-self.total_bytes // self.segment_size)

    @property
    def num_batches(self) -> int:
        return -(-self.total_segments // self.batch_segments)


def _sum_processes(value: torch.Tensor) -> int:
    """An integer summed over every process (``all_reduce``; on ``nccl``
    the tensor lies on a card)."""
    if _initialized():
        _dist().all_reduce(value)
    return int(value.item())


def run_corpus(pipeline: StoragePipeline, mesh: _mesh.Mesh, plan: CorpusPlan,
               local_batch_fn: Callable[[int, int], np.ndarray],
               challenge_seed: bytes = b"corpus-round") -> Iterator[dict]:
    """Stream ``plan`` through ``mesh.sharded_pipeline_step`` (encode, tag,
    prove, verify) in global batches.

    ``local_batch_fn(batch_index, local_segments)`` returns THIS
    process's [local_segments, k, fragment_size] uint8 slice (numpy or a
    tensor): process p owns the fixed slots ``[p * local_segs, (p + 1) *
    local_segs)`` of every global batch, the real segments filling a
    prefix. Every seg row of the mesh must lie inside one process, each
    holding ``seg / processes`` rows: its slots.

    Yields one summary dict a batch (``batch``, ``segments``,
    ``verified``, ``expected``), never the bulk data. The final batch may
    be partial: it is padded to the batch shape and the padded segments
    are masked out of the verified count, which is summed over every
    process."""
    from ..ops import podr2

    cfg = pipeline.config
    step = _mesh.sharded_pipeline_step(pipeline, mesh)
    idx, nu = podr2.gen_challenge(challenge_seed, cfg.blocks_per_fragment,
                                  device="cpu")
    seg_shards = mesh.shape["seg"]
    procs = process_count()
    if plan.batch_segments % seg_shards or plan.batch_segments % procs:
        raise ValueError(
            f"batch_segments {plan.batch_segments} must divide by both "
            f"the seg axis ({seg_shards}) and process count ({procs})")
    pid = process_index()
    rows_each = seg_shards // procs
    for i in range(seg_shards):
        if not rows_each or set(mesh.owners[i].tolist()) != {i // rows_each}:
            raise ValueError("run_corpus needs each process to hold whole "
                             "seg rows, seg / processes of them in order")
    frag_bytes = cfg.fragment_size
    local_segs = plan.batch_segments // procs
    per_row = plan.batch_segments // seg_shards
    rows = cfg.k + cfg.m
    start = pid * local_segs
    done = 0
    for b in range(plan.num_batches):
        want = min(plan.batch_segments, plan.total_segments - done)
        local_want = min(local_segs, max(0, want - start))
        local = torch.as_tensor(local_batch_fn(b, local_want)) if local_want \
            else torch.zeros((0, cfg.k, frag_bytes), dtype=torch.uint8)
        if tuple(local.shape) != (local_want, cfg.k, frag_bytes):
            raise ValueError(f"host batch shape {tuple(local.shape)}, not "
                             f"{(local_want, cfg.k, frag_bytes)}")
        pad = local_segs - local_want
        if pad:
            # the final batch may be partial: pad it to the batch shape
            local = torch.cat([local, local.new_zeros((pad, cfg.k,
                                                       frag_bytes))])
        weights = torch.cat([torch.ones(local_want, dtype=torch.int64),
                             torch.zeros(pad, dtype=torch.int64)])
        # the ids of the TPU package's formula: tags depend on them
        ids = (np.arange(local_segs * rows, dtype=np.int64)
               .reshape(local_segs, rows)
               + (b * procs + pid) * plan.batch_segments * rows)
        shape = (plan.batch_segments, cfg.k, frag_bytes)
        data = _mesh.shard(local, mesh, _mesh.DATA_SPEC, origin=start,
                           shape=shape)
        ids = _mesh.shard(ids, mesh, _mesh.ids_spec(False), origin=start,
                          shape=(plan.batch_segments, rows))
        _, _, ok = step(data, ids, idx, nu)
        count = None
        for (i, _), (_, verdict) in ok.pieces.items():
            w = weights[i * per_row - start:(i + 1) * per_row - start]
            part = (verdict.to(torch.int64)
                    * w.to(verdict.device)[:, None]).sum()
            count = part if count is None else count + part.to(count.device)
        done += want
        yield {
            "batch": b,
            "segments": want,
            "verified": _sum_processes(count),
            "expected": want * rows,
        }
