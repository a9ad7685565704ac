"""The storage pipeline: segments -> RS fragments -> PoDR2 tags.

The counterpart of ``cess_tpu/models/pipeline.py``: the data plane a
user's upload goes through. A batch of segments [B, segment_size] uint8
becomes fragments [B, k+m, fragment_size] (the k systematic row slices
of each segment, then m parity rows) and per-fragment tags [B, k+m,
blocks, limbs]. On the card that is three kernel launches: the parity
apply of ``PipelineConfig.strategy`` (systematic copy and parity in one
pass: ``gf_apply`` under the dense strategies, ``gf_xor`` under "xor",
either under "auto" by the cost model, see ``ops/rs.py``), ``prf_blocks``
(the per-block PRF) and ``podr2_tag``.

With a submission engine (``cess_tpu_torch/serve``, ``engine=``) the
steps submit through its batched queues instead, so concurrent callers
coalesce into shared device batches; results are the same bytes.
``fused_program`` is the direct encode + tag as one callable with no
host round trip, the program the streaming ingest
(``serve/stream.py``) runs per batch.

``encode_step``, ``tag_step`` and ``forward`` open the TPU package's
``pipeline.encode`` / ``pipeline.tag`` / ``pipeline.forward`` spans
(``obs/trace.py``; no-ops unless a tracer is armed) and take its
``tenant=`` tag, which rides into the engine's submits and is ignored
on the direct path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .. import constants
from .._device import resolve_device
from ..obs import trace
from ..ops import gf, podr2, rs_xor, xor_sched
from ..ops.rs import STRATEGIES, default_strategy, uses_xor
from ..ops.rs_kernel import gf_apply, tables


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    k: int = constants.REF_K
    m: int = constants.REF_M
    segment_size: int = constants.SEGMENT_SIZE
    strategy: str | None = None  # None: the dense kernel (rs.default_strategy)
    sectors: int = podr2.SECTORS  # PoDR2 block geometry

    @property
    def fragment_size(self) -> int:
        if self.segment_size % self.k:
            raise ValueError(f"segment {self.segment_size} B not divisible "
                             f"by k={self.k}")
        return self.segment_size // self.k

    @property
    def blocks_per_fragment(self) -> int:
        return podr2.Podr2Params(self.sectors).blocks_for(self.fragment_size)


class StoragePipeline(nn.Module):
    """Batched segment -> fragment encode and PoDR2 tag step.

    The parity tables and the key (alpha, PRF key words) are buffers, so
    ``.to(device)`` moves all of them; under "xor" and "auto" the parity
    matrix's XOR schedule is staged as the non-persistent buffer
    ``parity_ops``. The tag kernel's weights are derived from alpha
    whenever the key is read, so they cannot drift from it. Without
    ``podr2_key`` the key is ``Podr2Key.generate(0)``, the TPU package's
    default.

    ``engine``: an optional ``serve.SubmissionEngine``; ``encode_step``
    and ``tag_step`` (with id pairs) then submit through it. An engine
    whose codec geometry or audit key differs from the pipeline's is
    refused, at construction and when ``engine`` is set later: it would
    compute other bytes than the direct path."""

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 podr2_key: podr2.Podr2Key | None = None, engine=None, *,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        key = podr2_key if podr2_key is not None else podr2.Podr2Key.generate(
            0, podr2.Podr2Params(config.sectors), device=dev)
        if key.alpha.shape[0] != config.sectors:
            raise ValueError(f"key has {key.alpha.shape[0]} sectors, config "
                             f"{config.sectors}")
        key = key.to(dev)
        self.strategy = config.strategy or default_strategy(dev)
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        mat = gf.cauchy_parity_matrix(config.k, config.m)
        self.register_buffer("parity_tables", tables(mat, dev))
        self.parity_sched = None
        if self.strategy in ("xor", "auto"):
            self.parity_sched = xor_sched.compile_schedule(
                gf.expand_bitmatrix(mat))
            self.register_buffer("parity_ops", rs_xor.stage_ops(
                self.parity_sched, dev), persistent=False)
        self.register_buffer("alpha", key.alpha)
        self.register_buffer("prf_key", key.prf_key)
        self.engine = engine

    @property
    def engine(self):
        return self._engine

    @engine.setter
    def engine(self, engine) -> None:
        """Set (or clear, with None) the submission engine; refused when
        its codec geometry or audit key differs from the pipeline's."""
        cfg = self.config
        if engine is not None and engine.codec is not None \
                and (engine.codec.k, engine.codec.m) != (cfg.k, cfg.m):
            raise ValueError(
                f"engine codec RS({engine.codec.k},{engine.codec.m}) != "
                f"pipeline RS({cfg.k},{cfg.m})")
        if engine is not None and engine.audit is not None \
                and not podr2.keys_equal(engine.audit.key, self.podr2_key):
            raise ValueError("engine AuditBackend key differs from "
                             "the pipeline's PoDR2 key")
        self._engine = engine

    @property
    def podr2_key(self) -> podr2.Podr2Key:
        return podr2.Podr2Key(self.alpha, self.prf_key)

    @property
    def device(self) -> torch.device:
        return self.alpha.device

    def _data(self, segments) -> torch.Tensor:
        """Segments [B, segment_size] on the pipeline's device, viewed as
        [B, k, fragment_size] data rows."""
        cfg = self.config
        segments = torch.as_tensor(segments).to(self.device)
        if segments.dim() != 2 or segments.shape[1] != cfg.segment_size:
            raise ValueError(f"segments must be [B, {cfg.segment_size}], got "
                             f"{tuple(segments.shape)}")
        return segments.contiguous().view(segments.shape[0], cfg.k,
                                          cfg.fragment_size)

    def encode_step(self, segments: torch.Tensor,
                    tenant: str | None = None) -> torch.Tensor:
        """[B, segment_size] uint8 -> [B, k+m, fragment_size] uint8.
        ``tenant`` rides into the engine submit (per-tenant accounting);
        the direct path ignores it."""
        data = self._data(segments)
        with trace.span("pipeline.encode", sys="pipeline",
                        segments=data.shape[0]):
            if self.engine is not None and self.engine.codec is not None:
                # a device tensor in, a device tensor back: no host trip
                return torch.as_tensor(self.engine.encode(
                    data, tenant=tenant)).to(self.device)
            return self._encode(data)

    def _encode(self, data: torch.Tensor, staged=None) -> torch.Tensor:
        """[B, k, n] data rows -> [B, k+m, n] fragments on the data's
        device. ``staged``: the (parity tables, XOR op list) staged on
        that device when it is not the pipeline's (a mesh shard's
        columns, ``parallel/mesh.py``); n may be any column count."""
        cfg = self.config
        b, k, n = data.shape
        tabs, ops = staged or (self.parity_tables,
                               getattr(self, "parity_ops", None))
        out = torch.empty((b, k + cfg.m, n), dtype=torch.uint8,
                          device=data.device)
        if uses_xor(self.strategy, self.parity_sched, data.shape):
            rs_xor.gf_xor(self.parity_sched, ops, data, out=out[:, k:],
                          sys_out=out[:, :k])
        else:
            gf_apply(tabs, data, out=out[:, k:], sys_out=out[:, :k])
        return out

    def tag_step(self, fragments: torch.Tensor, fragment_ids=None,
                 tenant: str | None = None) -> torch.Tensor:
        """[B, k+m, fragment_size] -> tags [B, k+m, blocks, limbs] int32.

        fragment_ids: [B, k+m] scalar ids or [B, k+m, 2] hash word pairs
        (``podr2.fragment_id_from_hash``). The default ``arange(B*(k+m))``
        is for benches and demos only: ids must be unique per key. With
        an engine, id pairs are tagged through it; scalar ids (and the
        default) stay on the direct path, as in the TPU package.
        ``tenant`` as for ``encode_step``."""
        fragments = torch.as_tensor(fragments).to(self.device)
        b, rows, n = fragments.shape
        if fragment_ids is not None \
                and not isinstance(fragment_ids, (torch.Tensor, np.ndarray)):
            fragment_ids = np.asarray(fragment_ids)
        with trace.span("pipeline.tag", sys="pipeline", fragments=b * rows):
            if fragment_ids is not None and fragment_ids.ndim == 3 \
                    and self.engine is not None \
                    and self.engine.audit is not None:
                tags = torch.as_tensor(self.engine.tag_fragments(
                    fragment_ids.reshape(b * rows, 2),
                    fragments.reshape(b * rows, n),
                    tenant=tenant)).to(self.device)
                return tags.reshape(b, rows, *tags.shape[1:])
            return self._tag(fragments, fragment_ids)

    def _tag(self, fragments: torch.Tensor, fragment_ids) -> torch.Tensor:
        b, rows, n = fragments.shape
        if fragment_ids is None:
            fragment_ids = torch.arange(b * rows, dtype=torch.int64,
                                        device=self.device)
        elif not isinstance(fragment_ids, (torch.Tensor, np.ndarray)):
            fragment_ids = np.asarray(fragment_ids)
        ids = podr2.fragment_id_pairs(fragment_ids.reshape(
            (b * rows, 2) if fragment_ids.ndim == 3 else (b * rows,)),
            self.device)
        tags = podr2.tag_fragments(self.podr2_key, ids,
                                   fragments.reshape(b * rows, n))
        return tags.reshape(b, rows, *tags.shape[1:])

    def fused_program(self):
        """The direct encode + tag as one callable, ``(segments [B,
        segment_size] u8, fragment_ids [B*(k+m)] | [B, k+m] | [B, k+m,
        2]) -> {"fragments": [B, k+m, frag], "tags": [B, k+m, blocks,
        limbs]}``, run eagerly on the segments' device with no host round
        trip (never through an engine). The streaming ingest calls it
        once per batch."""
        return self._fused

    def _fused(self, segments, fragment_ids) -> dict[str, torch.Tensor]:
        shards = self._encode(self._data(segments))
        return {"fragments": shards, "tags": self._tag(shards, fragment_ids)}

    def forward(self, segments: torch.Tensor, fragment_ids=None,
                tenant: str | None = None) -> dict[str, torch.Tensor]:
        """Encode and tag: {"fragments": [B, k+m, frag] uint8, "tags":
        [B, k+m, blocks, limbs] int32}: through the engine when one is
        set (carrying ``tenant``), else the fused program."""
        with trace.span("pipeline.forward", sys="pipeline",
                        segments=len(segments)):
            if self.engine is not None:
                shards = self.encode_step(segments, tenant=tenant)
                return {"fragments": shards,
                        "tags": self.tag_step(shards, fragment_ids,
                                              tenant=tenant)}
            return self._fused(segments, fragment_ids)
