"""cess_tpu_torch: the storage data plane in PyTorch with CUDA kernels.

A port of ``cess_tpu``'s data plane (RS(k, m) encode and repair over
GF(2^8), PoDR2 tag generation, challenge, proof and verification over
M31) to PyTorch on an NVIDIA H100. Every result is bit-identical to the
TPU package on the same inputs; the TPU package's Pallas kernels become
hand-written CUDA kernels (``csrc/``), built with nvcc at first use.
This package imports neither jax nor ``cess_tpu``.

Layout: ``constants``; ``ops`` (``gf``, ``pfield``, ``prf``,
``rs_kernel`` + ``rs``, ``rs_xor`` + ``xor_sched``, ``rs_ref``,
``regen``, ``podr2_kernel`` + ``podr2``, ``audit_backend``);
``models.pipeline`` (``StoragePipeline``, with an optional engine and
its fused encode + tag program); ``parallel`` (``mesh``: the ``(seg,
byte)`` device mesh and the sharded pipeline and stream steps;
``multihost``: the same over processes through ``torch.distributed``, and
corpus runs); ``serve`` (the submission engine ``SubmissionEngine`` /
``make_engine``, its device pool ``DevicePool`` / ``DeviceLane`` and the
pinned-memory streaming ingest ``StreamingIngest``, with ``policy``,
``buckets`` and ``stats``);
``resilience`` (fault injection, retry, breakers, their counters);
``obs`` (``trace``, ``flight``, ``prom``: spans, the flight recorder, the
engine's latency histograms); ``node`` (``hashing``, ``offchain``: the
device half of the off-chain agents, host arrays in and out);
``convert`` (keys from the TPU package's arrays); ``kat`` (the
known-answer digest); ``_build``.
"""
from .parallel import (CorpusPlan, Mesh, ShardedTensor, global_mesh,
                       init_multihost, make_mesh, pool_stream_entry,
                       run_corpus, sharded_pipeline_step, sharded_stream_step,
                       stream_entry)
from .serve.pool import DeviceLane, DevicePool

__all__ = [
    "CorpusPlan",
    "DeviceLane",
    "DevicePool",
    "Mesh",
    "ShardedTensor",
    "global_mesh",
    "init_multihost",
    "make_mesh",
    "pool_stream_entry",
    "run_corpus",
    "sharded_pipeline_step",
    "sharded_stream_step",
    "stream_entry",
]
