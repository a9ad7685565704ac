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
engine's latency histograms; the detector and control planes);
``codec``, ``crypto`` and ``chain`` (the chain's runtime, host code);
``node`` (the node: chain spec, blocks, finality, block store, RPC, TCP
gossip, the CLI, and the off-chain agents with their device steps);
``convert`` (keys from the TPU package's arrays); ``kat`` (the
known-answer digest); ``_build``. The host layers import without torch:
the torch-backed exports below resolve on first use.
"""
import importlib

# torch-backed exports resolve on first use, so the host layers (``chain``,
# ``crypto``, ``codec``, ``node`` without its agents) import without torch
_LAZY = {
    **{name: ".parallel" for name in (
        "CorpusPlan", "Mesh", "ShardedTensor", "global_mesh",
        "init_multihost", "make_mesh", "pool_stream_entry", "run_corpus",
        "sharded_pipeline_step", "sharded_stream_step", "stream_entry")},
    "DeviceLane": ".serve.pool",
    "DevicePool": ".serve.pool",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    globals()[name] = value
    return value
