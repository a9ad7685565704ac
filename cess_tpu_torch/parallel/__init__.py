"""Multi-device scale-out: the mesh and the sharded data-plane steps.

The port's counterpart of ``cess_tpu/parallel``. ``mesh.py``: a
``(seg, byte)`` grid of devices (a device may be listed more than once)
and the sharded pipeline and stream steps, whose results stay on their
shards' devices as ``ShardedTensor``s; ``multihost.py``: the same over
several processes through ``torch.distributed``, and corpus runs in
which each process feeds only its own slice.
"""
from .mesh import (Mesh, ShardedTensor, make_mesh, pool_stream_entry,
                   sharded_pipeline_step, sharded_stream_step, stream_entry)
from .multihost import CorpusPlan, global_mesh, init_multihost, run_corpus

__all__ = [
    "CorpusPlan",
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
