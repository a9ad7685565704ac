"""The port's multi-process data plane (cess_tpu_torch.parallel.multihost),
modelled on tests/test_multiproc.py:

- a 16-entry mesh runs the sharded pipeline at (16, 1) and (8, 2),
  byte-equal to the JAX package's single-device forward (the port lists
  the CPU 16 times in one process: unlike JAX, nothing fixes a device
  count when the backend starts);
- TWO OS processes join a ``gloo`` process group through a ``file://``
  rendezvous (no TCP port: the suite runs on several workers at once)
  and stream a corpus, each feeding only its local slice;
- a mesh whose byte axis spans the two processes reduces the proof
  partials by ``all_reduce`` over the row's process group: each
  process's tags and every verdict, honest and with the byte shard of a
  challenged block tampered in one process (the other sees it only
  through the reduce), equal the one-process run.

Tolerance: none; every comparison is byte equality.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cess_tpu.models import pipeline as jpipeline
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu_torch.convert import pipeline_from_arrays
from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
from cess_tpu_torch.ops import podr2
from cess_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _spawn(script: str, *argv):
    return subprocess.Popen(
        [sys.executable, "-c", script, *map(str, argv)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO)


def _run_pair(script: str, tmp_path, *argv) -> list[str]:
    """Run ``script`` as processes 0 and 1 of one group; each process
    gets its own ``communicate`` timeout. Returns their outputs."""
    rdv = f"file://{tmp_path / 'rendezvous'}"
    procs = [_spawn(script, rdv, pid, tmp_path, *argv) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def test_sixteen_entry_mesh():
    jkey = jpodr2.Podr2Key.generate(0)
    frag = 8 * 512
    jcfg = jpipeline.PipelineConfig(k=4, m=8, segment_size=4 * frag)
    jpipe = jpipeline.StoragePipeline(jcfg, podr2_key=jkey)
    pipe = pipeline_from_arrays(4, 8, 4 * frag, jpodr2.SECTORS,
                                np.asarray(jkey.alpha),
                                np.asarray(jax.random.key_data(jkey.prf_key)),
                                device="cpu")
    b, rows = 16, 12
    data = np.random.default_rng(7).integers(
        0, 256, (b, 4, jcfg.fragment_size), dtype=np.uint8)
    ids = np.arange(b * rows, dtype=np.int32).reshape(b, rows)
    idx, nu = jpodr2.gen_challenge(b"sixteen-round", jcfg.blocks_per_fragment)
    ref = jpipe.forward(jnp.asarray(data.reshape(b, jcfg.segment_size)),
                        fragment_ids=jnp.asarray(ids))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for seg, byte in ((16, 1), (8, 2)):
            step = mesh.sharded_pipeline_step(
                pipe, mesh.make_mesh(["cpu"] * 16, seg=seg, byte=byte))
            shards, tags, ok = step(data, ids, np.asarray(idx),
                                    np.asarray(nu))
            assert np.asarray(ok).all(), (seg, byte)
            assert np.array_equal(np.asarray(shards),
                                  np.asarray(ref["fragments"]))
            assert np.array_equal(np.asarray(tags).astype(np.int64),
                                  np.asarray(ref["tags"]).astype(np.int64))
    finally:
        torch.set_num_threads(n)


TWO_PROC_CORPUS = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
from cess_tpu_torch.parallel import multihost

rdv, pid = sys.argv[1], int(sys.argv[2])
procs = multihost.init_multihost(rdv, 2, pid)
assert procs == 2 and multihost.process_count() == 2
mesh = multihost.global_mesh(seg=4, byte=2, devices=["cpu"] * 4)
assert mesh.shape == {"seg": 4, "byte": 2}
assert len(mesh.local_entries()) == 4 and not mesh.complete
assert all(g is None for g in mesh.groups)      # rows inside one process
pipe = StoragePipeline(PipelineConfig(k=2, m=1, segment_size=8192),
                       device="cpu")
# 9 segments in batches of 4: the padded partial final batch too
plan = multihost.CorpusPlan(total_bytes=9 * 8192, segment_size=8192,
                            batch_segments=4)
corpus = np.random.default_rng(11).integers(0, 256, (9, 2, 4096),
                                            dtype=np.uint8)

def local_batch(b, local_want):
    # each process ingests only its own slot of the global batch
    start = b * plan.batch_segments + pid * (plan.batch_segments // 2)
    return corpus[start:start + local_want]

results = list(multihost.run_corpus(pipe, mesh, plan, local_batch))
assert [r["segments"] for r in results] == [4, 4, 1], results
for r in results:
    assert r["verified"] == r["expected"], r
print("RESULTS " + __import__("json").dumps(results), flush=True)
"""


def test_two_process_gloo_corpus(tmp_path):
    outs = _run_pair(TWO_PROC_CORPUS, tmp_path)
    got = [json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("RESULTS "))[8:]) for out in outs]
    assert got[0] == got[1]
    assert [r["verified"] for r in got[0]] == [12, 12, 3]


BYTE_ACROSS = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
from cess_tpu_torch.ops import podr2
from cess_tpu_torch.parallel import mesh as pmesh, multihost

rdv, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
local, byte = int(sys.argv[4]), int(sys.argv[5])
multihost.init_multihost(rdv, 2, pid)
mesh = multihost.global_mesh(seg=1, byte=byte, devices=["cpu"] * local)
assert mesh.groups[0] is not None                # the row spans both
pipe = StoragePipeline(PipelineConfig(k=2, m=1, segment_size=2 * 4096),
                       device="cpu")
rng = np.random.default_rng(5)
data = rng.integers(0, 256, (2, 2, 4096), dtype=np.uint8)
ids = np.arange(6, dtype=np.int64).reshape(2, 3)
idx, nu = podr2.gen_challenge(b"across-round", 8, device="cpu")
step = pmesh.sharded_pipeline_step(pipe, mesh)
frags, tags, ok = step(data, ids, idx, nu)
saved = {"ok": next(iter(ok.pieces.values()))[1].numpy()}
for (i, j), (sl, t) in tags.pieces.items():
    saved[f"tags_{j}"] = t.numpy()
# tamper segment 1, fragment 2 in the byte shard of the challenged block
hit = (0, int(idx[0]) // (8 // byte))
if hit in frags.pieces:
    frags.pieces[hit][1][1, 2] ^= 0xA5
bad = step.audit(frags, tags, ids, idx, nu)
saved["bad"] = next(iter(bad.pieces.values()))[1].numpy()
np.savez(f"{out}/p{pid}.npz", **saved)
print("ACROSS-OK", flush=True)
"""


@pytest.mark.parametrize("local,byte", [(1, 2), (2, 4)])
def test_byte_axis_across_processes(tmp_path, local, byte):
    """(seg=1, byte=2): one entry a process; (seg=1, byte=4): two a
    process, summed in-process before the group's all_reduce."""
    _run_pair(BYTE_ACROSS, tmp_path, local, byte)
    pipe = StoragePipeline(PipelineConfig(k=2, m=1, segment_size=2 * 4096),
                           device="cpu")
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (2, 2, 4096), dtype=np.uint8)
    ids = np.arange(6, dtype=np.int64).reshape(2, 3)
    idx, nu = podr2.gen_challenge(b"across-round", 8, device="cpu")
    step = mesh.sharded_pipeline_step(
        pipe, mesh.make_mesh(["cpu"] * byte, seg=1, byte=byte))
    frags, tags, ok = step(data, ids, idx, nu)
    frags.pieces[(0, int(idx[0]) // (8 // byte))][1][1, 2] ^= 0xA5
    bad = np.asarray(step.audit(frags, tags, ids, idx, nu))
    whole = np.asarray(tags)
    per = 8 // byte
    assert np.asarray(ok).all() and not bad[1, 2] and bad.sum() == 5
    for pid in range(2):
        got = np.load(tmp_path / f"p{pid}.npz")
        assert np.array_equal(got["ok"], np.asarray(ok))
        assert np.array_equal(got["bad"], bad)
        for j in range(pid * local, (pid + 1) * local):
            assert np.array_equal(got[f"tags_{j}"],
                                  whole[:, :, j * per:(j + 1) * per])
