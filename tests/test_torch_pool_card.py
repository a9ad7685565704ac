"""The port's multi-device planes on the card: a device pool and a mesh
that list the one card more than once.

Every test here needs a CUDA device and skips without one. Like
``test_torch_serve_card.py`` the file imports neither jax nor cess_tpu:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_pool_card.py

The CPU tests of the same code, against the JAX package, are
``test_torch_pool.py``, ``test_torch_mesh.py`` and
``test_torch_multiproc.py``.
"""
import numpy as np
import pytest
import torch

from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
from cess_tpu_torch.ops import podr2, podr2_kernel, rs, rs_kernel
from cess_tpu_torch.parallel import make_mesh, sharded_pipeline_step
from cess_tpu_torch.resilience import (FaultPlan, FaultSpec, HealthMonitor,
                                       ResilienceConfig, faults)
from cess_tpu_torch.serve import (AdmissionPolicy, DevicePool,
                                  EngineUnavailable, StreamingIngest,
                                  make_engine)

pytestmark = pytest.mark.gpu

SEG = 2 * 64 * 1024          # RS(2,1): fragments of 64 KiB, 128 blocks


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda", 0)
    faults.disarm()


def rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8))


def test_pool_lanes_on_one_card_match_the_direct_path(cuda_device):
    key = podr2.Podr2Key.generate(3, device=cuda_device)
    pool = DevicePool([cuda_device, cuda_device])
    eng = make_engine(2, 1, podr2_key=key, pool=pool,
                      policy=AdmissionPolicy(max_delay=0.001))
    codec = rs.TorchCodec(2, 1, cuda_device)
    try:
        streams = {lane.stream for lane in pool.lanes}
        assert len(streams) == 2
        assert torch.cuda.current_stream(cuda_device) not in streams
        before = rs_kernel.gf_apply.launches
        data = rand((4, 2, 8192), 1).to(cuda_device)
        host = rand((3, 2, 8192), 2).numpy()
        out = eng.encode(data, timeout=60)
        # lane 0 holding rows in flight: the next batch goes to lane 1
        with pool._cond:
            pool.lanes[0].inflight_rows += 100
        try:
            out_h = eng.encode(host, timeout=60)
        finally:
            with pool._cond:
                pool.lanes[0].inflight_rows -= 100
        assert rs_kernel.gf_apply.launches - before == 2
        assert [ln.batches for ln in pool.lanes] == [1, 1]
        assert out.is_cuda and torch.equal(out, codec.encode(data))
        assert isinstance(out_h, np.ndarray)
        assert np.array_equal(out_h, codec.encode(host).cpu().numpy())
        frags = out.reshape(12, -1)
        ids = torch.stack([torch.arange(12), torch.full((12,), 5)],
                          1).to(cuda_device)
        tags = eng.tag_fragments(ids, frags, timeout=60)
        assert torch.equal(tags, podr2.tag_fragments(key, ids, frags))
        eng.warm_repair([((1, 2), (0,))], 8192, buckets=(4,))
        rec = eng.reconstruct(out[:, 1:], (1, 2), (0,), timeout=60)
        assert torch.equal(rec, data[:, :1])
        assert pool.lanes[0].codec.warm_hits == 1
        assert pool.lanes[1].codec.warm_hits == eng.codec.warm_hits == 0
    finally:
        eng.close()


def test_pool_chaos_drill_on_the_card(cuda_device):
    """Lane 0's dispatches raise: its breaker trips and lane 1 absorbs
    every batch through requeue, nothing degrades to the CPU."""
    res = ResilienceConfig()
    eng = make_engine(2, 1, resilience=res,
                      pool=DevicePool([cuda_device, cuda_device]),
                      policy=AdmissionPolicy(max_delay=0.001))
    codec = rs.TorchCodec(2, 1, cuda_device)
    plan = FaultPlan.seeded(b"card-drill",
                            {"engine.dispatch.d0": (1.0, "raise")},
                            horizon=64)
    try:
        with faults.armed(plan):
            for i in range(12):
                data = rand((3, 2, 4096), 100 + i).numpy()
                assert np.array_equal(eng.encode(data, timeout=60),
                                      codec.encode(data).cpu().numpy())
                assert eng.flush(30)
        snap = eng.pool.snapshot()
        rsnap = res.stats.snapshot()
        assert rsnap["breakers"]["codec.d0"]["state"] == "open"
        assert snap["lanes"][0]["batches"] == 0
        assert snap["lanes"][1]["batches"] == 12
        assert rsnap["degraded_batches"] == {}
        assert any(row[5] == "probe" for row in eng.pool.placement_log())
    finally:
        eng.close()


def test_card_member_refused_when_every_lane_is_sick(cuda_device):
    res = ResilienceConfig(monitor=lambda: HealthMonitor(min_samples=1,
                                                         probe_every=100))
    eng = make_engine(2, 1, resilience=res,
                      pool=DevicePool([cuda_device, cuda_device]),
                      policy=AdmissionPolicy(max_delay=0.2))
    codec = rs.TorchCodec(2, 1, cuda_device)
    plan = FaultPlan({"engine.dispatch.d0": {0: FaultSpec("raise")},
                      "engine.dispatch.d1": {0: FaultSpec("raise")}})
    try:
        with faults.armed(plan):
            eng.encode(rand((1, 2, 512), 1).numpy(), timeout=30)
        before = rs_kernel.gf_apply.launches
        fa = eng.submit_encode(rand((2, 2, 512), 2).to(cuda_device))
        b = rand((1, 2, 512), 3).numpy()
        fb = eng.submit_encode(b)
        with pytest.raises(EngineUnavailable):
            fa.result(timeout=30)
        out = fb.result(timeout=30)
        assert rs_kernel.gf_apply.launches == before   # served on the host
        assert np.array_equal(out, codec.encode(b).cpu().numpy())
    finally:
        eng.close()


def test_mesh_and_pool_stream_on_the_card(cuda_device):
    pipe = StoragePipeline(PipelineConfig(k=2, m=1, segment_size=SEG),
                           device=cuda_device)
    segs = rand((8, SEG), 4)
    ids = torch.arange(24, device=cuda_device).reshape(8, 3)
    ref = pipe(segs.to(cuda_device), ids)
    idx, nu = podr2.gen_challenge(b"card-mesh", 128, device=cuda_device)
    before = podr2_kernel.prf_blocks.launches
    for seg, byte in ((4, 1), (2, 2), (1, 4)):
        step = sharded_pipeline_step(
            pipe, make_mesh([cuda_device] * 4, seg=seg, byte=byte))
        frags, tags, ok = step(segs.view(8, 2, -1), ids, idx, nu)
        assert torch.equal(frags.gather(), ref["fragments"])
        assert torch.equal(tags.gather(), ref["tags"])
        assert bool(ok.gather().all())
    assert podr2_kernel.prf_blocks.launches > before
    pinned = segs.pin_memory()
    ing = StreamingIngest(pipe, 4, pool=DevicePool([cuda_device] * 2))
    # two runs with tails of 3 and 2 rows: the second reuses the tail's
    # pinned buffer, whose row 2 the first filled and must zero again
    for rows in (7, 6):
        got = ing.ingest(pinned[:rows])
        want = pipe(segs[:rows].to(cuda_device))
        assert torch.equal(got["fragments"], want["fragments"])
        assert torch.equal(got["tags"], want["tags"])
