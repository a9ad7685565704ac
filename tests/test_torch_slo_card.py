"""The engine's control planes on the card.

Every test here needs a CUDA device and skips without one. Like
``test_torch_kernels.py`` the file imports neither jax nor cess_tpu, so
it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_slo_card.py

The CPU tests of the same code, against the JAX package, are
``test_torch_slo.py`` and ``test_torch_profile.py``.
"""
import numpy as np
import pytest
import torch

from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
from cess_tpu_torch.obs.profile import ProfilePlane
from cess_tpu_torch.obs.slo import SloBoard, SloTarget
from cess_tpu_torch.ops import podr2_kernel, rs, rs_kernel
from cess_tpu_torch.resilience import ResilienceConfig
from cess_tpu_torch.serve import (AdaptiveBatchPolicy, AdmissionController,
                                  AdmissionPolicy, EngineShed,
                                  EngineUnavailable, StreamingIngest,
                                  make_engine)

pytestmark = pytest.mark.gpu

SEG = 2 * 64 * 1024          # RS(2,1): fragments of 64 KiB, 128 blocks


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8))


def test_admission_hold_on_the_card(cuda_device):
    """A protected class burning holds the codec breaker of an engine on
    the card: encodes are shed, a CUDA member of a repair is refused with
    no kernel launched, a numpy member is served on the CPU reference
    byte-equal; after release the kernels launch again."""
    board = SloBoard((SloTarget("verify", 0.05, 0.01),), fast_window=4,
                     slow_window=16, eval_every=4)
    ctrl = AdmissionController(board, AdaptiveBatchPolicy(board=board))
    eng = make_engine(2, 1, resilience=ResilienceConfig(), slo=board,
                      admission=ctrl, policy=AdmissionPolicy(max_delay=0.002))
    codec = rs.TorchCodec(2, 1, cuda_device)
    data = rand((2, 2, 1 << 16), 1).to(cuda_device)
    enc = codec.encode(data)
    try:
        for _ in range(8):
            board.observe("verify", 1.0)
        assert board.state("verify") == "burning" and ctrl.engaged
        assert eng.monitors["codec"].state == "held"
        with pytest.raises(EngineShed):
            eng.encode(data, timeout=60)
        torch.cuda.synchronize()
        before = rs_kernel.gf_apply.launches
        with pytest.raises(EngineUnavailable):
            eng.reconstruct(enc[:, 1:], (1, 2), (0,), timeout=60)
        host = eng.reconstruct(enc[:, 1:].cpu().numpy(), (1, 2), (0,),
                               timeout=60)
        assert rs_kernel.gf_apply.launches == before
        assert isinstance(host, np.ndarray)
        assert np.array_equal(host, enc[:, :1].cpu().numpy())
        snap = eng.stats_snapshot()
        assert snap["classes"]["encode"]["shed"] == 1
        assert snap["classes"]["repair"]["failed"] == 1
        assert snap["resilience"]["degraded_batches"]["repair"] == 1
        for _ in range(24):
            board.observe("verify", 0.001)
        assert board.state("verify") == "ok" and not ctrl.engaged
        assert eng.monitors["codec"].state == "closed"
        out = eng.encode(data, timeout=60)
        rebuilt = eng.reconstruct(enc[:, 1:], (1, 2), (0,), timeout=60)
        assert rs_kernel.gf_apply.launches >= before + 2
        assert torch.equal(out, enc) and torch.equal(rebuilt, enc[:, :1])
        assert ctrl.snapshot()["holds"] == ctrl.snapshot()["releases"] == 1
    finally:
        eng.close()


def test_profile_stream_feed_is_taken_at_completion(cuda_device):
    """The stream's profile feed is the time until each batch was done:
    the profile's stream GiB/s is no higher than the stream's own rate
    from host bytes, and its ragged tail lands in the engine's pad
    ledger beside the engine's own bucket pads."""
    cfg = PipelineConfig(k=2, m=1, segment_size=SEG)
    pipe = StoragePipeline(cfg, device=cuda_device)
    plane = ProfilePlane()
    board = SloBoard((SloTarget("stream", 10.0),))
    eng = make_engine(2, 1, slo=board, profile=plane)
    try:
        src = rand((70, SEG), 5).pin_memory()
        ing = StreamingIngest(pipe, 32, engine=eng, tenant="gw")
        launches = podr2_kernel.podr2_tag.launches
        out = ing.ingest(src)
        assert out["fragments"].shape == (70, 3, SEG // 2)
        assert podr2_kernel.podr2_tag.launches > launches
        eng.encode(rand((3, 2, 4096), 6).to(cuda_device), timeout=60)
    finally:
        eng.close()
    st = ing.stats
    acct = [a for a in plane.snapshot()["ops"]["accounts"]
            if a["cls"] == "stream"][0]
    busy = acct["h2d_s"] + acct["dispatch_s"]
    assert acct["batches"] == 3 and acct["padded_rows"] == 26
    profile_gibs = acct["bytes"] / (1 << 30) / busy
    stream_gibs = st.bytes_in / (1 << 30) / st.wall_s
    assert profile_gibs <= stream_gibs
    pads = plane.pads.total()
    assert pads["sources"] == {"stream": 26, "engine": 1}
    assert board.snapshot()["tenants"]["gw"]["stream"]["requests"] == 3
