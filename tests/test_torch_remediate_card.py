"""The remediation loop on the card.

Every test here needs a CUDA device and skips without one. Like
``test_torch_kernels.py`` the file imports neither jax nor cess_tpu, so
it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_remediate_card.py

The CPU tests of the same code, against the JAX package, are
``test_torch_remediate.py``, ``test_torch_fleet.py`` and
``test_torch_sim_planes.py``; ``chip_smoke.py``'s phase ``remediate``
runs both drills at the main path's width.
"""
import statistics
import time

import numpy as np
import pytest
import torch

from cess_tpu_torch.obs import flight, trace
from cess_tpu_torch.obs.fleet import FleetPlane
from cess_tpu_torch.obs.profile import ProfilePlane
from cess_tpu_torch.ops import rs, rs_kernel
from cess_tpu_torch.resilience import (FaultPlan, FaultSpec, ResilienceConfig,
                                       faults)
from cess_tpu_torch.serve import (AdmissionPolicy, DevicePool,
                                  EngineUnavailable, RemediationPlane,
                                  make_engine)

pytestmark = pytest.mark.gpu

N = 1 << 16                  # RS(2,1): fragments of 64 KiB
METRIC = "rs_4p8_encode_GiBps_per_chip"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rand(shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8)).to(dev)


def test_perf_pin_refuses_card_members_and_releases(cuda_device):
    """A watchdog regression (a seeded 50 ms dispatch delay) pins the
    encode class on the next tick: a CUDA encode is refused with no
    ``gf_apply`` launch, a numpy one is served on the CPU reference
    byte-equal; the re-probe releases the pin and the kernel launches
    again; the watchdog returns to ok."""
    dev = cuda_device
    data = rand((16, 2, N), 1, dev)
    want = rs.TorchCodec(2, 1, dev).encode(data)
    warm = ProfilePlane(window=8)
    eng = make_engine(2, 1, profile=warm)
    try:
        for _ in range(9):
            eng.encode(data, timeout=60)
        base = warm.ops.windowed_gibps()["encode"]
    finally:
        eng.close()
    profile = ProfilePlane(baseline={METRIC: base}, guard=0.25, window=2)
    eng = make_engine(2, 1, resilience=ResilienceConfig(), profile=profile)
    rec = flight.FlightRecorder(b"card-pin")
    plane = RemediationPlane(b"card-pin")
    rec.add_listener(plane.on_note)
    plane.bind_engine(eng)
    plan = FaultPlan.seeded(b"card-pin", {"engine.dispatch": (
        1.0, FaultSpec("delay", delay_s=0.05))}, horizon=16)
    mon = eng.monitors["codec"]
    try:
        with flight.armed(rec):
            with faults.armed(plan):
                for _ in range(2):
                    assert torch.equal(eng.encode(data, timeout=60), want)
                    plane.tick()
            assert mon.state == "held"
            fire = plane.journal()[-1]
            assert (fire["event"], fire["key"]) == ("fire", METRIC)
            assert fire["tick"] - plane.edge_log()[-1]["tick"] == 1
            torch.cuda.synchronize()
            before = rs_kernel.gf_apply.launches
            with pytest.raises(EngineUnavailable):
                eng.encode(data, timeout=60)
            host = eng.encode(data[:1].cpu().numpy(), timeout=60)
            torch.cuda.synchronize()
            assert rs_kernel.gf_apply.launches == before
            assert np.array_equal(host, want[:1].cpu().numpy())
            while plane.engagements():
                assert plane.count < 16
                plane.tick()
            assert plane.journal()[-1]["reason"] == "re-probe"
            assert mon.state == "closed"
            for _ in range(3):
                assert torch.equal(eng.encode(data, timeout=60), want)
                plane.tick()
            torch.cuda.synchronize()
            assert rs_kernel.gf_apply.launches > before
        log = profile.watchdog.transition_log()
        assert [t[2:4] for t in log] == [("ok", "regressed"),
                                         ("regressed", "ok")]
    finally:
        eng.close()


def test_straggler_lane_is_quarantined_and_returned(cuda_device):
    """``DevicePool([card] * 4)``, one request a batch: a seeded 50 ms
    delay on lane 2's encodes makes the straggler detector flag
    ``card.d2`` alone from each lane's ``device.encode`` span walls; the
    next tick holds lane 2's breaker, the next 8 encodes land on lanes 0,
    1 and 3, byte-equal, and after the re-probe lane 2 serves again."""
    dev = cuda_device
    wave_in = [rand((2, 2, N), 10 + i, dev) for i in range(4)]
    codec = rs.TorchCodec(2, 1, dev)
    wave_out = [codec.encode(x) for x in wave_in]
    tracer = trace.Tracer()
    eng = make_engine(2, 1, resilience=ResilienceConfig(), tracer=tracer,
                      pool=DevicePool([dev] * 4),
                      policy=AdmissionPolicy(max_batch_requests=1))
    rec = flight.FlightRecorder(b"card-lane")
    plane = RemediationPlane(b"card-lane")
    rec.add_listener(plane.on_note)
    plane.bind_engine(eng)
    fleet = FleetPlane("card")
    plan = FaultPlan.seeded(b"card-lane", {"engine.dispatch.encode.d2": (
        1.0, FaultSpec("delay", delay_s=0.05))}, horizon=64)
    seen = [0]
    walls = {i: [] for i in range(4)}

    def wave():
        log0 = len(eng.pool.placement_log())
        with eng._device_locks[dev]:      # placed before any runs
            futs = [eng.submit_encode(x) for x in wave_in]
            deadline = time.monotonic() + 30
            while len(eng.pool.placement_log()) < log0 + 4:
                assert time.monotonic() < deadline
                time.sleep(0.0005)
        for f, want in zip(futs, wave_out):
            assert torch.equal(f.result(60), want)
        spans = [s for s in tracer.finished() if s["span_id"] > seen[0]]
        seen[0] = max([seen[0]] + [s["span_id"] for s in spans])
        for s in spans:
            if s["name"] == "device.encode":
                i = s["attrs"]["device"]
                walls[i].append(s["dur_s"])
                fleet.stragglers.observe(f"card.d{i}", "encode_wall_s",
                                         round(s["dur_s"] / 0.05) * 0.05)
        return [row[4] for row in eng.pool.placement_log()[log0:]]

    try:
        wave()
        with flight.armed(rec):
            with faults.armed(plan):
                for _ in range(8):
                    assert sorted(wave()) == [0, 1, 2, 3]
                fleet.seal_round()
                plane.tick()
                assert fleet.stragglers.snapshot()["outliers"] \
                    == ["card.d2/encode_wall_s"]
                clean = [statistics.median(walls[i]) for i in (0, 1, 3)]
                assert statistics.median(walls[2]) >= 20 * max(clean)
                lane2 = eng.pool.lanes[2].monitors["codec"]
                assert lane2.state == "held"
                assert all(eng.pool.lanes[i].monitors["codec"].state
                           == "closed" for i in (0, 1, 3))
                placed = [wave() for _ in range(2)]
                assert all(set(p) <= {0, 1, 3} for p in placed)
                while plane.engagements():
                    assert plane.count < 40
                    fleet.seal_round()
                    plane.tick()
            assert lane2.state == "closed"
            assert sorted(wave()) == [0, 1, 2, 3]
        assert [(e["event"], e["key"]) for e in plane.journal()] == [
            ("fire", "card.d2"), ("release", "card.d2")]
    finally:
        eng.close()
