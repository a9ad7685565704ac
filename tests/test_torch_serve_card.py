"""The port's submission engine and streaming ingest on the card.

Every test here needs a CUDA device and skips without one. Like
``test_torch_kernels.py`` the file imports neither jax nor cess_tpu, so
it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_serve_card.py

The CPU tests of the same code, against the JAX package, are
``test_torch_serve.py`` and ``test_torch_stream.py``.
"""
import threading

import numpy as np
import pytest
import torch

from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
from cess_tpu_torch.ops import podr2, podr2_kernel, rs, rs_kernel
from cess_tpu_torch.resilience import (FaultInjected, FaultPlan, FaultSpec,
                                       HealthMonitor, ResilienceConfig, faults)
from cess_tpu_torch.serve import (AdmissionPolicy, EngineUnavailable,
                                  StreamingIngest, SubmissionEngine,
                                  make_engine)
from cess_tpu_torch.serve.stats import StreamStats

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


def test_engine_keeps_cuda_payloads_on_the_card(cuda_device):
    key = podr2.Podr2Key.generate(3, device=cuda_device)
    eng = make_engine(2, 1, podr2_key=key,
                      policy=AdmissionPolicy(max_delay=0.2))
    codec = rs.TorchCodec(2, 1, cuda_device)
    try:
        assert eng.device == cuda_device
        host = rand((3, 2, 4096), 1).numpy()
        dev = rand((2, 2, 4096), 2).to(cuda_device)
        f_host, f_dev = eng.submit_encode(host), eng.submit_encode(dev)
        out_host, out_dev = f_host.result(timeout=60), f_dev.result(timeout=60)
        assert isinstance(out_host, np.ndarray)
        assert out_dev.is_cuda and torch.equal(out_dev, codec.encode(dev))
        assert np.array_equal(out_host, codec.encode(host).cpu().numpy())
        assert eng.stats_snapshot()["classes"]["encode"]["batches"] == 1
        frags = out_dev.reshape(6, -1)
        ids = torch.stack([torch.arange(6), torch.full((6,), 9)], 1).to(
            cuda_device)
        tags = eng.tag_fragments(ids, frags)
        assert tags.is_cuda
        assert torch.equal(tags, podr2.tag_fragments(key, ids, frags))
        blocks = tags.shape[1]
        idx, nu = podr2.gen_challenge(b"card", blocks, device=cuda_device)
        r = podr2.aggregate_coeffs(b"card", ids, device=cuda_device)
        mu, sigma = eng.prove_aggregate(frags, tags, idx, nu, r)
        dmu, dsigma = podr2.prove_aggregate(frags, tags, idx, nu, r)
        assert mu.is_cuda and torch.equal(mu, dmu) and torch.equal(sigma,
                                                                    dsigma)
        assert eng.verify_aggregate(ids, blocks, idx, nu, r, mu, sigma)
        assert not eng.verify_aggregate(ids, blocks, idx, nu, r, mu,
                                        (sigma + 1) % podr2.pf.P)
    finally:
        eng.close()


def test_engine_waits_for_the_submitters_stream(cuda_device):
    """A payload written on another stream of the submitting thread is
    read only after that write: the submit's event orders it."""
    codec = rs.TorchCodec(2, 1, cuda_device)
    eng = SubmissionEngine(codec=codec,
                           policy=AdmissionPolicy(max_delay=0.001))
    try:
        want = rand((8, 2, 1 << 20), 3).to(cuda_device)
        side = torch.cuda.Stream(cuda_device)
        side.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(side):
            data = torch.zeros_like(want)
            for _ in range(20):            # keep the side stream busy
                data.copy_(want)
            out = eng.encode(data)
        assert torch.equal(out, codec.encode(want))
    finally:
        eng.close()


def test_warm_repair_replays_graphs_on_the_batcher(cuda_device):
    codec = rs.TorchCodec(2, 1, cuda_device)
    eng = SubmissionEngine(codec=codec, policy=AdmissionPolicy(
        max_batch_requests=2, max_delay=10.0))
    try:
        n = 1 << 16
        eng.warm_repair([((1, 2), (0,))], n, buckets=(2, 4))
        built = eng.stats_snapshot()["programs_built"]
        coded = codec.encode(rand((4, 2, n), 4).to(cuda_device))
        futs = [eng.submit_reconstruct(coded[i:i + 2, 1:], (1, 2), (0,))
                for i in (0, 2)]
        before = rs_kernel.gf_apply.launches
        outs = [f.result(timeout=60) for f in futs]
        assert torch.equal(torch.cat(outs), coded[:, :1])
        assert codec.warm_hits == 1          # one coalesced bucket-4 batch
        assert rs_kernel.gf_apply.launches > before
        assert eng.stats_snapshot()["programs_built"] == built
    finally:
        eng.close()


def test_concurrent_submitters_on_the_card(cuda_device):
    codec = rs.TorchCodec(2, 1, cuda_device)
    eng = SubmissionEngine(codec=codec,
                           policy=AdmissionPolicy(max_delay=0.05))
    datas = [rand((2, 2, 1 << 16), 10 + i) for i in range(8)]
    outs = [None] * 8
    barrier = threading.Barrier(8)

    def submit(i):
        data = datas[i].to(cuda_device) if i % 2 else datas[i].numpy()
        barrier.wait()
        outs[i] = eng.encode(data, timeout=60)

    try:
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for i, out in enumerate(outs):
            want = codec.encode(datas[i].to(cuda_device))
            got = out if i % 2 else torch.from_numpy(out).to(cuda_device)
            assert torch.equal(got, want), i
        assert eng.stats_snapshot()["classes"]["encode"][
            "batch_occupancy"] > 1
    finally:
        eng.close()


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("pinned", [True, False])
def test_staged_stream_equals_direct_forward(cuda_device, depth, pinned):
    """Pinned staging on a side stream, ragged tail included, equals the
    direct forward on the same rows with the stream's global ids."""
    pipe = StoragePipeline(PipelineConfig(k=2, m=1, segment_size=SEG),
                           device=cuda_device)
    segs = rand((11, SEG), 20 + depth)
    src = segs.pin_memory() if pinned else segs.numpy()
    seg_dev = segs.to(cuda_device)
    stats = StreamStats()
    ing = StreamingIngest(pipe, 4, depth=depth, stats=stats)
    for _ in range(2):                       # the buffers are reused
        off = 0
        for out in ing.run(src):
            rows = out["rows"]
            ids = torch.arange(off * 3, (off + rows) * 3, device=cuda_device)
            want = pipe(seg_dev[off:off + rows], ids)
            assert torch.equal(out["fragments"], want["fragments"])
            assert torch.equal(out["tags"], want["tags"])
            off += 4
        assert off == 12
    assert (stats.batches, stats.segments, stats.padded_segments) == \
        (6, 22, 2)
    ids = np.random.default_rng(5).integers(0, 1 << 32, (11, 3, 2),
                                            dtype=np.uint64).astype(np.uint32)
    got = ing.ingest(src, fragment_ids=ids)
    assert torch.equal(got["tags"], pipe(seg_dev, ids)["tags"])


def test_degraded_batches_keep_both_domains_byte_equal(cuda_device):
    """A CUDA-tensor member and a numpy member coalesced into one batch
    whose card attempt fails, then into one its tripped breaker sends to
    the CPU references: the numpy member gets every byte the card's path
    gives, as numpy, and launches no kernel; the CUDA member is never
    served on the host (rejected with the attempt's error, then refused
    with EngineUnavailable)."""
    key = podr2.Podr2Key.generate(7, device=cuda_device)
    res = ResilienceConfig(monitor=lambda: HealthMonitor(min_samples=1,
                                                         probe_every=100))
    eng = make_engine(2, 1, podr2_key=key, resilience=res,
                      policy=AdmissionPolicy(max_delay=0.2))
    codec = rs.TorchCodec(2, 1, cuda_device)
    plan = FaultPlan({"engine.dispatch": {0: FaultSpec("raise")}})
    try:
        for step, exc in enumerate((FaultInjected, EngineUnavailable)):
            dev = rand((2, 2, 1 << 16), 30 + step).to(cuda_device)
            host = rand((3, 2, 1 << 16), 40 + step).numpy()
            before = rs_kernel.gf_apply.launches
            with faults.armed(plan):
                f_dev = eng.submit_encode(dev)
                f_host = eng.submit_encode(host)
                with pytest.raises(exc):
                    f_dev.result(timeout=120)
                out_host = f_host.result(timeout=120)
            assert rs_kernel.gf_apply.launches == before
            assert isinstance(out_host, np.ndarray)
            assert np.array_equal(out_host, codec.encode(host).cpu().numpy())
            frags = codec.encode(dev).reshape(6, -1)
            ids = torch.stack([torch.arange(6), torch.full((6,), 3)], 1)
            f_t = eng.submit_tag(ids.to(cuda_device), frags)
            f_n = eng.submit_tag(ids.numpy(), frags.cpu().numpy())
            want = podr2.tag_fragments(key, ids.to(cuda_device), frags)
            if step == 0:
                assert torch.equal(f_t.result(timeout=120), want)
            else:
                with pytest.raises(EngineUnavailable):
                    f_t.result(timeout=120)
            assert np.array_equal(f_n.result(timeout=120),
                                  want.cpu().numpy())
            eng.monitors["audit"].force_open()
        snap = res.stats.snapshot()
        assert snap["fallback_batches"] == {"encode": 1}
        assert snap["degraded_batches"] == {"encode": 1, "tag": 1}
        assert snap["batch_requeues"] == 2
        assert eng.monitors["codec"].state == "open"
        assert eng.stats_snapshot()["classes"]["encode"]["failed"] == 2
        assert any(k[-1] == "cpu-fallback" for k in eng.programs.keys())
    finally:
        eng.close()


def test_recovery_relaunches_the_kernels(cuda_device):
    """While a breaker is open no kernel launches (numpy members are
    served on the host); the probe that closes it, and every batch
    after, runs on the card's kernels again."""
    key = podr2.Podr2Key.generate(8, device=cuda_device)
    res = ResilienceConfig(monitor=lambda: HealthMonitor(probe_every=2))
    eng = make_engine(2, 1, podr2_key=key, resilience=res,
                      policy=AdmissionPolicy(max_delay=0.001))
    codec = rs.TorchCodec(2, 1, cuda_device)
    try:
        eng.monitors["codec"].force_open()
        eng.monitors["audit"].force_open()
        kernels = (rs_kernel.gf_apply, podr2_kernel.prf_blocks,
                   podr2_kernel.podr2_tag)
        ids = np.stack([np.arange(3), np.zeros(3, np.int64)], 1)
        for step in range(3):
            data = rand((1, 2, 1 << 16), 50 + step)
            before = [k.launches for k in kernels]
            out = eng.encode(data.numpy())
            tags = eng.tag_fragments(ids, out.reshape(3, -1))
            rose = [k.launches > b for k, b in zip(kernels, before)]
            # step 0: degraded; step 1: the probe closes both breakers
            assert rose == [step > 0] * 3, (step, rose)
            want = codec.encode(data.to(cuda_device))
            assert np.array_equal(out, want.cpu().numpy())
            assert np.array_equal(tags, podr2.tag_fragments(
                key, torch.from_numpy(ids).to(cuda_device),
                want.reshape(3, -1)).cpu().numpy())
        assert eng.monitors["codec"].state == "closed"
        assert eng.monitors["audit"].state == "closed"
        snap = res.stats.snapshot()
        assert snap["degraded_batches"] == {"encode": 1, "tag": 1}
        assert snap["breakers"]["codec"]["recoveries"] == 1
    finally:
        eng.close()
