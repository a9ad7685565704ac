"""The device half of the off-chain agents (cess_tpu_torch.node) on the
card: a gateway upload, a miner's proofs and the TEE's checks, direct and
through a port engine, then a repair.

Every test here needs a CUDA device and skips without one. Like
``test_torch_serve_card.py`` the file imports neither jax nor cess_tpu,
so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_agents_card.py

The CPU tests of the same code, against the JAX package, are
``test_torch_offchain.py`` and ``test_torch_sim.py``.
"""
import warnings

import numpy as np
import pytest
import torch

from cess_tpu_torch.models.pipeline import PipelineConfig
from cess_tpu_torch.node import hashing, offchain
from cess_tpu_torch.obs import trace
from cess_tpu_torch.ops import podr2, podr2_kernel, rs_kernel
from cess_tpu_torch.serve import AdmissionPolicy, make_engine

pytestmark = pytest.mark.gpu

SEG = 2 * 256 * 1024         # RS(2,1): fragments of 256 KiB, 512 blocks


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def kernel_launches():
    return (rs_kernel.gf_apply.launches, podr2_kernel.prf_blocks.launches,
            podr2_kernel.podr2_tag.launches)


@pytest.mark.parametrize("routed", ["direct", "engine"])
def test_upload_prove_verify_on_the_card(cuda_device, routed):
    key = podr2.Podr2Key.generate(7, device=cuda_device)
    cfg = PipelineConfig(segment_size=SEG)
    pipe = offchain.AgentPipeline(cfg, podr2_key=key, device=cuda_device)
    cpu = offchain.AgentPipeline(cfg, podr2_key=key.to("cpu"), device="cpu")
    eng = None
    if routed == "engine":
        eng = make_engine(2, 1, podr2_key=key,
                          policy=AdmissionPolicy(max_delay=0.01))
        pipe.engine = eng
    data = np.random.default_rng(1).integers(0, 256, 4 * SEG, np.uint8)
    try:
        before = kernel_launches()
        up = offchain.upload_batch(pipe, data, tenant="alice")
        assert all(a > b for a, b in zip(kernel_launches(), before))
        want = offchain.upload_batch(cpu, data, tenant="alice")
        assert np.array_equal(up.fragments, want.fragments)
        assert np.array_equal(up.tags, want.tags)
        assert up.file_hash == want.file_hash and up.fetches == 1
        assert pipe.fragment_uploads == 0
        # miner j holds row j of every segment
        store = {h: up.fragments[i, j] for i, hs in
                 enumerate(up.fragment_hashes) for j, h in enumerate(hs)}
        tags = {h: up.tags[i, j] for i, hs in enumerate(up.fragment_hashes)
                for j, h in enumerate(hs)}
        blocks = cfg.blocks_per_fragment
        for row in range(3):
            owed = [hs[row] for hs in up.fragment_hashes]
            mu, sigma = offchain.prove_owed(b"round", owed, store, tags,
                                            engine=eng, device=cuda_device)
            cmu, csigma = offchain.prove_owed(b"round", owed, store, tags,
                                              device="cpu")
            assert np.array_equal(mu, cmu) and np.array_equal(sigma, csigma)
            assert offchain.verify_owed(key, blocks, b"round", owed, mu, sigma,
                                        engine=eng, device=cuda_device)
            short = {h: b for h, b in store.items() if h != owed[0]}
            smu, ssigma = offchain.prove_owed(b"round", owed, short, tags,
                                              engine=eng, device=cuda_device)
            assert not offchain.verify_owed(key, blocks, b"round", owed, smu,
                                            ssigma, engine=eng,
                                            device=cuda_device)
        # a lost row-0 fragment, rebuilt from rows 1 and 2
        hs = up.fragment_hashes[2]
        rebuilt = offchain.repair_via_fragments(
            2, 1, [store[hs[1]], store[hs[2]]], (1, 2), 0, engine=eng,
            device=cuda_device)
        assert hashing.fragment_hash(rebuilt) == hs[0]
        # and by repair symbols, folded on the card by default
        before = rs_kernel.gf_apply.launches
        folded = offchain.repair_via_symbols(
            2, 1, (1, 2), 0, [store[hs[1]], store[hs[2]]], engine=eng,
            device=cuda_device)
        assert folded == rebuilt and rs_kernel.gf_apply.launches > before
    finally:
        if eng is not None:
            eng.close()


# -- the upload's host buffers in page-locked memory --------------------------
def page_locked(a: np.ndarray) -> bool:
    """Whether a host array lies in page-locked memory, asked of CUDA by
    its address."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)     # read-only array
        return torch.from_numpy(a).is_pinned()


def traced_upload(pipe, data):
    """(``upload_batch``'s result, its ``offchain.upload`` span's attrs)."""
    tracer = trace.Tracer()
    with trace.armed(tracer):
        up = offchain.upload_batch(pipe, data)
    (span,) = [s for s in tracer.finished() if s["name"] == "offchain.upload"]
    return up, span["attrs"]


def pipelines(device):
    key = podr2.Podr2Key.generate(7, device=device)
    cfg = PipelineConfig(segment_size=SEG)
    return (offchain.AgentPipeline(cfg, podr2_key=key, device=device),
            offchain.AgentPipeline(cfg, podr2_key=key.to("cpu"),
                                   device="cpu"))


def assert_same_upload(got, want):
    assert np.array_equal(got.fragments, want.fragments)
    assert np.array_equal(got.tags, want.tags)
    assert np.array_equal(got.ids, want.ids)
    assert got.fragment_hashes == want.fragment_hashes
    assert got.segment_hashes == want.segment_hashes
    assert got.file_hash == want.file_hash and got.fetches == 1


# (size, input as bytes): the host copies the segments of a padded file
# and of read-only bytes (the gateway's input), not of a writable array
# of whole segments
UPLOAD_INPUTS = [(3 * SEG - 1000, False), (4 * SEG, False), (4 * SEG, True)]
UPLOAD_IDS = ["padded", "whole-segments", "whole-segments-bytes"]


def upload_input(rng, size, as_bytes):
    data = rng.integers(0, 256, size, np.uint8)
    return data.tobytes() if as_bytes else data


@pytest.mark.parametrize("size,as_bytes", UPLOAD_INPUTS, ids=UPLOAD_IDS)
def test_upload_stages_in_page_locked_memory_and_matches_the_cpu(
        cuda_device, size, as_bytes):
    pipe, cpu = pipelines(cuda_device)
    data = upload_input(np.random.default_rng(11), size, as_bytes)
    up, attrs = traced_upload(pipe, data)
    assert_same_upload(up, offchain.upload_batch(cpu, data))
    assert page_locked(up.fragments) and not up.fragments.flags.writeable
    assert attrs["pinned"] is True and attrs["host_allocs"] >= 0
    # RS(2,1): each segment and its data row 1 hashed from the host's
    # segments before the fetch, its parity row after: 3 of 4 bytes early
    assert attrs["hashed_bytes"] == 4 * up.fragments.size // 3
    assert 4 * attrs["early_bytes"] == 3 * attrs["hashed_bytes"]


@pytest.mark.parametrize("size,as_bytes", UPLOAD_INPUTS, ids=UPLOAD_IDS)
def test_repeat_upload_of_a_size_takes_no_new_page_locked_block(
        cuda_device, size, as_bytes):
    pipe, _ = pipelines(cuda_device)
    rng = np.random.default_rng(12)
    first, _ = traced_upload(pipe, upload_input(rng, size, as_bytes))
    del first                               # its blocks go back to the cache
    up, attrs = traced_upload(pipe, upload_input(rng, size, as_bytes))
    assert attrs["host_allocs"] == 0 and page_locked(up.fragments)


def test_kept_upload_keeps_its_bytes_through_later_uploads(cuda_device):
    pipe, cpu = pipelines(cuda_device)
    rng = np.random.default_rng(13)
    size = 2 * SEG - 77
    data = rng.integers(0, 256, size, np.uint8)
    kept = offchain.upload_batch(pipe, data)
    frags, tags = kept.fragments.copy(), kept.tags.copy()
    for _ in range(3):
        other = offchain.upload_batch(
            pipe, rng.integers(0, 256, size, np.uint8))
        assert not np.shares_memory(other.fragments, kept.fragments)
        assert not np.array_equal(other.fragments, frags)
        del other
    assert np.array_equal(kept.fragments, frags)
    assert np.array_equal(kept.tags, tags)
    assert_same_upload(kept, offchain.upload_batch(cpu, data))


def test_padded_tail_is_zero_in_a_block_that_held_another_file(cuda_device):
    """A larger file fills the cached segments block with nonzero bytes;
    a smaller one of the same segment count reuses it (no allocation)
    and still hashes, encodes and tags a zero tail."""
    pipe, cpu = pipelines(cuda_device)
    rng = np.random.default_rng(14)
    big = rng.integers(1, 256, 2 * SEG - 3, np.uint8)
    small = rng.integers(0, 256, SEG + 5, np.uint8)
    offchain.upload_batch(pipe, big)        # dropped: its blocks are free
    up, attrs = traced_upload(pipe, small)
    assert attrs["host_allocs"] == 0
    assert_same_upload(up, offchain.upload_batch(cpu, small))
