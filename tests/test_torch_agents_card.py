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
import numpy as np
import pytest
import torch

from cess_tpu_torch.models.pipeline import PipelineConfig
from cess_tpu_torch.node import hashing, offchain
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
