"""One storage-audit round of the port on the card, from the upload to the
verdict on chain, at a reduced size (RS(2,1), four segments of 512 KiB).

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor cess_tpu, so it runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_chain_card.py

The round on the card must launch the kernels and reach the same proofs,
verdicts and state root as the same round on the CPU (the plain path).
The CPU test of the round against the JAX package is
``test_torch_chain_audit.py``; ``chip_smoke.py``'s phase ``chain`` runs it
at full width.
"""
import numpy as np
import pytest
import torch

from cess_tpu_torch.crypto import bls12381
from cess_tpu_torch.models import PipelineConfig
from cess_tpu_torch.node import offchain
from cess_tpu_torch.ops import podr2, podr2_kernel, rs_kernel

from torch_chain_wiring import Chain, audit_round

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


def run(device):
    cfg = PipelineConfig(segment_size=SEG)
    key = podr2.Podr2Key.generate(7, device=device)
    pipe = offchain.AgentPipeline(cfg, podr2_key=key, device=device)
    data = np.random.default_rng(5).integers(0, 256, 4 * SEG, np.uint8)
    chain = Chain("cess_tpu_torch")
    return audit_round(pipe, data, chains=[chain], device=device,
                       tamper_row=2), chain


def test_audit_round_on_the_card_matches_the_cpu(cuda_device):
    assert bls12381._native is not None
    before = kernel_launches()
    card, chain = run(cuda_device)
    assert all(a > b for a, b in zip(kernel_launches(), before))
    cpu, _ = run("cpu")
    assert card["proofs"] == cpu["proofs"]
    assert card["verdicts"] == cpu["verdicts"]
    assert card["state_root"] == cpu["state_root"]
    tampered = card["tampered"]
    assert card["verdicts"] == {w: (True, w != tampered)
                                for w in card["deal"].assigned}
    assert chain.state.get("audit", "fail_count", tampered) == 1
    assert card["log_ok"]
