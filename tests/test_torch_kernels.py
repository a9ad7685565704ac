"""The port's CUDA kernels against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor cess_tpu (nor does ``test_torch_layouts``, whose
torch statement of ``gf_apply`` it holds the kernel to), so it also runs
where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from cess_tpu_torch import kat
from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
from cess_tpu_torch.ops import (gf, podr2, podr2_kernel, prf, regen, rs,
                                rs_kernel, rs_xor, xor_sched)
from cess_tpu_torch.ops.rs import TorchCodec
from test_torch_layouts import interleaved_apply

pytestmark = pytest.mark.gpu

XOR_MATRICES = {
    "parity_2_1": gf.cauchy_parity_matrix(2, 1),
    "parity_3_3": gf.cauchy_parity_matrix(3, 3),
    "parity_4_8": gf.cauchy_parity_matrix(4, 8),
    "parity_10_4": gf.cauchy_parity_matrix(10, 4),
    "decode_4_8_from_parity": gf.decode_matrix(4, 8, (4, 5, 6, 7)),
    "repair_2_1": gf.repair_matrix(2, 1, (1, 2), (0,)),
    "symbol_213": np.array([[1, 213]], dtype=np.uint8),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("k,m", [(2, 1), (4, 8), (10, 4)])
@pytest.mark.parametrize("n", [4096, 700, 16])
def test_gf_apply_matches_plain(cuda_device, k, m, n):
    mat = gf.cauchy_parity_matrix(k, m)
    tab = rs_kernel.tables(mat, cuda_device)
    data = rand((3, k, n), seed=n + k).to(cuda_device)
    out = torch.empty((3, k + m, n), dtype=torch.uint8, device=cuda_device)
    before = rs_kernel.gf_apply.launches
    rs_kernel.gf_apply(tab, data, out=out[:, k:], sys_out=out[:, :k])
    assert rs_kernel.gf_apply.launches == before + 1
    assert torch.equal(out[:, :k], data)
    assert torch.equal(out[:, k:], rs_kernel.gf_apply_plain(tab, data))
    # an unaligned view takes the kernel's byte path
    view = torch.empty((3, k, n + 1), dtype=torch.uint8,
                       device=cuda_device)[:, :, 1:]
    view.copy_(data)
    assert torch.equal(rs_kernel.gf_apply(tab, view),
                       rs_kernel.gf_apply_plain(tab, data))


@pytest.mark.parametrize("k,m", [(64, 64), (128, 128)])
def test_gf_apply_wide_geometries(cuda_device, k, m):
    """Tables above 48 KB (RS(64,64): 128 KB) and above 227 KB (RS(128,
    128): 512 KB, split into launches over output rows) encode exactly."""
    tab = rs_kernel.tables(gf.cauchy_parity_matrix(k, m), cuda_device)
    data = rand((2, k, 1000), seed=k).to(cuda_device)
    out = torch.empty((2, k + m, 1000), dtype=torch.uint8, device=cuda_device)
    before = rs_kernel.gf_apply.launches
    rs_kernel.gf_apply(tab, data, out=out[:, k:], sys_out=out[:, :k])
    # launches over output rows: 8-row steps whose interleaved image
    # (ceil(rows / 8) * 8 * k * 32 bytes) fits 227 KB
    step = rs_kernel.SMEM_BYTES // (k * 256) * 8
    assert step == rs_kernel.rows_per_launch(k)
    assert rs_kernel.gf_apply.launches == before + -(-m // step)
    assert -(-m // step) == {64: 1, 128: 3}[k]
    assert torch.equal(out[:, :k], data)
    assert torch.equal(out[:, k:], rs_kernel.gf_apply_plain(tab, data))


@pytest.mark.parametrize("r", [1, 3, 5])
@pytest.mark.parametrize("q", [2, 4, 10])
@pytest.mark.parametrize("n", [4096, 4099])
def test_gf_apply_partial_row_groups(cuda_device, r, q, n):
    """Row counts that leave a group of 4 partly empty: the padded rows
    are never stored, in the vector path, the byte path of a ragged tail
    and an unaligned view; the result equals the CPU statement of the
    kernel's arithmetic."""
    mat = gf.cauchy_parity_matrix(q, r)
    tab = rs_kernel.tables(mat, cuda_device)
    data = rand((3, q, n), seed=16 * r + q).to(cuda_device)
    out = torch.full((3, q + r + 1, n), 0xA5, dtype=torch.uint8,
                     device=cuda_device)
    rs_kernel.gf_apply(tab, data, out=out[:, q:q + r], sys_out=out[:, :q])
    want = rs_kernel.gf_apply_plain(tab, data)
    assert torch.equal(out[:, :q], data)
    assert torch.equal(out[:, q:q + r], want)
    assert bool((out[:, q + r] == 0xA5).all())
    assert torch.equal(want.cpu(), interleaved_apply(tab.cpu(), data.cpu()))
    view = torch.empty((3, q, n + 1), dtype=torch.uint8,
                       device=cuda_device)[:, :, 1:]
    view.copy_(data)
    assert torch.equal(rs_kernel.gf_apply(tab, view), want)


@pytest.mark.parametrize("limb_major", [False, True])
@pytest.mark.parametrize("c", [16384, 2049, 753, 1])
def test_prf_blocks_one_fragment(cuda_device, limb_major, c):
    """F = 1, as ``prf_elems`` and ``prf_elems_at`` call it: one tile of
    2048 blocks or a ragged last tile; ids and block indices above 2^32
    hash their low words."""
    key = podr2.Podr2Key.generate(3, device=cuda_device)
    ids = torch.tensor([[(1 << 40) + 7, (3 << 33) + 9]], dtype=torch.int64,
                       device=cuda_device)
    idx = torch.arange(c, device=cuda_device)
    before = podr2_kernel.prf_blocks.launches
    got = podr2_kernel.prf_blocks(key.prf_key, ids, None, c, 2,
                                  limb_major=limb_major)
    want = prf.prf_plain(key.prf_key, ids, idx, 2).to(torch.int32)
    assert podr2_kernel.prf_blocks.launches == before + 1
    assert torch.equal(got, want.transpose(1, 2) if limb_major else want)
    at = torch.tensor([0, c - 1, (1 << 32) + 5, 5], dtype=torch.int64,
                      device=cuda_device)
    assert torch.equal(
        podr2_kernel.prf_blocks(key.prf_key, ids, at, 4, 2,
                                limb_major=limb_major),
        prf.prf_plain(key.prf_key, ids, at, 2).to(torch.int32).transpose(1, 2)
        if limb_major else prf.prf_plain(key.prf_key, ids, at, 2).to(torch.int32))


@pytest.mark.parametrize("limbs", [1, 2, 3, 4])
@pytest.mark.parametrize("c", [16384, 16001])
def test_prf_blocks_eight_blocks_a_thread(cuda_device, limbs, c):
    """F x C above 8 x SMs x 256, where each thread takes 8 blocks of a
    tile (the main path's tag generation, 96 x 16384, takes this body
    too): both layouts, whole tiles and a ragged last tile."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    f = -(-8 * sms * podr2_kernel.PRF_THREADS // c)
    tile, _ = podr2_kernel.prf_grid(f, c, sms)
    assert tile == 8 * podr2_kernel.PRF_THREADS
    key = podr2.Podr2Key.generate(7, device=cuda_device)
    ids = torch.randint(0, 1 << 32, (f, 2), dtype=torch.int64,
                        generator=torch.Generator().manual_seed(c + limbs))
    ids = ids.to(cuda_device)
    want = prf.prf_plain(key.prf_key, ids, torch.arange(c, device=cuda_device),
                         limbs).to(torch.int32)
    for limb_major in (False, True):
        got = podr2_kernel.prf_blocks(key.prf_key, ids, None, c, limbs,
                                      limb_major=limb_major)
        assert torch.equal(got, want.transpose(1, 2) if limb_major else want)


@pytest.mark.parametrize("name", sorted(XOR_MATRICES))
@pytest.mark.parametrize("n", [4096, 4097, 701, 33, 31, 16])
def test_gf_xor_matches_plain(cuda_device, name, n):
    """Whole and ragged 32-byte groups (n on either side of a multiple of
    32), the systematic copy in the same pass, and an unaligned view."""
    mat = XOR_MATRICES[name]
    r, q = mat.shape
    sched = xor_sched.compile_schedule(gf.expand_bitmatrix(mat))
    ops = rs_xor.stage_ops(sched, cuda_device)
    data = rand((3, q, n), seed=n + q).to(cuda_device)
    want = rs_xor.xor_apply_plain(sched, data)
    assert torch.equal(want, rs_kernel.gf_apply_plain(
        rs_kernel.tables(mat, cuda_device), data))
    out = torch.empty((3, q + r, n), dtype=torch.uint8, device=cuda_device)
    before = rs_xor.gf_xor.launches
    rs_xor.gf_xor(sched, ops, data, out=out[:, q:], sys_out=out[:, :q])
    assert rs_xor.gf_xor.launches == before + 1
    assert torch.equal(out[:, :q], data)
    assert torch.equal(out[:, q:], want)
    # an unaligned view takes the kernel's byte path
    view = torch.empty((3, q, n + 1), dtype=torch.uint8,
                       device=cuda_device)[:, :, 1:]
    view.copy_(data)
    assert torch.equal(rs_xor.gf_xor(sched, ops, view), want)
    assert torch.equal(rs_xor.apply_schedule(sched, data.unsqueeze(0))[0],
                       want)


def test_gf_xor_without_output_rows(cuda_device):
    """An empty schedule (RS(3,0) has no parity rows) only copies."""
    codec = TorchCodec(3, 0, cuda_device, strategy="xor")
    data = rand((2, 3, 100), seed=2).to(cuda_device)
    assert torch.equal(codec.encode(data), data)


def test_gf_xor_many_batch_rows(cuda_device):
    sched = xor_sched.compile_schedule(
        gf.expand_bitmatrix(XOR_MATRICES["symbol_213"]))
    data = rand((70000, 2, 10), seed=7).to(cuda_device)
    got = rs_xor.gf_xor(sched, rs_xor.stage_ops(sched, cuda_device), data)
    assert torch.equal(got, rs_xor.xor_apply_plain(sched, data))


@pytest.mark.parametrize("strategy", ["pallas", "xor", "auto"])
def test_warm_graphs_equal_cold(cuda_device, strategy):
    """A CUDA-graph warm reconstruct and warm fold replay to the bytes of
    the cold path, count a hit, and count their kernels as launched."""
    codec = regen.RegenCodec(4, 8, device=cuda_device, strategy=strategy)
    coded = codec.encode(rand((8, 4, 4096), seed=9).to(cuda_device))
    present, missing = (1, 3, 5, 9), (0,)
    surv = coded[:, list(present)]
    cold = codec.reconstruct(surv, present, missing)
    codec.warm_reconstruct(present, missing, surv.shape)
    apply_ = codec._matrix_for("repair", present, missing)
    kernel = rs_xor.gf_xor if rs.uses_xor(strategy, apply_.sched, surv.shape) \
        else rs_kernel.gf_apply
    before = kernel.launches
    warm = codec.reconstruct(surv, present, missing)
    assert codec.warm_hits == 1
    assert torch.equal(warm, cold) and torch.equal(warm, coded[:, :1])
    assert kernel.launches == before + 1
    pairs = torch.cat([coded[:, 2:3], coded[:, 5:6]], dim=1)
    codec.warm_fold(7, pairs.shape)
    assert torch.equal(codec.fold_symbol(pairs, 7), torch.from_numpy(
        regen.fold_symbol_pairs(pairs.cpu().numpy(), 7)).to(cuda_device))
    assert codec.warm_hits == 2


def test_codec_on_card_matches_cpu(cuda_device):
    data = rand((4, 4, 1000), seed=1)
    cpu = TorchCodec(4, 8, device="cpu")
    card = TorchCodec(4, 8, device=cuda_device)
    shards = card.encode(data)
    assert torch.equal(shards.cpu(), cpu.encode(data))
    present = (4, 5, 6, 7)
    assert torch.equal(card.decode_data(shards[:, 4:8], present).cpu(), data)
    assert torch.equal(card.reconstruct(shards[:, 8:], (8, 9, 10, 11)).cpu(),
                       shards[:, :8].cpu())


@pytest.mark.parametrize("limbs", [1, 2, 3, 4])
@pytest.mark.parametrize("sectors", [256, 255, 100, 1])
@pytest.mark.parametrize("blocks", [37, 1000, 1001])
def test_tag_and_prf_match_plain(cuda_device, limbs, sectors, blocks):
    """Block counts whose F x blocks is and is not a multiple of the 8
    blocks a warp takes, and block sizes that take the vector path (512
    bytes) and the byte path (510, 200 and 2 bytes, lanes idle past the
    end)."""
    params = podr2.Podr2Params(sectors=sectors, limbs=limbs)
    key = podr2.Podr2Key.generate(5, params, device=cuda_device)
    lanes = 2 * sectors
    ids = torch.randint(0, 1 << 32, (5, 2), dtype=torch.int64,
                        generator=torch.Generator().manual_seed(limbs))
    ids = ids.to(cuda_device)
    prf_lm = podr2_kernel.prf_blocks(key.prf_key, ids, None, blocks, limbs,
                                     limb_major=True)
    want = prf.prf_plain(key.prf_key, ids, torch.arange(
        blocks, device=cuda_device), limbs)
    assert torch.equal(prf_lm, want.transpose(1, 2).to(torch.int32))
    at = torch.tensor([3, 0, blocks - 1, 3], dtype=torch.int64,
                      device=cuda_device)
    assert torch.equal(podr2_kernel.prf_blocks(key.prf_key, ids, at, 4, limbs),
                       prf.prf_plain(key.prf_key, ids, at, limbs).to(torch.int32))
    data = rand((5, blocks, lanes), seed=limbs).to(cuda_device)
    assert torch.equal(
        podr2_kernel.podr2_tag(key.weights, prf_lm, data),
        podr2_kernel.podr2_tag_plain(key.weights, prf_lm, data))


def test_pipeline_on_card_matches_cpu(cuda_device):
    cfg = PipelineConfig(k=2, m=1, segment_size=64 * 1024)
    seg = rand((2, cfg.segment_size), seed=3)
    card = StoragePipeline(cfg, device=cuda_device)(seg.to(cuda_device))
    cpu = StoragePipeline(cfg, device="cpu")(seg)
    for name in ("fragments", "tags"):
        assert torch.equal(card[name].cpu(), cpu[name])


def test_xor_pipeline_on_card_matches_cpu(cuda_device):
    cfg = PipelineConfig(k=4, m=8, segment_size=64 * 1024, strategy="xor")
    seg = rand((2, cfg.segment_size), seed=4)
    before = rs_kernel.gf_apply.launches, rs_xor.gf_xor.launches
    card = StoragePipeline(cfg, device=cuda_device)(seg.to(cuda_device))
    assert rs_kernel.gf_apply.launches == before[0]
    assert rs_xor.gf_xor.launches == before[1] + 1
    cpu = StoragePipeline(cfg, device="cpu")(seg)
    for name in ("fragments", "tags"):
        assert torch.equal(card[name].cpu(), cpu[name])


def test_known_answer_on_card(cuda_device):
    assert kat.run_port(cuda_device) == (kat.DIGEST, True)


def test_known_answer_on_card_under_xor(cuda_device):
    assert kat.run_port(cuda_device, strategy="xor") == (kat.DIGEST, True)
