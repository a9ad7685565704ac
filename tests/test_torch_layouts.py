"""The layouts of the port's kernels, stated in torch and plain Python.

``gf_apply`` rebuilds the nibble tables as row-interleaved words in
shared memory; ``interleaved_tables`` below states that image and
``interleaved_apply`` the kernel's arithmetic on it (lookup addresses by
``__byte_perm``, 4 x 4 byte transposes, the byte path of ragged tails).
Both are held here byte-equal to ``gf_apply_plain`` and to the JAX
package's Pallas encode in interpret mode, and on the card
``tests/test_torch_kernels.py`` holds the kernel to ``interleaved_apply``.
``prf_blocks`` gives each CTA a tile of one fragment's blocks, sized by
``podr2_kernel.prf_grid`` (the launch the wrapper makes);
``prf_thread_map`` states which thread hashes which element, and the
tests below show every element is hashed exactly once. Inputs are made
with numpy from a seed.

The module imports neither jax nor ``cess_tpu`` at import time (the JAX
reference is imported where it is called), so the card's tests can take
the statements from here.
"""
import numpy as np
import pytest
import torch

from cess_tpu_torch.ops import gf, podr2_kernel, rs_kernel
from cess_tpu_torch.ops.rs_kernel import (GROUP_ROWS, TABLE_BLOCK,
                                          groups_per_pass, passes)

R_VALUES = (1, 2, 3, 4, 5, 8, 12)
Q_VALUES = (1, 2, 4, 10)


def interleaved_tables(tab: torch.Tensor) -> torch.Tensor:
    """The kernel's shared-memory image of tables [r, q, 2, 16]: int64
    words [passes, q, 2 (lo, hi), 2 (group), 16 (nibble)], where byte t
    of word [p, j, h, g, v] is ``tab[row, j, h, v]`` for row = (p * NG +
    g) * 4 + t, and 0 past r and in group slot 1 when NG = 1. Each (p, j)
    is one 256-byte block."""
    r, q = tab.shape[:2]
    ng, npass = groups_per_pass(r), passes(r)
    padded = torch.zeros((npass * ng * GROUP_ROWS, q, 2, 16),
                         dtype=torch.int64, device=tab.device)
    padded[:r] = tab.to(torch.int64)
    shifts = 8 * torch.arange(GROUP_ROWS, device=tab.device).view(
        1, 1, GROUP_ROWS, 1, 1, 1)
    words = (padded.view(npass, ng, GROUP_ROWS, q, 2, 16) << shifts).sum(2)
    image = torch.zeros((npass, q, 2, 2, 16), dtype=torch.int64,
                        device=tab.device)
    image[:, :, :, :ng] = words.permute(0, 2, 3, 1, 4)
    return image


def byte_perm(x, y, s: int):
    """CUDA's ``__byte_perm(x, y, s)`` on 32-bit words held in int64
    (tensors or ints): byte n of the result is byte ``(s >> 4n) & 7`` of
    the 8 bytes y:x."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = 0
    for n in range(4):
        out = out | (src[(s >> (4 * n)) & 7] << (8 * n))
    return out


def interleaved_apply(tab: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """[B, q, n] uint8 -> [B, r, n] uint8 as ``csrc/gf_apply.cu`` computes
    it from ``interleaved_tables(tab)``: the whole 16-byte chunks by the
    vector path (nibble times 4 placed in a block offset by one
    ``byte_perm``, one word lookup per group and nibble, 4 x 4 byte
    transposes), the tail by the byte path."""
    r, q = tab.shape[:2]
    b, _, n = data.shape
    smem = interleaved_tables(tab).reshape(-1)
    ng, npass = groups_per_pass(r), passes(r)
    hi_off, g_off = 128, 64                     # bytes, as in the kernel
    out = torch.zeros((b, r, n), dtype=torch.uint8, device=data.device)
    shifts = 8 * torch.arange(4, device=data.device)

    def lds(addr):
        return smem[addr >> 2]

    full = n // 16 * 16
    if full:
        chunks = full // 16
        words = (data[:, :, :full].to(torch.int64).view(b, q, chunks, 4, 4)
                 << shifts).sum(-1)                   # [b, q, chunk, k]
        for p in range(npass):
            acc = [[torch.zeros((b, chunks), dtype=torch.int64,
                                device=data.device) for _ in range(16)]
                   for _ in range(ng)]
            for j in range(q):
                base = (p * q + j) * TABLE_BLOCK
                for k in range(4):
                    w = words[:, j, :, k]
                    lo4 = (w << 2) & 0x3C3C3C3C
                    hi4 = (w >> 2) & 0x3C3C3C3C
                    for e in range(4):
                        a_lo = byte_perm(lo4, base, 0x7650 | e)
                        a_hi = byte_perm(hi4, base, 0x7650 | e)
                        for g in range(ng):
                            acc[g][4 * k + e] = acc[g][4 * k + e] ^ lds(
                                a_lo + g * g_off) ^ lds(a_hi + hi_off + g * g_off)
            for g in range(ng):
                row0 = (p * ng + g) * GROUP_ROWS
                o = [[None] * 4 for _ in range(GROUP_ROWS)]
                for k in range(4):
                    a = acc[g][4 * k:4 * k + 4]
                    lo01 = byte_perm(a[0], a[1], 0x5140)
                    hi01 = byte_perm(a[0], a[1], 0x7362)
                    lo23 = byte_perm(a[2], a[3], 0x5140)
                    hi23 = byte_perm(a[2], a[3], 0x7362)
                    o[0][k] = byte_perm(lo01, lo23, 0x5410)
                    o[1][k] = byte_perm(lo01, lo23, 0x7632)
                    o[2][k] = byte_perm(hi01, hi23, 0x5410)
                    o[3][k] = byte_perm(hi01, hi23, 0x7632)
                for t in range(GROUP_ROWS):
                    if row0 + t < r:
                        row = torch.stack(o[t], dim=-1)       # [b, chunk, k]
                        out[:, row0 + t, :full] = ((row[..., None] >> shifts)
                                                   & 0xFF).reshape(b, full)
    for e in range(full, n):
        x = data[:, :, e].to(torch.int64)                     # [b, q]
        for p in range(npass):
            acc = [torch.zeros(b, dtype=torch.int64, device=data.device)
                   for _ in range(ng)]
            for j in range(q):
                base = (p * q + j) * TABLE_BLOCK
                for g in range(ng):
                    acc[g] = acc[g] ^ lds(base + (x[:, j] & 15) * 4 + g * g_off) \
                        ^ lds(base + hi_off + (x[:, j] >> 4) * 4 + g * g_off)
            for g in range(ng):
                for t in range(GROUP_ROWS):
                    row = (p * ng + g) * GROUP_ROWS + t
                    if row < r:
                        out[:, row, e] = ((acc[g] >> (8 * t)) & 0xFF).to(torch.uint8)
    return out


def prf_thread_map(f: int, c: int, sms: int):
    """``prf_blocks``' thread -> (fragment, block) map for the launch
    ``prf_grid`` sizes: yields ``(cta, thread, tile, fragment, blocks)``
    for every tile a thread works on, with the blocks it hashes there, as
    the kernel's loops walk them (tiles ``cta, cta + grid, ...``; blocks
    ``t0 + thread, t0 + thread + threads, ...`` below the tile's end)."""
    threads = podr2_kernel.PRF_THREADS
    tile_blocks, grid = podr2_kernel.prf_grid(f, c, sms)
    tiles_per_f = -(-c // tile_blocks)
    for cta in range(grid):
        for tile in range(cta, f * tiles_per_f, grid):
            frag = tile // tiles_per_f
            t0 = (tile - frag * tiles_per_f) * tile_blocks
            t_end = min(t0 + tile_blocks, c)
            for thread in range(threads):
                if t0 + thread < t_end:
                    yield cta, thread, tile, frag, range(t0 + thread, t_end,
                                                         threads)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def jax_apply(mat, data):
    """The JAX package's GF apply: its Pallas kernel in interpret mode."""
    from cess_tpu.ops import gf as jgf
    from cess_tpu.ops.rs_pallas import apply_bitmatrix

    return np.asarray(apply_bitmatrix(jgf.expand_bitmatrix(mat), data,
                                      tile_n=512))


def check_apply(mat, n, seed):
    r, q = mat.shape
    tab = rs_kernel.tables(mat, "cpu")
    data = rand((2, q, n), seed)
    got = interleaved_apply(tab, torch.from_numpy(data))
    assert got.shape == (2, r, n) and got.dtype == torch.uint8
    assert torch.equal(got, rs_kernel.gf_apply_plain(tab, torch.from_numpy(data)))
    np.testing.assert_array_equal(got.numpy(), jax_apply(mat, data))


@pytest.mark.parametrize("q", Q_VALUES)
@pytest.mark.parametrize("r", R_VALUES)
def test_interleaved_apply_matches_plain_and_jax(r, q):
    """n = 83: five whole 16-byte chunks (vector path) and a 3-byte tail
    (byte path)."""
    check_apply(gf.cauchy_parity_matrix(q, r), 83, seed=16 * r + q)


@pytest.mark.parametrize("name,mat", [
    ("decode_4_8_from_parity", gf.decode_matrix(4, 8, (4, 5, 6, 7))),
    ("repair_2_1", gf.repair_matrix(2, 1, (1, 2), (0,))),
    ("symbol_fold_213", np.array([[1, 213]], dtype=np.uint8)),
    ("parity_2_1", gf.cauchy_parity_matrix(2, 1)),
])
@pytest.mark.parametrize("n", [16, 64, 5])
def test_interleaved_apply_on_codec_matrices(name, mat, n):
    check_apply(mat, n, seed=n)


@pytest.mark.parametrize("r,q", [(1, 2), (3, 4), (5, 2), (8, 4), (12, 10)])
def test_interleaved_table_words(r, q):
    """Byte t of word [p, j, h, g, v] is the product table entry of row
    (p * NG + g) * 4 + t; rows past r and the unused group slot are 0;
    the image is table_smem_bytes(r, q) bytes."""
    mat = gf.cauchy_parity_matrix(q, r)
    tab = rs_kernel.tables(mat, "cpu")
    image = interleaved_tables(tab)
    ng = groups_per_pass(r)
    npass = passes(r)
    assert image.shape == (npass, q, 2, 2, 16)
    assert image.numel() * 4 == rs_kernel.table_smem_bytes(r, q)
    mul = gf.mul_table()
    for p in range(npass):
        for j in range(q):
            for h in range(2):
                for g in range(2):
                    for v in range(16):
                        word = int(image[p, j, h, g, v])
                        for t in range(4):
                            row = (p * ng + g) * 4 + t
                            want = 0
                            if g < ng and row < r:
                                want = int(mul[mat[row, j], v << (4 * h)])
                            assert (word >> (8 * t)) & 0xFF == want


def test_byte_perm_matches_cuda_semantics():
    x, y = 0x33221100, 0x77665544
    assert byte_perm(x, y, 0x3210) == x
    assert byte_perm(x, y, 0x7654) == y
    assert byte_perm(x, y, 0x5140) == 0x55114400
    assert byte_perm(x, 0x1200, 0x7652) == 0x00001222
    # the lookup address: byte 0 from the nibble word, bytes 1..3 from
    # the 256-aligned block offset
    assert byte_perm(0x3C280400, 0x2300, 0x7650 | 2) == 0x2328


def test_split_over_output_rows_fits_shared_memory():
    """Every launch's image fits 227 KB; a step is a multiple of 8 rows;
    RS(64, 64) is one launch and RS(128, 128) three."""
    for q in range(1, 257):
        step = rs_kernel.rows_per_launch(q)
        assert step % 8 == 0 and step > 0
        assert rs_kernel.table_smem_bytes(step, q) <= rs_kernel.SMEM_BYTES
        assert rs_kernel.table_smem_bytes(step + 8, q) > rs_kernel.SMEM_BYTES
        for r in (1, 3, 4, 5):
            assert rs_kernel.table_smem_bytes(r, q) <= rs_kernel.SMEM_BYTES
    assert -(-64 // rs_kernel.rows_per_launch(64)) == 1
    assert -(-128 // rs_kernel.rows_per_launch(128)) == 3
    assert rs_kernel.table_smem_bytes(8, 4) == 4 * 256
    assert rs_kernel.table_smem_bytes(1, 2) == 2 * 256


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("f,c", [(1, 16384), (96, 753), (5, 1), (3, 1000),
                                 (96, 16384)])
def test_prf_thread_map_covers_every_element_once(f, c, sms):
    """Every (fragment, block) is hashed by exactly one thread; a tile
    holds blocks of one fragment, consecutive threads take consecutive
    blocks, and a thread takes at most 8 blocks a tile (8 on the main
    path's 96 x 16384 on an H100's 132 SMs, 1 on the small launches)."""
    seen = np.zeros((f, c), dtype=np.int64)
    tile_blocks, grid = podr2_kernel.prf_grid(f, c, sms)
    threads = podr2_kernel.PRF_THREADS
    per_thread = tile_blocks // threads
    assert grid <= sms * podr2_kernel.PRF_CTAS_PER_SM
    tile_frag = {}
    for cta, thread, tile, frag, blocks in prf_thread_map(f, c, sms):
        assert 0 <= cta < grid and 0 <= thread < threads
        assert 1 <= len(blocks) <= per_thread
        assert tile_frag.setdefault(tile, frag) == frag
        assert blocks[0] % tile_blocks == thread
        assert all(b // tile_blocks == blocks[0] // tile_blocks
                   for b in blocks)
        seen[frag, list(blocks)] += 1
    assert (seen == 1).all()
    # every CTA of the grid has a tile
    assert len({tile % grid for tile in tile_frag}) == grid
    if sms == 132:
        assert per_thread == {(1, 16384): 1, (96, 753): 1, (5, 1): 1,
                              (3, 1000): 1, (96, 16384): 8}[f, c]
