"""GF(2^8) matrix apply: kernel ``gf_apply`` and its plain version.

The counterpart of ``cess_tpu/ops/rs_pallas.py``. ``gf_apply`` computes
``out[b, i, :] = XOR_j mat[i, j] * data[b, j, :]`` for any (r x q) GF
matrix given as its split nibble tables ``[r, q, 2, 16]`` (``lo`` then
``hi``, see ``gf.nibble_tables``). A CUDA tensor goes to the kernel in
``csrc/gf_apply.cu``; a CPU tensor goes to ``gf_apply_plain``, the
gather formulation in torch. ``gf_apply.launches`` counts kernel
launches (see ``count_launch``).

The kernel rebuilds the tables in shared memory as row-interleaved
32-bit words (byte t of a word is the product for output row 4g + t of
group g), so one lookup serves four output rows; the tests state that
image and the kernel's arithmetic on it in torch. The image takes
``table_smem_bytes(r, q)``, up to the 227 KB a block may use
(``SMEM_BYTES``); a larger matrix is applied by launches over slices of
``rows_per_launch(q)`` output rows, so every RS(k, m) with k + m <= 256
runs.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import gf

SMEM_BYTES = 232448   # 227 KB of shared memory a Hopper block may use
GROUP_ROWS = 4        # output rows in one table word
TABLE_BLOCK = 256     # bytes of one (pass, input row): [2 halves][2 groups][16] words

_C = ctypes.c_void_p
_LL = ctypes.c_longlong
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.library().gf_apply
        f.argtypes = [_C, _C, _C, _C, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                      ctypes.c_int, _C]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def tables(mat: np.ndarray, device) -> torch.Tensor:
    """The [r, q, 2, 16] uint8 nibble tables of a GF matrix on ``device``."""
    lo, hi = gf.nibble_tables(mat)
    return torch.from_numpy(np.ascontiguousarray(
        np.stack([lo, hi], axis=2))).to(device)


def gf_apply_plain(tab: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """[B, q, n] uint8 -> [B, r, n] uint8 by nibble-table gathers."""
    r, q = tab.shape[:2]
    d_lo = (data & 0x0F).to(torch.int64)
    d_hi = (data >> 4).to(torch.int64)
    acc = torch.zeros((r, *data.shape[:1], data.shape[-1]), dtype=torch.uint8,
                      device=data.device)
    for j in range(q):
        acc ^= tab[:, j, 0][:, d_lo[:, j]] ^ tab[:, j, 1][:, d_hi[:, j]]
    return acc.permute(1, 0, 2)


def groups_per_pass(r: int) -> int:
    """Row groups one kernel pass accumulates: 1 up to 4 rows, else 2."""
    return 1 if r <= GROUP_ROWS else 2


def passes(r: int) -> int:
    """Passes over the input of one launch of r output rows (at least 1,
    which also serves r = 0: the systematic copy)."""
    rows = groups_per_pass(r) * GROUP_ROWS
    return max(1, -(-r // rows))


def table_smem_bytes(r: int, q: int) -> int:
    """Shared memory of one launch: ceil(r / 8) * 8 * q * 32 bytes, and
    q * 256 for r <= 4."""
    return passes(r) * q * TABLE_BLOCK


def rows_per_launch(q: int) -> int:
    """Output rows a launch takes, a multiple of 8, so that its image
    fits ``SMEM_BYTES`` (RS(64, 64): 112, one launch; RS(128, 128): 56)."""
    return SMEM_BYTES // (max(q, 1) * TABLE_BLOCK) * 2 * GROUP_ROWS


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``.
    Inside a CUDA graph capture the kernel only enters the graph: it is
    counted in ``wrapper.captured`` instead, and each replay of the graph
    counts it as launched (``rs.py``'s warm programs)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def check_view(t: torch.Tensor, name: str, shape, device) -> None:
    """Raise unless ``t`` is a uint8 view of ``shape`` on ``device`` with
    unit stride along its last axis."""
    if t.dtype != torch.uint8:
        raise TypeError(f"{name} must be uint8, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} needs unit stride along its last axis")


def gf_apply(tab: torch.Tensor, data: torch.Tensor,
             out: torch.Tensor | None = None,
             sys_out: torch.Tensor | None = None) -> torch.Tensor:
    """Apply the GF matrix of ``tab`` [r, q, 2, 16] to ``data`` [B, q, n].

    ``out`` [B, r, n] and ``sys_out`` [B, q, n] may be strided views with
    unit stride along n, e.g. the parity and systematic rows of one
    [B, k+m, n] buffer; ``sys_out`` then receives a copy of ``data``.
    Returns ``out``."""
    if tab.dim() != 4 or tab.shape[2:] != (2, 16) or not tab.is_contiguous():
        raise ValueError(f"tables must be contiguous [r, q, 2, 16], got "
                         f"{tuple(tab.shape)}")
    if data.dim() != 3:
        raise ValueError(f"data must be [B, q, n], got {tuple(data.shape)}")
    r, q = tab.shape[:2]
    b, _, n = data.shape
    dev = data.device
    check_view(tab, "tables", tab.shape, dev)
    check_view(data, "data", (b, q, n), dev)
    if out is None:
        out = torch.empty((b, r, n), dtype=torch.uint8, device=dev)
    check_view(out, "out", (b, r, n), dev)
    if sys_out is not None:
        check_view(sys_out, "sys_out", (b, q, n), dev)
    if dev.type == "cpu":
        if r:
            out.copy_(gf_apply_plain(tab, data))
        if sys_out is not None:
            sys_out.copy_(data)
        return out
    if dev.type != "cuda":
        raise ValueError(f"gf_apply runs on cuda or cpu tensors, not {dev}")
    if b == 0 or n == 0:
        return out
    # output rows per launch: each launch's table image fits in shared memory
    step = rows_per_launch(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i0 in range(0, max(r, 1), step):
            _launch(tab[i0:i0 + step], data, out[:, i0:i0 + step],
                    sys_out if i0 == 0 else None, stream)
    return out


def _launch(tab, data, out, sys_out, stream) -> None:
    b, q, n = data.shape
    views = [data, out] + ([sys_out] if sys_out is not None else [])
    vec = all(v.data_ptr() % 16 == 0 and all(s % 16 == 0 for s in v.stride()[:2])
              for v in views)
    sys_ptr = sys_out.data_ptr() if sys_out is not None else None
    sys_bs, sys_rs = sys_out.stride()[:2] if sys_out is not None else (0, 0)
    rc = _kernel()(tab.data_ptr(), data.data_ptr(), out.data_ptr(), sys_ptr,
                   b, q, tab.shape[0], n, data.stride(0), data.stride(1),
                   out.stride(0), out.stride(1), sys_bs, sys_rs, int(vec),
                   stream)
    _build.check(rc, "gf_apply")
    count_launch(gf_apply)


gf_apply.launches = 0
gf_apply.captured = 0
