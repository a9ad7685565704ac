"""PoDR2 tag generation and per-block PRF: kernels and plain versions.

The counterpart of ``cess_tpu/ops/podr2_pallas.py``, plus the device
PRF the TPU package takes from ``jax.random``:

- ``podr2_tag(w, prf, data)``: ``tag[f, b, l] = (prf[f, l, b] +
  sum_i byte[f, b, i] * w[l, i]) mod p`` from the raw fragment bytes
  and the interleaved weights of ``weight_table``;
- ``prf_blocks(prf_key, ids, blocks, n, limbs)``: the PRF
  ``f_k(id_f, b)`` of every fragment at every given block, in the
  limb-major layout ``podr2_tag`` reads or the protocol's block-major
  one.

A CUDA tensor goes to the kernels in ``csrc/podr2_tag.cu`` and
``csrc/prf_blocks.cu``; a CPU tensor to the plain versions. Each
wrapper counts its launches in ``.launches`` (``rs_kernel.count_launch``:
a launch captured in a CUDA graph counts in ``.captured``).
``prf_grid`` sizes every ``prf_blocks`` launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import pfield as pf
from . import prf as prf_mod
from .rs_kernel import count_launch

MAX_LANES = 512       # 2 * sectors: 16 bytes of a block for each lane of a warp
MAX_KERNEL_LIMBS = 4  # the tag kernel is instantiated for 1..4 limbs
PRF_THREADS = 256     # prf_blocks: threads a CTA (at most its launch bound)
PRF_PER_THREAD = 8    # most blocks a thread takes in one tile
PRF_CTAS_PER_SM = 8   # 2048 resident threads an SM

_C = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = {
    "podr2_tag": [_C, _C, _C, _C, _LL, _LL, _I, _I, _I, _C],
    "prf_blocks": [_C, _C, _C, _C, _LL, _LL, _I, _LL, _LL, _LL, _I, _LL, _LL,
                   _C],
}
_fns: dict = {}


def _kernel(name: str):
    if name not in _fns:
        f = getattr(_build.library(), name)
        f.argtypes = _ARGTYPES[name]
        f.restype = ctypes.c_int
        _fns[name] = f
    return _fns[name]


def supported(sectors: int, blocks: int) -> bool:
    """The tag kernel's shape envelope: any sectors in 1..256 and any
    block count (the Pallas kernel admitted only sectors == 256 and
    blocks that tile by 128)."""
    return 1 <= sectors <= MAX_LANES // 2 and blocks >= 0


def weight_table(alpha: torch.Tensor) -> torch.Tensor:
    """[limbs, 2*sectors] int32 interleaved weights of alpha [sectors,
    limbs]: ``W[l, 2j] = alpha[j, l]``, ``W[l, 2j+1] = 256 alpha[j, l]
    mod p``, so that ``sum_j m_j alpha_j = sum_i byte_i W_i`` for the
    little-endian elements ``m_j = byte_2j + 256 byte_2j+1``."""
    a = alpha.to(torch.int64).t()
    w = torch.empty((a.shape[0], 2 * a.shape[1]), dtype=torch.int64,
                    device=alpha.device)
    w[:, 0::2] = a
    w[:, 1::2] = (a * 256) % pf.P
    return w.to(torch.int32)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# -- kernel 2: tags --------------------------------------------------------


def podr2_tag_plain(w: torch.Tensor, prf: torch.Tensor,
                    data: torch.Tensor) -> torch.Tensor:
    """``(prf + sum_j elems[f, b, j] * alpha[j, l]) mod p`` in int64,
    with alpha the even columns of ``w``: elements are below 2^16 and
    alpha below 2^31, so 256 products sum below 2^55."""
    alpha = w[:, 0::2].t().to(torch.int64)                 # [sectors, limbs]
    elems = pf.pack_bytes(data)                            # [F, blocks, s]
    mac = (elems[..., None] * alpha).sum(dim=-2)           # [F, blocks, L]
    return ((mac + prf.to(torch.int64).transpose(1, 2)) % pf.P).to(torch.int32)


def podr2_tag(w: torch.Tensor, prf: torch.Tensor,
              data: torch.Tensor) -> torch.Tensor:
    """w [limbs, lanes] int32, prf [F, limbs, blocks] int32, data [F,
    blocks, lanes] uint8 -> tags [F, blocks, limbs] int32."""
    _require(data.dim() == 3 and data.dtype == torch.uint8,
             f"data must be uint8 [F, blocks, lanes], got {data.dtype} "
             f"{tuple(data.shape)}")
    f, blocks, lanes = data.shape
    limbs = w.shape[0]
    _require(w.dtype == torch.int32 and tuple(w.shape) == (limbs, lanes),
             f"weights must be int32 [limbs, {lanes}], got {w.dtype} "
             f"{tuple(w.shape)}")
    _require(prf.dtype == torch.int32
             and tuple(prf.shape) == (f, limbs, blocks),
             f"prf must be int32 [{f}, {limbs}, {blocks}], got {prf.dtype} "
             f"{tuple(prf.shape)}")
    _require(lanes % 2 == 0 and 0 < lanes <= MAX_LANES,
             f"block of {lanes} bytes outside 2..{MAX_LANES}")
    dev = data.device
    _require(w.device == dev and prf.device == dev,
             "weights, prf and data must share a device")
    if dev.type == "cpu":
        return podr2_tag_plain(w, prf, data)
    _require(dev.type == "cuda", f"podr2_tag runs on cuda or cpu, not {dev}")
    _require(1 <= limbs <= MAX_KERNEL_LIMBS,
             f"tag kernel takes 1..{MAX_KERNEL_LIMBS} limbs, got {limbs}")
    _require(data.is_contiguous() and w.is_contiguous()
             and prf.is_contiguous(), "podr2_tag needs contiguous inputs")
    out = torch.empty((f, blocks, limbs), dtype=torch.int32, device=dev)
    if f * blocks == 0:
        return out
    vec = lanes % 16 == 0 and data.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        rc = _kernel("podr2_tag")(data.data_ptr(), w.data_ptr(),
                                  prf.data_ptr(), out.data_ptr(), f, blocks,
                                  lanes, limbs, int(vec), _stream(dev))
    _build.check(rc, "podr2_tag")
    count_launch(podr2_tag)
    return out


podr2_tag.launches = 0
podr2_tag.captured = 0


# -- kernel 3: PRF ---------------------------------------------------------


def prf_grid(f: int, c: int, sms: int) -> tuple[int, int]:
    """(blocks a tile, CTAs) of a ``prf_blocks`` launch over F fragments
    x C blocks on a card with ``sms`` SMs. A tile holds one fragment's
    blocks; each of its ``PRF_THREADS`` threads takes up to 8 of them when
    the launch gives every SM a CTA of such threads, else 1, so that a
    small launch spreads over the card. The CTAs stride over the
    ``f * ceil(c / tile)`` tiles."""
    per_thread = (PRF_PER_THREAD
                  if f * c >= PRF_PER_THREAD * sms * PRF_THREADS else 1)
    tile = PRF_THREADS * per_thread
    return tile, min(f * -(-c // tile), sms * PRF_CTAS_PER_SM)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def prf_blocks(prf_key: torch.Tensor, ids: torch.Tensor,
               blocks: torch.Tensor | None, n: int, limbs: int,
               limb_major: bool = False) -> torch.Tensor:
    """f_k(id_f, b) for ids [F, 2] int64 (lo, hi words) at block indices
    ``blocks`` [n] int64, or at 0..n-1 when ``blocks`` is None.

    Returns int32 field elements [F, n, limbs], or [F, limbs, n] when
    ``limb_major``. The plain version is ``prf.prf_plain``."""
    _require(ids.dim() == 2 and ids.shape[1] == 2 and ids.dtype == torch.int64,
             f"ids must be int64 [F, 2], got {ids.dtype} {tuple(ids.shape)}")
    _require(prf_key.dtype == torch.int64 and tuple(prf_key.shape) == (2,),
             "prf_key must be int64 [2]")
    if blocks is not None:
        _require(blocks.dtype == torch.int64 and tuple(blocks.shape) == (n,),
                 f"blocks must be int64 [{n}]")
    dev = ids.device
    _require(prf_key.device == dev
             and (blocks is None or blocks.device == dev),
             "prf_key, ids and blocks must share a device")
    f = ids.shape[0]
    if dev.type == "cpu":
        idx = torch.arange(n, dtype=torch.int64) if blocks is None else blocks
        out = prf_mod.prf_plain(prf_key, ids, idx, limbs).to(torch.int32)
        return out.transpose(1, 2).contiguous() if limb_major else out
    _require(dev.type == "cuda", f"prf_blocks runs on cuda or cpu, not {dev}")
    ids = ids.contiguous()
    shape = (f, limbs, n) if limb_major else (f, n, limbs)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if f * n * limbs == 0:
        return out
    s_f = limbs * n
    s_c, s_l = (1, n) if limb_major else (limbs, 1)
    blocks = blocks.contiguous() if blocks is not None else None
    blk_ptr = blocks.data_ptr() if blocks is not None else None
    prf_key = prf_key.contiguous()
    tile, grid = prf_grid(f, n, _sm_count(out.get_device()))
    with torch.cuda.device(dev):
        rc = _kernel("prf_blocks")(prf_key.data_ptr(), ids.data_ptr(),
                                   blk_ptr, out.data_ptr(), f, n, limbs,
                                   s_f, s_c, s_l, PRF_THREADS, tile, grid,
                                   _stream(dev))
    _build.check(rc, "prf_blocks")
    count_launch(prf_blocks)
    return out


prf_blocks.launches = 0
prf_blocks.captured = 0
