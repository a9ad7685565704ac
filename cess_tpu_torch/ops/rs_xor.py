"""GF(2^8) matrix apply by a compiled XOR schedule: kernel ``gf_xor``
and its plain version.

The counterpart of ``cess_tpu/ops/rs_xor.py``. The data stay packed:
four consecutive bytes form one 32-bit lane, and bit-plane b of byte
row j is ``(row_j >> b) & 0x01010101``, the information bit of every
byte at bit 0 of its byte lane. Every op of the schedule
(``xor_sched.compile_schedule``) is then one full-lane XOR covering four
bytes, and output plane a of row i is or-ed back as ``plane << a``. No
op mixes bit positions across byte lanes, so the result is exactly the
GF matrix apply of ``rs_kernel.gf_apply``.

- ``xor_apply_plain(sched, data)``: the plain version in torch, the
  counterpart of the TPU package's ``_apply_jnp``. Lanes are int32
  (CPU torch has no uint32 arithmetic): an arithmetic right shift by at
  most 7 followed by ``& 0x01010101`` reads the same bits as a logical
  one, and ``view(torch.uint8)`` is little-endian like JAX's bitcast.
  It walks the lane axis in chunks and keeps one value per address, so
  a scratch slot's old value is freed when the schedule reuses the slot.
- ``gf_xor(sched, ops, data, out=None, sys_out=None)``: a CUDA tensor
  goes to the kernel in ``csrc/gf_xor.cu``, a CPU tensor to the plain
  version. ``ops`` is the op list staged on the device once
  (``stage_ops``). ``out`` and ``sys_out`` follow ``gf_apply``'s
  strided-view contract. ``gf_xor.launches`` counts kernel launches.
- ``apply_schedule(sched, data)``: [..., q, n] uint8, any n.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .rs_kernel import SMEM_BYTES, check_view, count_launch
from .xor_sched import OP_ACC, OP_COPY, OP_XOR, XorSchedule

MASK = 0x01010101                  # bit 0 of each packed byte
MAX_THREADS = 256                  # lanes (threads) a kernel block holds
MIN_THREADS = 32
PLAIN_LANES = 1 << 20              # lanes of all batch rows a plain chunk holds

_C = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.library().gf_xor
        f.argtypes = [_C, _I, _C, _C, _C, _I, _I, _I, _I, _LL, _LL, _LL,
                      _LL, _LL, _LL, _LL, _I, _I, _C]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def words(sched: XorSchedule) -> int:
    """32-bit words of one lane's address space: inputs, scratch, outputs."""
    return sched.q8 + sched.n_scratch + sched.r8


def smem_bytes(sched: XorSchedule, threads: int) -> int:
    """Shared memory of one kernel block: the address spaces of its lanes
    and the op list with one spare op (``csrc/gf_xor.cu``)."""
    return words(sched) * threads * 4 + (len(sched.ops) + 1) * 8


def threads_for(sched: XorSchedule) -> int:
    """The kernel's lanes a block: the largest power of two <= 256 whose
    block fits the 227 KB of shared memory a block may use. Raises
    ``ValueError`` for a schedule that does not fit at 32."""
    t = MAX_THREADS
    while t >= MIN_THREADS:
        if smem_bytes(sched, t) <= SMEM_BYTES:
            return t
        t //= 2
    raise ValueError(
        f"XOR schedule of {words(sched)} words a lane and {len(sched.ops)} "
        f"ops needs {smem_bytes(sched, MIN_THREADS)} bytes of shared memory "
        f"at {MIN_THREADS} lanes a block; the kernel's limit is {SMEM_BYTES}")


def stage_ops(sched: XorSchedule, device) -> torch.Tensor:
    """The op list as a contiguous int16 [n_ops, 4] tensor (op, dst, a, b)
    on ``device``; the kernel reads each row as four uint16."""
    ops = np.asarray(sched.ops, dtype=np.int64).reshape(-1, 4)
    if ops.size and ops.max() >= 1 << 15:
        raise ValueError(f"XOR schedule addresses reach {ops.max()}, beyond "
                         "the kernel's 16-bit operands")
    return torch.from_numpy(ops.astype(np.int16)).to(device)


def _run(sched: XorSchedule, lanes: torch.Tensor) -> torch.Tensor:
    """int32 lanes [B, q, L] -> [B, r, L]: the schedule's ops in order,
    one value per address. Input planes are unpacked when first read."""
    q8, ob = sched.q8, sched.out_base
    vals: dict[int, torch.Tensor] = {}

    def get(i):
        v = vals.get(i)
        if v is None:
            if i >= q8:
                raise AssertionError(f"read before write at {i}")
            j, b = divmod(i, 8)
            v = vals[i] = (lanes[:, j] >> b) & MASK
        return v

    for op, d, a, b in sched.ops:
        if op == OP_XOR:
            v = get(a) ^ get(b)
        elif op == OP_ACC:
            v = get(d) ^ get(a)
        elif op == OP_COPY:
            v = get(a)
        else:
            v = torch.zeros_like(lanes[:, 0])
        vals[d] = v
    rows = []
    for i in range(sched.r8 // 8):
        word = vals[ob + 8 * i]
        for a in range(1, 8):
            word = word | (vals[ob + 8 * i + a] << a)
        rows.append(word)
    return torch.stack(rows, dim=1)


def xor_apply_plain(sched: XorSchedule, data: torch.Tensor) -> torch.Tensor:
    """[B, q, n] uint8 -> [B, r, n] uint8 by running the schedule on int32
    lanes, ``PLAIN_LANES`` lanes (over all batch rows) at a time."""
    b, q, n = data.shape
    r = sched.r8 // 8
    if q != sched.q8 // 8:
        raise ValueError(f"data rows {q} != schedule inputs {sched.q8 // 8}")
    n4 = -(-n // 4)
    padded = torch.zeros((b, q, 4 * n4), dtype=torch.uint8, device=data.device)
    padded[..., :n] = data
    lanes = padded.view(torch.int32)
    out = torch.zeros((b, r, n4), dtype=torch.int32, device=data.device)
    step = max(1, PLAIN_LANES // max(b, 1))
    if r:
        for s in range(0, n4, step):
            out[..., s:s + step] = _run(sched, lanes[..., s:s + step])
    return out.view(torch.uint8)[..., :n]


def gf_xor(sched: XorSchedule, ops: torch.Tensor | None, data: torch.Tensor,
           out: torch.Tensor | None = None,
           sys_out: torch.Tensor | None = None) -> torch.Tensor:
    """Apply ``sched`` to ``data`` [B, q, n] uint8, into ``out`` [B, r, n].

    ``ops`` is ``stage_ops(sched, data.device)`` (unused on the CPU).
    ``out`` and ``sys_out`` [B, q, n] may be strided views with unit
    stride along n, e.g. the parity and systematic rows of one [B, k+m, n]
    buffer; ``sys_out`` then receives a copy of ``data``. Returns ``out``."""
    if data.dim() != 3:
        raise ValueError(f"data must be [B, q, n], got {tuple(data.shape)}")
    q, r = sched.q8 // 8, sched.r8 // 8
    b, _, n = data.shape
    dev = data.device
    check_view(data, "data", (b, q, n), dev)
    if out is None:
        out = torch.empty((b, r, n), dtype=torch.uint8, device=dev)
    check_view(out, "out", (b, r, n), dev)
    if sys_out is not None:
        check_view(sys_out, "sys_out", (b, q, n), dev)
    if dev.type == "cpu":
        if r:
            out.copy_(xor_apply_plain(sched, data))
        if sys_out is not None:
            sys_out.copy_(data)
        return out
    if dev.type != "cuda":
        raise ValueError(f"gf_xor runs on cuda or cpu tensors, not {dev}")
    n_ops = len(sched.ops)
    if (ops is None or ops.dtype != torch.int16 or ops.device != dev
            or tuple(ops.shape) != (n_ops, 4) or not ops.is_contiguous()):
        raise ValueError(f"ops must be the schedule's contiguous int16 "
                         f"[{n_ops}, 4] op list on {dev} (stage_ops)")
    threads = threads_for(sched)
    if b == 0 or n == 0:
        return out
    views = [data, out] + ([sys_out] if sys_out is not None else [])
    vec = all(v.data_ptr() % 4 == 0 and all(s % 4 == 0 for s in v.stride()[:2])
              for v in views)
    sys_ptr = sys_out.data_ptr() if sys_out is not None else None
    sys_bs, sys_rs = sys_out.stride()[:2] if sys_out is not None else (0, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(ops.data_ptr(), n_ops, data.data_ptr(), out.data_ptr(),
                       sys_ptr, b, q, r, words(sched), n, data.stride(0),
                       data.stride(1), out.stride(0), out.stride(1), sys_bs,
                       sys_rs, threads, int(vec), stream)
    _build.check(rc, "gf_xor")
    count_launch(gf_xor)
    return out


gf_xor.launches = 0
gf_xor.captured = 0


def apply_schedule(sched: XorSchedule, data: torch.Tensor,
                   ops: torch.Tensor | None = None) -> torch.Tensor:
    """Apply a compiled schedule to [..., q, n] uint8 data on its device:
    [..., r, n] uint8. Any n: the kernel masks the ragged last lane and
    the plain version pads and strips it. ``ops`` defaults to staging
    the op list on the data's device now."""
    q, r = sched.q8 // 8, sched.r8 // 8
    *lead, q_in, n = data.shape
    if q_in != q:
        raise ValueError(f"data rows {q_in} != schedule inputs {q}")
    flat = data.reshape(-1, q, n)
    if n > 1 and flat.stride(-1) != 1:
        flat = flat.contiguous()
    if ops is None and data.device.type == "cuda":
        ops = stage_ops(sched, data.device)
    return gf_xor(sched, ops, flat).reshape(*lead, r, n)
