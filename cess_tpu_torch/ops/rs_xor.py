"""GF(2^8) matrix apply by a compiled XOR schedule: kernel ``gf_xor``
and its plain versions.

The counterpart of ``cess_tpu/ops/rs_xor.py``. Two bit-sliced layouts
run the same schedule (``xor_sched.compile_schedule``); XOR never mixes
bit positions, so both give exactly the GF matrix apply of
``rs_kernel.gf_apply``:

- the TPU package's 4-byte lanes: bit-plane b of byte row j is
  ``(row_j >> b) & 0x01010101`` on 32-bit lanes, output plane a is or-ed
  back as ``plane << a``. ``xor_apply_plain(sched, data)`` runs it in
  torch, the counterpart of the TPU package's ``_apply_jnp``. Lanes are
  int32 (CPU torch has no uint32 arithmetic): an arithmetic right shift
  by at most 7 followed by ``& 0x01010101`` reads the same bits as a
  logical one, and ``view(torch.uint8)`` is little-endian like JAX's
  bitcast. It walks the lane axis in chunks and keeps one value per
  address, so a scratch slot's old value is freed when it is reused.
- the kernel's 32-byte planes: ``planes32`` bit-transposes each row's 32
  consecutive bytes into 8 plane words (bit 8e + k of plane b is bit b
  of byte 4k + e), ``unplanes32`` undoes it, and ``xor_apply_sliced32``
  runs the staged op list (``stage_ops``: uniform ops in bundles of 4
  that read no result of their own bundle) on those planes, as
  ``csrc/gf_xor.cu`` does: one op covers 32 bytes.

- ``gf_xor(sched, ops, data, out=None, sys_out=None)``: a CUDA tensor
  goes to the kernel in ``csrc/gf_xor.cu``, a CPU tensor to
  ``xor_apply_plain``. ``ops`` is the op list staged on the device once
  (``stage_ops``). ``out`` and ``sys_out`` follow ``gf_apply``'s
  strided-view contract. ``gf_xor.launches`` counts kernel launches.
- ``apply_schedule(sched, data)``: [..., q, n] uint8, any n.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from .rs_kernel import SMEM_BYTES, check_view, count_launch
from .xor_sched import OP_ACC, OP_COPY, OP_XOR, XorSchedule

MASK = 0x01010101                  # bit 0 of each packed byte
GROUP = 32                         # bytes of a row one kernel thread takes
# the delta swaps of the 32-byte bit transpose: (shift, mask) per stage
SWAPS = ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F))
BUNDLE = 4                         # ops the kernel issues together
WINDOW = 64                        # unplaced ops the bundler looks over
MAX_THREADS = 256                  # threads a kernel block holds
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
        f.argtypes = [_C, _I, _C, _C, _C, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                      _LL, _LL, _LL, _LL, _I, _C]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def zero_slot(sched: XorSchedule) -> int:
    """The address past the outputs that the uniform op list reads as 0."""
    return sched.q8 + sched.n_scratch + sched.r8


def words(sched: XorSchedule) -> int:
    """32-bit words of one kernel thread's address space: inputs,
    scratch, outputs and the zero slot, rounded up to an odd count so
    that a warp's 32 threads, ``words`` apart, hit 32 distinct banks."""
    return (zero_slot(sched) + 1) | 1


def smem_bytes(sched: XorSchedule, threads: int) -> int:
    """Shared memory of one kernel block: the address spaces of its
    threads and the bundled op list with one spare bundle
    (``csrc/gf_xor.cu``)."""
    return words(sched) * threads * 4 + (len(bundled_ops(sched)) + BUNDLE) * 8


def threads_for(sched: XorSchedule) -> int:
    """The kernel's threads a block, each taking a 32-byte group of every
    row: the largest power of two <= 256 whose block fits the 227 KB of
    shared memory a block may use. Raises ``ValueError`` for a schedule
    that does not fit at 32."""
    t = MAX_THREADS
    while t >= MIN_THREADS:
        if smem_bytes(sched, t) <= SMEM_BYTES:
            return t
        t //= 2
    raise ValueError(
        f"XOR schedule of {words(sched)} words a thread and {len(sched.ops)} "
        f"ops needs {smem_bytes(sched, MIN_THREADS)} bytes of shared memory "
        f"at {MIN_THREADS} threads a block; the kernel's limit is {SMEM_BYTES}")


def uniform_ops(sched: XorSchedule) -> np.ndarray:
    """The schedule as int64 [n_ops, 3] (d, a, b): every op ``buf[d] =
    buf[a] ^ buf[b]``, ``zero_slot`` reading as 0 (ACC ``d ^= a`` is
    ``d ^ a``, COPY ``a ^ zero``, ZERO ``zero ^ zero``)."""
    z = zero_slot(sched)
    rows = []
    for op, d, a, b in sched.ops:
        if op == OP_XOR:
            rows.append((d, a, b))
        elif op == OP_ACC:
            rows.append((d, d, a))
        elif op == OP_COPY:
            rows.append((d, a, z))
        else:
            rows.append((d, z, z))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


@functools.lru_cache(maxsize=128)
def bundled_ops(sched: XorSchedule) -> np.ndarray:
    """``uniform_ops`` packed into bundles of ``BUNDLE`` ops, int64
    [n_bundles * BUNDLE, 3], read-only: the kernel runs a bundle as all
    its loads, then its stores in order, so no op may read the result of
    another op of its bundle. A greedy list schedule: an op joins the
    current bundle when the ops whose results it reads sit in earlier
    bundles and the ops that must store before it (earlier writers of its
    destination, earlier readers of the value it overwrites) are placed.
    Slots left over hold ``zero ^ zero`` into the zero slot, which
    changes nothing."""
    ops = uniform_ops(sched)
    z = zero_slot(sched)
    reads_from, stores_after = [], []   # per op: ops it must follow
    last_writer: dict[int, int] = {}
    readers: dict[int, list[int]] = {}
    for j, (d, a, b) in enumerate(ops.tolist()):
        srcs = [x for x in (a, b) if x != z]
        reads_from.append({last_writer[x] for x in srcs if x in last_writer})
        before = set(readers.get(d, ()))
        if d in last_writer:
            before.add(last_writer[d])
        before.discard(j)
        stores_after.append(before)
        for x in srcs:
            readers.setdefault(x, []).append(j)
        last_writer[d] = j
        readers[d] = []
    where = [-1] * len(ops)
    pending, rows = list(range(len(ops))), []
    while pending:
        here, rest = [], []
        for pos, j in enumerate(pending):
            if (len(here) < BUNDLE and pos < WINDOW
                    and all(0 <= where[p] < len(rows) for p in reads_from[j])
                    and all(where[p] >= 0 for p in stores_after[j])):
                where[j] = len(rows)
                here.append(j)
            else:
                rest.append(j)
        rows.append([ops[j].tolist() for j in here]
                    + [[z, z, z]] * (BUNDLE - len(here)))
        pending = rest
    out = np.asarray(rows, dtype=np.int64).reshape(-1, 3)
    out.setflags(write=False)
    return out


def stage_ops(sched: XorSchedule, device) -> torch.Tensor:
    """The bundled op list as a contiguous int16 [n_bundles * BUNDLE, 4]
    tensor of (d, a, b, 0) slots on ``device``; the kernel reads each row
    as four uint16."""
    bundled = bundled_ops(sched)
    ops = np.zeros((len(bundled), 4), dtype=np.int64)
    ops[:, :3] = bundled
    if ops.size and ops.max() >= 1 << 15:
        raise ValueError(f"XOR schedule addresses reach {ops.max()}, beyond "
                         "the kernel's 16-bit operands")
    return torch.from_numpy(ops.astype(np.int16)).to(device)


def _transpose(w: torch.Tensor) -> torch.Tensor:
    """int64 words [..., 8] (each below 2^32) -> [..., 8]: the kernel's
    three delta swaps, each exchanging bit j of the word index with bit j
    of the bit-in-byte index. Its own inverse."""
    for j, (s, m) in enumerate(SWAPS):
        v = w.reshape(*w.shape[:-1], 4 >> j, 2, s)
        x, y = v[..., 0, :], v[..., 1, :]
        t = ((x >> s) ^ y) & m
        w = torch.stack([x ^ (t << s), y ^ t], dim=-2).reshape(w.shape)
    return w


def planes32(data: torch.Tensor) -> torch.Tensor:
    """uint8 [..., n] -> int64 [..., 8, G] (G = ceil(n / 32), zero
    padded): plane b of group g holds bit b of byte 32g + 4k + e at bit
    8e + k, the kernel's layout."""
    *lead, n = data.shape
    g = -(-n // GROUP)
    padded = torch.zeros((*lead, g * GROUP), dtype=torch.int64,
                         device=data.device)
    padded[..., :n] = data
    b = padded.reshape(*lead, g, 8, 4)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    return _transpose(w).transpose(-1, -2)


def unplanes32(planes: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """int64 [..., 8, G] -> uint8 [..., n] (n defaults to 32 G): the
    inverse of ``planes32``."""
    w = _transpose(planes.transpose(-1, -2))
    b = torch.stack([(w >> (8 * e)) & 0xFF for e in range(4)], dim=-1)
    out = b.reshape(*planes.shape[:-2], -1).to(torch.uint8)
    return out if n is None else out[..., :n]


def xor_apply_sliced32(sched: XorSchedule, data: torch.Tensor) -> torch.Tensor:
    """[B, q, n] uint8 -> [B, r, n] uint8 the kernel's way: 32-byte
    planes, and ``stage_ops``'s bundled uniform op list over one buffer
    holding every address (inputs, scratch, outputs, zero), each bundle
    reading all its operands before it stores."""
    b, q, n = data.shape
    r = sched.r8 // 8
    if q != sched.q8 // 8:
        raise ValueError(f"data rows {q} != schedule inputs {sched.q8 // 8}")
    planes = planes32(data)                                  # [B, q, 8, G]
    g = planes.shape[-1]
    buf = torch.zeros((zero_slot(sched) + 1, b, g), dtype=torch.int64,
                      device=data.device)
    buf[:sched.q8] = planes.permute(1, 2, 0, 3).reshape(sched.q8, b, g)
    for bundle in stage_ops(sched, "cpu")[:, :3].reshape(-1, BUNDLE, 3):
        vals = [buf[a] ^ buf[c] for _, a, c in bundle.tolist()]
        for (d, _, _), v in zip(bundle.tolist(), vals):
            buf[d] = v
    out = buf[sched.out_base:sched.out_base + sched.r8]      # [r8, B, G]
    return unplanes32(out.reshape(r, 8, b, g).permute(2, 0, 1, 3), n)


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
    rows = len(bundled_ops(sched))
    if (ops is None or ops.dtype != torch.int16 or ops.device != dev
            or tuple(ops.shape) != (rows, 4) or not ops.is_contiguous()
            or ops.data_ptr() % 16):
        raise ValueError(f"ops must be the schedule's contiguous, 16-byte "
                         f"aligned int16 [{rows}, 4] op list on {dev} "
                         f"(stage_ops)")
    threads = threads_for(sched)
    if b == 0 or n == 0:
        return out
    sys_ptr = sys_out.data_ptr() if sys_out is not None else None
    sys_bs, sys_rs = sys_out.stride()[:2] if sys_out is not None else (0, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(ops.data_ptr(), rows // BUNDLE, data.data_ptr(),
                       out.data_ptr(),
                       sys_ptr, b, q, r, words(sched), zero_slot(sched), n,
                       data.stride(0), data.stride(1), out.stride(0),
                       out.stride(1), sys_bs, sys_rs, threads, stream)
    _build.check(rc, "gf_xor")
    count_launch(gf_xor)
    return out


gf_xor.launches = 0
gf_xor.captured = 0


def apply_schedule(sched: XorSchedule, data: torch.Tensor, *,
                   ops: torch.Tensor | None = None) -> torch.Tensor:
    """Apply a compiled schedule to [..., q, n] uint8 data on its device:
    [..., r, n] uint8. Any n: the kernel masks the ragged last group and
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
