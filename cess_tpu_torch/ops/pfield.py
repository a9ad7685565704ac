"""Mersenne prime field F_p, p = 2^31 - 1, on torch tensors.

The card and the CPU both have 64-bit integers, so the port computes in
``int64`` and needs none of the 16-bit limb splitting the TPU package
does to stay inside 32-bit lanes: a product of two field elements is
below 2^62 and is reduced with one ``%``. Field elements are stored as
``int32`` tensors (every element is below 2^31); each function here
accepts int32 or int64 and returns int64. Raw 32-bit words (PRF
output, hash words) travel as int64 in [0, 2^32) — see ``u32``.
``psum_mod`` sums partials across the devices of a mesh axis, and across
processes through ``torch.distributed``.
"""
from __future__ import annotations

import torch

P = (1 << 31) - 1  # 2147483647, Mersenne prime M31
MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF
BYTES_PER_ELEM = 2


def u32(x: torch.Tensor) -> torch.Tensor:
    """The unsigned 32-bit value of each element as int64 (an int32
    tensor holding a uint32 bit pattern becomes its value in [0, 2^32))."""
    return x.to(torch.int64) & MASK32


def to_field(x: torch.Tensor) -> torch.Tensor:
    """Reduce unsigned 32-bit values into [0, p)."""
    x = u32(x)
    r = (x & P) + (x >> 31)
    return torch.where(r >= P, r - P, r)


def addmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for a, b in [0, p)."""
    return (a.to(torch.int64) + b.to(torch.int64)) % P


def submod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.int64) - b.to(torch.int64)) % P


def negmod(a: torch.Tensor) -> torch.Tensor:
    """-a mod p for a in [0, p)."""
    return (-a.to(torch.int64)) % P


def mulmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p for a, b in [0, p): the product is below 2^62."""
    return (a.to(torch.int64) * b.to(torch.int64)) % P


def mulmod_u16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p for a in [0, 2^16), b in [0, p). The TPU package
    splits b into 16-bit limbs here to stay inside 32-bit lanes; in int64
    the product is below 2^47 and this is ``mulmod``."""
    return mulmod(a, b)


def dot_u16_deferred(m: torch.Tensor, b: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """sum_j m_j * b_j mod p for m in [0, 2^16), b in [0, p), over a dim
    of at most 256 terms: the TPU package's deferred-reduction dot, whose
    bound this keeps. In int64 it is ``dotmod``."""
    n = m.shape[dim]
    if n > 256:
        raise ValueError(f"deferred dot bound: dim size {n} > 256")
    return dotmod(m, b, dim=dim)


def rotk(x: torch.Tensor, k: int) -> torch.Tensor:
    """x * 2^k mod p for x in [0, p), 0 <= k < 31: a 31-bit rotation."""
    x = x.to(torch.int64)
    if k == 0:
        return x
    return ((x << k) & P) | (x >> (31 - k))


def summod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exact modular sum along a dim of values in [0, p): the int64 sum
    of up to 2^32 such terms cannot overflow."""
    return x.to(torch.int64).sum(dim=dim) % P


def dotmod(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Modular dot product sum_i a_i * b_i along a dim (broadcasting)."""
    return summod(mulmod(a, b), dim=dim)


def psum_mod(parts, group=None) -> torch.Tensor:
    """Exact modular sum of same-shaped partials in [0, p) across a mesh
    axis: the counterpart of the TPU package's ``psum_mod``.

    ``parts``: this process's partials, which may lie on several devices;
    they are gathered to the first one's device and summed there as
    int64. ``group``: a ``torch.distributed`` process group whose other
    members hold the axis's other partials; the int64 sum is then
    ``all_reduce``d (SUM) over it. The result, ``% P``, is int64 on the
    first partial's device, on every member of the group.

    The TPU package splits each value into 16-bit limbs so that its
    uint32 psums cannot overflow. Here no split is needed: an int64 sum
    of fewer than 2^32 values below 2^31 stays below 2^63, and the
    result is the same field element."""
    parts = list(parts)
    dev = parts[0].device
    total = torch.stack([p.to(dev, torch.int64) for p in parts]).sum(dim=0)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total % P


def powmod(a: int, e: int) -> int:
    """Host-side scalar power mod p."""
    return pow(int(a), int(e), P)


def invmod(a: int) -> int:
    if int(a) % P == 0:
        raise ZeroDivisionError("inverse of 0 in F_p")
    return pow(int(a), P - 2, P)


def pack_bytes(data: torch.Tensor, width: int = BYTES_PER_ELEM) -> torch.Tensor:
    """uint8 [..., width*L] -> int64 field elements [..., L], little-endian."""
    *lead, n = data.shape
    if n % width:
        raise ValueError(f"byte length {n} not divisible by {width}")
    if not 1 <= width <= 3:  # width 4 would not embed into [0, p)
        raise ValueError(f"element width {width} not in 1..3")
    d = data.reshape(*lead, n // width, width).to(torch.int64)
    out = d[..., 0]
    for i in range(1, width):
        out = out | (d[..., i] << (8 * i))
    return out


def unpack_bytes(elems: torch.Tensor, width: int = BYTES_PER_ELEM) -> torch.Tensor:
    """Inverse of pack_bytes: elements below 2^(8*width) -> uint8."""
    e = elems.to(torch.int64)
    parts = torch.stack([(e >> (8 * i)) & 0xFF for i in range(width)], dim=-1)
    return parts.reshape(*e.shape[:-1], e.shape[-1] * width).to(torch.uint8)
