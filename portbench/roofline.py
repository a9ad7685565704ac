"""Bytes and operations of the port's kernels, from each call's shapes,
and the peaks of the card they are held against.

The work is the call's contract, whatever implements it: every input
byte is read once and every output byte written once, and the integer
operations are the algorithm's, not a kernel's. A share of the roofline
is the least time the card could take over the time the kernels took,
the least time being the larger of bytes over the memory peak and
operations over the integer peak.

Peaks (NVIDIA H100 SXM5 80 GB, at its 700 W limit):

- ``HBM_BYTES_PER_S``: 3.35 TB/s of HBM3, NVIDIA's data sheet.
- ``INT_OPS_PER_S``: 33.45 T 32-bit integer operations a second = 132
  SMs x 128 lanes a clock x 1.98 GHz. A Hopper SM's four schedulers each
  issue one 32-lane warp instruction a clock, and integer adds and
  multiply-adds also run as IMAD on the 128 FP32 lanes beside the 64
  INT32 ones, so 128 lanes a clock is the most any mix reaches; 1.98 GHz
  is the boost clock behind the data sheet's 67 TFLOP/s of FP32 (132 x
  128 x 2 x 1.98 GHz).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS, INT_LANES_PER_SM, BOOST_HZ = 132, 128, 1.98e9
INT_OPS_PER_S = SMS * INT_LANES_PER_SM * BOOST_HZ
# one threefry2x32 hash: 20 rounds of (add, rotate, xor) = 60, five key
# injections of 3 adds = 15, and the 4 additions of the key and counter
THREEFRY_OPS = 79


def seconds(nbytes: float, ops: float) -> float:
    """The least time of a call: its bytes or its operations at peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def gf_apply(b: int, q: int, r: int, n: int, systematic: bool) -> tuple:
    """(bytes, ops) of a GF(2^8) matrix apply [b, q, n] -> [b, r, n];
    ``systematic``: the input rows are also written out beside the
    result, as the encode does. Operations: one GF multiply and one XOR
    per output byte and input row."""
    out_rows = r + (q if systematic else 0)
    return b * q * n + b * out_rows * n, 2 * b * r * q * n


def gf_xor(b: int, q: int, r: int, n: int, systematic: bool) -> tuple:
    """The same apply by an XOR schedule: the same contract and work."""
    return gf_apply(b, q, r, n, systematic)


def prf_blocks(f: int, c: int, limbs: int, explicit: bool) -> tuple:
    """(bytes, ops) of the per-block PRF of f fragment ids at c blocks:
    ids in (and the c int64 block indices when ``explicit``), f*c*limbs
    field elements out; two id folds per fragment, then per block one
    block fold and one hash per limb."""
    nbytes = f * 16 + (c * 8 if explicit else 0) + f * c * limbs * 4
    return nbytes, (2 * f + f * c * (1 + limbs)) * THREEFRY_OPS


def podr2_tag(f: int, blocks: int, block_bytes: int, limbs: int) -> tuple:
    """(bytes, ops) of the PoDR2 tags of f fragments of ``blocks`` blocks:
    the fragments, the weights (limbs x 2*sectors words) and the PRF in,
    the tags out; one multiply and one add per byte and limb."""
    n = blocks * block_bytes
    words = f * blocks * limbs * 4
    return f * n + limbs * block_bytes * 4 + 2 * words, f * n * limbs * 2


KERNELS = {"gf_apply": gf_apply, "gf_xor": gf_xor,
           "prf_blocks": prf_blocks, "podr2_tag": podr2_tag}


def share(calls, kernel_s: float) -> float | None:
    """The roofline share in % of the ``calls`` [(bytes, ops), ...] whose
    kernels took ``kernel_s`` seconds on the device; None when there is
    no kernel time to hold them against."""
    if kernel_s <= 0 or not calls:
        return None
    return 100.0 * sum(seconds(b, o) for b, o in calls) / kernel_s
