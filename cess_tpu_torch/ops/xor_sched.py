"""XOR-schedule compiler for GF(2^8) codec matrices (host-side).

The dense lowerings apply the full (8r x 8q) GF(2) bitmatrix
(gf.expand_bitmatrix) to the data's bit-planes — every 1-bit costs an
op whether or not another output row already computed the same
subexpression. This module compiles that bitmatrix ONCE into a sparse
XOR program (arxiv 2108.02692: erasure-code matrix apply as a
program-optimization problem):

- greedy pairwise common-subexpression elimination (Paar's algorithm):
  repeatedly extract the pair of live terms shared by the most output
  rows, materialise it as one intermediate XOR, and substitute it into
  every row that contains both halves — until no pair of output rows
  shares >= 2 live terms;
- a topologically-ordered op list over a flat address space
  [inputs | scratch | outputs], with scratch slots assigned by
  liveness analysis (each intermediate is freed after its last read,
  slots are min-index-reused), so the executor's scratch high-water
  mark is bounded far below the intermediate count;
- a canonical serialized form (``XorSchedule.witness()``): compilation
  is a pure function of the matrix bytes — same matrix, byte-identical
  schedule, on every host, every time. No clock reads, no entropy, no
  dict-order dependence anywhere in this module.

The port's own copy of ``cess_tpu/ops/xor_sched.py`` (the port imports
nothing from that package). It must stay identical in what it
computes: the same bitmatrix gives the byte-identical ``witness()`` in
both packages, and ``estimate`` keeps the TPU package's constants, so
strategy="auto" picks the same executor for the same dispatch shape in
both. The executors live in ``rs_xor.py`` (kernel ``gf_xor`` and its
plain version); ``rs.py`` applies the cost model.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import heapq
import json

import numpy as np

# opcodes (serialized as the first element of each 4-tuple op)
OP_XOR = 0   # buf[dst] = buf[a] ^ buf[b]
OP_ACC = 1   # buf[dst] ^= buf[a]
OP_COPY = 2  # buf[dst] = buf[a]
OP_ZERO = 3  # buf[dst] = 0


@dataclasses.dataclass(frozen=True)
class XorSchedule:
    """A compiled XOR program for one (8r x 8q) GF(2) bitmatrix.

    ``ops`` is the topologically-ordered instruction list; operands
    are flat indices into [inputs 0..q8) | scratch q8..q8+n_scratch) |
    outputs q8+n_scratch..q8+n_scratch+r8). ``n_xors`` counts real
    XOR work (OP_XOR + OP_ACC); ``dense_xors`` is what the dense
    bitmatrix expansion pays (sum over rows of popcount-1);
    ``saving_frac`` = 1 - n_xors/dense_xors.
    """

    r8: int
    q8: int
    n_scratch: int
    ops: tuple[tuple[int, int, int, int], ...]
    n_xors: int
    dense_xors: int
    saving_frac: float
    matrix_sha256: str

    @property
    def out_base(self) -> int:
        return self.q8 + self.n_scratch

    def witness(self) -> bytes:
        """Canonical bytes: the same matrix always compiles to the
        byte-identical witness (pinned by tests/test_torch_xor.py)."""
        return json.dumps(
            {"v": 1, "r8": self.r8, "q8": self.q8,
             "scratch": self.n_scratch, "n_xors": self.n_xors,
             "dense_xors": self.dense_xors,
             "saving_frac": round(self.saving_frac, 6),
             "matrix_sha256": self.matrix_sha256,
             "ops": [list(op) for op in self.ops]},
            sort_keys=True, separators=(",", ":")).encode()

    def dump(self) -> dict:
        """Viewer-facing summary: op counts and scratch high-water."""
        counts = {"xor": 0, "acc": 0, "copy": 0, "zero": 0}
        names = {OP_XOR: "xor", OP_ACC: "acc",
                 OP_COPY: "copy", OP_ZERO: "zero"}
        for op in self.ops:
            counts[names[op[0]]] += 1
        return {"kind": "xor_schedule", "r8": self.r8, "q8": self.q8,
                "n_xors": self.n_xors, "dense_xors": self.dense_xors,
                "saving_frac": round(self.saving_frac, 6),
                "scratch_high_water": self.n_scratch,
                "op_counts": counts, "total_ops": len(self.ops),
                "matrix_sha256": self.matrix_sha256}


def _cse(rows: list[set[int]], q8: int):
    """Greedy pairwise CSE: returns (rows, parents) where ``parents``
    maps each new intermediate id (>= q8, creation order = topological
    order) to its (lo, hi) parent pair. Deterministic: the most-shared
    pair wins, ties to the lexicographically smallest pair."""
    parents: dict[int, tuple[int, int]] = {}
    next_id = q8
    while True:
        counts: dict[tuple[int, int], int] = {}
        for row in rows:
            terms = sorted(row)
            for x in range(len(terms)):
                for y in range(x + 1, len(terms)):
                    pair = (terms[x], terms[y])
                    counts[pair] = counts.get(pair, 0) + 1
        best, best_n = None, 1
        for pair in sorted(counts):
            n = counts[pair]
            if n > best_n:
                best, best_n = pair, n
        if best is None:
            return rows, parents
        a, b = best
        t = next_id
        next_id += 1
        parents[t] = (a, b)
        for row in rows:
            if a in row and b in row:
                row.discard(a)
                row.discard(b)
                row.add(t)


def _schedule(rows: list[set[int]], parents: dict[int, tuple[int, int]],
              q8: int, r8: int):
    """Linearize the DAG output-row by output-row with liveness-based
    scratch allocation. Returns (sym_ops, n_scratch) where operands
    are ("i", j) / ("s", slot) / ("o", i) symbols."""
    uses: dict[int, int] = {t: 0 for t in parents}
    for a, b in parents.values():
        for p in (a, b):
            if p in uses:
                uses[p] += 1
    for row in rows:
        for t in row:
            if t in uses:
                uses[t] += 1
    slot_of: dict[int, int] = {}
    free: list[int] = []
    high = 0
    computed: set[int] = set()
    ops: list[tuple[int, tuple, tuple, tuple]] = []

    def operand(t):
        return ("i", t) if t < q8 else ("s", slot_of[t])

    def consume(t):
        if t < q8:
            return
        uses[t] -= 1
        if uses[t] == 0:
            heapq.heappush(free, slot_of[t])

    def emit_term(t):
        nonlocal high
        stack = [t]
        while stack:
            cur = stack[-1]
            if cur < q8 or cur in computed:
                stack.pop()
                continue
            a, b = parents[cur]
            pending = [p for p in (a, b)
                       if p >= q8 and p not in computed]
            if pending:
                stack.extend(pending)
                continue
            stack.pop()
            srcs = (operand(a), operand(b))
            consume(a)
            consume(b)
            if free:
                slot = heapq.heappop(free)
            else:
                slot = high
                high += 1
            slot_of[cur] = slot
            ops.append((OP_XOR, ("s", slot), srcs[0], srcs[1]))
            computed.add(cur)

    nil = ("i", 0)
    for i, row in enumerate(rows):
        terms = sorted(row)
        for t in terms:
            emit_term(t)
        dst = ("o", i)
        if not terms:
            ops.append((OP_ZERO, dst, nil, nil))
        elif len(terms) == 1:
            ops.append((OP_COPY, dst, operand(terms[0]), nil))
            consume(terms[0])
        else:
            ops.append((OP_XOR, dst, operand(terms[0]),
                        operand(terms[1])))
            consume(terms[0])
            consume(terms[1])
            for t in terms[2:]:
                ops.append((OP_ACC, dst, operand(t), nil))
                consume(t)
    return ops, high


def _compile(shape: tuple[int, int], raw: bytes) -> XorSchedule:
    r8, q8 = shape
    bmat = np.frombuffer(raw, dtype=np.uint8).reshape(shape)
    rows = [set(np.flatnonzero(bmat[i]).tolist()) for i in range(r8)]
    dense_xors = sum(max(0, len(row) - 1) for row in rows)
    rows, parents = _cse(rows, q8)
    sym_ops, high = _schedule(rows, parents, q8, r8)
    n_scratch = max(high, 1)   # executors always carry >= 1 slot

    def flat(sym):
        space, idx = sym
        if space == "i":
            return idx
        if space == "s":
            return q8 + idx
        return q8 + n_scratch + idx

    ops = tuple((op, flat(dst), flat(a), flat(b))
                for op, dst, a, b in sym_ops)
    n_xors = sum(1 for op in ops if op[0] in (OP_XOR, OP_ACC))
    saving = 0.0 if dense_xors == 0 \
        else 1.0 - n_xors / dense_xors
    return XorSchedule(
        r8=r8, q8=q8, n_scratch=n_scratch, ops=ops,
        n_xors=n_xors, dense_xors=dense_xors, saving_frac=saving,
        matrix_sha256=hashlib.sha256(raw).hexdigest())


@functools.lru_cache(maxsize=128)
def _compile_cached(shape: tuple[int, int], raw: bytes) -> XorSchedule:
    return _compile(shape, raw)


def compile_schedule(bmat: np.ndarray) -> XorSchedule:
    """Compile an (8r x 8q) 0/1 bitmatrix (gf.expand_bitmatrix) into
    its canonical XOR schedule. Cached on the matrix bytes — the
    compiled program is immutable and shared."""
    bmat = np.ascontiguousarray(np.asarray(bmat, dtype=np.uint8))
    if bmat.ndim != 2 or bmat.shape[0] % 8 or bmat.shape[1] % 8:
        raise ValueError(f"expected an (8r x 8q) bitmatrix, "
                         f"got shape {bmat.shape}")
    return _compile_cached(bmat.shape, bmat.tobytes())


# ---------------------------------------------------------------------------
# Compile-time cost model (the strategy="auto" selector, rs.py)
# ---------------------------------------------------------------------------
# The constants model a TPU (matrix unit, vector unit, issue overhead), as
# in the TPU package: the port keeps them so that "auto" decides exactly
# as the TPU package does. Whether they choose well on an H100 is
# measured by chip_smoke.py, not assumed here.

#: MXU issue width: 128x128 MACs per step
_MXU_MACS = 16384.0
#: VPU issue width in uint32 lanes (8x128); the bit-sliced executor
#: packs 4 data bytes per lane
_VPU_LANES = 1024.0
#: per-instruction issue overhead relative to one lane-op, amortized
#: over the row bucket: the scheduled kernel streams n_xors distinct
#: vector instructions per tile where the dense path issues a handful
#: of fused ops
_OVERHEAD = 64.0


def rows_bucket(rows: int) -> int:
    """Next power-of-two row bucket (the engine's coalescing shape)."""
    b = 1
    while b < max(rows, 1):
        b *= 2
    return b


def estimate(r8: int, q8: int, n_xors: int, bucket: int) -> dict:
    """Dense-MXU vs scheduled-XOR cost per output byte-column, in
    arbitrary issue-slot units x 1e6 (ints, so the estimate can ride
    program-cache keys into the CompileLedger). Deterministic pure
    arithmetic — never a measurement."""
    r, q = r8 // 8, q8 // 8
    bucket = max(int(bucket), 1)
    # dense: the full bitmatrix rides the MXU (r8*q8 MACs per bit
    # column) plus VPU unpack/pack of every bit-plane
    dense = (r8 * q8) / _MXU_MACS + (16.0 * q + 15.0 * r) / _VPU_LANES
    dense += _OVERHEAD * (r + q) / bucket / _VPU_LANES
    # scheduled: n_xors full-lane u32 ops cover 4 bytes each, plus
    # shift/mask unpack and shift/or pack of the touched planes
    xor = (n_xors + 16.0 * q + 16.0 * r) / (4.0 * _VPU_LANES)
    xor += _OVERHEAD * n_xors / bucket / (4.0 * _VPU_LANES)
    chosen = "xor" if xor < dense else "dense"
    return {"chosen": chosen, "dense_cost": int(dense * 1e6),
            "xor_cost": int(xor * 1e6), "rows_bucket": bucket,
            "n_xors": n_xors}
