"""Systematic RS(k, m) erasure codec over GF(2^8) on torch tensors.

The counterpart of ``cess_tpu/ops/rs.py``'s ``TPUCodec`` and its
``make_codec`` gate. Every encode, reconstruct and decode is one GF
matrix apply (``MatrixApply``) under the codec's strategy:

- ``"gather"``, ``"bitmatrix"`` and ``"pallas"``, the TPU package's three
  dense lowerings, all run the port's one dense lowering, kernel
  ``gf_apply`` (split nibble tables, ``rs_kernel``). The default is
  ``"gather"`` on the CPU and ``"pallas"`` on the card, the names the TPU
  package picks for the same backends;
- ``"xor"`` runs the matrix's compiled XOR schedule, kernel ``gf_xor``
  (``rs_xor``);
- ``"auto"`` holds both and picks per dispatch shape with the TPU
  package's cost model (``xor_sched.estimate`` over the rows bucket), so
  the same shape takes the same executor in both packages and
  ``program_meta`` agrees byte for byte. Results never depend on the
  choice.

A CUDA tensor goes to the kernels, a CPU tensor to their plain versions.
Decode and repair matrices are built on the host per erasure pattern
(``gf``) and staged on the codec's device once. ``warm_reconstruct``
prepares the repair of one pattern and shape ahead of time: on the card
a CUDA graph captured over static buffers, on the CPU a closure over the
staged matrix; ``reconstruct`` replays it on an exact match and counts
``warm_hits``. Shards are uint8 ``[..., rows, n]``; numpy inputs are
moved to the codec's device.

Fault seams (``resilience/faults.py``): ``rs.encode``, ``rs.reconstruct``
and ``rs.decode`` sit on ``TorchCodec`` (and so on ``RegenCodec``) only,
at the TPU package's positions. The CPU references the engine degrades
to (``rs_ref.ReferenceCodec``, ``regen.RegenReference``) carry none, so
a chaos plan failing the card's path leaves the breaker's fallback
clean.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import resolve_device
from ..resilience import faults
from . import gf, rs_xor, xor_sched
from .rs_kernel import gf_apply, tables

STRATEGIES = ("gather", "bitmatrix", "pallas", "xor", "auto")
KERNELS = (gf_apply, rs_xor.gf_xor)   # the wrappers a GF apply may launch


def default_strategy(device: torch.device) -> str:
    """The dense strategy's name for ``device``, as the TPU package names
    its default for the same backend."""
    return "gather" if device.type == "cpu" else "pallas"


def decide(sched: xor_sched.XorSchedule, shape) -> dict:
    """The cost model's verdict for data of ``shape`` [..., q, n]: the
    estimate over the rows bucket of its leading dimensions."""
    rows = 1
    for d in shape[:-2]:
        rows *= int(d)
    return xor_sched.estimate(sched.r8, sched.q8, sched.n_xors,
                              xor_sched.rows_bucket(rows))


def uses_xor(strategy: str, sched, shape) -> bool:
    """Whether a dispatch of ``shape`` runs the XOR schedule ``sched``:
    always under "xor", by the cost model under "auto"."""
    return strategy == "xor" or (
        strategy == "auto" and decide(sched, shape)["chosen"] == "xor")


class MatrixApply:
    """One GF matrix staged on a device and applied by a strategy: the
    nibble tables for ``gf_apply`` (dense and "auto"), the compiled XOR
    schedule with its op list on the device (``"xor"`` and "auto")."""

    def __init__(self, mat: np.ndarray, strategy: str, device: torch.device):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        self.mat = np.asarray(mat, dtype=np.uint8)
        self.strategy = strategy
        self.tables = None if strategy == "xor" else tables(self.mat, device)
        self.sched = self.ops = None
        if strategy in ("xor", "auto"):
            self.sched = xor_sched.compile_schedule(
                gf.expand_bitmatrix(self.mat))
            self.ops = rs_xor.stage_ops(self.sched, device)

    def cache_meta(self, shape) -> tuple:
        """The strategy that serves ``shape`` and the cost model's estimate,
        as the TPU package's program-cache key components; empty for the
        dense strategies."""
        if self.strategy == "auto":
            est = decide(self.sched, tuple(shape))
            return (("strategy", "auto:" + est["chosen"]),
                    ("dense_cost", est["dense_cost"]),
                    ("xor_cost", est["xor_cost"]),
                    ("n_xors", est["n_xors"]))
        if self.strategy == "xor":
            return (("strategy", "xor"),
                    ("n_xors", self.sched.n_xors),
                    ("dense_xors", self.sched.dense_xors))
        return ()

    def __call__(self, data: torch.Tensor, out: torch.Tensor | None = None,
                 sys_out: torch.Tensor | None = None) -> torch.Tensor:
        """[B, q, n] uint8 -> [B, r, n]; ``out``/``sys_out`` as for
        ``gf_apply``."""
        if data.shape[-2] != self.mat.shape[1]:
            raise ValueError(f"expected {self.mat.shape[1]} shard rows, got "
                             f"{data.shape[-2]}")
        if uses_xor(self.strategy, self.sched, data.shape):
            return rs_xor.gf_xor(self.sched, self.ops, data, out, sys_out)
        return gf_apply(self.tables, data, out, sys_out)


class _Graph:
    """A warm program on the card: ``fn`` captured in a CUDA graph over a
    static input buffer of ``shape`` and the static output it returns."""

    def __init__(self, fn, shape, device: torch.device):
        self.inp = torch.zeros(shape, dtype=torch.uint8, device=device)
        # one launch outside the capture loads the kernels and sets their
        # shared-memory attributes, so the capture holds launches only
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(self.inp)
        torch.cuda.current_stream(device).wait_stream(side)
        before = [w.captured for w in KERNELS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(self.inp)
        self.launches = [w.captured - c for w, c in zip(KERNELS, before)]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.inp.copy_(x)
        self.graph.replay()
        for w, c in zip(KERNELS, self.launches):
            w.launches += c
        return self.out.clone()


class TorchCodec:
    """Systematic RS(k, m): data rows first, then the Cauchy parity rows."""

    def __init__(self, k: int, m: int, device=None, strategy: str | None = None):
        if k < 1 or m < 0 or k + m > gf.FIELD:
            raise ValueError(f"invalid RS geometry k={k}, m={m}")
        self.k = k
        self.m = m
        self.device = resolve_device(device)
        self.strategy = strategy or default_strategy(self.device)
        self._parity = MatrixApply(gf.cauchy_parity_matrix(k, m),
                                   self.strategy, self.device)
        self._cache: dict[tuple, MatrixApply] = {}
        self._warm: dict[tuple, object] = {}     # warm repair programs
        self.warm_hits = 0

    def _shards(self, x, rows: int, what: str) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.device)
        if x.dtype != torch.uint8:
            raise TypeError(f"shards must be uint8, got {x.dtype}")
        if x.dim() < 2 or x.shape[-2] != rows:
            raise ValueError(f"expected {rows} {what} rows, got shape "
                             f"{tuple(x.shape)}")
        return x

    def _apply(self, apply_: MatrixApply, shards: torch.Tensor) -> torch.Tensor:
        *lead, q, n = shards.shape
        flat = shards.reshape(-1, q, n)
        if n > 1 and flat.stride(-1) != 1:
            flat = flat.contiguous()
        return apply_(flat).reshape(*lead, apply_.mat.shape[0], n)

    # -- encode -------------------------------------------------------------
    def encode_parity(self, data) -> torch.Tensor:
        """[..., k, n] uint8 -> [..., m, n] parity rows."""
        return self._apply(self._parity, self._shards(data, self.k, "data"))

    def encode(self, data) -> torch.Tensor:
        """[..., k, n] -> [..., k+m, n]: one kernel pass writes the
        systematic copy and the parity rows into one buffer."""
        faults.inject("rs.encode")
        data = self._shards(data, self.k, "data")
        *lead, k, n = data.shape
        flat = data.reshape(-1, k, n)
        if n > 1 and flat.stride(-1) != 1:
            flat = flat.contiguous()
        out = torch.empty((flat.shape[0], k + self.m, n), dtype=torch.uint8,
                          device=self.device)
        self._parity(flat, out=out[:, k:], sys_out=out[:, :k])
        return out.reshape(*lead, k + self.m, n)

    # -- decode -------------------------------------------------------------
    def _matrix(self, kind: str, present: tuple[int, ...],
                missing: tuple[int, ...]) -> np.ndarray:
        if kind == "decode":
            return gf.decode_matrix(self.k, self.m, present)
        return gf.repair_matrix(self.k, self.m, present, missing)

    def _matrix_for(self, kind: str, present: tuple[int, ...],
                    missing: tuple[int, ...] = ()) -> MatrixApply:
        key = (kind, present, missing)
        if key not in self._cache:
            self._cache[key] = MatrixApply(
                self._matrix(kind, present, missing), self.strategy,
                self.device)
        return self._cache[key]

    def _pattern(self, present, missing) -> tuple[tuple, tuple]:
        present = tuple(int(i) for i in present)
        if missing is None:
            missing = tuple(i for i in range(self.k + self.m)
                            if i not in present)
        return present, tuple(int(i) for i in missing)

    def _warm_program(self, key: tuple, apply_: MatrixApply, shape, device):
        """The warm program of ``key`` (built on first call) for inputs of
        exactly ``shape`` on the codec's device."""
        dev = self.device if device is None else resolve_device(device)
        if dev != self.device:
            raise ValueError(f"a codec on {self.device} cannot warm a "
                             f"program for {dev}")
        key = (*key, tuple(shape), dev)
        if key not in self._warm:
            fn = functools.partial(self._apply, apply_)
            self._warm[key] = fn if dev.type == "cpu" else _Graph(
                fn, tuple(shape), dev)
        return self._warm[key]

    def _warm_call(self, key: tuple, x: torch.Tensor):
        """Run the warm program of ``key`` for ``x`` and count a hit, or
        return None when none was warmed for its exact shape."""
        warm = self._warm.get((*key, tuple(x.shape), x.device))
        if warm is None:
            return None
        self.warm_hits += 1
        return warm(x)

    def warm_reconstruct(self, present, missing=None, shape=None, device=None):
        """Prepare the reconstruct of one erasure pattern for survivors of
        exactly ``shape``, e.g. (k, fragment_size): the repair matrix is
        built and staged now and, on the card, its apply is captured in a
        CUDA graph, so a later ``reconstruct`` of this pattern and shape
        copies the survivors in and replays. ``device`` defaults to the
        codec's own, the only one it can warm. Returns the program."""
        present, missing = self._pattern(present, missing)
        if shape is None:
            raise ValueError("warm_reconstruct needs the exact survivor "
                             "shape, e.g. (k, fragment_size)")
        return self._warm_program(
            (present, missing), self._matrix_for("repair", present, missing),
            shape, device)

    def reconstruct(self, survivors, present: tuple[int, ...],
                    missing: tuple[int, ...] | None = None) -> torch.Tensor:
        """Rows ``missing`` (default: every absent row) from any k
        survivors [..., k, n] ordered as ``present``; a warmed pattern and
        shape replays its warm program."""
        faults.inject("rs.reconstruct")
        present, missing = self._pattern(present, missing)
        survivors = self._shards(survivors, self.k, "survivor")
        out = self._warm_call((present, missing), survivors)
        if out is not None:
            return out
        return self._apply(self._matrix_for("repair", present, missing),
                           survivors)

    def decode_data(self, survivors, present: tuple[int, ...]) -> torch.Tensor:
        """The k data rows from any k survivors ordered as ``present``."""
        faults.inject("rs.decode")
        apply_ = self._matrix_for("decode", tuple(int(i) for i in present))
        return self._apply(apply_, self._shards(survivors, self.k, "survivor"))

    def program_meta(self, kind: str, present=(), missing=(),
                     shape=()) -> tuple:
        """Which strategy serves (kind, pattern, shape) and the cost
        model's estimate, exactly as ``TPUCodec.program_meta``: () unless
        the codec runs "xor" or "auto"."""
        if self.strategy not in ("xor", "auto"):
            return ()
        if kind == "encode":
            apply_ = self._parity
        else:
            apply_ = self._matrix_for(kind, tuple(present), tuple(missing))
        return apply_.cache_meta(tuple(shape))


@functools.lru_cache(maxsize=None)
def make_codec(k: int, m: int, backend: str | None = None,
               strategy: str | None = None):
    """The ``ErasureCodec`` gate: "cuda", or None and "auto" (the
    default), run on the card and raise when none is present; "cpu" is
    the explicit host choice; "regen" is the regenerating repair plane
    (``regen.RegenCodec``) on the card; "native" is the C++ host codec
    (``rs_native.NativeCodec``, numpy in and out), NotImplementedError
    when it cannot be built. ``strategy`` as for ``TorchCodec``."""
    if backend not in (None, "auto", "cpu", "cuda", "regen", "native"):
        raise ValueError(f"unknown ErasureCodec backend {backend!r}")
    if backend == "native":
        try:
            from .rs_native import NativeCodec
        except ImportError as e:
            raise NotImplementedError(
                "native (C++) ErasureCodec backend could not be built; "
                "use backend='cpu' or 'cuda'") from e
        return NativeCodec(k, m)
    if backend == "regen":
        from .regen import RegenCodec   # regen builds on this module

        return RegenCodec(k, m, strategy=strategy)
    return TorchCodec(k, m, device=None if backend == "auto" else backend,
                      strategy=strategy)
