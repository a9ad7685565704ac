"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface. Each is compiled by
its own ``nvcc`` process (all started together) for ``sm_90a``, and the
objects are linked into one shared library under ``build/kernels/`` of
the checkout, named by a hash of the sources and flags: an unchanged
tree reuses the library, a changed one builds anew. The kernel modules
(``ops/rs_kernel.py``, ``ops/podr2_kernel.py``) set the ``argtypes`` of
the functions they call. A failed compile, link or load raises
:class:`KernelBuildError`, which the serving engine never absorbs into a
CPU fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_log = ""             # nvcc's output (ptxas register and spill lines)


class KernelBuildError(RuntimeError):
    """The kernel library could not be compiled, linked or loaded."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")


def sources(src_dir: Path = SRC_DIR) -> list[Path]:
    return sorted(Path(src_dir).glob("*.cu"))


def library_path(src_dir: Path = SRC_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(src_dir):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcess_kernels_{h.hexdigest()[:16]}.so"


def build(src_dir: Path = SRC_DIR) -> Path:
    """Compile and link the kernels of ``src_dir`` (this tree's by
    default; another checkout's to time its kernels beside these) unless
    their library exists."""
    global build_log
    out = library_path(src_dir)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = out.stem
    objs, procs = [], []
    for src in sources(src_dir):
        # per-process object names: concurrent first uses do not collide
        obj = BUILD_DIR / f"{stem}_{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode:
            failed.append(src.name)
    build_log = "".join(logs)
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        path = build()
        try:
            _lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C launcher reported a CUDA error."""
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
