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

The host libraries (``native/*.cpp``: the CPU erasure codec and the
BLS12-381 backend) are built the same way by ``build_host``: one ``g++``
a source, into ``build/native/``, named by a hash of the source and the
flags, at first use, under a file lock so that concurrent first uses
build once, written to a per-process file and moved into place.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NATIVE_DIR = Path(__file__).resolve().parent / "native"
HOST_BUILD_DIR = BUILD_DIR.parent / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
ARCH_FLAGS = ("-march=native",)     # dropped on a retry, as the Makefile does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_log = ""             # nvcc's output (ptxas register and spill lines)


class KernelBuildError(RuntimeError):
    """The kernel library could not be compiled, linked or loaded."""


class HostBuildError(RuntimeError):
    """A host library of ``native/`` could not be compiled."""


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


def host_library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + ARCH_FLAGS).encode())
    h.update(source.name.encode())
    h.update(source.read_bytes())
    return HOST_BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """The host library of ``native/<name>.cpp``, compiled by ``g++``
    unless it exists: with ``-march=native`` first and without it if
    that fails. Raises :class:`HostBuildError`."""
    source = NATIVE_DIR / f"{name}.cpp"
    out = host_library_path(source)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise HostBuildError("g++ not found")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)    # released when the file closes
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        logs = []
        for flags in (CXX_FLAGS + ARCH_FLAGS, CXX_FLAGS):
            proc = subprocess.run([cxx, *flags, str(source), "-o", str(tmp)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode == 0:
                os.replace(tmp, out)
                return out
            logs.append(proc.stdout)
        tmp.unlink(missing_ok=True)
    raise HostBuildError(f"g++ failed on {source.name}:\n" + "".join(logs))
