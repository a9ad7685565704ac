"""The port's native (C++) erasure codec (cess_tpu_torch.ops.rs_native)
against the reference's NativeCodec and the port's TorchCodec on the CPU.

Tolerance 0: fragments are protocol facts. The port builds its own copy
of the C++ source into build/native/ (never the reference's library);
encode, reconstruct and decode_data are byte-equal to the reference's
NativeCodec and to ``TorchCodec(k, m, "cpu")`` at RS(2,1), RS(4,8) and
RS(16,16), on 1 and 4 threads.
"""
import numpy as np
import pytest
import torch

from cess_tpu.ops import rs_native as jnative
from cess_tpu_torch import _build
from cess_tpu_torch.ops import rs_native
from cess_tpu_torch.ops.rs import TorchCodec, make_codec

GEOMETRIES = [(2, 1), (4, 8), (16, 16)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def erasure(k, m):
    missing = tuple(range(min(m, k)))
    present = tuple(i for i in range(k + m) if i not in missing)[:k]
    return present, missing


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_native_codec_matches_reference_and_torch(k, m, threads):
    rng = np.random.default_rng(k * 100 + m + threads)
    data = rng.integers(0, 256, (3, k, 1031), dtype=np.uint8)   # odd n
    nat = rs_native.NativeCodec(k, m, threads=threads)
    ref = jnative.NativeCodec(k, m, threads=threads)
    tc = TorchCodec(k, m, "cpu")
    coded = nat.encode(data)
    assert coded.dtype == np.uint8 and coded.shape == (3, k + m, 1031)
    assert np.array_equal(coded, ref.encode(data))
    assert np.array_equal(coded, tc.encode(torch.from_numpy(data)).numpy())
    assert np.array_equal(nat.parity, ref.parity)
    present, missing = erasure(k, m)
    surv = coded[:, list(present)]
    rec = nat.reconstruct(surv, present, missing)
    assert np.array_equal(rec, coded[:, list(missing)])
    assert np.array_equal(rec, ref.reconstruct(surv, present, missing))
    assert np.array_equal(rec, tc.reconstruct(torch.from_numpy(surv),
                                              present, missing).numpy())
    assert np.array_equal(nat.reconstruct(surv, present),
                          ref.reconstruct(surv, present))
    dec = nat.decode_data(surv, present)
    assert np.array_equal(dec, data)
    assert np.array_equal(dec, ref.decode_data(surv, present))
    assert np.array_equal(dec, tc.decode_data(torch.from_numpy(surv),
                                              present).numpy())


def test_threads_match_single():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (8, 4, 4096), dtype=np.uint8)
    one = rs_native.NativeCodec(4, 8, threads=1).encode(data)
    assert np.array_equal(one, rs_native.NativeCodec(4, 8, threads=4)
                          .encode(data))
    assert np.array_equal(one[:, :4], data)


def test_make_codec_native_gate():
    codec = make_codec(4, 8, "native")
    assert isinstance(codec, rs_native.NativeCodec) and codec.threads == 1
    data = np.random.default_rng(3).integers(0, 256, (4, 512), np.uint8)
    assert np.array_equal(codec.encode(data),
                          make_codec(4, 8, "cpu").encode(
                              torch.from_numpy(data)).numpy())


def test_shard_row_mismatch_and_geometry_refusals():
    nat = rs_native.NativeCodec(4, 8)
    with pytest.raises(ValueError, match="shard rows"):
        rs_native.apply_matrix(nat.parity, np.zeros((3, 16), dtype=np.uint8))
    with pytest.raises(ValueError, match="data shards"):
        nat.encode(np.zeros((3, 16), dtype=np.uint8))
    with pytest.raises(ValueError, match="invalid RS geometry"):
        rs_native.NativeCodec(200, 100)


def test_library_is_the_ports_own_build():
    path = _build.host_library_path(_build.NATIVE_DIR / "rs_native.cpp")
    assert rs_native._LIB._name == str(path)
    assert path.parent == _build.HOST_BUILD_DIR
    assert rs_native.simd_level() == jnative.simd_level()


def test_failed_build_raises_not_implemented(monkeypatch, tmp_path):
    """A library that cannot be built is ImportError at import and
    NotImplementedError at the gate, as in the reference."""
    import importlib
    import sys

    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path)   # no source here
    with pytest.raises(ImportError, match="cannot build native codec"):
        rs_native._load()
    monkeypatch.delitem(sys.modules, "cess_tpu_torch.ops.rs_native")
    make_codec.cache_clear()
    try:
        with pytest.raises(NotImplementedError, match="native"):
            make_codec(2, 1, "native")
    finally:
        make_codec.cache_clear()
        monkeypatch.undo()
        importlib.import_module("cess_tpu_torch.ops.rs_native")


def test_concurrent_first_builds_make_one_library(tmp_path):
    """Several processes building at once (test workers importing the
    module together) wait on one lock and leave one library and no
    partial file."""
    import subprocess
    import sys

    code = ("import sys\n"
            "from pathlib import Path\n"
            "from cess_tpu_torch import _build\n"
            "_build.HOST_BUILD_DIR = Path(sys.argv[1])\n"
            "print(_build.build_host('rs_native'))\n")
    repo = str(_build.NATIVE_DIR.parent.parent)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=repo, stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1 and outs[0].startswith(str(tmp_path))
    assert [p.name for p in tmp_path.glob("*.so")] == [outs[0].split("/")[-1]]
    assert not list(tmp_path.glob("*.tmp"))
