"""The readers of the upload's hashing pool: the threads hashing, one
thread's rate and the share of the wall the hashes queued, each with its
exact value on synthetic runs of one client and of several, None
wherever a run holds nothing for it (no upload outside the profiled
slice, a program whose uploads clock no hash task), and a finite number in a traced run of
every cell on the CPU.

    python -m pytest -q portbench/tests
"""
import dataclasses
import math

import pytest

from cess_tpu_torch.models.pipeline import PipelineConfig
from cess_tpu_torch.node import offchain
from cess_tpu_torch.obs import trace
from portbench import data, hashpool, harness, program
from portbench.tests import test_portbench_engine, test_portbench_harness

THREADS, RATE = "offchain.hash_threads", "offchain.hash_thread_GBps"
QUEUE = "offchain.hash_queue_pct"
READERS = (THREADS, RATE, QUEUE)
SEG = 64 * 1024
CONFIG = {"k": 2, "m": 1, "segment_size": 1000}     # 2000 bytes a segment


def read(name, run):
    return harness.metric_reader(name)(run)


def rec(t0, t1, segments=1, queue=0.0, busy=0.0, profiled=False, ok=True,
        clocked=True):
    r = {"t0": t0, "t1": t1, "ok": ok, "profiled": profiled,
         "segments": segments, "hash_s": 0.0}
    if clocked:
        r.update({"hash.queue_s": queue, "hash.busy_s": busy})
    return r


def port_key():
    return program.podr2_key(*data.key_material(5, 256, 2), "cpu")


def run_of(records, kind="upload", config=CONFIG):
    return harness.Run("rs21.upload", kind, config, records)


ONE_CLIENT = [
    rec(0.0, 2.0, segments=2, queue=0.5, busy=6.0),
    rec(2.0, 3.0, segments=1, queue=0.25, busy=2.0),
    # the profiled slice's upload and a failed one are left out
    rec(3.0, 4.0, segments=9, queue=1.0, busy=8.0, profiled=True),
    rec(4.0, 4.5, segments=9, queue=0.5, busy=4.0, ok=False),
]
SHARED = [
    rec(0.0, 2.0, segments=2, queue=0.5, busy=6.0),
    rec(1.0, 3.0, segments=1, queue=0.25, busy=2.0),    # beside the first
    rec(3.0, 6.0, segments=9, queue=1.0, busy=8.0, profiled=True),
    rec(6.0, 7.0, segments=1, queue=0.0, busy=4.0),     # after the slice
    rec(6.5, 7.0, segments=1, queue=0.0, busy=0.0, ok=False),
]


@pytest.mark.parametrize("kind,records,want", [
    # 8 busy seconds over 3 s of wall; 3 segments of 2000 bytes
    ("upload", ONE_CLIENT, {THREADS: 8.0 / 3.0, RATE: 6000 / 8.0 / 1e9,
                            QUEUE: 100.0 * 0.75 / 3.0}),
    # 12 busy seconds over the 4 s in which a host upload ran (0-3, 6-7:
    # the slice's 3 s hold none); queued 0.75 of the uploads' 5 s
    ("upload_shared", SHARED, {THREADS: 12.0 / 4.0, RATE: 8000 / 12.0 / 1e9,
                               QUEUE: 100.0 * 0.75 / 5.0}),
], ids=["upload", "upload_shared"])
@pytest.mark.parametrize("name", READERS)
def test_reader_on_synthetic_runs(name, kind, records, want):
    assert read(name, run_of(records, kind)) == pytest.approx(want[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_where_there_is_nothing(name):
    unclocked = [rec(0.0, 1.0, clocked=False), rec(1.0, 2.0, clocked=False)]
    for kind in ("upload", "upload_shared"):
        assert read(name, run_of(unclocked, kind)) is None
        assert read(name, run_of([], kind)) is None
        assert read(name, run_of([rec(0.0, 1.0, busy=1.0, profiled=True)],
                                 kind)) is None
    # one upload without the clocks leaves the run unread
    assert read(name, run_of(ONE_CLIENT[:2] + unclocked[:1])) is None


def test_wall_is_the_union_of_the_uploads():
    assert hashpool.wall([]) == 0.0
    assert hashpool.wall([rec(0.0, 1.0), rec(1.0, 3.0)]) == 3.0
    assert hashpool.wall([rec(0.0, 4.0), rec(1.0, 2.0), rec(3.0, 5.0),
                          rec(7.0, 8.0)]) == 6.0


@pytest.mark.parametrize("k,m", [(2, 1), (4, 8)], ids=["rs21", "rs48"])
def test_hashed_bytes_equal_the_uploads_own_count(k, m):
    """The configuration's formula against the ``offchain.upload`` span's
    ``hashed_bytes``, the bytes ``_UploadHashes`` submits."""
    pipe = offchain.AgentPipeline(PipelineConfig(k=k, m=m, segment_size=SEG),
                                  podr2_key=port_key(), device="cpu")
    tracer = trace.Tracer()
    sizes = (1, SEG, 3 * SEG - 1000)
    with trace.armed(tracer):
        for size in sizes:
            offchain.upload_batch(pipe, bytes(size))
    attrs = [s["attrs"] for s in tracer.finished()
             if s["name"] == "offchain.upload"]
    config = {"k": k, "m": m, "segment_size": SEG}
    assert [a["hashed_bytes"] for a in attrs] == [
        hashpool.hashed_bytes(config, -(-size // SEG)) for size in sizes]


def cells():
    """Each cell of the benchmark at the size the CPU runs in a second."""
    return {"rs21.upload": test_portbench_harness.tiny(
                harness.load_cell("rs21.upload")),
            "rs48.upload": test_portbench_harness.tiny(
                harness.load_cell("rs48.upload")),
            "rs21_engine.upload4": test_portbench_engine.tiny()}


def unclocked_entries():
    """The program with uploads that clock no hash task, as before the
    pool's clocks."""
    def upload_batch(*args, **kwargs):
        up = offchain.upload_batch(*args, **kwargs)
        seconds = {k: v for k, v in up.seconds.items()
                   if k not in offchain.HASH_CLOCKS}
        return dataclasses.replace(up, seconds=seconds)

    return program.Entries(upload_batch)


@pytest.mark.parametrize("name", list(cells()))
def test_traced_cell_reads_the_pool_on_the_cpu(name):
    cell = cells()[name]
    assert all(name in m["workloads"] for m in cell.per_layer
               if m["name"] in READERS)
    r = harness.run_cell(cell, 2 ** 31 + 91, 2.0, True, "cpu")
    assert r["attempted"] > 0 and r["failed"] == 0, r
    got = {n: r["metrics"][n]["value"] for n in READERS}
    assert all(math.isfinite(v) and v > 0 for n, v in got.items()
               if n != QUEUE), got
    assert 0.0 <= got[QUEUE] < 100.0
    assert got[THREADS] <= offchain._HASH_THREADS
    bare = harness.run_cell(cell, 2 ** 31 + 91, 2.0, True, "cpu",
                            unclocked_entries())
    assert bare["attempted"] > 0 and bare["failed"] == 0, bare
    assert not set(READERS) & set(bare["metrics"])
