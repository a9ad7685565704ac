"""The readers of ``upload_batch``'s stages on synthetic runs: the three
stage shares of the upload wall and the card's idle time inside the hash
stage, each with its exact value, and None wherever a run holds nothing
for it (no trace, another kind, a program whose upload clocks no such
stage).

    python -m pytest -q portbench/tests
"""
import pytest

from portbench import devtrace, harness

STAGE_READERS = {"offchain.upload_pad_pct": "pad_s",
                 "offchain.upload_h2d_pct": "encode.h2d_s",
                 "offchain.upload_d2h_pct": "fetch.copy_s"}
IDLE_HASH = "device.idle_hash_pct.upload"


def read(name, run):
    return harness.metric_reader(name)(run)


def rec(t0, t1, profiled=False, staged=True, ok=True, **clocks):
    r = {"t0": t0, "t1": t1, "ok": ok, "profiled": profiled,
         "fetch_s": 0.0, "hash_s": 0.0}
    if staged:
        r.update({"pad_s": 0.0, "encode.h2d_s": 0.0, "fetch.copy_s": 0.0})
    r.update({k.replace("__", ".") + "_s": v for k, v in clocks.items()})
    return r


def ev(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X",
            "args": args}


def slice_trace():
    """A 10 ms slice, microseconds: one upload whose pad (0-1000), hash
    (5000-8000) and finish (9500-10000) leave the card idle, the copies
    and kernels busy from 1000 to 5000 and again 8000-9500 (the tags)."""
    return devtrace.DeviceTrace([
        ev(devtrace.SLICE, "user_annotation", 0, 10000),
        ev("portbench:upload", "user_annotation", 0, 10000),
        ev("offchain.upload.pad", "user_annotation", 0, 1000),
        ev("offchain.upload.encode", "user_annotation", 1000, 1500),
        ev("offchain.upload.encode.h2d", "user_annotation", 1000, 1400),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1000, 1500),
        ev("void gf_apply_kernel<1>(unsigned char const*)", "kernel",
           2500, 500),
        ev("offchain.upload.fetch", "user_annotation", 2500, 2500),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 3000, 2000,
           bytes=4_000_000),
        ev("offchain.upload.hash", "user_annotation", 5000, 3000),
        ev("offchain.upload.tag", "user_annotation", 8000, 1500),
        ev("void podr2_tag_kernel<2>(int)", "kernel", 8000, 1500),
        ev("offchain.upload.finish", "user_annotation", 9500, 500),
    ])


def upload_run(records, trace=None, kind="upload"):
    return harness.Run("rs21.upload", kind, {}, records, trace)


@pytest.mark.parametrize("name,field", sorted(STAGE_READERS.items()))
def test_stage_share_of_the_wall(name, field):
    key = field[:-2].replace(".", "__")
    records = [rec(0.0, 2.0, **{key: 0.5}), rec(2.0, 3.0, **{key: 0.25}),
               # the profiled slice's and a failed upload are left out
               rec(3.0, 4.0, profiled=True, **{key: 1.0}),
               rec(4.0, 4.5, ok=False, **{key: 0.5})]
    assert read(name, upload_run(records)) == pytest.approx(
        100.0 * 0.75 / 3.0)
    # the same with a trace: the host clocks are read all the same
    assert read(name, upload_run(records, slice_trace())) == \
        pytest.approx(25.0)


@pytest.mark.parametrize("name", sorted(STAGE_READERS))
def test_stage_share_reads_none_where_there_is_nothing(name):
    assert read(name, upload_run([])) is None
    assert read(name, upload_run([rec(0, 1)], kind="repair")) is None
    # a program whose upload clocks no such stage (the records of the
    # stages "encode", "fetch", "hash" and "tag" alone)
    assert read(name, upload_run([rec(0, 1, staged=False),
                                  rec(1, 2, staged=False)])) is None
    assert read(name, upload_run([rec(0, 1, profiled=True)])) is None


def test_idle_in_the_hash_stage():
    t = slice_trace()
    # idle: pad 1000, hash 3000, finish 500 us, each gap named after
    # the innermost range at its midpoint
    assert t.idle_gaps == [
        ("offchain.upload.hash", pytest.approx(3e-3)),
        ("offchain.upload.pad", pytest.approx(1e-3)),
        ("offchain.upload.finish", pytest.approx(5e-4))]
    run = upload_run([rec(0, 1, profiled=True)], t)
    assert read(IDLE_HASH, run) == pytest.approx(30.0)
    # the other readers of the slice still read it
    assert harness.metric_reader("device.idle_pct.upload")(run) == \
        pytest.approx(45.0)


def test_idle_in_the_hash_stage_reads_none_where_there_is_nothing():
    t = slice_trace()
    assert read(IDLE_HASH, upload_run([rec(0, 1, profiled=True)])) is None
    assert read(IDLE_HASH, upload_run([rec(0, 1, profiled=True)], t,
                                      kind="repair")) is None
    # a program that opens no stage range: its gaps bear the harness's
    # name, and its records no "pad_s"
    bare = devtrace.DeviceTrace([
        ev(devtrace.SLICE, "user_annotation", 0, 1000),
        ev("portbench:upload", "user_annotation", 0, 1000),
        ev("void gf_apply_kernel<1>(unsigned char const*)", "kernel",
           100, 100)])
    assert read(IDLE_HASH, upload_run([rec(0, 1, profiled=True,
                                           staged=False)], bare)) is None
    # a staged program whose hash never leaves the card idle reads 0
    busy = devtrace.DeviceTrace([
        ev(devtrace.SLICE, "user_annotation", 0, 1000),
        ev("offchain.upload.hash", "user_annotation", 0, 1000),
        ev("void gf_apply_kernel<1>(unsigned char const*)", "kernel",
           0, 1000)])
    assert read(IDLE_HASH, upload_run([rec(0, 1, profiled=True)],
                                      busy)) == 0.0
