"""The yardstick's arithmetic: the kernels' bounds from their shapes, the
idle union of a device trace and the end-to-end statistics, on synthetic
inputs.

    python -m pytest -q portbench/tests
"""
import pytest

from portbench import devtrace, e2e, roofline

MIB = 1 << 20


def ms(call) -> float:
    return roofline.seconds(*call) * 1e3


def test_bounds_of_the_main_path():
    # the bounds PERF.md's kernel table gives at the main path's shapes:
    # RS(2,1) [32, 2, 8 MiB] and RS(4,8) [32, 4, 4 MiB] encodes; tags and
    # PRF of 96 fragments of 16384 blocks in 2 limbs
    assert ms(roofline.gf_apply(32, 2, 1, 8 * MIB, True)) == \
        pytest.approx(0.4006, abs=5e-5)
    assert ms(roofline.gf_apply(32, 4, 8, 4 * MIB, True)) == \
        pytest.approx(0.6410, abs=5e-5)
    assert ms(roofline.gf_xor(32, 4, 8, 4 * MIB, True)) == \
        pytest.approx(0.6410, abs=5e-5)
    assert ms(roofline.podr2_tag(96, 16384, 512, 2)) == \
        pytest.approx(0.2479, abs=5e-5)
    assert ms(roofline.prf_blocks(96, 16384, 2, False)) == \
        pytest.approx(0.0111, abs=5e-5)
    b, o = roofline.prf_blocks(96, 16384, 2, False)
    assert o / roofline.INT_OPS_PER_S > b / roofline.HBM_BYTES_PER_S
    assert roofline.INT_OPS_PER_S == pytest.approx(33.45e12, rel=1e-3)


def test_repair_and_share():
    b, o = roofline.gf_apply(1, 4, 1, 4 * MIB, False)
    assert b == 5 * 4 * MIB and o == 2 * 4 * 4 * MIB
    least = roofline.seconds(b, o)
    assert roofline.share([(b, o)] * 2, 4 * least) == pytest.approx(50.0)
    assert roofline.share([(b, o)], 0.0) is None
    assert roofline.share([], 1.0) is None


def ev(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X",
            "args": args}


def test_idle_union_and_gaps():
    events = [
        ev(devtrace.SLICE, "user_annotation", 1000, 1000),
        ev("portbench:op", "user_annotation", 1000, 1000),
        ev("aten::copy_", "cpu_op", 1500, 300),
        # overlapping kernels count once; a copy and a fill are busy too
        ev("void gf_apply_kernel<1>(unsigned char const*)", "kernel",
           1100, 100),
        ev("void podr2_tag_kernel<2>(int)", "kernel", 1150, 100),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1400, 50,
           bytes=5_000_000),
        ev("Memset (Device)", "gpu_memset", 1900, 20),
        # outside the slice: not counted
        ev("void prf_blocks_kernel(int)", "kernel", 2500, 100),
    ]
    t = devtrace.DeviceTrace(events)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((150 + 50 + 20) * 1e-6)
    assert t.idle_pct == pytest.approx(78.0)
    assert t.port_kernel_s == {"gf_apply": pytest.approx(1e-4),
                               "podr2_tag": pytest.approx(1e-4)}
    assert len(t.kernels) == 2
    assert t.d2h_bytes == 5_000_000 and t.d2h_s == pytest.approx(5e-5)
    # the longest gap, 1450-1900 us, falls in the aten::copy_ range
    assert [(n, round(s * 1e6)) for n, s in t.idle_gaps] == [
        ("aten::copy_", 450), ("portbench:op", 150), ("portbench:op", 100),
        ("portbench:op", 80)]
    assert sum(s for _, s in t.idle_gaps) == pytest.approx(
        t.window_s - t.busy_s)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] in ("gf_apply_kernel", "podr2_tag_kernel")
    assert len(bd["idle_gaps"]) <= 10


def test_merged_and_gaps():
    spans = devtrace.merged([(5, 7), (1, 3), (2, 4), (7, 8)])
    assert spans == [[1, 4], [5, 8]]
    assert devtrace.covered(spans, 0, 10) == 6
    assert devtrace.gaps(spans, 0, 10) == [(0, 1), (4, 5), (8, 10)]
    assert devtrace.gaps([], 0, 2) == [(0, 2)]


def test_window_statistics():
    recs = [{"t1": t, "n": 1} for t in (1.0, 2.0, 3.0, 9.9, 10.5)]
    done = e2e.in_window(recs, 10.0)
    assert len(done) == 4
    assert e2e.rate(done, "n", 10.0) == pytest.approx(0.4)
    vals = list(range(1, 101))
    assert e2e.percentile(vals, 95) == 95
    assert e2e.percentile([3.0], 95) == 3.0
    assert e2e.percentile([5, 1, 4, 2, 3], 50) == 3
    assert e2e.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)
