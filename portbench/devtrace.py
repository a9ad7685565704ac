"""The profiled slice of a traced run: ``torch.profiler`` over whole
operations inside the window, read back as device intervals.

The slice is opened and closed between operations, after a synchronise,
so every kernel, copy and fill it records belongs to the operations it
spans. ``Slice.read`` turns the profiler's Chrome trace into the numbers
the per-layer readers take: each device operation's time by name, the
busy share of the slice (the union of kernel, copy and fill intervals),
the device-to-host copies' bytes and time, the kernels launched, and
the longest idle gaps named by what the host was doing in them.
"""
from __future__ import annotations

import collections
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "portbench:slice"
# the port's kernels by the names their __global__ functions carry
PORT_KERNEL = re.compile(r"\b(gf_apply|podr2_tag|prf_blocks|gf_xor)_kernel\b")


def op_name(name: str, width: int = 64) -> str:
    """A device event's name without return type, template and
    arguments."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name)[0].strip()[:width] or name[:width]


def merged(spans) -> list:
    """Sorted (start, end) spans merged where they overlap or touch."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(spans, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the merged ``spans`` cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in spans)


def gaps(spans, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that merged ``spans`` leave
    uncovered."""
    out, t = [], lo
    for s, e in spans:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class DeviceTrace:
    """The device side of one profiled slice (times in seconds)."""

    def __init__(self, events: list):
        window = [e for e in events if e["name"] == SLICE
                  and e.get("cat") == "user_annotation"]
        if len(window) != 1:
            raise RuntimeError(f"{len(window)} {SLICE} ranges in the trace")
        w0 = window[0]["ts"]
        w1 = w0 + window[0]["dur"]
        self.window_s = (w1 - w0) / 1e6
        device = [e for e in events if e.get("cat") in DEVICE_CATS
                  and w0 <= e["ts"] <= w1]
        busy = merged((e["ts"], e["ts"] + e["dur"]) for e in device)
        self.busy_s = covered(busy, w0, w1) / 1e6
        self.kernels = [e for e in device if e["cat"] == "kernel"]
        by_op = collections.defaultdict(float)
        for e in device:
            by_op[op_name(e["name"])] += e["dur"] / 1e6
        self.device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])
        self.port_kernel_s = collections.defaultdict(float)
        for e in self.kernels:
            m = PORT_KERNEL.search(e["name"])
            if m:
                self.port_kernel_s[m.group(1)] += e["dur"] / 1e6
        d2h = [e for e in device if e["cat"] == "gpu_memcpy"
               and "DtoH" in e["name"]]
        self.d2h_bytes = sum(int(e.get("args", {}).get("bytes", 0))
                             for e in d2h)
        self.d2h_s = sum(e["dur"] for e in d2h) / 1e6
        host = [e for e in events if e.get("cat") in ("cpu_op",
                                                      "user_annotation")
                and e["name"] != SLICE and e["ts"] < w1
                and e["ts"] + e.get("dur", 0) > w0]
        named = []
        for s, e in gaps(busy, w0, w1):
            mid = (s + e) / 2
            inside = [h for h in host if h["ts"] <= mid <= h["ts"] + h["dur"]]
            # the innermost range the host was in when the device idled
            what = min(inside, key=lambda h: h["dur"])["name"] if inside \
                else "between operations"
            named.append((op_name(what), (e - s) / 1e6))
        self.idle_gaps = sorted(named, key=lambda kv: -kv[1])

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


class Slice:
    """A ``torch.profiler`` window over whole operations, on the card."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._torch = torch
        kwargs = {}
        try:
            from torch._C._profiler import _ExperimentalConfig

            kwargs["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA], **kwargs)
        self._range = record_function(SLICE)

    def start(self) -> None:
        self._torch.cuda.synchronize()
        self._prof.__enter__()
        self._range.__enter__()

    def stop(self) -> None:
        self._torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def read(self) -> DeviceTrace:
        """The slice's device trace, through a Chrome trace written to
        and removed from ``TMPDIR``."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return DeviceTrace([e for e in events
                            if e.get("ph") == "X" and "dur" in e])


def warm_profiler() -> None:
    """Start and stop the profiler once around one device op, so the
    tracing library is loaded before the window (set-up)."""
    import torch

    s = Slice()
    s.start()
    torch.ones(1, device="cuda").add_(1)
    s.stop()
    s.read()
