"""``device.d2h_GBps.<kind>``: the device-to-host bytes of the profiled
slice over the time their copies took on the card (10^9 bytes a
second)."""


def read(run):
    if run.trace is None or not run.trace.d2h_s:
        return None
    return run.trace.d2h_bytes / run.trace.d2h_s / 1e9
