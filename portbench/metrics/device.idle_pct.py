"""``device.idle_pct.<kind>``: the share of the profiled slice in which
no kernel, copy or fill ran on the card (one minus the union of their
intervals). One reader for every cell; ``BENCHMARK.json`` splits the
metric by the end-to-end metric each kind of cell reports (``upload``:
``upload_GiBps``; ``repair``: ``repair_p95_ms``)."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct
