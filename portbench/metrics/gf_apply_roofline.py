"""``gf_apply_roofline.<kind>``: the ``gf_apply`` calls of the operations
in the profiled slice, held to the card's peaks (``roofline``) against
the ``gf_apply`` kernels' device time. An upload encodes [segments, k,
n] into the k systematic and m parity rows; a cell of another kind finds
nothing to read here."""
from portbench import roofline


def read(run):
    if run.kind != "upload" or run.trace is None:
        return None
    c = run.config
    k, m, n = c["k"], c["m"], c["segment_size"] // c["k"]
    calls = [roofline.gf_apply(r["segments"], k, m, n, True)
             for r in run.slice_records if r["ok"]]
    return roofline.share(calls, run.trace.port_kernel_s.get("gf_apply", 0))
