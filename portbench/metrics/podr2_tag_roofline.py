"""``podr2_tag_roofline``: the uploads' tags in the profiled slice, one
``podr2_tag`` over every fragment of a file, held to the card's peaks
(``roofline``) against the ``podr2_tag`` kernels' device time. Moves
``upload_GiBps``."""
from portbench import roofline


def read(run):
    if run.kind != "upload" or run.trace is None:
        return None
    c = run.config
    blocks = c["segment_size"] // c["k"] // c["block_bytes"]
    calls = [roofline.podr2_tag(r["segments"] * (c["k"] + c["m"]), blocks,
                                c["block_bytes"], c["limbs"])
             for r in run.slice_records if r["ok"]]
    return roofline.share(calls, run.trace.port_kernel_s.get("podr2_tag", 0))
