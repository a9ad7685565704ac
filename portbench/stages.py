"""What the per-layer readers of ``upload_batch``'s stages share: the
share of the uploads' wall that one stage clock holds.

Each upload's record carries every key of ``Upload.seconds`` as
``<key>_s`` ("pad_s", "encode.h2d_s", "fetch.copy_s", ...). A program
whose upload clocks no such stage records no such key, and its run reads
None here.
"""


def wall_share(run, field: str):
    """Σ ``field`` over Σ wall (%) of the uploads that returned outside
    the profiled slice, or None where the run has none or no such
    field."""
    if run.kind != "upload":
        return None
    recs = [r for r in run.host_records if r["ok"]]
    if not recs or any(field not in r for r in recs):
        return None
    wall = sum(r["t1"] - r["t0"] for r in recs)
    return 100.0 * sum(r[field] for r in recs) / wall if wall else None
