"""``offchain.upload_fetch_pct``: the share of the uploads' wall that
``upload_batch``'s own "fetch" stage clock holds (the wait for the encode
and the fragments' copy to the host), over the operations outside the
profiled slice. Moves ``upload_GiBps``."""


def read(run):
    recs = [r for r in run.host_records if run.kind == "upload" and r["ok"]]
    wall = sum(r["t1"] - r["t0"] for r in recs)
    return 100.0 * sum(r["fetch_s"] for r in recs) / wall if wall else None
