"""``offchain.upload_hash_pct``: the share of the uploads' wall that
``upload_batch``'s "hash" stage clock holds (sha256 identities and ids on
the host), over the operations outside the profiled slice. Moves
``upload_GiBps``."""


def read(run):
    recs = [r for r in run.host_records if run.kind == "upload" and r["ok"]]
    wall = sum(r["t1"] - r["t0"] for r in recs)
    return 100.0 * sum(r["hash_s"] for r in recs) / wall if wall else None
