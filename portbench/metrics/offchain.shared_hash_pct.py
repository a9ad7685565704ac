"""``offchain.shared_hash_pct``: in a cell of several gateway clients
(kind ``upload_shared``), the share of the uploads' wall that
``upload_batch``'s "hash" stage clock holds (sha256 identities and ids
on the host, the clients' uploads sharing one hashing pool): Σ hash over
Σ wall of the uploads that returned outside the profiled slice. Moves
``upload_GiBps``. Kind ``upload`` reads the same clock as
``offchain.upload_hash_pct``; records without ``hash_s`` read None."""


def read(run):
    if run.kind != "upload_shared":
        return None
    recs = [r for r in run.host_records if r["ok"]]
    if not recs or any("hash_s" not in r for r in recs):
        return None
    wall = sum(r["t1"] - r["t0"] for r in recs)
    return 100.0 * sum(r["hash_s"] for r in recs) / wall if wall else None
