"""``offchain.hash_queue_pct``: the share of the uploads' wall that
their "hash" stage spent before the last of their hash tasks started on
the pool, the tasks queued behind others: Σ ``hash.queue`` over Σ wall
(%) of the uploads that returned outside the profiled slice, in kinds
``upload`` and ``upload_shared`` alike. The rest of the "hash" stage
waits on tasks already running. Moves ``upload_GiBps``. Records without
``hash.queue_s`` read None."""
from portbench import hashpool


def read(run):
    recs = hashpool.records(run)
    if recs is None:
        return None
    wall = sum(r["t1"] - r["t0"] for r in recs)
    return 100.0 * sum(r["hash.queue_s"] for r in recs) / wall \
        if wall else None
