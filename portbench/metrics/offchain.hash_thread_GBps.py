"""``offchain.hash_thread_GBps``: the rate of one hashing thread (GB/s,
10^9 bytes): the bytes the uploads that returned outside the profiled
slice handed their hash tasks (each segment, its data rows 1..k-1 and
its m parity rows, from the run's configuration) over Σ ``hash.busy``.
Moves ``upload_GiBps``. Records without ``hash.busy_s`` read None."""
from portbench import hashpool


def read(run):
    recs = hashpool.records(run)
    if recs is None:
        return None
    busy = sum(r["hash.busy_s"] for r in recs)
    hashed = sum(hashpool.hashed_bytes(run.config, r["segments"])
                 for r in recs)
    return hashed / busy / 1e9 if busy else None
