"""``offchain.hash_threads``: the mean number of the hashing pool's
threads (8 on the card's host) running one of the uploads' hash tasks
while uploads run: Σ ``hash.busy`` over the wall of the uploads that
returned outside the profiled slice (the union of their [t0, t1]:
Σ(t1 - t0) in kind ``upload``). Near the pool's size, hashes queue
behind each other; well below it, the uploads wait on passes already
running. Moves ``upload_GiBps``. Records without ``hash.busy_s`` read
None."""
from portbench import hashpool


def read(run):
    recs = hashpool.records(run)
    if recs is None:
        return None
    wall = hashpool.wall(recs)
    return sum(r["hash.busy_s"] for r in recs) / wall if wall else None
