"""What the readers of the upload's hashing pool share.

Each upload's record carries ``Upload.seconds``' pool clocks as
``hash.queue_s`` (the part of the "hash" stage before the last of the
upload's hash tasks started) and ``hash.busy_s`` (the worker-seconds its
hash tasks ran). A program whose upload clocks no such thing records no
such key, and its run reads None here.
"""

FIELDS = ("hash.queue_s", "hash.busy_s")


def records(run):
    """The uploads that returned outside the profiled slice, or None where
    the run has none or one of them lacks the pool's clocks."""
    recs = [r for r in run.host_records if r["ok"]]
    if not recs or any(f not in r for r in recs for f in FIELDS):
        return None
    return recs


def wall(recs) -> float:
    """The seconds in which at least one of ``recs`` ran: the union of
    their [t0, t1]. Σ(t1 - t0) for one client's uploads, one after
    another; with several clients the stretch from the first ``t0`` to
    the last ``t1``, less the profiled slice, where no upload of
    ``recs`` runs."""
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted((r["t0"], r["t1"]) for r in recs):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def hashed_bytes(config: dict, segments: int) -> int:
    """The bytes an upload of ``segments`` segments hands its hash tasks:
    each segment's own pass, its data rows 1..k-1 and its m parity rows
    (``_UploadHashes``' ``hashed_bytes``)."""
    seg, k, m = config["segment_size"], config["k"], config["m"]
    return segments * (seg + (k - 1 + m) * (seg // k))
