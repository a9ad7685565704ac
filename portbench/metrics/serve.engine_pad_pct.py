"""``serve.engine_pad_pct``: the zero pad rows of the engine batches
that served the uploads returned outside the profiled slice, over all
the rows those batches ran on the device (%), each batch counted once by
its id however many uploads it served. Moves ``upload_GiBps``. Records
without ``engine_batches`` (``[class, batch id, members, real rows,
bucket rows]`` of each request, ``drivers/upload_shared.py``) read
None."""


def read(run):
    recs = [r for r in run.host_records if r["ok"]]
    if not recs or any("engine_batches" not in r for r in recs):
        return None
    batches = {bid: (rows, bucket) for r in recs
               for _, bid, _, rows, bucket in r["engine_batches"]}
    total = sum(bucket for _, bucket in batches.values())
    return 100.0 * sum(bucket - rows for rows, bucket in batches.values()) \
        / total if total else None
