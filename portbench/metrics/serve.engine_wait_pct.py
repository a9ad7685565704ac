"""``serve.engine_wait_pct``: the share of the uploads' wall that their
requests waited queued in the submission engine, submit to drain:
Σ(``encode.queue`` + ``tag.queue``) over Σ wall (%), over the uploads
that returned outside the profiled slice. Moves ``upload_GiBps``. A
program whose uploads clock no engine queue (records without
``encode.queue_s``) reads None."""

FIELDS = ("encode.queue_s", "tag.queue_s")


def read(run):
    recs = [r for r in run.host_records if r["ok"]]
    if not recs or any(f not in r for r in recs for f in FIELDS):
        return None
    wall = sum(r["t1"] - r["t0"] for r in recs)
    return 100.0 * sum(r[f] for r in recs for f in FIELDS) / wall \
        if wall else None
