"""``device.idle_hash_pct.<kind>``: the share of the profiled slice in
which the card idles while the host is inside ``upload_batch``'s "hash"
stage: the idle gaps that the device trace names after the profiler
range ``offchain.upload.hash``, over the slice. Host hashing that the
card waits on shows here; hashing hidden behind device work does not.
A program whose stages open no profiler range (its records carry no
``pad_s``) reads None."""

HASH = "offchain.upload.hash"


def read(run):
    if run.kind != "upload" or run.trace is None \
            or not any("pad_s" in r for r in run.slice_records):
        return None
    idle = sum(s for name, s in run.trace.idle_gaps if name == HASH)
    return 100.0 * idle / run.trace.window_s
