"""``offchain.upload_d2h_pct``: the share of the uploads' wall that
``upload_batch``'s "fetch.copy" part holds (the fragments' copy from the
device to pageable host memory, after the wait for the encode), over the
operations outside the profiled slice. Moves ``upload_GiBps``."""
from portbench import stages


def read(run):
    return stages.wall_share(run, "fetch.copy_s")
