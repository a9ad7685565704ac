"""``offchain.upload_h2d_pct``: the share of the uploads' wall that
``upload_batch``'s "encode.h2d" part holds (the segments' copy from
pageable host memory to the device), over the operations outside the
profiled slice. Moves ``upload_GiBps``."""
from portbench import stages


def read(run):
    return stages.wall_share(run, "encode.h2d_s")
