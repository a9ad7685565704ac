"""``offchain.upload_pad_pct``: the share of the uploads' wall that
``upload_batch``'s "pad" stage holds (the file cut into zero-padded
segments on the host: a copy of every byte of a file whose size is not
a whole number of segments), over the operations outside the profiled
slice. Moves ``upload_GiBps``."""
from portbench import stages


def read(run):
    return stages.wall_share(run, "pad_s")
