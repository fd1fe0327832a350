"""mfu.batch: The model operations the window's calls need (each block of the
reference's packing at its valid length) over the window times the peak."""

from h100_bench.lib import readers

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "pairs_per_s"


def read(run):
    return readers.mfu(run)
