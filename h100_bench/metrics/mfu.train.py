"""mfu.train: Forward and backward operations (no recompute) of the window's optimizer
steps, each row at its valid length, over the window, the cards and the peak."""

from h100_bench.lib import readers

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_pairs_per_s"


def read(run):
    return readers.mfu(run)
