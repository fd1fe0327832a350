"""device_idle.train: Share of the profiled slice with nothing running on the card (rank 0's)."""

from h100_bench.lib import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(run):
    return readers.device_idle(run)
