"""launches_per_step.train: Kernels launched per optimizer step in the profiled slice (rank 0's)."""

from h100_bench.lib import readers

LAYER = "trainer"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(run):
    return readers.launches_per_unit(run)
