"""allreduce_exposed.dp4: Share of the profiled slice in which an NCCL kernel runs and no compute
kernel does, on rank 0: the gradients' all-reduce left in the open."""

from h100_bench.lib import readers

LAYER = "mesh"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(run):
    return readers.comm_exposed(run)
