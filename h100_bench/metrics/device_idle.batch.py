"""device_idle.batch: Share of the profiled slice with nothing running on the card."""

from h100_bench.lib import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "pairs_per_s"


def read(run):
    return readers.device_idle(run)
