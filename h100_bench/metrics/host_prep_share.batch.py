"""host_prep_share.batch: Host text work's share of the batch cells' process() seconds, from the
program's ProcessPerformanceTrace of every call in the window."""

from h100_bench.lib import readers

LAYER = "engine"
UNIT = "%"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    return readers.host_prep_share(run)
