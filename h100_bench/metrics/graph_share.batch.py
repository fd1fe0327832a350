"""graph_share.batch: Share of the window's forwards that the program served
by replaying a CUDA graph, from the program's counters of every call in the
window."""

LAYER = "model step"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(run):
    """``graph_replays`` / ``forwards`` over the window's calls; None where
    the program counts no ``graph_replays``."""
    traces = [t for t in run.host_traces if "graph_replays" in t]
    forwards = sum(t["forwards"] for t in traces)
    if forwards <= 0:
        return None
    return 100.0 * sum(t["graph_replays"] for t in traces) / forwards
