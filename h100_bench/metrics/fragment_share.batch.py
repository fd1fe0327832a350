"""fragment_share.batch: Share of the window's process() seconds in which the calling
thread produced or waited for the next fragmentized entry (the fragmentation
workers' output), from the program's spans of every call in the window."""

LAYER = "engine"
UNIT = "%"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    """Seconds of the program's ``engine.fragments`` span over those of its root
    ``engine.process``, summed over the window's calls; None where the
    program reports no such span."""
    traces = [t for t in run.host_traces if "engine.fragments_seconds" in t]
    total = sum(t["engine.process_seconds"] for t in traces)
    if total <= 0:
        return None
    return 100.0 * sum(t["engine.fragments_seconds"] for t in traces) / total
