"""dispatch_share.batch: Share of the window's process() seconds spent copying a
forward's inputs to the card and launching its kernels, from the program's
spans of every call in the window."""

LAYER = "model step"
UNIT = "%"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    """Seconds of the program's ``engine.dispatch`` span over those of its root
    ``engine.process``, summed over the window's calls; None where the
    program reports no such span."""
    traces = [t for t in run.host_traces if "engine.dispatch_seconds" in t]
    total = sum(t["engine.process_seconds"] for t in traces)
    if total <= 0:
        return None
    return 100.0 * sum(t["engine.dispatch_seconds"] for t in traces) / total
