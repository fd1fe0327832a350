"""pad_share.batch: Share of the token positions of the window's forwards
that hold padding: the rows and lengths the forwards ran at, bucketed,
against the tokens of their blocks, from the program's counters of every
call in the window."""

LAYER = "model step"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(run):
    """1 - ``valid_tokens`` / ``token_slots`` over the window's calls; None
    where the program counts neither."""
    traces = [t for t in run.host_traces if "token_slots" in t]
    slots = sum(t["token_slots"] for t in traces)
    if slots <= 0:
        return None
    return 100.0 * (1.0 - sum(t["valid_tokens"] for t in traces) / slots)
