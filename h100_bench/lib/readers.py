"""The arithmetic of the per-layer metrics; each ``metrics/<name>.py``
names its own inputs (kinds of work, kernel name patterns) and calls one
of these. A reader that finds nothing to read returns None, and the
harness leaves the metric out of the result line."""

from __future__ import annotations

from .trace import matching
from .work import PEAK_FLOPS


def host_prep_share(run) -> float | None:
    """Host text work's share of the window's ``process()`` seconds: the
    preprocess, assembly and postprocess stopwatches of every call's
    ``performance_trace`` over their total seconds."""
    traces = run.host_traces
    total = sum(t["total_seconds"] for t in traces)
    if not traces or total <= 0:
        return None
    host = sum(t["preprocess_seconds"] + t["assembly_seconds"] + t["postprocess_seconds"]
               for t in traces)
    return 100.0 * host / total


def mfu(run) -> float | None:
    """The model operations the window's inputs need over the window's
    seconds times the cards times the peak bf16 rate."""
    if run.window_work is None or run.window_s <= 0:
        return None
    return 100.0 * run.window_work.total_flops() / (run.window_s * run.cell.chips * PEAK_FLOPS)


def roofline(run, kinds, patterns) -> float | None:
    """Least time of the profiled slice's work of ``kinds`` over the device
    time of the kernels matching ``patterns``."""
    if run.summary is None or run.slice_work is None:
        return None
    seconds, names = matching(run.summary["kernels"], patterns)
    if seconds <= 0:
        return None
    return 100.0 * run.slice_work.bound_s(kinds) / seconds


def device_idle(run) -> float | None:
    """Share of the profiled slice with no kernel, copy or set on the card
    (rank 0's card on several)."""
    s = run.summary
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def launches_per_unit(run) -> float | None:
    """Kernels launched per call or step of the profiled slice (rank 0's)."""
    if run.summary is None or run.slice_units <= 0:
        return None
    return run.summary["launches"] / run.slice_units


def comm_exposed(run) -> float | None:
    """Share of the profiled slice in which a collective kernel runs and no
    compute kernel does, on rank 0."""
    s = run.summary
    if s is None or s["window_s"] <= 0 or not any("nccl" in k.lower() for k in s["kernels"]):
        return None
    return 100.0 * s["comm_exposed_s"] / s["window_s"]
