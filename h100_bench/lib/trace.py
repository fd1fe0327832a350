"""Reduce a ``torch.profiler`` Chrome trace to what the per-layer metrics read.

``summarize(events, t0_us, t1_us)`` takes the trace's complete ("X")
events and the profiled slice's bounds and gives:

* ``busy_s``: the union of the device's kernel, copy and set intervals;
* ``window_s``: the slice's length;
* ``kernels``: device seconds and launches by kernel name;
* ``device_ops``: the ten names that took the most device time;
* ``idle_gaps``: the ten longest stretches with nothing on the device,
  each named by what the host was doing at its middle: the innermost host
  range (a ``record_function`` of the harness or an aten op) open there,
  or "host: no op" when none was;
* ``launches``: the number of kernels run;
* ``comm_exposed_s``: the time a collective kernel runs and no other.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
# The harness's range around the whole profiled slice.
SLICE = "bench.slice"
# Collective kernels (NCCL's are named nccl...).
COMM = re.compile("nccl", re.IGNORECASE)


def load_events(path) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _host_label(host, mid: float) -> str:
    best = None
    for lo, hi, name in host:
        if lo <= mid <= hi and (best is None or hi - lo < best[1] - best[0]):
            best = (lo, hi, name)
    return f"host: {best[2]}" if best else "host: python, no torch op"


def summarize(events: list[dict], t0_us: float | None = None, t1_us: float | None = None) -> dict:
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") in HOST_CATS and e["name"] != SLICE]
    if t0_us is None:
        t0_us = min([float(e["ts"]) for e in events], default=0.0)
    if t1_us is None:
        t1_us = max([float(e["ts"]) + float(e["dur"]) for e in events], default=0.0)
    intervals = [(max(float(e["ts"]), t0_us), min(float(e["ts"]) + float(e["dur"]), t1_us))
                 for e in device]
    merged = _merge([iv for iv in intervals if iv[1] > iv[0]])
    busy = sum(hi - lo for lo, hi in merged)
    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in device:
        if e.get("cat") == "kernel":
            kernels[e["name"]][0] += float(e["dur"]) * 1e-6
            kernels[e["name"]][1] += 1
    edges = [t0_us] + [x for iv in merged for x in iv] + [t1_us]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    top_gaps = [[_host_label(host, (lo + hi) / 2), dur * 1e-6] for dur, lo, hi in gaps[:10]]
    comm = _merge([iv for e, iv in zip(device, intervals)
                   if iv[1] > iv[0] and COMM.search(e["name"])])
    compute = _merge([iv for e, iv in zip(device, intervals)
                      if iv[1] > iv[0] and e.get("cat") == "kernel" and not COMM.search(e["name"])])
    ops = sorted(((name, v[0]) for name, v in kernels.items()), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy * 1e-6,
        "window_s": (t1_us - t0_us) * 1e-6,
        "kernels": {k: {"seconds": v[0], "launches": v[1]} for k, v in kernels.items()},
        "device_ops": [[n, s] for n, s in ops],
        "idle_gaps": top_gaps,
        "launches": sum(v[1] for v in kernels.values()),
        "comm_exposed_s": (_measure(comm) - _overlap(comm, compute)) * 1e-6,
    }


def _measure(merged) -> float:
    return sum(hi - lo for lo, hi in merged)


def _overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def matching(kernels: dict, patterns) -> tuple[float, list[str]]:
    """Device seconds of the kernels whose names match any of ``patterns``
    (regular expressions, searched), and those names."""
    regex = re.compile("|".join(f"(?:{p})" for p in patterns))
    names = [k for k in kernels if regex.search(k)]
    return sum(kernels[k]["seconds"] for k in names), names
