"""Run one cell of the benchmark once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is the result (JSON); the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error and the ``checks`` key of the result. ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
profiled slice of the window. ``--calibrate K`` (not a run) reads the
program's and the control's numbers on seeds seed..seed+K-1 in one process.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """perf_counter() at this process's start (Linux; else now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench.lib import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", type=int, default=0,
                   help="read the program and the control on this many seeds, then exit")
    return p.parse_args(argv)


def per_layer(run: harness.Run) -> dict:
    out = {}
    for metric in run.cell.per_layer:
        value = harness.load_metric(metric["name"]).read(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def device_info(run: harness.Run, measured: dict) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": run.cell.chips,
            "memory_peak_bytes": measured["memory_peak_bytes"]}
    if run.trace and run.summary is not None:
        summaries = run.rank_summaries or [run.summary]
        info["busy_s"] = sum(s["busy_s"] for s in summaries) / len(summaries)
        info["window_s"] = run.summary["window_s"]
    return info


def main(argv=None) -> int:
    args = parse(argv)
    harness.setenv()
    cell = harness.Cell.load(args.workload)
    import torch

    # A calibration reads the program on one card and the reference.
    chips = 1 if args.calibrate else cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.eprint(f"{cell.name} needs {chips} CUDA card(s); "
                       f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    entry = harness.load_entry(cell.workload["entry"])
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace), T0)
    if args.calibrate:
        rows = entry.calibrate(run, [args.seed + k for k in range(args.calibrate)])
        print(json.dumps(rows))
        return 0
    measured = entry.run(run)
    return finish(run, measured)


def finish(run: harness.Run, measured: dict, device: dict | None = None) -> int:
    """Print the result line of a finished run (or refuse one that loaded
    a forbidden module)."""
    bad = harness.forbidden_modules()
    if bad:
        harness.eprint(f"forbidden modules loaded in the process: {bad}")
        return 3
    if run.trace:
        metrics = per_layer(run)
        s = run.summary
        breakdown = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
        groups = kernel_groups(run.summary["kernels"])
        harness.eprint(f"device kernels in no group: "
                       f"{sorted(k for k, g in groups.items() if not g)}")
        harness.eprint(f"device kernels in two groups or more: "
                       f"{sorted((k, g) for k, g in groups.items() if len(g) > 1)}")
    else:
        names = {m["name"]: m["unit"] for m in run.cell.end_to_end}
        metrics = {"setup_s": {"value": run.setup_s, "unit": "s"}}
        for name, unit in names.items():
            if name in run.e2e:
                metrics[name] = {"value": run.e2e[name], "unit": unit}
        breakdown = None
    device = device or device_info(run, measured)
    for name, value, limit, ok in run.checks:
        harness.eprint(f"check {name}: {value!r} (limit {limit!r}){'' if ok else '  FAILED'}")
    print(harness.result_line(run, device, metrics, breakdown), flush=True)
    return 0


def kernel_groups(kernels) -> dict[str, list[str]]:
    """The groups of ``metrics/kernel_groups.json`` that each kernel's name
    matches: one each, when the groups are sound."""
    from h100_bench.lib.trace import matching

    groups = harness.read_json(harness.BENCH / "metrics" / "kernel_groups.json")
    out = {k: [] for k in kernels}
    for group, patterns in groups.items():
        for k in matching(kernels, patterns)[1]:
            out[k].append(group)
    return out


if __name__ == "__main__":
    sys.exit(main())
