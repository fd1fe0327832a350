"""The harness around one run: files found by name, the card check, the
import check, the profiled slice and the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file found by the name ``BENCHMARK.json`` gives it:
``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<mix>.json``, ``entries/<entry>.py`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
from dataclasses import dataclass, field
from pathlib import Path
from time import perf_counter
from typing import Any

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# Whole top-level module names that no process of a run may hold.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "open_provence_tpu"})


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN_MODULES``, compared as whole names."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def cache_env() -> dict[str, str]:
    """Fixed cache directories inside the checkout: the kernel library's
    build directory and the compilers' caches, so only a checkout's first
    run of a cell builds."""
    cache = BENCH / "_cache"
    return {
        "OPEN_PROVENCE_TPU_TORCH_BUILD_DIR": str(cache / "kernels"),
        "TRITON_CACHE_DIR": str(cache / "triton"),
        "TORCHINDUCTOR_CACHE_DIR": str(cache / "inductor"),
        "CUDA_CACHE_PATH": str(cache / "nv"),
        # Libraries the port may import must not bring JAX in with them.
        "USE_FLAX": "0",
        "USE_JAX": "0",
        "USE_TF": "0",
    }


@dataclass
class Cell:
    """One cell and everything found by its names."""

    name: str
    workload: dict
    config: dict
    mix: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    chips: int

    @classmethod
    def load(cls, name: str, bench_dir: Path = BENCH, bench_file: Path | None = None) -> "Cell":
        """The cell ``name`` of ``bench_file`` (the checkout's
        BENCHMARK.json), its files read from ``bench_dir``. A cell held out
        of BENCHMARK.json names its configuration, mix and cards in its
        own workload file; it can be calibrated and tested, not measured."""
        bench = read_json(bench_file or bench_dir.parent / "BENCHMARK.json")
        path = bench_dir / "workloads" / f"{name}.json"
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None and path.exists() and "held_out" in read_json(path):
            entry = read_json(path)["held_out"]
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        workload = read_json(path)
        config = read_json(bench_dir / "configs" / f"{entry['config']}.json")
        mix = read_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in bench["per_layer"]
                     if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        return cls(name, workload, config, mix, e2e, per_layer, int(entry["chips"]))


@dataclass
class Run:
    """What a run measured, handed to the metric readers."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: str = "cuda"  # "cpu" only in the tests' rehearsals
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    e2e: dict = field(default_factory=dict)
    # Filled by the entry for the readers:
    window_work: Any = None  # Work of the whole window
    slice_work: Any = None  # Work of the profiled slice
    slice_units: int = 0  # calls or steps in the profiled slice
    host_traces: list = field(default_factory=list)  # ProcessPerformanceTrace dicts
    summary: dict | None = None  # lib/trace.summarize of the profiled slice
    rank_summaries: list = field(default_factory=list)
    checks: list = field(default_factory=list)  # [name, value, limit, ok]
    correct: bool = True

    def check(self, name: str, value: float, limit: float, ok: bool | None = None) -> None:
        ok = bool(value <= limit) if ok is None else bool(ok)
        self.checks.append([name, value, limit, ok])
        self.correct = self.correct and ok


def card(run: Run, index: int = 0):
    """The torch device of this run's card ``index`` (the CPU in a rehearsal)."""
    import torch

    if run.device == "cpu":
        return torch.device("cpu")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def check_kernels(run: Run, device, names) -> None:
    """The main path ran the port's kernels and no plain version (on a card;
    a CPU rehearsal runs the plain versions by design)."""
    from open_provence_tpu_torch import kernels

    if device.type != "cuda":
        return
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    run.check("kernel_launches_missing", sum(launches[k] == 0 for k in names), 0)
    run.check("plain_calls", sum(plain.values()), 0)
    eprint(f"kernel launches {launches}; plain calls {plain}")


def load_metric(name: str):
    """The reader module of per-layer metric ``name`` (metrics/<name>.py)."""
    path = BENCH / "metrics" / f"{name}.py"
    module_name = f"h100_bench_metric_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_entry(name: str):
    """The entry module ``entries/<name>.py`` (imported by its package name,
    so that spawned ranks find its functions)."""
    return importlib.import_module(f"h100_bench.entries.{name}")


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, exclusive method)."""
    values = sorted(values)
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=100)[94])


class Profiled:
    """A ``torch.profiler`` capture of a slice of the window, bounded to a
    few calls or steps; the trace is written to ``path`` (inside the
    checkout, one fixed file a cell) and reduced by ``lib/trace.py``."""

    def __init__(self, path: Path):
        self.path = path
        self.prof = None
        self.t_host = 0.0

    def start(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.rf = torch.profiler.record_function("bench.slice")
        self.rf.__enter__()
        self.t_host = perf_counter()

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.t_host = perf_counter() - self.t_host
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        from . import trace

        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        events = trace.load_events(self.path)
        marks = [e for e in events
                 if e["name"] == "bench.slice" and e.get("cat") == "user_annotation"]
        t0 = float(marks[0]["ts"]) if marks else None
        t1 = float(marks[0]["ts"]) + float(marks[0]["dur"]) if marks else None
        return trace.summarize(events, t0, t1)


def result_line(run: Run, device: dict, metrics: dict, breakdown: dict | None) -> str:
    out = {"correct": bool(run.correct), "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit, "ok": ok}
                     for name, value, limit, ok in run.checks}
    return json.dumps(out)


class HostLoad:
    """What the host's cores did between ``start()`` and ``report()``:
    the machine's busy and stolen (taken by the hypervisor for others)
    cores from ``/proc/stat``, and this process's CPU seconds (all its
    threads) per second of wall."""

    def start(self) -> None:
        self.t, self.stat, self.cpu = perf_counter(), self._stat(), self._cpu()

    @staticmethod
    def _stat() -> list[float]:
        try:
            with open("/proc/stat") as f:
                return [float(x) for x in f.readline().split()[1:9]]
        except (OSError, ValueError):
            return [0.0] * 8

    @staticmethod
    def _cpu() -> float:
        t = os.times()
        return t.user + t.system

    def report(self) -> str:
        wall = perf_counter() - self.t
        d = [b - a for a, b in zip(self.stat, self._stat())]
        cores = os.cpu_count() or 1
        own = (self._cpu() - self.cpu) / max(wall, 1e-9)
        if sum(d) <= 0:  # a sandbox whose /proc/stat stands still
            machine = "the machine's load unreadable"
        else:
            busy = (d[0] + d[1] + d[2] + d[5] + d[6]) / sum(d) * cores
            machine = f"{busy:.2f} of {cores} cores busy, {d[7] / sum(d) * cores:.2f} stolen"
        return f"host load over {wall:.1f} s: {machine}; this process {own:.2f} cores"


def eprint(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def setenv() -> None:
    os.environ.update(cache_env())
