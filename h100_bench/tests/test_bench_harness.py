"""The harness finds what belongs to a cell by name, refuses forbidden
modules by whole top-level name, and reduces a trace to its breakdown."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench.lib import harness, trace

ROOT = Path(__file__).resolve().parents[2]


def test_a_dropped_workload_file_is_found_by_name(tmp_path):
    bench_dir = tmp_path / "h100_bench"
    for sub in ("configs", "traffic", "metrics", "workloads"):
        shutil.copytree(harness.BENCH / sub, bench_dir / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "gte-base.new", "config": "gte-modernbert-base",
                               "traffic": "batch512", "chips": 1, "why": "a test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric and "gte-base.batch512" in metric["workloads"]:
            metric["workloads"].append("gte-base.new")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (bench_dir / "workloads" / "gte-base.new.json").write_text(json.dumps(
        {"entry": "serve", "why": "a test", "limits": {"keep_prob_gap": 1, "score_gap": 1}}))
    cell = harness.Cell.load("gte-base.new", bench_dir)
    assert cell.mix["max_length"] == 512 and cell.config["hidden_size"] == 768
    assert {m["name"] for m in cell.end_to_end} == {"pairs_per_s", "setup_s"}
    assert "mfu.batch" in {m["name"] for m in cell.per_layer}
    assert harness.load_entry(cell.workload["entry"]).run


def test_every_metric_and_cell_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for metric in bench["per_layer"]:
        module = harness.load_metric(metric["name"])
        assert (module.LAYER, module.UNIT, module.SOURCE, module.MOVES) == (
            metric["layer"], metric["unit"], metric["source"], metric["moves"])
    for w in bench["workloads"]:
        cell = harness.Cell.load(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["open_provence_tpu_torch", "open_provence_tpu_torch.ops", "jaxtyping",
              "flaxy", "open_provence_tpu", "open_provence_tpu.configs", "jaxlib.xla", "h100_bench"]
    assert harness.forbidden_modules(loaded) == ["jaxlib.xla", "open_provence_tpu",
                                                 "open_provence_tpu.configs"]


def test_a_run_imports_no_jax_package():
    code = ("import sys; sys.path.insert(0, %r); import h100_bench.run, h100_bench.entries.serve, "
            "h100_bench.entries.train, open_provence_tpu_torch.train.trainer; "
            "from h100_bench.lib import harness; print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "gte-base.batch512",
                          "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def _toy_events():
    # Two kernels on the card with a gap; host ops around them (microseconds).
    return [
        {"ph": "X", "cat": "user_annotation", "name": "bench.slice", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "gemm_a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "gemm_a", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "nccl_allreduce", "ts": 60, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "flash_x", "ts": 70, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 95, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 40, "dur": 15},
        {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 35, "dur": 30},
    ]


def test_the_breakdown_of_a_recorded_toy_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _toy_events()}))
    events = trace.load_events(path)
    s = trace.summarize(events, 0.0, 100.0)
    # Busy: [10, 35] + [60, 90] + [95, 100] (the copy cut at the slice's end).
    assert s["busy_s"] == pytest.approx(60e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["launches"] == 4
    assert s["kernels"]["gemm_a"] == {"seconds": pytest.approx(30e-6), "launches": 2}
    assert dict(s["device_ops"]) == {"nccl_allreduce": pytest.approx(30e-6),
                                     "gemm_a": pytest.approx(30e-6), "flash_x": pytest.approx(5e-6)}
    assert s["device_ops"][-1][0] == "flash_x"
    # Gaps: [0, 10] (no host op), [35, 60] (inside aten::copy_, the innermost),
    # [90, 95] (no host op).
    assert s["idle_gaps"] == [["host: aten::copy_", pytest.approx(25e-6)],
                              ["host: python, no torch op", pytest.approx(10e-6)],
                              ["host: python, no torch op", pytest.approx(5e-6)]]
    # NCCL runs 30 us, 5 of them beside flash_x.
    assert s["comm_exposed_s"] == pytest.approx(25e-6)
    assert trace.matching(s["kernels"], ["gemm", "flash"]) == (pytest.approx(35e-6),
                                                               ["gemm_a", "flash_x"])


def test_each_recorded_kernel_falls_in_exactly_one_group():
    from h100_bench import run

    recorded = (harness.BENCH / "tests" / "kernel_names.txt").read_text()
    names = [n for n in recorded.splitlines() if n]
    groups = run.kernel_groups({n: {"seconds": 0.0} for n in names})
    assert {n: g for n, g in groups.items() if len(g) != 1} == {}
    # The port's GEMM namespace holds its LayerNorm pass, which is no product.
    assert all(g == ["norms"] for n, g in groups.items() if "normalize_kernel" in n)


def test_the_gemm_roofline_times_the_gemm_group():
    groups = harness.read_json(harness.BENCH / "metrics" / "kernel_groups.json")
    assert list(harness.load_metric("gemm_roofline.batch").PATTERNS) == groups["gemm"]
