"""On a card: the control (the reference with float8 products in the
program's place) fails the limits of each one-card cell of
BENCHMARK.json at the cell's own size, and the program passes them, on
one seed. Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
         if w["chips"] == 1]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(card, cell):
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", cell,
                          "--seed", str(2**33 + 101), "--seconds", "1", "--calibrate", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200, check=True)
    row = json.loads(out.stdout.strip().splitlines()[-1])[0]
    limits = harness.Cell.load(cell).workload["limits"]
    assert all(row["program"][k] <= v for k, v in limits.items() if k in row["program"])
    assert any(row["control"][k] > v for k, v in limits.items() if k in row["control"])
