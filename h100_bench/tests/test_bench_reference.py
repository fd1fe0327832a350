"""The plain reference against the port's plain CPU path at tiny widths.

Only these tests import both: the reference itself imports nothing of the
program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from h100_bench.lib.weights import make_weights
from h100_bench.reference import modernbert as ref_model
from h100_bench.tests.helpers import TINY, cpu_run, tiny_cell

REFERENCE = Path(__file__).resolve().parents[1] / "reference"


def _port_module(cfg):
    from open_provence_tpu_torch import build_module
    from h100_bench.entries.serve import port_config

    return build_module(port_config(cfg, 128))


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in {"torch", "numpy", "math", "dataclasses",
                                              "__future__"}, (path.name, name)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_forward_matches_the_ports_plain_path(pooling):
    cfg = dict(tiny_cell("gte-base.batch512").config, classifier_pooling=pooling)
    weights = make_weights(cfg, 123, "cpu")
    module = _port_module(cfg)
    assert set(module.state_dict()) == set(weights)
    module.load_state_dict(weights)
    module.eval()
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(3, TINY["vocab_size"], (3, 40), generator=gen)
    mask = torch.ones(3, 40, dtype=torch.long)
    mask[1, 25:] = 0
    mask[2, 7:] = 0
    with torch.no_grad():
        out = module(ids, mask)
        ranking, pruning = ref_model.forward(weights, cfg, ids, mask)
    torch.testing.assert_close(ranking, out["ranking_logits"], rtol=1e-4, atol=1e-4)
    real = mask.bool()
    torch.testing.assert_close(pruning[real], out["pruning_logits"][real], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("queries", [2, 1])
def test_process_answers_match_on_the_cpu(queries):
    cell = tiny_cell("gte-base.batch512")
    # One query a call goes through process()'s flat-list form.
    cell.mix = dict(cell.mix, queries_per_call=queries, max_length=128 * queries)
    run = cpu_run(cell)
    checks = {name: value for name, value, _, _ in run.checks}
    assert run.correct
    assert checks["keep_logit_rms"] < 1e-4 and checks["keep_logit_gap"] < 1e-4
    assert checks["score_gap"] < 1e-5
    assert checks["decision_flips"] == 0


def test_training_steps_match_in_fp32_on_the_cpu():
    cell = tiny_cell("ruri-310m.train512")
    cell.config["training"] = dict(cell.config["training"], bf16=False)
    cell.workload = dict(cell.workload, limits=dict(cell.workload["limits"], loss_gap=1.0,
                                                     loss_step_gap=1.0))
    run = cpu_run(cell)
    checks = {name: value for name, value, _, _ in run.checks}
    assert run.correct
    for name in ("loss_gap", "loss_step_gap", "grad_profile_gap", "change_gap"):
        assert checks[name] < 1e-5, (name, checks[name])
