"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card, drives the rest of a run of
a tiny cell on the CPU with one fault planted in the program, and sees
``correct`` come out false under the cell's own limits; the same run
unbroken comes out true. The faults: an answer altered where it is
produced, half of a forward's rows left out (the mean of the others put in
their place), a training step that leaves its state unchanged, half of
each training batch left out (the mean taken over the rest) and, on a data
mesh of four gloo ranks, the exchange between ranks left out."""

from __future__ import annotations

import pytest
import torch

from h100_bench.tests.helpers import cpu_run, tiny_cell


def _fp32(cell):
    cell.config["training"] = dict(cell.config["training"], bf16=False)
    return cell


def test_unbroken_serving_is_correct():
    assert cpu_run(tiny_cell("gte-base.batch512")).correct


def test_an_altered_answer_is_caught(monkeypatch):
    from open_provence_tpu_torch.inference import engine

    real = engine.forward_logits

    def altered(*args):
        ranking, keep = real(*args)
        keep = keep.clone()
        keep[0] = (keep[0] + 0.2).clamp(max=1.0)
        return ranking, keep

    monkeypatch.setattr(engine, "forward_logits", altered)
    run = cpu_run(tiny_cell("gte-base.batch512"))
    assert not run.correct


def test_half_of_a_forwards_rows_left_out_is_caught(monkeypatch):
    from open_provence_tpu_torch.inference import engine

    real = engine.forward_logits

    def half(module, device, ids, mask):
        keep_rows = max(1, ids.shape[0] // 2)
        ranking, keep = real(module, device, ids[:keep_rows], mask[:keep_rows])
        rest = ids.shape[0] - keep_rows
        ranking = torch.cat([ranking, ranking.mean(0, keepdim=True).expand(rest, -1)])
        keep = torch.cat([keep, keep.mean(0, keepdim=True).expand(rest, -1)])
        return ranking, keep

    monkeypatch.setattr(engine, "forward_logits", half)
    assert not cpu_run(tiny_cell("gte-base.batch512")).correct


def test_unbroken_training_is_correct():
    assert cpu_run(_fp32(tiny_cell("ruri-310m.train512"))).correct


def test_a_step_that_leaves_its_state_unchanged_is_caught(monkeypatch):
    from open_provence_tpu_torch.train.trainer import OpenProvenceTrainer

    def unchanged(self, grads):
        self.step += 1

    monkeypatch.setattr(OpenProvenceTrainer, "apply_gradients", unchanged)
    run = cpu_run(_fp32(tiny_cell("ruri-310m.train512")))
    assert not run.correct
    assert dict((n, v) for n, v, _, _ in run.checks)["change_gap"] == pytest.approx(1.0)


def test_half_of_each_batch_left_out_is_caught(monkeypatch):
    from open_provence_tpu_torch.train.trainer import OpenProvenceTrainer

    real = OpenProvenceTrainer._prepare_batch

    def half(self, batch):
        out = real(self, batch)
        keep = out["input_ids"].shape[0] // 2
        return {k: v[:keep] for k, v in out.items()}

    monkeypatch.setattr(OpenProvenceTrainer, "_prepare_batch", half)
    assert not cpu_run(_fp32(tiny_cell("ruri-310m.train512"))).correct


def test_a_data_mesh_of_four_gloo_ranks_is_correct():
    cell = _fp32(tiny_cell("ruri-310m.train512", mesh_of=4))
    run = cpu_run(cell, seconds=1.0)
    assert run.correct and run.attempted >= 1


def plant_no_exchange():
    """The exchange between ranks left out: no rank sums the gradients or
    the logged loss over the data group."""
    from open_provence_tpu_torch.train.trainer import OpenProvenceTrainer

    OpenProvenceTrainer._sum_gradients = lambda self, grads: None
    OpenProvenceTrainer._global_metrics = lambda self, loss, components: (loss, components)


def test_the_exchange_left_out_is_caught():
    from open_provence_tpu_torch.train.trainer import OpenProvenceTrainer

    kept = OpenProvenceTrainer._sum_gradients, OpenProvenceTrainer._global_metrics
    cell = _fp32(tiny_cell("ruri-310m.train512", mesh_of=4))
    cell.workload = dict(cell.workload, plant=f"{__name__}:plant_no_exchange")
    try:
        assert not cpu_run(cell, seconds=1.0).correct
    finally:  # rank 0 ran in this process
        OpenProvenceTrainer._sum_gradients, OpenProvenceTrainer._global_metrics = kept
