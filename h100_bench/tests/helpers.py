"""Tiny cells for the CPU tests: the real cells' files, cut to a size the
CPU runs in seconds, driven through the harness on the CPU."""

from __future__ import annotations

import copy
import time

from h100_bench.lib import harness

TINY = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 2,
        "intermediate_size": 96, "vocab_size": 256, "local_attention": 16}


def tiny_cell(name: str, mesh_of: int = 0) -> harness.Cell:
    """Cell ``name`` cut to a tiny size; ``mesh_of`` > 0 runs its training
    steps on a data mesh of that many gloo ranks, with the mesh files
    ``traffic/train512.dp4.json`` and ``workloads/ruri-310m.train512.dp4.json``."""
    cell = harness.Cell.load(name)
    if mesh_of:
        cell.mix = harness.read_json(harness.BENCH / "traffic" / "train512.dp4.json")
        cell.mix["ranks"] = mesh_of
        cell.workload = harness.read_json(harness.BENCH / "workloads" / "ruri-310m.train512.dp4.json")
    cfg = dict(cell.config, **TINY)
    cfg["pruning_config"] = dict(cfg["pruning_config"], hidden_size=TINY["hidden_size"])
    cell.config = cfg
    mix = copy.deepcopy(cell.mix)
    if "queries_per_call" in mix:
        mix.update(queries_per_call=2, passages_per_query=3, calls_in_pool=3, check_calls=2,
                   max_length=128 if mix["max_length"] == 512 else 256, profile={"calls": 1})
        mix["passage_tokens"] = dict(mix["passage_tokens"], median=mix["passage_tokens"]["median"] / 10,
                                     min=20, max=600)
    else:
        mix.update(pairs_per_step=8, micro_batches=2 if mix.get("ranks", 1) == 1 else 1,
                   steps_in_pool=2, max_length=96,
                   spans_per_text=[2, 6], tokens_per_span=12, profile={"steps": 1})
        mix["text_tokens"] = dict(mix["text_tokens"], median=60, min=40, max=200)
    cell.mix = mix
    return cell


def cpu_run(cell: harness.Cell, seed: int = 2**33 + 7, seconds: float = 0.5,
            trace: bool = False) -> harness.Run:
    """One run of ``cell`` on the CPU (the plain versions of the kernels),
    through the entry and its correctness check."""
    run = harness.Run(cell, seed, seconds, trace, time.perf_counter(), device="cpu")
    harness.load_entry(cell.workload["entry"]).run(run)
    return run
