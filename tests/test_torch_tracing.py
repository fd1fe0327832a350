"""The port's spans and counters (``utils/tracing.py``) in ``process()`` and
in the trainer, on the CPU at tiny widths.

* Without a profiler a call opens no profiler range, and its trace
  reports every span and counter.
* Under ``torch.profiler`` each span is a ``user_annotation`` range of its
  name in the exported trace, nested in its root.
* The root's children cover the call, and the padding counters equal the
  dispatched batches' sizes and attention masks.
* Planning asks the driver for the card's memory once a card.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from open_provence_tpu_torch.configs import ModernBertBackboneConfig, OpenProvenceConfig
from open_provence_tpu_torch.inference import OpenProvenceModel, engine
from open_provence_tpu_torch.train import OpenProvenceDataCollator, OpenProvenceTrainer
from open_provence_tpu_torch.utils.convert import init_params
from open_provence_tpu_torch.utils.tracing import (
    PROCESS_COUNTERS,
    PROCESS_SPANS,
    ProcessPerformanceTrace,
    Spans,
)
from open_provence_tpu.utils import tracing as reference_tracing
from tests.dummy_tokenizers import DummyTokenizer, PairDummyTokenizer

# The timing keys of the JAX package's trace, which the port keeps.
REFERENCE_KEYS = {f.name for f in dataclasses.fields(reference_tracing.ProcessPerformanceTrace)}
# One 34-token block each (1 + 30 + 3): three forwards of 4 rows at 48.
CONTEXTS = [f"Topic {i:02d} is sushi. More on it." for i in range(12)]


def tiny_config(max_length=64):
    backbone = ModernBertBackboneConfig(
        vocab_size=512, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=128, local_attention=16,
        pad_token_id=0, num_labels=1,
    )
    return OpenProvenceConfig(
        base_model_config=backbone.to_dict(), num_labels=1,
        pruning_config={"hidden_size": 32, "classifier_dropout": 0.0}, max_length=max_length,
    )


@pytest.fixture(scope="module")
def model():
    config = tiny_config()
    m = OpenProvenceModel(config, init_params(config, torch.Generator().manual_seed(0)),
                          DummyTokenizer(), device="cpu", bucket_step=16)
    m.process("q", CONTEXTS[:2], show_progress=False)  # the splitter's first use
    return m


def _call(model):
    return model.process("q", CONTEXTS, batch_size=4, preprocess_batch_size=2,
                         show_progress=False)


def test_spans_time_nest_and_count():
    spans = Spans()
    with spans("root"):
        for _ in range(3):
            with spans("child"):
                spans.count("n", 2)
    spans.count("n")
    spans.add("elsewhere", 0.25)
    spans.add("elsewhere", 0.5)
    assert set(spans.seconds) == {"root", "child", "elsewhere"}
    assert 0 < spans.seconds["child"] <= spans.seconds["root"]
    assert spans.seconds["elsewhere"] == 0.75
    assert spans.counts == {"n": 7}


def test_process_without_a_profiler_opens_no_range(model, monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    monkeypatch.setattr(torch._C._autograd, "_record_function_with_args_enter",
                        lambda name, *args: opened.append(name))
    out = _call(model)
    assert opened == []
    timing = out["timing"]
    assert REFERENCE_KEYS and REFERENCE_KEYS <= set(timing)
    assert set(timing) == {*REFERENCE_KEYS, *(f"{s}_seconds" for s in PROCESS_SPANS),
                           *PROCESS_COUNTERS}
    assert timing["tokenize_seconds"] > 0
    assert all(isinstance(v, (int, float)) for v in timing.values())
    trace = out["performance_trace"]
    assert isinstance(trace, ProcessPerformanceTrace) and trace.as_dict() == timing
    s = trace.span_seconds
    assert timing["total_seconds"] == s["engine.process"] > 0
    assert timing["inference_seconds"] == pytest.approx(s["engine.dispatch"] + s["engine.fetch"])
    assert timing["preprocess_seconds"] == pytest.approx(
        s["engine.plan"] + s["engine.fragments"] + s["engine.pad"])
    assert timing["blocks"] == 12 and timing["forwards"] == 3


def test_process_under_the_profiler_records_every_span_in_its_root(model, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _call(model)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    ranges = {}
    for e in events:
        ranges.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert set(PROCESS_SPANS) <= set(ranges)
    (root,) = ranges["engine.process"]
    for name in PROCESS_SPANS[1:]:
        for lo, hi in ranges[name]:
            assert root[0] <= lo <= hi <= root[1], name
    # One range for each of the call's 12 entries, and one for the pool's
    # shutdown.
    assert len(ranges["engine.fragments"]) == 13
    assert len(ranges["engine.dispatch"]) == len(ranges["engine.pad"]) == 3


def test_the_children_cover_the_call(model):
    spans = _call(model)["performance_trace"].span_seconds
    children = sum(spans[name] for name in PROCESS_SPANS[1:])
    assert 0.9 * spans["engine.process"] <= children <= spans["engine.process"]


def test_the_padding_counters_match_the_dispatched_batches(model, monkeypatch):
    """Three 13-character passages and two 30-character ones after a
    two-character query: blocks of 2 + 13 + 3 = 18 and 2 + 30 + 3 = 35
    tokens, in the 32 and 48 buckets; at 4 rows a forward the three pad to
    4 rows and the two stay 2."""
    real, batches = engine.pad_block_batch, []

    def recorded(*args):
        out = real(*args)
        batches.append(out)
        return out

    monkeypatch.setattr(engine, "pad_block_batch", recorded)
    short, long = "Abcdefgh ijk.", "Abcdefgh ijk lmnop qrstu vwxy."
    assert (len(short), len(long)) == (13, 30)
    timing = model.process("qq", [short, long, short, long, short], batch_size=4,
                           show_progress=False)["timing"]
    assert sorted(b["attention_mask"].shape for b in batches) == [(2, 48), (4, 32)]
    assert timing["valid_tokens"] == 3 * 18 + 2 * 35
    assert timing["token_slots"] == 4 * 32 + 2 * 48
    assert timing["valid_tokens"] == sum(int(b["attention_mask"].sum()) for b in batches)
    assert timing["token_slots"] == sum(b["attention_mask"].size for b in batches)
    assert (timing["forwards"], timing["blocks"]) == (2, 5)


def test_the_trainer_opens_its_ranges_under_the_profiler(tmp_path):
    config = tiny_config(max_length=64)
    trainer = OpenProvenceTrainer(
        config, init_params(config, torch.Generator().manual_seed(0)), PairDummyTokenizer(),
        output_dir=tmp_path, learning_rate=1e-3, total_steps=4, bf16=False, device="cpu",
    )
    collator = OpenProvenceDataCollator(
        tokenizer=PairDummyTokenizer(), max_length=64, scores_column="teacher_score",
        chunks_pos_column="context_spans", relevant_chunks_column="context_spans_relevance",
    )
    batch = collator([{
        "query": "rivers", "texts": ["the river runs. plants grow near it."],
        "context_spans": [[[0, 15], [16, 36]]], "context_spans_relevance": [[1, 0]],
        "labels": [1], "teacher_score": [0.7],
    }])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.train(lambda: iter([batch]), total_steps=1, logging_steps=0)
    names = [e.key for e in prof.key_averages()]
    for name in ("train.collate", "train.step", "train.prepare", "train.forward_backward",
                 "train.optimizer"):
        assert name in names, name
    assert trainer.step == 1 and np.isfinite(trainer.log_history[-1]["loss"])


def test_planning_asks_the_card_for_its_memory_once(monkeypatch):
    """``process()`` plans with the card's memory size on every call; the
    driver is asked once a card, and the env override still wins."""
    from open_provence_tpu_torch.inference import preprocess_tuning

    asked = []

    def mem_get_info(index):
        asked.append(index)
        return 1 << 30, 80 << 30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.delenv("OPEN_PROVENCE_DEVICE_MEMORY_GB", raising=False)
    preprocess_tuning._cuda_total_bytes.cache_clear()
    try:
        for _ in range(3):
            assert preprocess_tuning.estimate_device_memory_bytes("cuda:0") == 80 << 30
        assert preprocess_tuning.estimate_device_memory_bytes("cuda:1") == 80 << 30
        assert asked == [0, 1]
        monkeypatch.setenv("OPEN_PROVENCE_DEVICE_MEMORY_GB", "16")
        assert preprocess_tuning.estimate_device_memory_bytes("cuda:0") == 16 << 30
        assert preprocess_tuning.estimate_device_memory_bytes("cpu") == 16 << 30
    finally:
        preprocess_tuning._cuda_total_bytes.cache_clear()
