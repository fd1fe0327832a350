"""The traffic generator repeats exactly for a seed, follows the mixes'
stated distributions, and writes sentences the program's splitter finds."""

from __future__ import annotations

import numpy as np
import pytest

from h100_bench.lib import harness
from h100_bench.lib.textgen import Traffic, quantile_lengths, sentence_lengths

SEED = 2**33 + 11
SERVE_CELLS = ("gte-base.batch512",)


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_process_calls_repeat_for_a_seed(cell):
    mix = harness.Cell.load(cell).mix
    a, b = Traffic(mix, SEED).process_call(3), Traffic(mix, SEED).process_call(3)
    assert a.queries == b.queries and a.passages == b.passages
    c = Traffic(mix, SEED + 1).process_call(3)
    assert c.passages != a.passages


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_process_calls_follow_the_mix(cell):
    mix = harness.Cell.load(cell).mix
    call = Traffic(mix, SEED).process_call(0)
    assert len(call.queries) == mix["queries_per_call"]
    assert all(len(group) == mix["passages_per_query"] for group in call.passages)
    lengths = sorted(sum(len(s) for s in p) for group in call.passages for p in group)
    # Every call and every seed: the distribution's evenly spaced quantiles.
    want = sorted(quantile_lengths(mix["passage_tokens"], call.pairs).tolist())
    assert lengths == want
    other = Traffic(mix, SEED + 5).process_call(7)
    assert sorted(sum(len(s) for s in p) for g in other.passages for p in g) == want
    assert sorted(len(q) for q in call.queries) == sorted(
        quantile_lengths(mix["query_tokens"], len(call.queries)).tolist())
    lo, hi = mix["text"]["sentence_tokens"]
    sizes = [len(s) for g in call.passages for p in g for s in p]
    assert min(sizes) >= lo and max(sizes) <= hi
    median = np.median(lengths)
    assert abs(median - mix["passage_tokens"]["median"]) <= 0.05 * mix["passage_tokens"]["median"]


def test_lognormal_quantiles_have_the_stated_spread():
    dist = {"dist": "lognormal", "median": 300, "sigma": 0.6, "min": 1, "max": 10**6}
    logs = np.log(quantile_lengths(dist, 4096))
    assert abs(np.median(logs) - np.log(300)) < 0.01
    assert abs(np.std(logs) - 0.6) < 0.02


def test_sentence_lengths_sum_and_stay_in_range():
    rng = np.random.default_rng(0)
    for total in (48, 61, 300, 2048):
        parts = sentence_lengths(total, 8, 60, lambda: int(rng.integers(8, 61)))
        assert sum(parts) == total and min(parts) >= 8 and max(parts) <= 60


@pytest.mark.parametrize("cell", SERVE_CELLS)
@pytest.mark.parametrize("median", [300, 4000])
def test_the_programs_splitter_finds_the_sentences(cell, median):
    from open_provence_tpu_torch.text.splitters import resolve_sentence_splitter

    split = resolve_sentence_splitter(None, None)
    mix = harness.Cell.load(cell).mix
    mix = dict(mix, passage_tokens=dict(mix["passage_tokens"], median=median, max=16384))
    call = Traffic(mix, SEED).process_call(1)
    for group in call.passages[:4]:
        for sentences in group:
            assert split("".join(sentences)) == sentences


def test_training_rows_repeat_and_follow_the_mix():
    mix = harness.Cell.load("ruri-310m.train512").mix
    rows = Traffic(mix, SEED).train_rows(2)
    assert rows == Traffic(mix, SEED).train_rows(2)
    assert len(rows) == mix["pairs_per_step"]
    lengths = sorted(len(r["texts"][0]) for r in rows)
    assert lengths == sorted(quantile_lengths(mix["text_tokens"], len(rows)).tolist())
    relevance = [x for r in rows for x in r["context_spans_relevance"][0]]
    assert abs(np.mean(relevance) - mix["relevant_share"]) < 0.05
    lo, hi = mix["spans_per_text"]
    for r in rows:
        text, spans = r["texts"][0], r["context_spans"][0]
        assert lo <= len(spans) <= hi
        # Spans tile the text, the separating spaces left out.
        assert spans[0][0] == 0 and spans[-1][1] == len(text)
        for (a, b), (c, _) in zip(spans, spans[1:]):
            assert c == b + 1 and text[b] == " "
        assert r["labels"] == [int(any(r["context_spans_relevance"][0]))]
        assert 0.0 <= r["teacher_score"][0] < 1.0
