"""The port's data factory (``open_provence_tpu_torch.datasets_factory``)
against the JAX package's ``datasets_factory``, on the CPU.

Every case of tests/test_datasets_factory.py has a counterpart here that
feeds one seeded input through both packages and compares the results: the
JAX functions on HF ``Dataset``s, the port's on ``RowTable``s; rows through
``to_list()`` (with their column names), statistics and dropped IDs exactly,
shard files byte for byte.

* ``RowTable``'s HF operations (``from_list``, ``from_dict``,
  ``add_column``, ``remove_columns``, ``filter`` with indices) give HF's
  rows and columns, and raise where HF raises.
* The converter, the frequency filter, span labeling with an injected
  annotator and its shard cache, teacher scores and the prompt helpers give
  the JAX package's results on seeded rows.
* The encoder teacher: ``make_encoder_annotator`` and ``add_teacher_scores``
  on the JAX encoder and the port's encoder of one checkpoint (the toy
  backbone of scripts/make_toy_assets.py, with its fast tokenizer), on
  pairs of mixed lengths. The JAX encoder attends the tokenizer's padding
  (ROADMAP C), so it gets the padding-free tokenizer of
  tests/test_torch_encoder.py.
* ``datasets_factory.cli``: every command end to end on JSON-lines input
  and on ``save_to_disk`` input, in process; ``generate`` and
  ``frequency_filter`` against the JAX scripts' output; the encoder commands
  against the library calls on the same encoder; the script wrappers reach
  their commands.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from datasets import Dataset, DatasetDict, load_from_disk

import open_provence_tpu.datasets_factory as jax_factory
import open_provence_tpu_torch.datasets_factory as port_factory
from open_provence_tpu.datasets_factory import converter as jax_converter
from open_provence_tpu.encoder import OpenProvenceEncoder as JaxEncoder
from open_provence_tpu_torch import OpenProvenceEncoder
from open_provence_tpu_torch.configs import ModernBertBackboneConfig, OpenProvenceConfig
from open_provence_tpu_torch.datasets_factory import cli as port_cli
from open_provence_tpu_torch.datasets_factory import converter as port_converter
from open_provence_tpu_torch.train.data import RowTable, write_jsonl_splits
from open_provence_tpu_torch.utils.convert import init_params
from tests.dummy_tokenizers import PairDummyTokenizer
from tests.test_torch_encoder import Unpadded

REPO = Path(__file__).resolve().parent.parent
WORDS = ("sushi ramen kyoto tokyo market dish travel spring budget spreadsheet deadline "
         "plants river temple garden festival").split()
MARGIN = 1e-4


def _sentence(rng: np.random.Generator) -> str:
    words = rng.choice(WORDS, int(rng.integers(3, 8)))
    return " ".join(words).capitalize() + str(rng.choice([".", "!", "?", "."]))


def _text(rng: np.random.Generator, low: int = 1, high: int = 5) -> str:
    return " ".join(_sentence(rng) for _ in range(int(rng.integers(low, high))))


def _triplets(n: int, seed: int, negatives: int = 3) -> list[dict]:
    """Sentence-transformers rows: query, positive, negative_1..k."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {"query": f"what about {rng.choice(WORDS)} {i} ?", "positive": _text(rng)}
        for k in range(negatives):
            row[f"negative_{k + 1}"] = _text(rng)
        rows.append(row)
    return rows


def _context_rows(n: int, seed: int, texts: int = 2, prefix: str = "r") -> list[dict]:
    """Context-relevance rows (id, query, texts, context_spans) whose spans
    are the generic splitter's."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row_texts = [_text(rng, 2, 6) for _ in range(texts)]
        rows.append({
            "id": f"{prefix}{i}", "query": f"about {rng.choice(WORDS)}", "texts": row_texts,
            "context_spans": [port_converter.text_to_spans(
                t, port_converter.generic_sentence_splitter) for t in row_texts],
        })
    return rows


def _hf(rows: list[dict]) -> Dataset:
    return Dataset.from_list(rows)


def _same_table(port, jax) -> None:
    assert port.column_names == jax.column_names
    assert port.to_list() == jax.to_list()


def _same_splits(port: dict, jax) -> None:
    assert list(port) == list(jax)
    for name in port:
        _same_table(port[name], jax[name])


def test_all_is_the_jax_packages():
    assert port_factory.__all__ == jax_factory.__all__
    assert all(callable(getattr(port_factory, name)) for name in port_factory.__all__)


# --- RowTable against HF Dataset ------------------------------------------------

RAGGED_ROWS = [{"b": 1, "a": [1, 2]}, {"a": [3], "c": "dropped"}, {"b": 3, "a": []}]
TABLE_OPS = {
    "add_column": lambda t: t.add_column("new", [10, 20, 30]),
    "add_then_remove": lambda t: t.add_column("new", [[1], [2], [3]]).remove_columns("b"),
    "remove_list": lambda t: t.add_column("z", ["x", "y", "w"]).remove_columns(["a", "b"]),
    "filter_with_indices": lambda t: t.filter(lambda row, idx: idx != 1, with_indices=True),
    "filter_rows": lambda t: t.filter(lambda row: len(row["a"]) > 0),
    "select_shuffle": lambda t: t.shuffle(seed=3).select([2, 0]),
}


@pytest.mark.parametrize("op", list(TABLE_OPS))
def test_row_table_operations_match_hf(op):
    port = TABLE_OPS[op](RowTable.from_list(RAGGED_ROWS))
    _same_table(port, TABLE_OPS[op](Dataset.from_list(RAGGED_ROWS)))


TABLE_ERRORS = {
    "add_existing": lambda t: t.add_column("a", [1, 2, 3]),
    "add_wrong_length": lambda t: t.add_column("z", [1]),
    "remove_missing": lambda t: t.remove_columns("zz"),
}


@pytest.mark.parametrize("op", list(TABLE_ERRORS))
def test_row_table_errors_match_hf(op):
    for table in (RowTable.from_list(RAGGED_ROWS), Dataset.from_list(RAGGED_ROWS)):
        with pytest.raises(ValueError):
            TABLE_ERRORS[op](table)


def test_row_table_from_list_and_from_dict_match_hf():
    """Arrow's rules: the first row's keys, in its order; None for a key a
    row lacks; an empty table keeps the columns it was given."""
    _same_table(RowTable.from_list(RAGGED_ROWS), Dataset.from_list(RAGGED_ROWS))
    assert RowTable.from_list([]).column_names == Dataset.from_list([]).column_names == []
    empty = {c: [] for c in ("id", "query", "texts")}
    _same_table(RowTable.from_dict(empty), Dataset.from_dict(empty))
    columns = {"x": [1, 2], "y": ["a", "b"]}
    _same_table(RowTable.from_dict(columns), Dataset.from_dict(columns))
    with pytest.raises(ValueError):
        RowTable.from_dict({"x": [1], "y": []})


# --- converter -------------------------------------------------------------------

FIELD_CASES = [
    {"query": "q", "positive": "p", "negative_1": "n1", "negative_2": "n2"},
    {"question": "q", "answer": "a"},
    {"prompt": ["list", "", "query"], "target": 7, "neg": None, "negative": "z"},
    {"query": "", "question": "second", "pos": "p", "negative_2": "b", "negative_1": "a"},
    {"positive": "p"},
    {"query": "q"},
]


@pytest.mark.parametrize("example", FIELD_CASES)
def test_extract_fields_matches_jax(example):
    try:
        want = jax_factory.extract_fields(example)
    except ValueError as error:
        with pytest.raises(ValueError, match=str(error)):
            port_factory.extract_fields(example)
        return
    assert port_factory.extract_fields(example) == want


SPAN_TEXTS = [
    "First sentence. Second sentence! Third?",
    "One line only",
    "",
    "   ",
    "  spaced.   out.  ",
    "Repeat. Repeat. Repeat.",
    "Line one\nline two\n\nline three.",
    "京都は良い。寺が多い！本当？",
]


@pytest.mark.parametrize("language", ["generic", "en", "ja", "de", "xx"])
@pytest.mark.parametrize("text", SPAN_TEXTS)
def test_text_to_spans_matches_jax(text, language):
    def splitter(module):
        if language == "generic":
            return module.generic_sentence_splitter
        return module.resolve_factory_splitter(language)

    got = port_factory.text_to_spans(text, splitter(port_converter))
    assert got == jax_factory.text_to_spans(text, splitter(jax_converter))
    assert all(0 <= s <= e <= len(text) for s, e in got)


def test_build_record_and_slug_match_jax():
    for idx, example in enumerate(_triplets(6, seed=1, negatives=2)):
        kw = dict(splitter=port_converter.generic_sentence_splitter, idx=idx,
                  dataset_slug="slug", split="train")
        want = jax_factory.build_record(
            example, **{**kw, "splitter": jax_converter.generic_sentence_splitter})
        assert port_factory.build_record(example, **kw) == want
        assert want["id"] == f"slug:train:{idx}" and want["labels"] == [1, 0, 0]
    for name, subset in (("a/b/c", None), ("tomaarsen/nq", "triplet-5"), ("x", "")):
        assert port_factory.slugify_dataset_name(name, subset) == \
            jax_factory.slugify_dataset_name(name, subset)


@pytest.mark.parametrize("total", [0, 1, 2, 3, 4, 5, 50, 64, 99, 100, 149, 151, 1000, 100_000,
                                   10_000_000])
def test_split_policy_matches_jax(total):
    assert port_factory.compute_split_size(total) == jax_factory.compute_split_size(total)
    if total == 0:
        for module in (port_converter, jax_converter):
            with pytest.raises(ValueError):
                module._eval_carve_plan(0)
        return
    plan = port_converter._eval_carve_plan(total)
    assert plan == jax_converter._eval_carve_plan(total)
    if total > 1:
        assert total - sum(plan) >= 1


@pytest.mark.parametrize("n,seed", [(2, 0), (3, 1), (50, 0), (64, 7), (151, 42)])
def test_ensure_eval_splits_matches_jax(n, seed):
    """The same rows in the same order in each carved split."""
    rows = _triplets(n, seed=seed, negatives=1)
    got = port_factory.ensure_eval_splits({"train": RowTable.from_list(rows)}, seed=seed)
    want = jax_factory.ensure_eval_splits({"train": _hf(rows)}, seed=seed)
    _same_splits(got, want)
    assert sum(len(t) for t in got.values()) == n
    complete = {"train": RowTable.from_list(rows), "validation": RowTable.from_list(rows[:1]),
                "test": RowTable.from_list(rows[1:2])}
    assert port_factory.ensure_eval_splits(complete, seed=seed) is complete


def _source(form: str, splits: dict[str, list[dict]]):
    """The splits as the converter's input of each form."""
    if form == "row_table":
        return RowTable.from_list(splits["train"])
    if form == "hf_dataset":
        return _hf(splits["train"])
    if form == "tables":
        return {k: RowTable.from_list(v) for k, v in splits.items()}
    return DatasetDict({k: _hf(v) for k, v in splits.items()})


@pytest.mark.parametrize("form", ["row_table", "hf_dataset", "tables", "hf_dict"])
@pytest.mark.parametrize("language,sample_size,seed", [("en", None, 42), ("en", 7, 3),
                                                       ("ja", 100, 0), ("fr", None, 5)])
def test_convert_dataset_dict_matches_jax(form, language, sample_size, seed):
    splits = {"train": _triplets(23, seed=seed)}
    if form in ("tables", "hf_dict"):
        splits["validation"] = _triplets(4, seed=seed + 100)
    kw = dict(language=language, dataset_slug="toy", sample_size=sample_size, seed=seed)
    got = port_factory.convert_dataset_dict(_source(form, splits), **kw)
    want = jax_factory.convert_dataset_dict(
        DatasetDict({k: _hf(v) for k, v in splits.items()}), **kw)
    assert all(isinstance(t, RowTable) for t in got.values())
    _same_splits(got, want)
    assert got["train"].column_names == ["id", "query", "texts", "context_spans", "labels"]


def test_convert_keeps_the_columns_of_an_empty_split():
    splits = {"train": _triplets(5, seed=0), "validation": _triplets(2, seed=1)}
    empty = {c: [] for c in splits["train"][0]}
    got = port_factory.convert_dataset_dict(
        {**{k: RowTable.from_list(v) for k, v in splits.items()},
         "test": RowTable.from_dict(empty)}, language="en", dataset_slug="toy")
    want = jax_factory.convert_dataset_dict(
        DatasetDict({**{k: _hf(v) for k, v in splits.items()}, "test": Dataset.from_dict(empty)}),
        language="en", dataset_slug="toy")
    _same_splits(got, want)
    assert len(got["test"]) == 0 and got["test"].column_names == list(port_converter._EMPTY_COLUMNS)


@pytest.mark.parametrize("source,kw", [({"validation": _triplets(2, 0)}, {}),
                                       ({"train": _triplets(3, 0)}, {"sample_size": 0})])
def test_convert_errors_match_jax(source, kw):
    with pytest.raises(ValueError) as want:
        jax_factory.convert_dataset_dict(
            DatasetDict({k: _hf(v) for k, v in source.items()}),
            language="en", dataset_slug="x", **kw)
    with pytest.raises(ValueError, match=str(want.value)):
        port_factory.convert_dataset_dict(
            {k: RowTable.from_list(v) for k, v in source.items()},
            language="en", dataset_slug="x", **kw)


# --- labeling ----------------------------------------------------------------------

ANNOTATORS = {
    "topic": lambda query, chunks: [i for i, c in enumerate(chunks)
                                    if query.split()[-1] in c.lower()],
    "none": lambda query, chunks: [],
    "out_of_range": lambda query, chunks: [-1, 0, len(chunks), len(chunks) + 3],
    "every_other": lambda query, chunks: list(range(0, len(chunks), 2)),
}


@pytest.mark.parametrize("relabel", [False, True])
@pytest.mark.parametrize("annotator", list(ANNOTATORS))
def test_annotate_span_relevance_matches_jax(annotator, relabel):
    rows = _context_rows(7, seed=2)
    if relabel:  # an existing column is replaced, at the end
        rows = [{**r, "context_spans_relevance": [[9]] * len(r["texts"])} for r in rows]
    fn = ANNOTATORS[annotator]
    got = port_factory.annotate_span_relevance(RowTable.from_list(rows), fn)
    want = jax_factory.annotate_span_relevance(_hf(rows), fn)
    _same_table(got, want)
    assert got.column_names[-1] == "context_spans_relevance"


def _shards(directory: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir())}


@pytest.mark.parametrize("shard_size", [1, 2, 10])
def test_shard_cache_matches_jax(tmp_path, shard_size):
    """Shard files byte for byte; a second run reads every row back without
    calling the annotator; a corrupt shard is recomputed."""
    rows = _context_rows(5, seed=3)
    calls = {"port": 0, "jax": 0}

    def counting(side):
        def annotate(query, chunks):
            calls[side] += 1
            return [len(chunks) - 1]
        return annotate

    tables = {"port": (port_factory, RowTable.from_list(rows)), "jax": (jax_factory, _hf(rows))}
    outputs = {}
    for side, (module, table) in tables.items():
        cache = module.ShardCache(tmp_path / side, shard_size=shard_size)
        outputs[side] = module.annotate_span_relevance(table, counting(side), cache=cache)
    _same_table(outputs["port"], outputs["jax"])
    assert _shards(tmp_path / "port") == _shards(tmp_path / "jax")
    first = dict(calls)
    assert first["port"] == first["jax"] == sum(len(r["texts"]) for r in rows)
    for side, (module, table) in tables.items():
        again = module.annotate_span_relevance(
            table, counting(side), cache=module.ShardCache(tmp_path / side, shard_size=shard_size))
        assert again.to_list() == outputs[side].to_list()
    assert calls == first
    for side in tables:
        (tmp_path / side / "shard-000000.json").write_text("{not json")
    for side, (module, table) in tables.items():
        module.annotate_span_relevance(
            table, counting(side), cache=module.ShardCache(tmp_path / side, shard_size=shard_size))
    assert calls["port"] == calls["jax"] > first["port"]
    assert _shards(tmp_path / "port") == _shards(tmp_path / "jax")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prompt_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    query = "x" * int(rng.integers(0, 300))
    chunks = [_text(rng) * int(rng.integers(1, 20)) for _ in range(int(rng.integers(1, 25)))]
    assert port_factory.build_chunk_prompt(query, chunks) == jax_factory.build_chunk_prompt(
        query, chunks)
    for iteration in range(5):
        assert port_factory.truncate_content(query, chunks, iteration) == \
            jax_factory.truncate_content(query, chunks, iteration)
    response = " ".join(str(v) for v in rng.integers(-3, 30, 12))
    for n in (0, 3, 30):
        assert port_factory.parse_indices(response, n) == jax_factory.parse_indices(response, n)
    indices = rng.integers(-2, 12, 8).tolist()
    assert port_factory.to_flags(indices, 10) == jax_factory.to_flags(indices, 10)


@pytest.mark.parametrize("batch_size", [1, 3, 32])
def test_add_teacher_scores_matches_jax(batch_size):
    rows = _context_rows(6, seed=4, texts=3)
    rows[2]["texts"] = rows[2]["texts"][:1]  # a row of one text

    def predict(pairs):
        return [float(len(t)) / (1 + len(q)) for q, t in pairs]

    for relabel in (False, True):
        if relabel:
            rows = [{**r, "teacher_scores.toy": [0.0]} for r in rows]
        got = port_factory.add_teacher_scores(RowTable.from_list(rows), predict,
                                              teacher_name="toy", batch_size=batch_size)
        want = jax_factory.add_teacher_scores(_hf(rows), predict, teacher_name="toy",
                                              batch_size=batch_size)
        _same_table(got, want)


class _Response:
    def __init__(self, content: str):
        self._content = content

    def raise_for_status(self) -> None:
        return None

    def json(self) -> dict:
        return {"choices": [{"message": {"content": self._content}}]}


def test_openai_annotator_matches_jax_with_a_fake_transport(monkeypatch):
    """The same request for the same chunks, and the same indices back;
    no key raises."""
    import httpx

    sent = []

    def post(url, **kwargs):
        sent.append((url, kwargs))
        return _Response("relevant: [1] and [3], not 9")

    monkeypatch.setattr(httpx, "post", post)
    monkeypatch.setenv("OPENAI_API_KEY", "k")
    monkeypatch.setenv("OPENAI_BASE_URL", "http://localhost:1/v1/")
    chunks = ["aaa", "bbb", "ccc"]
    got = port_factory.make_openai_annotator("m", request_timeout=3.0)("q?", chunks)
    want = jax_factory.make_openai_annotator("m", request_timeout=3.0)("q?", chunks)
    assert got == want == [0, 2]
    assert sent[0] == sent[1] and sent[0][0] == "http://localhost:1/v1/chat/completions"
    monkeypatch.delenv("OPENAI_API_KEY")
    with pytest.raises(OSError):
        port_factory.make_openai_annotator("m")("q?", chunks)


# --- frequency filter -----------------------------------------------------------------


def _duplicate_rows(n: int, seed: int, with_ids: bool = True) -> list[dict]:
    """Rows of 2-4 texts drawn from a small pool, so that texts repeat."""
    rng = np.random.default_rng(seed)
    pool = [_sentence(rng) for _ in range(12)]
    rows = []
    for i in range(n):
        texts = [str(t) for t in rng.choice(pool, int(rng.integers(2, 5)))]
        rows.append({"id": f"row-{i}", "texts": texts} if with_ids else {"texts": texts})
    return rows


@pytest.mark.parametrize("threshold", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_frequency_filter_matches_jax(threshold, seed):
    rows = _duplicate_rows(40, seed)
    got, got_stats, got_dropped = port_factory.frequency_filter_train(
        RowTable.from_list(rows), threshold)
    want, want_stats, want_dropped = jax_factory.frequency_filter_train(_hf(rows), threshold)
    _same_table(got, want)
    assert got_stats.to_dict() == want_stats.to_dict()
    assert got_dropped == want_dropped
    assert got_stats.rows_removed == len(got_dropped)


def test_frequency_filter_cases_match_jax():
    """tests/test_datasets_factory.py's case, row indices for a missing id
    column, and the threshold check."""
    rows = [{"id": f"r{i}", "texts": t}
            for i, t in enumerate([["a", "b"], ["a", "c"], ["a", "b"], ["d", "e"]])]
    for threshold, dropped in ((1, {"r2"}), (0, {"r1", "r2"})):
        got = port_factory.frequency_filter_train(RowTable.from_list(rows), threshold)
        want = jax_factory.frequency_filter_train(_hf(rows), threshold)
        assert got[2] == want[2] == dropped
        assert got[1].to_dict() == want[1].to_dict()
    no_ids = _duplicate_rows(12, seed=5, with_ids=False)
    got = port_factory.frequency_filter_train(RowTable.from_list(no_ids), 0)
    want = jax_factory.frequency_filter_train(_hf(no_ids), 0)
    assert got[2] == want[2] and got[2] <= {str(i) for i in range(12)}
    _same_table(got[0], want[0])
    with pytest.raises(ValueError):
        port_factory.frequency_filter_train(RowTable.from_list(rows), -1)


# --- the encoder teacher against the JAX encoder --------------------------------------------


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    """The JAX encoder (padding-free tokenizer) and the port's encoder of one
    checkpoint: the toy backbone, saved by the JAX encoder."""
    sys.path.insert(0, str(REPO / "scripts"))
    from make_toy_assets import build_backbone_dir, build_tokenizer

    tmp = tmp_path_factory.mktemp("teacher")
    tokenizer, vocab_size = build_tokenizer(tmp / "backbone")
    build_backbone_dir(tmp / "backbone", vocab_size)
    jax_encoder = JaxEncoder(tmp / "backbone", tokenizer=tokenizer, max_length=64,
                             attention_impl="xla", bucket_step=16)
    saved = jax_encoder.save_pretrained(tmp / "saved")
    port_encoder = OpenProvenceEncoder.from_pretrained(saved, tokenizer=tokenizer, device="cpu",
                                                       bucket_step=16)
    jax_encoder.tokenizer = Unpadded(tokenizer)
    return jax_encoder, port_encoder


def _toy_rows(n: int, seed: int) -> list[dict]:
    """Rows of toy-vocabulary texts of 1-6 sentences (mixed lengths)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        texts = [" ".join(" ".join(rng.choice(WORDS, int(rng.integers(3, 8)))) + " ."
                          for _ in range(int(rng.integers(1, 7))))
                 for _ in range(int(rng.integers(1, 4)))]
        rows.append({"id": f"t{i}", "query": f"what about {rng.choice(WORDS)} ?", "texts": texts,
                     "context_spans": [port_converter.text_to_spans(
                         t, port_converter.generic_sentence_splitter) for t in texts]})
    return rows


class _Recording:
    """The encoder, keeping each ``predict_context`` output."""

    def __init__(self, encoder):
        self.encoder, self.outputs = encoder, []

    def predict_context(self, *args, **kwargs):
        out = self.encoder.predict_context(*args, **kwargs)
        self.outputs.append(out)
        return out


@pytest.mark.parametrize("token_threshold,chunk_threshold", [(0.5, 0.5), (0.3, 0.2), (0.6, 0.9)])
def test_encoder_annotator_matches_jax(teachers, token_threshold, chunk_threshold):
    """One pair a call: every flag equal, except in a pair where a token's
    probability lies within MARGIN of the token threshold (none expected);
    token probabilities within MARGIN."""
    jax_encoder, port_encoder = teachers
    rows = _toy_rows(6, seed=11)
    kw = dict(token_threshold=token_threshold, chunk_threshold=chunk_threshold)
    port_rec, jax_rec = _Recording(port_encoder), _Recording(jax_encoder)
    got = port_factory.annotate_span_relevance(
        RowTable.from_list(rows), port_factory.make_encoder_annotator(port_rec, **kw))
    want = jax_factory.annotate_span_relevance(
        _hf(rows), jax_factory.make_encoder_annotator(jax_rec, **kw))
    assert got.column_names == want.column_names
    assert len(port_rec.outputs) == len(jax_rec.outputs) == sum(len(r["texts"]) for r in rows)
    near = 0
    flat_got = [f for row in got.to_list() for f in row["context_spans_relevance"]]
    flat_want = [f for row in want.to_list() for f in row["context_spans_relevance"]]
    for mine, theirs, p_out, j_out in zip(flat_got, flat_want, port_rec.outputs, jax_rec.outputs):
        np.testing.assert_allclose(p_out.token_scores, j_out.token_scores, atol=MARGIN)
        close = bool(np.any(np.abs(np.asarray(j_out.token_scores) - token_threshold) <= MARGIN))
        near += close
        if not close:
            assert mine == theirs
    assert near == 0, f"{near} pairs hold a token within {MARGIN} of the threshold"
    assert any(any(flags) for flags in flat_got) or token_threshold > 0.5


@pytest.mark.parametrize("batch_size", [1, 4, 32])
def test_teacher_scores_match_jax_encoder(teachers, batch_size):
    """add_teacher_scores through encoder.predict on mixed-length pairs, as
    the add_reranker_teacher_scores command calls it: scores within 1e-5."""
    jax_encoder, port_encoder = teachers
    rows = _toy_rows(7, seed=12)
    got = port_factory.add_teacher_scores(
        RowTable.from_list(rows), lambda pairs: port_encoder.predict(pairs, batch_size=batch_size),
        teacher_name="toy", batch_size=batch_size)
    want = jax_factory.add_teacher_scores(
        _hf(rows), lambda pairs: jax_encoder.predict(pairs, batch_size=batch_size),
        teacher_name="toy", batch_size=batch_size)
    assert got.column_names == want.column_names
    for mine, theirs in zip(got.to_list(), want.to_list()):
        assert len(mine["teacher_scores.toy"]) == len(mine["texts"])
        np.testing.assert_allclose(mine["teacher_scores.toy"], theirs["teacher_scores.toy"],
                                   atol=1e-5)


# --- the commands ------------------------------------------------------------------------


def _write(form: str, splits: dict[str, list[dict]], path: Path) -> Path:
    if form == "jsonl":
        return write_jsonl_splits(splits, path)
    DatasetDict({k: _hf(v) for k, v in splits.items()}).save_to_disk(str(path))
    return path


def _read(path: Path) -> dict[str, list[dict]]:
    """Every split of a command's output, in either form."""
    if (path / "dataset_dict.json").exists():
        return {k: v.to_list() for k, v in load_from_disk(str(path)).items()}
    return {p.stem: [json.loads(line) for line in p.read_text().splitlines()]
            for p in sorted(path.glob("*.jsonl"))}


def _jax_script(name: str):
    path = REPO / "scripts" / "context_relevance_datasets" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _unslug(splits: dict[str, list[dict]], slug: str) -> dict[str, list[dict]]:
    return {k: [{**r, "id": r["id"].replace(slug, "SRC", 1)} for r in v]
            for k, v in splits.items()}


def _output_form(form: str, path: Path) -> None:
    if form == "jsonl":
        assert not (path / "dataset_dict.json").exists() and any(path.glob("*.jsonl"))
    else:
        assert (path / "dataset_dict.json").exists()


@pytest.mark.parametrize("form", ["jsonl", "disk"])
def test_generate_and_filter_commands_match_jax_scripts(tmp_path, form):
    """generate then frequency_filter through the port's CLI on either form,
    against the JAX scripts on the save_to_disk form: the same splits, rows
    and order (IDs carry the source path), the same statistics file."""
    train = _triplets(30, seed=8)
    train += [dict(train[i], query=f"again {i} ?") for i in (3, 5, 7)]  # repeated texts
    src = _write(form, {"train": train}, tmp_path / f"src_{form}")
    ref = _write("disk", {"train": train}, tmp_path / "src_ref")

    assert port_cli.main(["generate", "--dataset", str(src), "--lang", "en", "--seed", "3",
                          "--output-dir", str(tmp_path / "gen")]) == 0
    assert _jax_script("generate_ds_from_sentence_transformer").main(
        ["--dataset", str(ref), "--lang", "en", "--seed", "3",
         "--output-dir", str(tmp_path / "gen_ref")]) == 0
    _output_form(form, tmp_path / "gen")
    got, want = _read(tmp_path / "gen"), _read(tmp_path / "gen_ref")
    assert sorted(got) == sorted(want) == ["test", "train", "validation"]
    assert _unslug(got, str(src).replace("/", "_")) == _unslug(want, str(ref).replace("/", "_"))
    assert [len(got[k]) for k in ("validation", "test")] == list(
        port_converter._eval_carve_plan(len(train)))

    assert port_cli.main(["frequency_filter", "--dataset", str(tmp_path / "gen"),
                          "--threshold", "1", "--output-dir", str(tmp_path / "freq")]) == 0
    assert _jax_script("frequency_filter_ds").main(
        ["--dataset", str(tmp_path / "gen_ref"), "--threshold", "1",
         "--output-dir", str(tmp_path / "freq_ref")]) == 0
    _output_form(form, tmp_path / "freq")
    got, want = _read(tmp_path / "freq"), _read(tmp_path / "freq_ref")
    assert _unslug(got, str(src).replace("/", "_")) == _unslug(want, str(ref).replace("/", "_"))
    stats = (tmp_path / "freq" / "frequency_filter_stats.json").read_text()
    assert stats == (tmp_path / "freq_ref" / "frequency_filter_stats.json").read_text()
    assert json.loads(stats)["train"]["rows_removed"] >= 1


@pytest.fixture(scope="module")
def teacher_dir(tmp_path_factory):
    """A tiny port checkpoint for the char-level PairDummyTokenizer."""
    backbone = ModernBertBackboneConfig(
        vocab_size=512, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=2, local_attention=16, pad_token_id=0)
    config = OpenProvenceConfig(base_model_config=backbone.to_dict(), max_length=96,
                                pruning_config={"hidden_size": 32, "classifier_dropout": 0.0})
    encoder = OpenProvenceEncoder(config=config,
                                  state_dict=init_params(config, torch.Generator().manual_seed(0)),
                                  tokenizer=PairDummyTokenizer(), device="cpu")
    return encoder.save_pretrained(tmp_path_factory.mktemp("teacher_ckpt") / "toy-teacher")


@pytest.mark.parametrize("form", ["jsonl", "disk"])
def test_label_and_score_commands_end_to_end(tmp_path, teacher_dir, form):
    """add_context_spans_relevance (encoder teacher, shard cache, one split
    and all) then add_reranker_teacher_scores, on either form: the output
    keeps the input's form, the .tmp directory is gone, one flag a span, and
    the values are those of the library calls on the same encoder. The
    shard cache is keyed by row ID and every split starts at shard 0 (the
    JAX script's cache, ROADMAP C), so the IDs differ across splits, as the
    converter's do."""
    splits = {"train": _context_rows(5, seed=20, texts=3, prefix="train-"),
              "validation": _context_rows(2, 21, prefix="validation-")}
    src = _write(form, splits, tmp_path / "src")
    tok = PairDummyTokenizer()
    base = ["--teacher-model", str(teacher_dir), "--device", "cpu"]
    assert port_cli.main(["add_context_spans_relevance", "--dataset", str(src), *base,
                          "--split", "validation", "--output-dir", str(tmp_path / "one")],
                         tokenizer=tok) == 0
    one = _read(tmp_path / "one")
    assert "context_spans_relevance" not in one["train"][0]
    assert "context_spans_relevance" in one["validation"][0]
    out = tmp_path / "labeled"
    for _ in range(2):  # the second run reads every row from the cache
        assert port_cli.main(["add_context_spans_relevance", "--dataset", str(src), *base,
                              "--cache-dir", str(tmp_path / "cache"), "--token-threshold", "0.4",
                              "--output-dir", str(out)], tokenizer=tok) == 0
    _output_form(form, out)
    assert not out.with_name("labeled.tmp").exists()
    assert port_cli.main(["add_reranker_teacher_scores", "--dataset", str(out), *base,
                          "--batch-size", "4", "--output-dir", str(tmp_path / "scored")],
                         tokenizer=tok) == 0
    _output_form(form, tmp_path / "scored")
    scored = _read(tmp_path / "scored")

    encoder = OpenProvenceEncoder.from_pretrained(teacher_dir, tokenizer=tok, device="cpu")
    annotator = port_factory.make_encoder_annotator(encoder, token_threshold=0.4)
    for name, rows in splits.items():
        want = port_factory.annotate_span_relevance(RowTable.from_list(rows), annotator)
        want = port_factory.add_teacher_scores(
            want, lambda pairs: encoder.predict(pairs, batch_size=4),
            teacher_name="toy-teacher", batch_size=4)
        assert list(scored[name][0]) == want.column_names == [
            "id", "query", "texts", "context_spans", "context_spans_relevance",
            "teacher_scores.toy-teacher"]
        for got_row, want_row in zip(scored[name], want.to_list()):
            assert got_row["context_spans_relevance"] == want_row["context_spans_relevance"]
            assert [len(f) for f in got_row["context_spans_relevance"]] == [
                len(s) for s in got_row["context_spans"]]
            np.testing.assert_allclose(got_row["teacher_scores.toy-teacher"],
                                       want_row["teacher_scores.toy-teacher"], atol=1e-6)


@pytest.mark.parametrize("form", ["jsonl", "disk"])
def test_upload_dry_run_reads_either_form(tmp_path, capsys, form):
    src = _write(form, {"train": _context_rows(3, 0), "test": _context_rows(1, 1)},
                 tmp_path / "src")
    assert port_cli.main(["upload", "--dataset", str(src), "--repo-id", "u/x", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "[dry-run] Skipping push_to_hub." in out
    assert "test=1" in out and "train=3" in out


SCRIPTS = {
    "generate_ds_from_sentence_transformer": "generate",
    "frequency_filter_ds": "frequency_filter",
    "add_context_spans_relevance": "add_context_spans_relevance",
    "add_reranker_teacher_scores": "add_reranker_teacher_scores",
    "upload_context_relevance_to_hf": "upload",
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_script_wrappers_reach_their_command(script, monkeypatch):
    """Each ``*_torch.py`` wrapper hands its arguments to its command."""
    seen = {}

    def command(args, tokenizer):
        seen.update(vars(args))
        return 0

    monkeypatch.setitem(port_cli.COMMANDS, SCRIPTS[script], command)
    path = REPO / "scripts" / "context_relevance_datasets" / f"{script}_torch.py"
    spec = importlib.util.spec_from_file_location(f"wrapper_{script}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    required = {"upload": ["--repo-id", "u/x"]}.get(SCRIPTS[script], ["--output-dir", "o"])
    if SCRIPTS[script].startswith("add_"):
        required += ["--teacher-model", "t"]
    assert module.main(["--dataset", "d", *required]) == 0
    assert seen["command"] == SCRIPTS[script] and seen["dataset"] == "d"
