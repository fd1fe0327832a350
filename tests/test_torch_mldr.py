"""The port's MLDR evaluation (``eval/mldr_eval.py``, ``eval/mldr_cli.py``,
``eval/mldr_ignore.py``, ``eval/external_baselines.py``) against the JAX
package's ``eval/mldr_eval.py``, ``eval/external_baselines.py`` and
``scripts/eval_mldr.py``, on the CPU.

* Every case of tests/test_eval_mldr.py runs through both packages on one
  input: records, statistics, summaries, prompts, judge payloads, ignore
  lists and judged records are equal (the ``perf_counter`` timings left
  out); the judge's prompt and system prompt are the JAX package's, byte for
  byte, and so are both Markdown reports.
* ``build_records`` on the JAX model's ``process`` and the port's, one
  fp32 weight set (``state_dict_from_flax``), titled and untitled passages
  (the engine's host fallback for fragment means under a title prefix):
  pruned texts and the kept and removed sentences equal, scores within 1e-5.
* ``eval.mldr_cli`` end to end on JSON-lines input and on ``save_to_disk``
  input with a fake judge, the stage-skip rerun, ``--text-source original``
  and ``--threshold 0``, against the JAX script on the same weights;
  ``eval.mldr_ignore`` with a fake judge; the naver adapter with a fake
  model; the script wrappers reach their CLIs.
"""

from __future__ import annotations

import asyncio
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from datasets import Dataset, DatasetDict

import open_provence_tpu.eval.mldr_eval as jax_mldr
from open_provence_tpu.configs import ModernBertBackboneConfig as JaxBackboneConfig
from open_provence_tpu.configs import OpenProvenceConfig as JaxConfig
from open_provence_tpu.eval import external_baselines as jax_baselines
from open_provence_tpu.inference import OpenProvenceModel as JaxModel
from open_provence_tpu.models.model import build_module as build_jax_module
from open_provence_tpu_torch.configs import ModernBertBackboneConfig, OpenProvenceConfig
from open_provence_tpu_torch.encoder import OpenProvenceEncoder
from open_provence_tpu_torch.eval import external_baselines as port_baselines
from open_provence_tpu_torch.eval import mldr_cli, mldr_ignore
from open_provence_tpu_torch.eval import mldr_eval as port_mldr
from open_provence_tpu_torch.inference import OpenProvenceModel
from open_provence_tpu_torch.train.data import write_jsonl_splits
from open_provence_tpu_torch.utils.convert import state_dict_from_flax
from tests.dummy_tokenizers import DummyTokenizer

REPO = Path(__file__).resolve().parent.parent
SHIPPED_IGNORES = REPO / "scripts" / "eval_mldr" / "ignored_questions.yaml"
BACKBONE = dict(
    vocab_size=512, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
    num_attention_heads=2, max_position_embeddings=128, local_attention=16,
    global_attn_every_n_layers=3, pad_token_id=0, num_labels=1,
)
WORDS = "sushi ramen kyoto market travel budget deadline plants river temple".split()
TIMINGS = ("process_time_seconds", "evaluation_time_seconds", "llm_latency", "latency")


def _mldr_rows():
    """tests/test_eval_mldr.py's rows."""
    return [
        {
            "query_id": "q-en-1",
            "query": "what about sushi?",
            "positive_passages": [
                {"docid": "d1", "title": "Sushi", "text": "sushi is great. more text."},
            ],
            "negative_passages": [
                {"docid": "d2", "title": None, "text": "budget spreadsheets. boring."},
            ],
        },
        {
            "query_id": "q-en-2",
            "query": "what about plants?",
            "positive_passages": [
                {"docid": "d3", "title": ["Plant", "Care"], "text": "water the plants."},
            ],
            "negative_passages": [],
        },
    ]


def _seeded_rows(n: int, seed: int, empty_query: bool = True) -> list[dict]:
    """MLDR rows from a numpy seed: 1 positive and 0-3 negatives of 2-9
    sentences, titled (a string) or untitled (None) at random; with
    ``empty_query`` one row without passages."""
    rng = np.random.default_rng(seed)
    rows = []
    for q in range(n):
        topic = str(rng.choice(WORDS))

        def passage(kind: str, k: int) -> dict:
            sentences = [
                " ".join(rng.choice(WORDS, int(rng.integers(3, 7)))) + "."
                for _ in range(int(rng.integers(2, 10)))
            ]
            title = f"About {rng.choice(WORDS)}" if rng.random() < 0.5 else None
            return {"docid": f"{kind}{q}-{k}", "title": title, "text": " ".join(sentences)}

        rows.append({
            "query_id": f"q-en-{q}",
            "query": f"what about {topic}?",
            "positive_passages": [passage("p", 0)],
            "negative_passages": [passage("n", k) for k in range(int(rng.integers(0, 4)))],
        })
    if empty_query:
        rows.append({"query_id": "q-en-empty", "query": "nothing?", "positive_passages": [],
                     "negative_passages": []})
    return rows


def _fake_process(question, context, title, threshold, batch_size,
                  use_best_reranker_score, show_progress, return_sentence_texts):
    """tests/test_eval_mldr.py's fake process(): prunes nothing."""
    return {
        "pruned_context": [[c for c in ctxs] for ctxs in context],
        "reranking_score": [[0.5 + 0.001 * len(c) for c in ctxs] for ctxs in context],
        "compression_rate": [[10.0 for _ in ctxs] for ctxs in context],
        "kept_sentences": [[[c] for c in ctxs] for ctxs in context],
        "removed_sentences": [[[] for _ in ctxs] for ctxs in context],
        "title": title,
    }


def _short_process(question, context, title, **kwargs):
    """A process() whose nested lists come back short and without titles:
    the records' defaults."""
    return {"pruned_context": [ctxs[:1] for ctxs in context], "reranking_score": None,
            "compression_rate": [[]] * len(context), "title": [["Model title"]] * len(context)}


def _strip(value):
    """``value`` without the perf_counter timings."""
    if isinstance(value, dict):
        return {k: _strip(v) for k, v in value.items() if k not in TIMINGS}
    if isinstance(value, list):
        return [_strip(v) for v in value]
    return value


# --- the functions of tests/test_eval_mldr.py --------------------------------------

TITLES = ["  Sushi ", ["A", None, " B "], "", None, [], ("x", "y"), 7, ["", "  "], "  "]


@pytest.mark.parametrize("value", TITLES)
def test_normalize_title_matches_jax(value):
    assert port_mldr.normalize_title(value) == jax_mldr.normalize_title(value)


ROW_SETS = {"test_rows": _mldr_rows, "seeded_0": lambda: _seeded_rows(6, 0),
            "seeded_1": lambda: _seeded_rows(9, 1), "empty": lambda: []}


@pytest.mark.parametrize("process", [_fake_process, _short_process])
@pytest.mark.parametrize("rows", list(ROW_SETS))
def test_build_records_matches_jax(rows, process):
    kw = dict(threshold=0.1, batch_size=4)
    got = port_mldr.build_records(process, ROW_SETS[rows](), **kw)
    want = jax_mldr.build_records(process, ROW_SETS[rows](), **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if rows == "test_rows" and process is _fake_process:
        records, stats, n_queries = got
        assert n_queries == 2 and len(records) == 3
        assert records[2]["title"] == "Plant Care" and stats["pos_compression"] == [10.0, 10.0]


@pytest.mark.parametrize("rows", list(ROW_SETS))
def test_build_original_records_and_summary_match_jax(rows):
    got = port_mldr.build_original_records(ROW_SETS[rows]())
    want = jax_mldr.build_original_records(ROW_SETS[rows]())
    assert got == want
    records, stats, n = got
    assert all(r["pruned_text"] == r["original_text"] for r in records)
    payload = {"threshold": 0.1, "model": "m"}
    for module, result in ((port_mldr, got), (jax_mldr, want)):
        assert module.process_summary(*result, args_payload=payload, elapsed=1.5) == \
            jax_mldr.process_summary(*want, args_payload=payload, elapsed=1.5)
    fake = port_mldr.build_records(_fake_process, ROW_SETS[rows](), threshold=0.1, batch_size=4)
    summary = port_mldr.process_summary(*fake, args_payload=payload, elapsed=2.0)
    assert summary == jax_mldr.process_summary(*fake, args_payload=payload, elapsed=2.0)


def test_reports_match_jax_byte_for_byte(tmp_path):
    records, _, _ = port_mldr.build_records(_fake_process, _seeded_rows(8, 2), threshold=0.1,
                                            batch_size=4)
    records[0]["reranking_score"] = None
    records[1]["pruned_text"] = ""
    for module, name in ((port_mldr, "port"), (jax_mldr, "jax")):
        module.write_markdown_report(records, tmp_path / name / "result.md", threshold=0.1,
                                     max_queries=3)
    assert (tmp_path / "port" / "result.md").read_bytes() == \
        (tmp_path / "jax" / "result.md").read_bytes()
    summary = {"llm_model": "m", "reasoning_effort": None, "records_evaluated": 3,
               "counts": {"has_answer_1": 2, "has_answer_0": 0, "failed": 1},
               "answer_score_stats": {"mean": 0.5, "median": 0.5, "min": 0.1, "max": 0.9},
               "evaluation_time_seconds": 1.25}
    for stats in (summary["answer_score_stats"], None):
        summary["answer_score_stats"] = stats
        for module, name in ((port_mldr, "port"), (jax_mldr, "jax")):
            module.write_eval_summary_md(summary, tmp_path / name / "summary.md",
                                         extra={"Dataset": "d", "Language": "en"})
        assert (tmp_path / "port" / "summary.md").read_bytes() == \
            (tmp_path / "jax" / "summary.md").read_bytes()


JUDGE_PAYLOADS = [
    '{"has_answer": 1, "answer_score": 0.9, "reasoning": "yes"}',
    '{"contains_answer": 0, "reason": "no"}',
    '{"has_answer": 0, "answer_score": null, "reasoning": "x", "extra": 1}',
    '{"has_answer": 2, "reasoning": "x"}',
    '{"has_answer": 1, "answer_score": 1.5, "reasoning": "x"}',
    '{"has_answer": 1, "reasoning": 3}',
    '[1, 2]',
    "not json",
]


@pytest.mark.parametrize("content", JUDGE_PAYLOADS)
def test_parse_judge_payload_matches_jax(content):
    try:
        want = jax_mldr.parse_judge_payload(content)
    except (ValueError, json.JSONDecodeError) as error:
        with pytest.raises(type(error)):
            port_mldr.parse_judge_payload(content)
        return
    assert port_mldr.parse_judge_payload(content) == want


@pytest.mark.parametrize("question,text,title", [
    ("q?", "some text", "T"), ("", "", None), ("  spaced  ", "\n text \n", "  "),
    ("日本語の質問？", "本文。", "題"),
])
def test_judge_prompt_matches_jax_byte_for_byte(question, text, title):
    assert port_mldr.SYSTEM_PROMPT == jax_mldr.SYSTEM_PROMPT
    assert port_mldr._JUDGE_INSTRUCTION == jax_mldr._JUDGE_INSTRUCTION
    got = port_mldr.build_user_prompt(question, text, title)
    assert got.encode() == jax_mldr.build_user_prompt(question, text, title).encode()


def test_judge_config_matches_jax():
    assert port_mldr.JudgeConfig().__dict__ == jax_mldr.JudgeConfig().__dict__


FILTER_RECORDS = [
    {"query_id": "q1", "label": 1, "pruned_text": "x" * 100},
    {"query_id": "q2", "label": 1, "pruned_text": "keep"},
    {"query_id": "q3", "label": 0, "pruned_text": "neg"},
    {"query_id": 4, "label": 1, "pruned_text": None},
]


@pytest.mark.parametrize("ignore_map", [{}, {"q1": "oversize"}, {"4": "int id"}])
@pytest.mark.parametrize("include_negatives", [False, True])
@pytest.mark.parametrize("max_text_chars", [10, 0, -5, 60000])
def test_filter_records_for_judging_matches_jax(ignore_map, include_negatives, max_text_chars):
    kw = dict(ignore_map=ignore_map, include_negatives=include_negatives,
              max_text_chars=max_text_chars)
    assert port_mldr.filter_records_for_judging(FILTER_RECORDS, **kw) == \
        jax_mldr.filter_records_for_judging(FILTER_RECORDS, **kw)


IGNORE_FILES = {
    "en_ja": "en:\n- qid: q-en-1\n  reason: oversize\nja: []\n",
    "jp_alias": "en: []\njp:\n- qid: q-ja-7\n  reason: oversize\n",
    "odd_entries": "en:\n- qid: 5\n  reason: '  padded  '\n- reason: no qid\n- qid: q\n",
    "empty": "",
}


@pytest.mark.parametrize("lang", ["en", "ja", "jp", "de"])
@pytest.mark.parametrize("text", list(IGNORE_FILES))
def test_load_ignore_list_matches_jax(tmp_path, text, lang):
    path = tmp_path / "ig.yaml"
    path.write_text(IGNORE_FILES[text])
    assert port_mldr.load_ignore_list(path, lang) == jax_mldr.load_ignore_list(path, lang)


def test_shipped_ignore_list_matches_jax():
    for lang in ("en", "ja", "jp"):
        assert port_mldr.load_ignore_list(SHIPPED_IGNORES, lang) == \
            jax_mldr.load_ignore_list(SHIPPED_IGNORES, lang)
    en = port_mldr.load_ignore_list(SHIPPED_IGNORES, "en")
    assert len(en) == 26 and len(port_mldr.load_ignore_list(SHIPPED_IGNORES, "ja")) == 34
    records = [{"query_id": qid, "label": 1, "pruned_text": "t"} for qid in en]
    records.append({"query_id": "q-en-keep", "label": 1, "pruned_text": "t"})
    filtered, skipped = port_mldr.filter_records_for_judging(records, ignore_map=en)
    assert [r["query_id"] for r in filtered] == ["q-en-keep"]
    assert {s["query_id"] for s in skipped} == set(en)


async def _fake_judge(prompt, config):
    if "sushi" in prompt:
        return {"has_answer": 1, "answer_score": 0.9, "reasoning": "found"}
    if "plants" in prompt:
        return {"has_answer": 0, "answer_score": None, "reasoning": "absent"}
    raise ValueError("judge exploded")


def test_judge_records_matches_jax():
    records = [
        {"query_id": "q1", "query": "sushi?", "pruned_text": "sushi here", "title": None},
        {"query_id": "q2", "query": "other?", "pruned_text": "nothing", "title": "T"},
        {"query_id": "q3", "query": "plants?", "pruned_text": "", "title": None},
    ]
    kw = dict(retries=1, retry_delay=0.0, request_timeout=2.0)
    got, got_summary = port_mldr.judge_records(records, port_mldr.JudgeConfig(**kw),
                                               judge_fn=_fake_judge)
    want, want_summary = jax_mldr.judge_records(records, jax_mldr.JudgeConfig(**kw),
                                                judge_fn=_fake_judge)
    assert _strip(got) == _strip(want) and _strip(got_summary) == _strip(want_summary)
    assert got[1]["llm_has_answer"] is None and got[1]["llm_attempts"] == 2
    assert got_summary["counts"] == {"has_answer_1": 1, "has_answer_0": 1, "failed": 1}


@pytest.mark.parametrize("retries", [0, 2])
def test_evaluate_batch_failures_match_jax(retries):
    async def failing(prompt, config):
        raise TimeoutError("too slow")

    async def silent(prompt, config):
        raise TimeoutError()

    records = [{"query_id": "q", "query": "q", "pruned_text": "t", "title": None}]
    for judge in (failing, silent):
        results = [
            asyncio.run(module.evaluate_batch(
                records, module.JudgeConfig(retries=retries, retry_delay=0.0,
                                            request_timeout=0.001), judge_fn=judge))
            for module in (port_mldr, jax_mldr)
        ]
        assert _strip(results[0]) == _strip(results[1])
        assert results[0][0]["has_answer"] is None and results[0][0]["attempts"] == retries + 1
        assert results[0][0]["error"] in ("too slow", "TimeoutError")


def test_call_openai_judge_matches_jax_with_a_fake_transport(monkeypatch):
    """The same request body for each model family, the same parsed payload;
    no key raises."""
    import httpx

    bodies = []

    class Client:
        def __init__(self, timeout):
            self.timeout = timeout

        async def __aenter__(self):
            return self

        async def __aexit__(self, *exc):
            return False

        async def post(self, url, headers, json):
            bodies.append((url, json, self.timeout))

            class Response:
                def raise_for_status(self):
                    return None

                def json(self):
                    return {"choices": [{"message": {
                        "content": '{"has_answer": 1, "answer_score": 0.5, "reasoning": "r"}'}}]}
            return Response()

    monkeypatch.setattr(httpx, "AsyncClient", Client)
    monkeypatch.setenv("OPENAI_API_KEY", "k")
    for kw in ({}, {"model": "gpt-4o", "reasoning_effort": None, "base_url": "http://x/v1/"}):
        got = asyncio.run(port_mldr.call_openai_judge("p", port_mldr.JudgeConfig(**kw)))
        want = asyncio.run(jax_mldr.call_openai_judge("p", jax_mldr.JudgeConfig(**kw)))
        assert got == want and bodies[-1] == bodies[-2]
    monkeypatch.delenv("OPENAI_API_KEY")
    with pytest.raises(OSError):
        asyncio.run(port_mldr.call_openai_judge("p", port_mldr.JudgeConfig()))


# --- build_records on both models -------------------------------------------------------


def _config(cls, backbone_cls):
    return cls(base_model_config=backbone_cls(**BACKBONE).to_dict(), num_labels=1,
               pruning_config={"hidden_size": 32, "classifier_dropout": 0.0}, max_length=64)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX model and the port's model on one fp32 weight set, and the
    port's checkpoint directory of it."""
    jax_config = _config(JaxConfig, JaxBackboneConfig)
    params = build_jax_module(jax_config).init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32),
        attention_impl="xla",
    )["params"]
    config = _config(OpenProvenceConfig, ModernBertBackboneConfig)
    state_dict = state_dict_from_flax(jax.device_get(params), config)
    checkpoint = OpenProvenceEncoder(config=config, state_dict=state_dict,
                                     tokenizer=DummyTokenizer(), device="cpu").save_pretrained(
        tmp_path_factory.mktemp("mldr_ckpt") / "tiny")
    return {
        "jax": JaxModel(jax_config, params, DummyTokenizer(), attention_impl="xla",
                        bucket_step=16),
        "port": OpenProvenceModel(config, state_dict, DummyTokenizer(), device="cpu",
                                  bucket_step=16),
        "checkpoint": checkpoint,
    }


def _assert_same_records(got: list[dict], want: list[dict]) -> None:
    """Texts and sentences equal; scores and compression within 1e-5."""
    assert len(got) == len(want)
    for mine, theirs in zip(got, want):
        assert set(mine) == set(theirs)
        for key in theirs:
            if key in ("reranking_score", "compression_rate") and theirs[key] is not None:
                np.testing.assert_allclose(mine[key], theirs[key], atol=1e-5, err_msg=key)
            else:
                assert mine[key] == theirs[key], key


@pytest.mark.parametrize("threshold", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("seed", [3, 4])
def test_build_records_on_both_models(models, threshold, seed):
    """Titled and untitled passages: the title prefix sends fragment means to
    the engine's host path on both sides."""
    rows = _seeded_rows(5, seed)
    titled = sum(p["title"] is not None for r in rows
                 for p in r["positive_passages"] + r["negative_passages"])
    assert 0 < titled < sum(len(r["positive_passages"] + r["negative_passages"]) for r in rows)
    kw = dict(threshold=threshold, batch_size=4)
    got, got_stats, got_n = port_mldr.build_records(models["port"].process, rows, **kw)
    want, want_stats, want_n = jax_mldr.build_records(models["jax"].process, rows, **kw)
    assert got_n == want_n == 5
    _assert_same_records(got, want)
    for key in want_stats:
        np.testing.assert_allclose(got_stats[key], want_stats[key], atol=1e-5, err_msg=key)
    if threshold == 0.0:
        assert all(r["pruned_text"] == r["original_text"] and not r["removed_sentences"]
                   for r in got)
    assert any(r["kept_sentences"] for r in got) == (threshold < 1.0)


# --- the CLIs -------------------------------------------------------------------------


def _cli_rows() -> list[dict]:
    """Four seeded rows; the second's ID, q-en-2, is on the shipped ignore
    list."""
    rows = _seeded_rows(4, 5, empty_query=False)
    rows[1]["query_id"], rows[2]["query_id"] = "q-en-2", "q-en-7"
    return rows


def _write_mldr(form: str, rows: list[dict], path: Path) -> Path:
    if form == "jsonl":
        return write_jsonl_splits({"test": rows, "dev": rows[:1]}, path)
    DatasetDict({"test": Dataset.from_list(rows), "dev": Dataset.from_list(rows[:1])}
                ).save_to_disk(str(path))
    return path


def _read_records(path: Path) -> list[dict]:
    return mldr_cli.read_records(path)[0]


def _jax_cli(monkeypatch, model):
    import open_provence_tpu.inference as jax_inference

    monkeypatch.setattr(jax_inference.OpenProvenceModel, "from_pretrained",
                        classmethod(lambda cls, *a, **k: model))
    spec = importlib.util.spec_from_file_location("jax_eval_mldr",
                                                  REPO / "scripts" / "eval_mldr.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("form", ["jsonl", "disk"])
def test_mldr_cli_matches_jax_script(models, tmp_path, monkeypatch, form):
    """Both stages through the port's CLI (a checkpoint directory,
    ``--device cpu``) and the JAX script (its model on the same weights),
    the judge replaced in each module: the same records, summaries and
    judged records; the records keep the input's form; a rerun skips both
    stages; ``--text-source original`` and ``--threshold 0`` give every
    passage back."""
    rows = _cli_rows()
    src = _write_mldr(form, rows, tmp_path / "mldr")
    ref = _write_mldr("disk", rows, tmp_path / "mldr_ref")
    calls = {"n": 0}

    async def judge(prompt, config):
        calls["n"] += 1
        return {"has_answer": int("sushi" in prompt), "answer_score": 0.25, "reasoning": "ok"}

    monkeypatch.setattr(port_mldr, "call_openai_judge", judge)
    monkeypatch.setattr(jax_mldr, "call_openai_judge", judge)
    common = ["--threshold", "0.1", "--batch-size", "4", "--limit", "3", "--no-progress",
              "--ignore-file", str(SHIPPED_IGNORES)]
    port_args = ["--model", str(models["checkpoint"]), "--dataset", str(src),
                 "--output-dir", str(tmp_path / "port"), "--device", "cpu", *common]
    assert mldr_cli.main(port_args, tokenizer=DummyTokenizer()) == 0
    jax_cli = _jax_cli(monkeypatch, models["jax"])
    assert jax_cli.main(["--model", "ignored", "--dataset", str(ref),
                         "--output-dir", str(tmp_path / "jax"), *common]) == 0

    process = tmp_path / "port" / "process"
    assert (process / "dataset" / "records.jsonl").exists() == (form == "jsonl")
    got, want = _read_records(process / "dataset"), _read_records(tmp_path / "jax/process/dataset")
    assert len(got) == sum(1 + len(r["negative_passages"]) for r in rows[:3])
    _assert_same_records(got, want)
    got_summary = json.loads((process / "summary.json").read_text())
    want_summary = json.loads((tmp_path / "jax/process/summary.json").read_text())
    assert set(got_summary) == set(want_summary) and got_summary["model"] == str(
        models["checkpoint"])
    for key in ("num_records", "num_queries", "limit", "threshold", "source_text"):
        assert got_summary[key] == want_summary[key], key
    assert (process / "result.md").exists()

    judged = _read_records(tmp_path / "port" / "eval_llm" / "dataset")
    assert [r["query_id"] for r in judged] == ["q-en-0", "q-en-7"]  # positives, q-en-2 ignored
    _assert_same_records(_strip(judged), _strip(_read_records(tmp_path / "jax/eval_llm/dataset")))
    got_eval = json.loads((tmp_path / "port" / "eval_llm" / "summary.json").read_text())
    want_eval = json.loads((tmp_path / "jax" / "eval_llm" / "summary.json").read_text())
    assert _strip({**got_eval, "input_dataset": None}) == _strip({**want_eval,
                                                                  "input_dataset": None})
    assert got_eval["ignored_count"] == 1 + len(rows[1]["negative_passages"])
    assert (tmp_path / "port/eval_llm/summary.md").exists()

    # The stage skip: nothing is recomputed or judged again.
    before, stamp = calls["n"], (process / "summary.json").stat().st_mtime_ns
    assert mldr_cli.main(port_args, tokenizer=DummyTokenizer()) == 0
    assert calls["n"] == before and (process / "summary.json").stat().st_mtime_ns == stamp

    for extra, name in ((["--text-source", "original"], "process_original"),
                        (["--threshold", "0", "--force-process", "--no-eval"], "process")):
        args = [*port_args, *extra]
        assert mldr_cli.main(args, tokenizer=DummyTokenizer()) == 0
        records = _read_records(tmp_path / "port" / name / "dataset")
        assert len(records) == len(got)
        assert all(r["pruned_text"] == r["original_text"] for r in records)
    original = json.loads((tmp_path / "port/process_original/summary.json").read_text())
    assert original["avg_pos_compression"] == 0.0 and original["avg_pos_score"] is None


def test_mldr_cli_requires_a_model_and_an_ignore_list(models, tmp_path):
    src = _write_mldr("jsonl", _cli_rows(), tmp_path / "mldr")
    with pytest.raises(SystemExit):
        mldr_cli.main(["--dataset", str(src), "--output-dir", str(tmp_path / "a")])
    with pytest.raises(FileNotFoundError):
        mldr_cli.main(["--dataset", str(src), "--output-dir", str(tmp_path / "b"),
                       "--text-source", "original", "--ignore-file", str(tmp_path / "none")])


def test_mldr_ignore_with_a_fake_judge(tmp_path, monkeypatch):
    """Oversize positives flagged without the judge, the judge's flags
    kept, a failed judgement skipped, other languages of the file kept; the
    prompt is the JAX script's."""
    rows = _cli_rows()
    rows[0]["positive_passages"][0]["text"] = "x" * 2000
    src = write_jsonl_splits({"test": rows}, tmp_path / "mldr")
    asked = []

    async def judge(question, positives, config):
        asked.append((question, len(positives), config.model))
        if question == rows[2]["query"]:
            raise ValueError("down")
        return {"ignore": int(question == rows[1]["query"]), "reason": "malformed"}

    monkeypatch.setattr(mldr_ignore, "judge_question", judge)
    output = tmp_path / "ig.yaml"
    output.write_text("ja:\n- qid: q-ja-1\n  reason: kept\n")
    assert mldr_ignore.main(["--dataset", str(src), "--max-chars", "1000", "--output", str(output),
                             "--llm-model", "m"]) == 0
    assert sorted(asked) == sorted((r["query"], 1, "m") for r in rows[1:])
    en = port_mldr.load_ignore_list(output, "en")
    assert set(en) == {"q-en-0", "q-en-2"} and en["q-en-2"] == "malformed"
    assert "2000 characters > 1000" in en["q-en-0"]
    assert port_mldr.load_ignore_list(output, "ja") == {"q-ja-1": "kept"}
    spec = importlib.util.spec_from_file_location(
        "jax_ignore", REPO / "scripts" / "eval_mldr" / "generate_ignore_qid.py")
    jax_ignore = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_ignore)
    for positives in ([], ["a", "b"]):
        assert mldr_ignore.build_prompt("q?", positives) == jax_ignore.build_prompt("q?", positives)


@pytest.mark.parametrize("script,module,attribute", [
    ("eval_mldr_torch.py", mldr_cli, "run_process"),
    ("eval_mldr/generate_ignore_qid_torch.py", mldr_ignore, "run"),
])
def test_mldr_script_wrappers_reach_their_cli(script, module, attribute, monkeypatch, tmp_path):
    seen = {}

    def stub(args, *rest):
        seen.update(vars(args))
        if attribute == "run":
            async def nothing():
                return []
            return nothing()
        return tmp_path

    monkeypatch.setattr(module, attribute, stub)
    spec = importlib.util.spec_from_file_location("wrapper", REPO / "scripts" / script)
    wrapper = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wrapper)
    argv = ["--output-dir", str(tmp_path), "--no-eval"] if attribute == "run_process" else [
        "--output", str(tmp_path / "ig.yaml")]
    assert wrapper.main(argv) == 0
    assert seen["lang"] == "en"


# --- the naver-provence adapter -------------------------------------------------------------

NAVER_IDS = [("naver/provence-reranker-debertav3-v1", False), ("NAVER/Provence-XL", False),
             ("naver/splade-v3", False), ("my/provence-clone", False),
             ("naver/provence-reranker-debertav3-v1", True), (str(Path(__file__).parent), None),
             ("  naver/provence  ", False)]


@pytest.mark.parametrize("identifier,is_local", NAVER_IDS)
def test_naver_detection_matches_jax(identifier, is_local):
    assert port_baselines.is_naver_provence_model(identifier, is_local=is_local) == \
        jax_baselines.is_naver_provence_model(identifier, is_local=is_local)


class FakeConfig:
    max_position_embeddings = 512


class FakeNaver:
    """tests/test_eval_mldr.py's fake remote model."""

    def __init__(self):
        self.config = FakeConfig()
        self.max_len = 512
        self.eval_called = False
        self.device = None

    def forward(self, *args, **kwargs):
        return {
            "ranking_scores": torch.ones(2, dtype=torch.bfloat16),
            "compression_logits": torch.zeros(2, 3, dtype=torch.bfloat16),
            "other": "untouched",
        }

    def eval(self):
        self.eval_called = True
        return self

    def to(self, device):
        self.device = device
        return self

    def process(self, question, context, **kwargs):
        out = self.forward()
        return {"pruned_context": context, "reranking_score": float(out["ranking_scores"][0])}


@pytest.mark.parametrize("max_length", [None, 1024])
def test_naver_adapter_with_a_fake_model(max_length):
    model = FakeNaver()
    process_fn = port_baselines.prepare_naver_provence_model(model, max_length=max_length)
    assert model.max_len == model.config.max_position_embeddings == (max_length or 512)
    out = model.forward()
    assert out["ranking_scores"].dtype == torch.float32
    assert out["compression_logits"].dtype == torch.float32 and out["other"] == "untouched"
    assert process_fn("q?", "ctx") == {"pruned_context": "ctx", "reranking_score": 1.0}

    class FakeAutoModel:
        last = None

        @classmethod
        def from_pretrained(cls, ident, **kwargs):
            cls.last = (ident, kwargs)
            return FakeNaver()

    fn, loaded = port_baselines.load_naver_process_fn(
        "naver/provence-reranker-debertav3-v1", max_length=2048, device="cpu",
        torch_dtype=torch.bfloat16, auto_model_cls=FakeAutoModel)
    assert loaded.eval_called and loaded.max_len == 2048 and loaded.device == "cpu"
    assert FakeAutoModel.last == ("naver/provence-reranker-debertav3-v1",
                                  {"trust_remote_code": True, "torch_dtype": torch.bfloat16})
    assert fn("q?", "ctx")["pruned_context"] == "ctx"


def test_naver_adapter_requires_process():
    class NoProcess:
        def forward(self, *a, **k):
            return {}

    for module in (port_baselines, jax_baselines):
        with pytest.raises(AttributeError, match="process"):
            module.prepare_naver_provence_model(NoProcess())


def test_naver_route_of_the_cli(tmp_path, monkeypatch):
    """A naver hub id loads through the adapter, on the CLI's device."""
    seen = {}

    def load(identifier, **kwargs):
        seen.update(kwargs, identifier=identifier)
        return _fake_process, None

    monkeypatch.setattr(port_baselines, "load_naver_process_fn", load)
    src = _write_mldr("jsonl", _cli_rows(), tmp_path / "mldr")
    assert mldr_cli.main(["--model", "naver/provence-reranker-debertav3-v1", "--dataset", str(src),
                          "--output-dir", str(tmp_path / "out"), "--no-eval", "--device", "cpu",
                          "--max-length", "1024", "--no-progress"]) == 0
    assert seen == {"identifier": "naver/provence-reranker-debertav3-v1", "max_length": 1024,
                    "device": "cpu", "disable_progress": True}
    records = _read_records(tmp_path / "out" / "process" / "dataset")
    assert all(r["compression_rate"] == 10.0 for r in records)
