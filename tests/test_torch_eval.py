"""The port's dataset-retention evaluation (``open_provence_tpu_torch.eval``)
against the JAX package's ``eval/datasets_eval.py``, on the CPU.

* The pure functions (``normalize_relevance``, ``extract_sentences``,
  ``infer_predictions``, ``SpanCounters.metrics``, ``build_markdown``,
  ``EvalConfig.load``) give the JAX package's results on the cases of
  tests/test_eval_datasets.py and on seeded random ones.
* ``load_dataset_split`` reads the rows ``datasets`` reads from a
  ``save_to_disk`` directory (a DatasetDict and a single Dataset), and the
  same rows from a directory of ``<split>.jsonl`` files.
* ``run_evaluation`` through both packages on one fp32 tiny model (the JAX
  init moved by ``state_dict_from_flax``) and one toy dataset, at
  thresholds 0, 0.1, 0.5 and 1: every sentence's keep/drop prediction, the
  confusion counts and the metrics are equal, except for a sentence whose
  probability lies within MARGIN of the threshold (counted; none expected);
  sentence probabilities agree within MARGIN.
* ``eval.cli.main`` and ``scripts/eval_datasets_torch.py`` write both
  reports on ``--device cpu``, with the thresholds de-duplicated in order.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from open_provence_tpu.configs import ModernBertBackboneConfig as JaxBackboneConfig
from open_provence_tpu.configs import OpenProvenceConfig as JaxConfig
from open_provence_tpu.eval import datasets_eval as jax_eval
from open_provence_tpu.inference import OpenProvenceModel as JaxModel
from open_provence_tpu.models.model import build_module as build_jax_module
from open_provence_tpu_torch.configs import ModernBertBackboneConfig, OpenProvenceConfig
from open_provence_tpu_torch.encoder import OpenProvenceEncoder
from open_provence_tpu_torch.eval import cli as port_cli
from open_provence_tpu_torch.eval import datasets_eval as port_eval
from open_provence_tpu_torch.inference import OpenProvenceModel
from open_provence_tpu_torch.train.data import write_jsonl_splits
from open_provence_tpu_torch.utils.convert import state_dict_from_flax
from tests.dummy_tokenizers import DummyTokenizer

REPO = Path(__file__).resolve().parent.parent
MARGIN = 1e-4
THRESHOLDS = [0.0, 0.1, 0.5, 1.0]
BACKBONE = dict(
    vocab_size=512, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
    num_attention_heads=2, max_position_embeddings=128, local_attention=16,
    global_attn_every_n_layers=3, pad_token_id=0, num_labels=1,
)
WORDS = "sushi ramen kyoto market travel budget deadline plants river temple".split()


# --- the pure functions ------------------------------------------------------

RELEVANCE_CASES = [([1, 0, 1], 3), ([0, 2], 3), (None, 2), ([5], 3), ([], 0), ([1, 1], 2),
                   ([3, -1, 0], 4), ((0, 1), 2)]
SPAN_CASES = [("abcdef", [[0, 3], [3, 6]]), ("abcdef", [[4, 2]]), ("abcdef", []), ("", []),
              ("abcdefghij", [[2, 2]]), ("abcdefghij", [[0, 100]]), ("abcdefghij", [[-3, 4]])]
PREDICTION_CASES = [(["aaa", "bbb", "ccc"], "aaaccc", 3), (["aaa", "bbb", "ccc"], "", 3),
                    (["aaa", "bbb", "ccc"], "aaabbbccc", 3), (["aaa", "bbb", "ccc"], "x", 0),
                    (["aa", "bb", "cc"], "aab", 3), (["aa", "", "cc"], "aacc", 3),
                    (["aa", "bb"], "aabb", 1)]


@pytest.mark.parametrize("values,count", RELEVANCE_CASES)
def test_normalize_relevance_matches_jax(values, count):
    assert port_eval.normalize_relevance(values, count) == jax_eval.normalize_relevance(
        values, count)


def test_normalize_relevance_cases():
    assert port_eval.normalize_relevance([1, 0, 1], 3) == [1, 0, 1]
    assert port_eval.normalize_relevance([0, 2], 3) == [1, 0, 1]
    assert port_eval.normalize_relevance(None, 2) == [0, 0]
    assert port_eval.normalize_relevance([5], 3) == [0, 0, 0]
    assert port_eval.normalize_relevance([], 0) == []
    with pytest.raises(TypeError):
        port_eval.normalize_relevance(7, 2)


@pytest.mark.parametrize("text,spans", SPAN_CASES)
def test_extract_sentences_matches_jax(text, spans):
    assert port_eval.extract_sentences(text, spans) == jax_eval.extract_sentences(text, spans)


@pytest.mark.parametrize("sentences,pruned,count", PREDICTION_CASES)
def test_infer_predictions_matches_jax(sentences, pruned, count):
    assert port_eval.infer_predictions(sentences, pruned, count) == jax_eval.infer_predictions(
        sentences, pruned, count)


def _fill(counters_cls, seed: int):
    """SpanCounters after 20 seeded contexts: matching and mismatched mask
    lengths (skipped spans), probabilities present and missing."""
    rng = np.random.default_rng(seed)
    counters = counters_cls()
    for _ in range(20):
        n = int(rng.integers(0, 6))
        gold = rng.integers(0, 2, n).tolist()
        predicted = rng.integers(0, 2, n + int(rng.random() < 0.2)).tolist()
        probs = rng.random(n).tolist() if rng.random() < 0.7 else []
        counters.update(gold, predicted, n, probs)
        counters.compression_sum += float(rng.random())
        counters.context_count += 1
    return counters


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_counters_metrics_match_jax(seed):
    timing = {"total_seconds": 1.5}
    got = _fill(port_eval.SpanCounters, seed).metrics(1.5, timing)
    assert got == _fill(jax_eval.SpanCounters, seed).metrics(1.5, timing)
    assert got["span_total"] + got["span_skipped"] > 0
    empty = port_eval.SpanCounters().metrics(0.0, {})
    assert empty == jax_eval.SpanCounters().metrics(0.0, {})
    assert empty["f2"] is None and empty["precision"] is None


def _metadata(datasets):
    return {"timestamp_utc": "t", "model": "m", "config": "c", "batch_size": 4,
            "total_process_time_seconds": 1.25, "thresholds": [0.1, 0.5],
            "datasets": datasets, "per_threshold_process_time_seconds": {"0.1": 0.5, "0.5": 0.75}}


def test_build_markdown_matches_jax():
    datasets = [{"key": "a:test", "split": "test", "n_samples": 3},
                {"key": "b:freq2", "split": "test", "n_samples": 2}]
    results = {0.1: {"a:test": _fill(port_eval.SpanCounters, 0).metrics(0.5, {}),
                     "b:freq2": _fill(port_eval.SpanCounters, 1).metrics(0.25, {})},
               0.5: {"a:test": port_eval.SpanCounters().metrics(0.75, {})}}
    markdown = port_eval.build_markdown(_metadata(datasets), results)
    assert markdown == jax_eval.build_markdown(_metadata(datasets), results)
    assert "### Threshold 0.1" in markdown and "| b:freq2 |" in markdown
    empty = port_eval.build_markdown(_metadata([]), {0.1: {}})
    assert empty == jax_eval.build_markdown(_metadata([]), {0.1: {}})
    assert "(no datasets)" in empty


def test_eval_config_load_matches_jax(tmp_path):
    path = tmp_path / "eval.yaml"
    path.write_text("split: validation\ndatasets:\n  - plain/name\n"
                    "  - dataset_name: x/y\n    subset: freq2\n    n_samples: 5\n"
                    "  - dataset_name: z\n    split: test\n")
    assert port_eval.EvalConfig.load(path).__dict__ == {
        "datasets": [port_eval.DatasetSpec(**vars(s))
                     for s in jax_eval.EvalConfig.load(path).datasets],
        "split": "validation"}
    for text, error in (("- a\n", TypeError), ("split: test\n", ValueError),
                        ("datasets:\n  - 3\n", TypeError)):
        path.write_text(text)
        with pytest.raises(error):
            port_eval.EvalConfig.load(path)


# --- reading datasets ----------------------------------------------------------


def _rows(n: int, seed: int) -> list[dict]:
    """Context-relevance rows (the schema of scripts/make_toy_assets.py:
    129-136) from a numpy seed: 1-3 texts a row of 2-6 sentences each, the
    relevance as a binary mask or, in some texts, as a list of indices."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        topic = str(rng.choice(WORDS))
        texts, spans_all, relevance_all = [], [], []
        for _ in range(int(rng.integers(1, 4))):
            count = int(rng.integers(2, 7))
            mask = rng.integers(0, 2, count).tolist()
            sentences = [
                " ".join([*rng.choice(WORDS, int(rng.integers(3, 7))),
                          *([topic] if keep else [])]) + "."
                for keep in mask
            ]
            text, spans = "", []
            for sentence in sentences:
                start = len(text) + (1 if text else 0)
                text = f"{text} {sentence}" if text else sentence
                spans.append([start, start + len(sentence)])
            texts.append(text)
            spans_all.append(spans)
            relevance_all.append(mask if rng.random() < 0.7
                                 else [i for i, keep in enumerate(mask) if keep])
        rows.append({"query": f"what about {topic}?", "texts": texts,
                     "context_spans": spans_all, "context_spans_relevance": relevance_all})
    return rows


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """One toy dataset three ways: a save_to_disk DatasetDict (test and
    validation), a save_to_disk Dataset and the same splits as JSON lines."""
    from datasets import Dataset, DatasetDict

    root = tmp_path_factory.mktemp("eval_sources")
    splits = {"test": _rows(12, 0), "validation": _rows(4, 1)}
    columns = list(splits["test"][0])

    def table(rows):
        return Dataset.from_dict({c: [r[c] for r in rows] for c in columns})

    DatasetDict({k: table(v) for k, v in splits.items()}).save_to_disk(str(root / "dict"))
    table(splits["test"]).save_to_disk(str(root / "single"))
    write_jsonl_splits(splits, root / "jsonl")
    return {"root": root, "splits": splits}


@pytest.mark.parametrize("name", ["dict", "jsonl"])
@pytest.mark.parametrize("split,n_samples", [("test", None), ("validation", 3), ("test", 50)])
def test_load_dataset_split_reads_the_rows(sources, name, split, n_samples):
    spec = port_eval.DatasetSpec(dataset_name=str(sources["root"] / name), n_samples=n_samples)
    got = port_eval.load_dataset_split(spec, split)
    want = sources["splits"][split][: n_samples or None]
    assert list(got) == want
    jax_spec = jax_eval.DatasetSpec(dataset_name=str(sources["root"] / "dict"),
                                    n_samples=n_samples)
    assert list(got) == list(jax_eval.load_dataset_split(jax_spec, split))


def test_load_dataset_split_single_dataset_and_missing_split(sources):
    spec = port_eval.DatasetSpec(dataset_name=str(sources["root"] / "single"), n_samples=5)
    # A Dataset has no splits: the whole table, whatever the split asked.
    assert list(port_eval.load_dataset_split(spec, "anything")) == sources["splits"]["test"][:5]
    jax_spec = jax_eval.DatasetSpec(dataset_name=str(sources["root"] / "single"), n_samples=5)
    assert list(jax_eval.load_dataset_split(jax_spec, "anything")) == sources["splits"]["test"][:5]
    for name in ("dict", "jsonl"):
        spec = port_eval.DatasetSpec(dataset_name=str(sources["root"] / name))
        with pytest.raises(KeyError, match="Split 'train' not found"):
            port_eval.load_dataset_split(spec, "train")


# --- run_evaluation through both packages -----------------------------------------


def _config(cls, backbone_cls):
    return cls(base_model_config=backbone_cls(**BACKBONE).to_dict(), num_labels=1,
               pruning_config={"hidden_size": 32, "classifier_dropout": 0.0}, max_length=64)


@pytest.fixture(scope="module")
def models():
    jax_config = _config(JaxConfig, JaxBackboneConfig)
    params = build_jax_module(jax_config).init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32),
        attention_impl="xla",
    )["params"]
    config = _config(OpenProvenceConfig, ModernBertBackboneConfig)
    state_dict = state_dict_from_flax(jax.device_get(params), config)
    return {
        "jax": JaxModel(jax_config, params, DummyTokenizer(), attention_impl="xla",
                        bucket_step=16),
        "port": OpenProvenceModel(config, state_dict, DummyTokenizer(), device="cpu",
                                  bucket_step=16),
        "config": config,
        "state_dict": state_dict,
    }


def _eval_config(tmp_path: Path, source: Path) -> Path:
    path = tmp_path / f"eval_{source.name}.yaml"
    path.write_text(f"split: test\ndatasets:\n  - dataset_name: \"{source}\"\n    n_samples: 10\n")
    return path


def _evaluate(module, model, tmp_path, source, tag):
    config_path = _eval_config(tmp_path, source)
    return module.run_evaluation(
        model, module.EvalConfig.load(config_path), model_name="tiny",
        config_path=str(config_path), thresholds=THRESHOLDS, batch_size=4, limit=9,
        output_file=tmp_path / f"{tag}.md", output_json=tmp_path / f"{tag}.json",
    )


def _only(metrics_by_key: dict) -> dict:
    (metrics,) = metrics_by_key.values()
    return metrics


HOST_KEYS = ("process_time_seconds", "timing", "roc_data")


@pytest.mark.parametrize("source", ["dict", "jsonl"])
def test_run_evaluation_matches_jax(models, sources, tmp_path, source):
    jax_run = _evaluate(jax_eval, models["jax"], tmp_path, sources["root"] / "dict", "jax")
    port_run = _evaluate(port_eval, models["port"], tmp_path, sources["root"] / source, "port")
    near_total = 0
    for threshold in THRESHOLDS:
        want, got = _only(jax_run["results"][threshold]), _only(port_run["results"][threshold])
        assert want["contexts"] == got["contexts"] == sum(
            len(r["texts"]) for r in sources["splits"]["test"][:9])
        w_roc, g_roc = want["roc_data"], got["roc_data"]
        assert g_roc["labels"] == w_roc["labels"]
        scores = np.asarray(w_roc["scores"])
        np.testing.assert_allclose(g_roc["scores"], scores, atol=MARGIN, rtol=0)
        near = np.abs(scores - threshold) <= MARGIN
        flips = np.asarray(g_roc["predictions"]) != np.asarray(w_roc["predictions"])
        assert not np.any(flips & ~near), (threshold, np.flatnonzero(flips & ~near))
        near_total += int(near.sum())
        if flips.any():  # only a sentence at the threshold may move a count
            moved = sum(abs(got["confusion_matrix"][k] - want["confusion_matrix"][k])
                        for k in want["confusion_matrix"])
            assert moved <= 2 * int(flips.sum())
            continue
        assert {k: v for k, v in got.items() if k not in HOST_KEYS} == {
            k: v for k, v in want.items() if k not in HOST_KEYS}
    assert near_total == 0, f"{near_total} sentences lie within {MARGIN} of a threshold"
    extremes = (_only(port_run["results"][0.0]), _only(port_run["results"][1.0]))
    assert extremes[0]["recall"] == 1.0 and extremes[0]["mean_compression"] == 0.0
    assert extremes[1]["confusion_matrix"]["tp"] == 0 and extremes[1]["precision"] is None
    payload = json.loads((tmp_path / "port.json").read_text())
    assert set(payload) == {"args", "results"}
    assert list(payload["results"]) == ["0", "0.1", "0.5", "1"]
    assert payload["args"]["limit_override"] == 9
    markdown = (tmp_path / "port.md").read_text()
    for label in ("0", "0.1", "0.5", "1"):
        assert f"### Threshold {label}\n" in markdown


def test_targets_skip_other_datasets(models, sources, tmp_path):
    config_path = _eval_config(tmp_path, sources["root"] / "jsonl")
    run = port_eval.run_evaluation(
        models["port"], port_eval.EvalConfig.load(config_path), model_name="tiny",
        config_path=str(config_path), thresholds=[0.5], targets={"nothing:test"})
    assert run["metadata"]["datasets"] == [] and run["results"] == {0.5: {}}


# --- the CLI ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(models, tmp_path_factory):
    directory = tmp_path_factory.mktemp("eval_ckpt") / "ckpt"
    OpenProvenceEncoder(config=models["config"], state_dict=models["state_dict"],
                        tokenizer=DummyTokenizer(), device="cpu").save_pretrained(directory)
    return directory


def test_cli_writes_both_reports(checkpoint, sources, tmp_path):
    config_path = _eval_config(tmp_path, sources["root"] / "jsonl")
    out = tmp_path / "out"
    rc = port_cli.main(["--config", str(config_path), "--model", str(checkpoint),
                        "--th", "0.5,0", "--th", "0.5", "--batch-size", "8", "--limit", "4",
                        "--attention-impl", "xla", "--device", "cpu", "--silent",
                        "--output-file", str(out / "r.md"), "--output-json", str(out / "r.json")],
                       tokenizer=DummyTokenizer())
    assert rc == 0
    payload = json.loads((out / "r.json").read_text())
    assert payload["args"]["thresholds"] == [0.5, 0.0]
    assert list(payload["results"]) == ["0.5", "0"]
    assert _only(payload["results"]["0"])["contexts"] == sum(
        len(r["texts"]) for r in sources["splits"]["test"][:4])
    assert "### Threshold 0.5" in (out / "r.md").read_text()
    with pytest.raises(SystemExit):
        port_cli.main(["--config", str(config_path), "--model", str(checkpoint),
                       "--attention-impl", "mosaic"])


def test_cli_script_prints_markdown(sources, tmp_path, capsys):
    """scripts/eval_datasets_torch.py on a checkpoint that carries its
    tokenizer files (the toy fast tokenizer), with the default threshold."""
    assets = _load(REPO / "scripts" / "make_toy_assets.py")
    tokenizer, vocab = assets.build_tokenizer(tmp_path / "tok")
    backbone = dict(BACKBONE, vocab_size=vocab)
    config = OpenProvenceConfig(base_model_config=ModernBertBackboneConfig(**backbone).to_dict(),
                                pruning_config={"hidden_size": 32, "classifier_dropout": 0.0},
                                max_length=64)
    from open_provence_tpu_torch.utils.convert import init_params

    directory = OpenProvenceEncoder(
        config=config, state_dict=init_params(config, torch.Generator().manual_seed(0)),
        tokenizer=tokenizer, device="cpu").save_pretrained(tmp_path / "ckpt")
    config_path = _eval_config(tmp_path, sources["root"] / "dict")
    script = _load(REPO / "scripts" / "eval_datasets_torch.py")
    assert script.main(["--config", str(config_path), "--model", str(directory),
                        "--device", "cpu", "--no-progress", "--limit", "2"]) == 0
    printed = capsys.readouterr().out
    assert "### Threshold 0.1" in printed and "F2 Score" in printed


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
