"""Dataset-retention evaluation: span-level F2 / precision / recall /
compression sweeps over thresholds.

The port's copy of the JAX package's ``eval/datasets_eval.py`` (library
form of the reference's scripts/eval_datasets.py): one
``process(..., return_sentence_metrics=True)`` call per dataset on the
port's ``OpenProvenceModel``, gold masks from ``context_spans_relevance``,
predictions inferred by prefix-matching kept sentences inside the pruned
text, F2 = 5PR/(4P+R) (reference eval_datasets.py:247-486). The metric
math and the Markdown/JSON reports are the JAX package's, line for line.

Datasets are read by the training data's source reader
(``train/data.py::_open_source``) into a ``RowTable``: a local
``save_to_disk`` directory or a hub name through HF ``datasets`` (imported
at use), or a local directory of ``<split>.jsonl`` files without it.
"""

from __future__ import annotations

import json
from collections.abc import Sequence
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from time import perf_counter
from typing import Any

from ..train.data import RowTable, _open_source, _SourceSpec


@dataclass
class DatasetSpec:
    dataset_name: str
    subset: str | None = None
    split: str | None = None
    n_samples: int | None = None


@dataclass
class EvalConfig:
    datasets: list[DatasetSpec]
    split: str = "test"

    @classmethod
    def load(cls, path: str | Path) -> "EvalConfig":
        import yaml

        payload = yaml.safe_load(Path(path).read_text())
        if not isinstance(payload, dict):
            raise TypeError("Evaluation config must be a mapping")
        raw_specs = payload.get("datasets")
        if not raw_specs:
            raise ValueError("Evaluation config has no datasets.")
        specs = []
        for raw in raw_specs:
            if isinstance(raw, str):
                specs.append(DatasetSpec(dataset_name=raw))
            elif isinstance(raw, dict):
                specs.append(
                    DatasetSpec(
                        dataset_name=str(raw["dataset_name"]),
                        subset=str(raw["subset"]) if raw.get("subset") is not None else None,
                        split=str(raw["split"]) if raw.get("split") is not None else None,
                        n_samples=int(raw["n_samples"])
                        if raw.get("n_samples") is not None
                        else None,
                    )
                )
            else:
                raise TypeError(f"Unsupported dataset spec: {raw!r}")
        return cls(datasets=specs, split=str(payload.get("split", "test")))


def normalize_relevance(values: Any, span_count: int) -> list[int]:
    """Binary mask or index list → binary mask of span_count
    (reference eval_datasets.py:132-147)."""
    if span_count <= 0:
        return []
    if values is None:
        return [0] * span_count
    if not isinstance(values, Sequence):
        raise TypeError(f"context_spans_relevance must be a sequence, got {type(values)}")
    if len(values) == span_count:
        return [1 if int(v) != 0 else 0 for v in values]
    mask = [0] * span_count
    for value in values:
        index = int(value)
        if 0 <= index < span_count:
            mask[index] = 1
    return mask


def extract_sentences(text: str, spans: Sequence[Sequence[int]]) -> list[str]:
    """Char-span slices of the context text (reference :149-162)."""
    if not spans:
        return [text] if text else []
    sentences = []
    length = len(text)
    for start_raw, end_raw in spans:
        start = max(0, int(start_raw))
        end = min(length, int(end_raw))
        sentences.append("" if end <= start else text[start:end])
    return sentences


def infer_predictions(
    sentences: Sequence[str], pruned_text: str, span_count: int
) -> list[int]:
    """A sentence is predicted 'kept' iff it appears as the next prefix of
    the pruned text (reference :171-184)."""
    if span_count <= 0:
        return []
    predictions = []
    cursor = 0
    for sentence in sentences[:span_count]:
        candidate = sentence or ""
        length = len(candidate)
        if length and pruned_text[cursor : cursor + length] == candidate:
            predictions.append(1)
            cursor += length
        else:
            predictions.append(0)
    return predictions


@dataclass
class SpanCounters:
    """Running confusion-matrix + compression accumulators for one dataset."""

    span_total: int = 0
    span_correct: int = 0
    span_skipped: int = 0
    compression_sum: float = 0.0
    context_count: int = 0
    tp: int = 0
    fp: int = 0
    tn: int = 0
    fn: int = 0
    roc_scores: list[float] = field(default_factory=list)
    roc_labels: list[int] = field(default_factory=list)
    roc_predictions: list[int] = field(default_factory=list)

    def update(
        self,
        gold: list[int],
        predicted: list[int],
        span_count: int,
        sentence_probabilities: Sequence[float],
    ) -> None:
        probabilities_available = len(sentence_probabilities) >= span_count > 0
        if span_count > 0:
            if len(gold) != span_count or len(predicted) != span_count:
                self.span_skipped += span_count
            else:
                self.span_total += span_count
                self.span_correct += sum(1 for a, b in zip(gold, predicted) if a == b)
                for idx, (g, p) in enumerate(zip(gold, predicted)):
                    if g == 1 and p == 1:
                        self.tp += 1
                    elif g == 1 and p == 0:
                        self.fn += 1
                    elif g == 0 and p == 1:
                        self.fp += 1
                    else:
                        self.tn += 1
                    if probabilities_available:
                        self.roc_scores.append(float(sentence_probabilities[idx]))
                        self.roc_labels.append(int(g))
                        self.roc_predictions.append(int(p))

    def metrics(self, process_time: float, timing: dict[str, float]) -> dict[str, Any]:
        accuracy = self.span_correct / self.span_total if self.span_total else None
        compression_mean = (
            self.compression_sum / self.context_count if self.context_count else None
        )
        precision = self.tp / (self.tp + self.fp) if (self.tp + self.fp) else None
        recall = self.tp / (self.tp + self.fn) if (self.tp + self.fn) else None
        if precision is not None and recall is not None and (4 * precision + recall) > 0:
            f2 = (5 * precision * recall) / (4 * precision + recall)
        else:
            f2 = None
        return {
            "span_total": self.span_total,
            "span_correct": self.span_correct,
            "span_accuracy": accuracy,
            "span_skipped": self.span_skipped,
            "contexts": self.context_count,
            "mean_compression": compression_mean,
            "process_time_seconds": process_time,
            "precision": precision,
            "recall": recall,
            "f2": f2,
            "confusion_matrix": {"tp": self.tp, "fp": self.fp, "tn": self.tn, "fn": self.fn},
            "roc_data": {
                "scores": self.roc_scores,
                "labels": self.roc_labels,
                "predictions": self.roc_predictions,
            },
            "timing": timing,
        }


def evaluate_dataset(
    model: Any,
    dataset: Any,
    *,
    threshold: float,
    batch_size: int,
    show_progress: bool = False,
) -> dict[str, Any]:
    """Run one dataset through process() and score spans."""
    questions: list[str] = []
    contexts_nested: list[list[list[str]]] = []
    span_counts_nested: list[list[int]] = []
    relevance_nested: list[list[Any]] = []

    for example in dataset:
        question = example.get("query")
        if question is None:
            continue
        texts = example.get("texts") or []
        spans_list = example.get("context_spans") or []
        relevance_list = example.get("context_spans_relevance") or []
        contexts, span_counts, relevance_entries = [], [], []
        for idx, text in enumerate(texts):
            spans = spans_list[idx] if idx < len(spans_list) else []
            contexts.append(extract_sentences(text, spans))
            span_counts.append(len(spans))
            relevance_entries.append(relevance_list[idx] if idx < len(relevance_list) else [])
        questions.append(str(question))
        contexts_nested.append(contexts)
        span_counts_nested.append(span_counts)
        relevance_nested.append(relevance_entries)

    counters = SpanCounters()
    process_time = 0.0
    timing_summary: dict[str, float] = {}

    if questions:
        start = perf_counter()
        outputs = model.process(
            question=questions,
            context=contexts_nested,
            title=None,
            batch_size=batch_size,
            threshold=threshold,
            show_progress=show_progress,
            return_sentence_metrics=True,
        )
        process_time = perf_counter() - start

        timing_payload = outputs.get("timing") or {}
        if isinstance(timing_payload, dict) and timing_payload:
            timing_summary = {k: float(v) for k, v in timing_payload.items()}
            process_time = timing_summary.get("total_seconds", process_time)

        pruned_all = outputs["pruned_context"]
        compression_all = outputs["compression_rate"]
        probs_all = outputs.get("sentence_probabilities") or []

        for q_idx, sentences_per_query in enumerate(contexts_nested):
            pruned = pruned_all[q_idx] if q_idx < len(pruned_all) else []
            compressions = compression_all[q_idx] if q_idx < len(compression_all) else []
            probs_ctx = probs_all[q_idx] if q_idx < len(probs_all) else []
            for c_idx, sentences in enumerate(sentences_per_query):
                span_count = (
                    span_counts_nested[q_idx][c_idx]
                    if c_idx < len(span_counts_nested[q_idx])
                    else 0
                )
                gold = normalize_relevance(
                    relevance_nested[q_idx][c_idx]
                    if c_idx < len(relevance_nested[q_idx])
                    else [],
                    span_count,
                )
                pruned_text = pruned[c_idx] if c_idx < len(pruned) else ""
                predicted = infer_predictions(sentences, pruned_text, span_count)
                probabilities = (
                    probs_ctx[c_idx]
                    if isinstance(probs_ctx, Sequence) and c_idx < len(probs_ctx)
                    else []
                )
                counters.update(gold, predicted, span_count, probabilities)
                if c_idx < len(compressions):
                    counters.compression_sum += float(compressions[c_idx])
                counters.context_count += 1

    return counters.metrics(process_time, timing_summary)


def format_threshold_label(value: float) -> str:
    numeric = float(value)
    return f"{int(numeric)}" if numeric.is_integer() else f"{numeric:.6g}"


def build_markdown(
    metadata: dict[str, Any],
    results_by_threshold: dict[float, dict[str, dict[str, Any]]],
) -> str:
    """Markdown report with the reference's column layout
    (eval_datasets.py:489-580)."""
    thresholds = [float(v) for v in metadata.get("thresholds") or []]
    labels = [format_threshold_label(v) for v in thresholds]

    def fmt(value, spec=".4f"):
        return format(value, spec) if value is not None else "N/A"

    lines = [
        f"* Timestamp (UTC): {metadata['timestamp_utc']}",
        f"* Model: `{metadata['model']}`",
        f"* Config: `{metadata['config']}`",
        f"* Batch size: {metadata['batch_size']}",
        f"* Total process time (s): {metadata['total_process_time_seconds']:.2f}",
        "* Primary metric: F2 score (β=2).",
    ]
    if labels:
        lines.append(f"* Thresholds: {', '.join(labels)}")
    datasets_meta = metadata.get("datasets", [])
    if datasets_meta:
        lines.append("* Evaluated datasets:")
        for entry in datasets_meta:
            lines.append(
                f"  - {entry['key']} (split={entry['split']}, n_samples={entry['n_samples']})"
            )
    runtimes = metadata.get("per_threshold_process_time_seconds") or {}
    if runtimes:
        parts = [f"{lbl}: {runtimes[lbl]:.2f}" for lbl in labels if lbl in runtimes]
        if parts:
            lines.append("* Threshold runtimes (s): " + ", ".join(parts))

    dataset_keys = [entry["key"] for entry in datasets_meta]
    for threshold, label in zip(thresholds, labels):
        metrics_map = results_by_threshold.get(threshold, {})
        lines += [
            "",
            f"### Threshold {label}",
            "",
            "| Dataset | F2 Score | Recall | Precision | FN | TP | FP | TN | "
            "Mean Compression (%) | Span Accuracy | Total Spans | Contexts |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|",
        ]
        keys = [k for k in dataset_keys if k in metrics_map] or sorted(metrics_map)
        if not keys:
            lines.append("| (no datasets) | N/A | N/A | N/A | N/A | N/A | 0 | 0 |")
            continue
        for key in keys:
            m = metrics_map[key]
            cm = m.get("confusion_matrix", {})
            lines.append(
                f"| {key} | {fmt(m.get('f2'))} | {fmt(m.get('recall'))} | "
                f"{fmt(m.get('precision'))} | {cm.get('fn', 0)} | {cm.get('tp', 0)} | "
                f"{cm.get('fp', 0)} | {cm.get('tn', 0)} | "
                f"{fmt(m.get('mean_compression'), '.2f')} | {fmt(m.get('span_accuracy'))} | "
                f"{m.get('span_total', 0)} | {m.get('contexts', 0)} |"
            )
    return "\n".join(lines)


def load_dataset_split(spec: DatasetSpec, split: str) -> RowTable:
    """Hub ID or local directory (reference :190-215); ``n_samples`` keeps
    the first rows, as ``Dataset.select(range(n))`` does."""
    source = _open_source(
        _SourceSpec(name=spec.dataset_name, subset=spec.subset, teacher_column="teacher_score",
                    items=None, upsample=None, n_samples=None)
    )
    if list(source) == [None]:  # a save_to_disk Dataset: one table, no splits
        dataset = source[None]
    elif split not in source:
        raise KeyError(f"Split '{split}' not found in dataset ({', '.join(source)})")
    else:
        dataset = source[split]
    if spec.n_samples is not None:
        dataset = dataset.select(range(min(len(dataset), spec.n_samples)))
    return dataset


def run_evaluation(
    model: Any,
    eval_config: EvalConfig,
    *,
    model_name: str,
    config_path: str,
    thresholds: list[float],
    batch_size: int = 512,
    split_override: str | None = None,
    limit: int | None = None,
    targets: set[str] | None = None,
    show_progress: bool = False,
    output_file: Path | None = None,
    output_json: Path | None = None,
) -> dict[str, Any]:
    """Evaluate all datasets × thresholds; write markdown/JSON reports."""
    metadata: dict[str, Any] = {
        "timestamp_utc": datetime.now(timezone.utc).isoformat(),
        "model": model_name,
        "config": config_path,
        "threshold": thresholds[0] if len(thresholds) == 1 else None,
        "thresholds": thresholds,
        "batch_size": batch_size,
        "split_override": split_override,
        "limit_override": limit,
        "datasets": [],
        "total_process_time_seconds": 0.0,
        "per_threshold_process_time_seconds": {},
    }

    records = []
    for spec in eval_config.datasets:
        split = spec.split or split_override or eval_config.split
        key = f"{spec.dataset_name}:{spec.subset or split}"
        if targets and key not in targets:
            continue
        dataset = load_dataset_split(spec, split)
        if limit is not None:
            dataset = dataset.select(range(min(len(dataset), limit)))
        records.append({"key": key, "split": split, "dataset": dataset})
        metadata["datasets"].append(
            {"key": key, "split": split, "n_samples": len(dataset)}
        )

    results_by_threshold: dict[float, dict[str, dict[str, Any]]] = {}
    runtime_map: dict[str, float] = {}
    total_time = 0.0
    for threshold in thresholds:
        per_dataset: dict[str, dict[str, Any]] = {}
        runtime = 0.0
        for record in records:
            metrics = evaluate_dataset(
                model,
                record["dataset"],
                threshold=threshold,
                batch_size=batch_size,
                show_progress=show_progress,
            )
            per_dataset[record["key"]] = metrics
            runtime += metrics.get("process_time_seconds", 0.0)
        results_by_threshold[threshold] = per_dataset
        runtime_map[format_threshold_label(threshold)] = runtime
        total_time += runtime

    metadata["total_process_time_seconds"] = total_time
    metadata["per_threshold_process_time_seconds"] = runtime_map

    markdown = build_markdown(metadata, results_by_threshold)
    if output_file:
        output_file.parent.mkdir(parents=True, exist_ok=True)
        output_file.write_text(markdown + "\n")
    if output_json:
        output_json.parent.mkdir(parents=True, exist_ok=True)
        json_results = {
            format_threshold_label(th): metrics
            for th, metrics in results_by_threshold.items()
        }
        output_json.write_text(
            json.dumps({"args": metadata, "results": json_results}, indent=2, ensure_ascii=False)
        )
    return {"metadata": metadata, "results": results_by_threshold, "markdown": markdown}
