"""Post-training evaluation on the port: the dataset-retention sweeps of
``datasets_eval`` and their CLI (``python -m open_provence_tpu_torch.eval.cli``)."""

from .datasets_eval import (
    DatasetSpec,
    EvalConfig,
    SpanCounters,
    build_markdown,
    evaluate_dataset,
    extract_sentences,
    format_threshold_label,
    infer_predictions,
    load_dataset_split,
    normalize_relevance,
    run_evaluation,
)

__all__ = [
    "DatasetSpec",
    "EvalConfig",
    "SpanCounters",
    "build_markdown",
    "evaluate_dataset",
    "extract_sentences",
    "format_threshold_label",
    "infer_predictions",
    "load_dataset_split",
    "normalize_relevance",
    "run_evaluation",
]
