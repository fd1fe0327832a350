"""The data factory on the port: triplet conversion, duplicate filtering,
span labeling and teacher scores on ``train/data.py``'s ``RowTable``, with
the JAX package's ``datasets_factory`` names. Its CLI is
``python -m open_provence_tpu_torch.datasets_factory.cli``."""

from .converter import (
    build_record,
    compute_split_size,
    convert_dataset_dict,
    convert_split,
    ensure_eval_splits,
    extract_fields,
    generic_sentence_splitter,
    resolve_factory_splitter,
    slugify_dataset_name,
    text_to_spans,
)
from .frequency_filter import DuplicateStats, frequency_filter_train
from .labeling import (
    ShardCache,
    add_teacher_scores,
    annotate_span_relevance,
    build_chunk_prompt,
    make_encoder_annotator,
    make_openai_annotator,
    parse_indices,
    to_flags,
    truncate_content,
)

__all__ = [
    "build_record",
    "compute_split_size",
    "convert_dataset_dict",
    "convert_split",
    "ensure_eval_splits",
    "extract_fields",
    "generic_sentence_splitter",
    "resolve_factory_splitter",
    "slugify_dataset_name",
    "text_to_spans",
    "DuplicateStats",
    "frequency_filter_train",
    "ShardCache",
    "add_teacher_scores",
    "annotate_span_relevance",
    "build_chunk_prompt",
    "make_encoder_annotator",
    "make_openai_annotator",
    "parse_indices",
    "to_flags",
    "truncate_content",
]
