"""Fixed-shape training collator.

Transforms a batch of {query, texts, context_spans, context_spans_relevance,
labels, teacher_score} rows into flattened query–document pairs with
token-level pruning labels and per-pair ranking targets — the same semantics
as the reference ``OpenProvenceDataCollator`` (open_provence/data_collator.py)
but emitting XLA-friendly **fixed shapes**:

* sequences padded to the static ``max_length`` (not batch max),
* the flattened pair dimension padded to a multiple of ``pair_multiple``
  (set to the mesh data-axis size × microbatch granularity) with fully
  masked dummy rows,

so that the jitted train step compiles once. Per-pair ranking targets are
pre-gathered (equivalent to the reference's [batch, max_docs] matrix +
gather, losses.py:129-193, with the same -100 → 0.0 fallback).
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np

from .span_labels import (
    compute_span_token_positions,
    generate_labels_v1,
    labels_from_span_positions,
    normalize_relevant_chunks,
)

logger = logging.getLogger(__name__)


class OpenProvenceDataCollator:
    def __init__(
        self,
        tokenizer: Any,
        max_length: int = 512,
        query_column: str = "query",
        texts_column: str = "texts",
        labels_column: str = "labels",
        scores_column: str | None = None,
        chunks_pos_column: str = "chunks_pos",
        relevant_chunks_column: str = "relevant_chunks",
        pair_multiple: int = 8,
        pad_pairs_to: int | None = None,
    ):
        self.tokenizer = tokenizer
        self.max_length = int(max_length)
        self.query_column = query_column
        self.texts_column = texts_column
        self.labels_column = labels_column
        self.scores_column = scores_column
        self.chunks_pos_column = chunks_pos_column
        self.relevant_chunks_column = relevant_chunks_column
        self.pair_multiple = max(1, int(pair_multiple))
        self.pad_pairs_to = pad_pairs_to

        self._validated = False
        self._has_labels = False

        vocab = {}
        try:
            vocab = tokenizer.get_vocab()
        except Exception:
            pass
        self._has_sep_token = "[SEP]" in vocab
        self._eos_token_id = getattr(tokenizer, "eos_token_id", None) or 2
        self._sep_token_id = getattr(tokenizer, "sep_token_id", None)
        self._pad_token_id = getattr(tokenizer, "pad_token_id", None) or 0

    def _validate_columns(self, features: list[dict[str, Any]]) -> None:
        if self._validated or not features:
            return
        columns = features[0].keys()
        required = [
            self.query_column,
            self.texts_column,
            self.chunks_pos_column,
            self.relevant_chunks_column,
        ]
        missing = [c for c in required if c not in columns]
        if missing:
            raise ValueError(
                f"Missing required columns: {missing}. Available columns: "
                f"{list(columns)}\nRequired columns: {required}"
            )
        scores_available = bool(self.scores_column and self.scores_column in columns)
        if self.scores_column and not scores_available:
            logger.warning(
                "Teacher scores column '%s' not found. Using '%s' for ranking targets.",
                self.scores_column,
                self.labels_column,
            )
            self.scores_column = None
        self._has_labels = bool(self.labels_column and self.labels_column in columns)
        if not self._has_labels and not scores_available:
            raise ValueError(
                "Neither labels nor teacher scores are available for ranking targets. "
                "Provide at least one of them."
            )
        self._validated = True

    def __call__(self, features: list[dict[str, Any]]) -> dict[str, np.ndarray]:
        self._validate_columns(list(features))

        pairs: list[tuple[str, str]] = []
        batch_indices: list[int] = []
        doc_indices: list[int] = []
        pair_targets: list[float] = []
        pair_chunks_pos: list[list[list[int]]] = []
        pair_relevant: list[list[int]] = []
        pair_chunk_texts: list[list[str]] = []

        for batch_idx, feature in enumerate(features):
            query = feature[self.query_column]
            texts = feature[self.texts_column]
            chunks_pos = feature[self.chunks_pos_column]
            relevant_chunks = normalize_relevant_chunks(
                feature[self.relevant_chunks_column], chunks_pos
            )
            num_docs = len(texts)
            if self.scores_column and self.scores_column in feature:
                targets = feature[self.scores_column]
            elif self._has_labels and self.labels_column in feature:
                targets = feature[self.labels_column]
            else:
                raise ValueError(
                    "Unable to determine ranking targets; missing teacher scores and labels."
                )
            if not isinstance(targets, list):
                raise ValueError(
                    "Ranking targets must be provided as a list aligning with document candidates."
                )
            for doc_idx in range(num_docs):
                text = texts[doc_idx]
                target = targets[doc_idx] if doc_idx < len(targets) else -100.0
                chunk_pos = chunks_pos[doc_idx]
                rel = relevant_chunks[doc_idx]
                pairs.append((query, text))
                batch_indices.append(batch_idx)
                doc_indices.append(doc_idx)
                # -100 padding → 0.0 fallback (reference losses.py:148-157).
                pair_targets.append(0.0 if target == -100 else float(target))
                pair_chunks_pos.append(chunk_pos)
                pair_relevant.append(rel)
                pair_chunk_texts.append(
                    [text[int(s): int(e)] for s, e in chunk_pos]
                )

        num_pairs = len(pairs)
        encoded = self.tokenizer(
            [[q, t] for q, t in pairs],
            padding="max_length",
            truncation=True,
            max_length=self.max_length,
            return_offsets_mapping=True,
        )
        input_ids = np.asarray(encoded["input_ids"], dtype=np.int32)
        attention_mask = np.asarray(encoded["attention_mask"], dtype=np.int32)
        offset_mappings = (
            np.asarray(encoded["offset_mapping"], dtype=np.int64)
            if "offset_mapping" in encoded
            else None
        )

        pruning_labels = np.full((num_pairs, self.max_length), -100, dtype=np.int64)
        for idx in range(num_pairs):
            query, _ = pairs[idx]
            try:
                span_positions = compute_span_token_positions(
                    self.tokenizer, query, pair_chunk_texts[idx]
                )
                pruning_labels[idx] = labels_from_span_positions(
                    self.max_length, span_positions, pair_relevant[idx]
                )
            except Exception as exc:
                if offset_mappings is None:
                    raise
                logger.warning("Falling back to v1 label generation: %s", exc)
                pruning_labels[idx] = generate_labels_v1(
                    input_ids[idx],
                    offset_mappings[idx],
                    pair_chunks_pos[idx],
                    pair_relevant[idx],
                    sep_token_id=self._sep_token_id,
                    eos_token_id=self._eos_token_id,
                    has_sep_token=self._has_sep_token,
                )

        # Never train on padding positions.
        pruning_labels = np.where(attention_mask > 0, pruning_labels, -100)

        # Pad the pair dimension to a fixed static size.
        if self.pad_pairs_to is not None:
            target_pairs = int(self.pad_pairs_to)
            if num_pairs > target_pairs:
                raise ValueError(
                    f"Batch produced {num_pairs} pairs > pad_pairs_to={target_pairs}"
                )
        else:
            m = self.pair_multiple
            target_pairs = ((num_pairs + m - 1) // m) * m if num_pairs else m

        def _pad_rows(arr: np.ndarray, fill) -> np.ndarray:
            if arr.shape[0] == target_pairs:
                return arr
            pad_shape = (target_pairs - arr.shape[0], *arr.shape[1:])
            return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)

        pair_mask = np.zeros((target_pairs,), dtype=np.float32)
        pair_mask[:num_pairs] = 1.0

        return {
            "input_ids": _pad_rows(input_ids, self._pad_token_id),
            "attention_mask": _pad_rows(attention_mask, 0),
            "pruning_labels": _pad_rows(pruning_labels, -100),
            "ranking_targets": _pad_rows(
                np.asarray(pair_targets, dtype=np.float32), 0.0
            ),
            "pair_mask": pair_mask,
            "batch_indices": _pad_rows(np.asarray(batch_indices, dtype=np.int32), -1),
            "doc_indices": _pad_rows(np.asarray(doc_indices, dtype=np.int32), -1),
        }
