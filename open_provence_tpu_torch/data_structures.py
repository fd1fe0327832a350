"""Output dataclasses for pruning/reranking predictions.

numpy-based counterparts of the reference's
open_provence/data_structures.py, carried over from the JAX package as they
are (they hold host arrays and need no torch).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


def _serialize(value: Any) -> Any:
    if isinstance(value, np.ndarray):
        return value.tolist()
    if hasattr(value, "tolist"):
        return value.tolist()
    return value


@dataclass
class OpenProvenceOutput:
    """Chunk-based pruning predictions (reference data_structures.py:14-44)."""

    ranking_scores: float | np.ndarray | None = None
    chunk_predictions: np.ndarray | None = None  # [num_chunks]
    chunk_scores: np.ndarray | None = None  # [num_chunks]
    token_scores: np.ndarray | None = None  # [doc_len]
    chunk_positions: list[Any] | None = None
    compression_ratio: float | None = None

    def to_dict(self) -> dict[str, Any]:
        return {k: _serialize(v) for k, v in self.__dict__.items() if v is not None}


@dataclass
class OpenProvenceOnlyOutput:
    """Pruning-only mode outputs (reference data_structures.py:47-84)."""

    pruning_masks: np.ndarray | None = None
    pruning_logits: np.ndarray | None = None
    pruning_probs: np.ndarray | None = None
    sentences: list[list[str]] | None = None
    compression_ratio: float | None = None
    num_pruned_tokens: int | None = None
    pruned_documents: list[str] | None = None

    def to_dict(self) -> dict[str, Any]:
        return {k: _serialize(v) for k, v in self.__dict__.items() if v is not None}


@dataclass
class RerankingOpenProvenceOutput:
    """Joint reranking + pruning outputs (reference data_structures.py:87-145)."""

    ranking_scores: np.ndarray | None = None
    ranking_logits: np.ndarray | None = None
    pruning_masks: np.ndarray | None = None
    pruning_logits: np.ndarray | None = None
    pruning_probs: np.ndarray | None = None
    sentences: list[list[str]] | None = None
    sentence_boundaries: list[list[tuple[int, int]]] | None = None
    original_positions: list[list[tuple[int, int]]] | None = None
    compression_ratio: float | None = None
    num_pruned_sentences: int | None = None
    pruned_documents: list[str] | None = None

    def to_dict(self) -> dict[str, Any]:
        return {k: _serialize(v) for k, v in self.__dict__.items() if v is not None}


@dataclass
class PruningBehaviorConfig:
    """Legacy pruning/reranking behavior knobs (reference
    data_structures.py:148-174, there named OpenProvenceConfig)."""

    pruning_hidden_size: int | None = None
    pruning_num_labels: int = 2
    pruning_dropout: float = 0.1
    chunker_type: str = "multilingual"
    max_sentences: int = 64
    min_sentence_length: int = 5
    max_sentence_length: int = 500
    pruning_mode: str = "sentence"
    default_pruning_threshold: float = 0.5
    min_sentences_to_keep: int = 1
    use_cache: bool = True
    batch_size: int = 32
    extras: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        payload = dict(self.__dict__)
        payload.pop("extras")
        payload.update(self.extras)
        return payload
