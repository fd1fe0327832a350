"""Host-side aggregation of pruning outputs into user-facing results.

Behavioral counterpart of the reference's postprocess stage
(modeling_open_provence_standalone.py:2962-3312, 3748-3805): fragment →
sentence keep-probability pooling (with the title-prefix token-offset
correction), threshold keep decisions with ``always_select_title``,
char-based compression, ``use_best_reranker_score`` max-over-blocks,
score-descending reordering with ``top_k``, and collapse of the nested
results back to the caller's input shape.

The design differs from the reference: each context is summarized once into
a :class:`ContextOutcome`, pooling runs vectorized over numpy arrays (prefix
offsets, segment sums via cumulative sums, sentence means via ``bincount``)
instead of per-sentence Python dict loops, and the output payload is
projected from the outcome grid by a per-shape collapse table.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class BlockScores:
    """Device outputs for one packed block (cf. standalone:451-459).

    Exactly one of ``token_probs`` (host pooling path; per-token keep
    probabilities for the whole block) or ``fragment_means`` (device-pooled
    fast path; one mean per fragment, exact only when no title-prefix offset
    correction applies) is set.
    """

    order: int
    rank: float | None
    fragment_gids: np.ndarray  # [F] int, global fragment indices
    fragment_spans: np.ndarray  # [F, 2] int, token ranges within the block
    token_probs: np.ndarray | None = None  # [T] fp32
    fragment_means: np.ndarray | None = None  # [F] fp32


@dataclass
class ContextOutcome:
    """Everything the payload needs to know about one pruned context."""

    pruned_text: str = ""
    score: float | None = None
    compression: float = 0.0
    kept: list[str] = field(default_factory=list)
    removed: list[str] = field(default_factory=list)
    title: Any = None
    sentence_probs: list[float] = field(default_factory=list)


def _title_value(prefix_sentences: Any) -> Any:
    """Collapse the prefix-sentence list to the payload's title value:
    None / single string / list of strings."""
    items = list(prefix_sentences or [])
    if not items:
        return None
    return items[0] if len(items) == 1 else [str(item) for item in items]


def _block_fragment_scores(block: BlockScores, prefix_cumsum: np.ndarray, gid_to_sent: np.ndarray) -> np.ndarray:
    """Per-fragment mean keep probabilities for one block (fp32 [F]).

    Host path: segment means over ``token_probs`` after shifting each
    fragment's span left by the total token length of the title-prefix
    sentences that precede its sentence (standalone:3075-3081). Empty
    segments score 1.0.
    """
    if block.fragment_means is not None:
        return np.asarray(block.fragment_means, dtype=np.float32)
    probs = np.asarray(block.token_probs, dtype=np.float32)
    n_tokens = probs.shape[0]
    spans = block.fragment_spans.astype(np.int64)
    sent_idx = gid_to_sent[block.fragment_gids]
    shift = prefix_cumsum[np.minimum(np.maximum(sent_idx, 0), len(prefix_cumsum) - 1)]
    lo = np.clip(spans[:, 0] - shift, 0, n_tokens)
    hi = np.clip(spans[:, 1] - shift, lo, n_tokens)
    prefix_sums = np.concatenate([[0.0], np.cumsum(probs, dtype=np.float64)])
    width = hi - lo
    totals = prefix_sums[hi] - prefix_sums[lo]
    return np.where(width > 0, totals / np.maximum(width, 1), 1.0).astype(np.float32)


def summarize_context(
    info: dict[str, Any] | None,
    context_entry: Any,
    *,
    threshold: float,
    always_select_title: bool,
    use_best_reranker_score: bool,
    first_line_as_title: bool,
    zero_score_when_empty: bool,
) -> ContextOutcome:
    """Fold one context's block predictions into a :class:`ContextOutcome`."""
    prefix_sentences = list((info or {}).get("prefix_sentences") or [])

    if not info or not info.get("fragments"):
        # Nothing ran on device: echo the context back unchanged. In
        # first-line-title mode the extracted title still surfaces.
        fallback_title = _title_value(prefix_sentences) if first_line_as_title else None
        return ContextOutcome(
            pruned_text=context_entry,
            title=fallback_title,
            kept=[context_entry] if context_entry else [],
        )

    sentences: list[str] = info["sentences"]
    blocks = info["blocks"]
    raw_blocks: list[BlockScores] = sorted(info["raw_blocks"], key=lambda b: b.order)
    fallback_title = _title_value(prefix_sentences) if first_line_as_title else None

    if not blocks or not raw_blocks:
        return ContextOutcome(
            pruned_text=context_entry,
            title=fallback_title,
            kept=list(sentences),
            sentence_probs=[1.0] * len(sentences),
        )

    n_sentences = len(sentences)
    fragments = info["fragments"]
    max_gid = max((f.global_index for f in fragments), default=-1)
    gid_to_sent = np.full(max_gid + 2, -1, dtype=np.int64)
    for frag in fragments:
        gid_to_sent[frag.global_index] = frag.sentence_index
    prefix_cumsum = np.concatenate(
        [[0], np.cumsum(np.asarray(info.get("prefix_token_counts") or [], dtype=np.int64))]
    )

    # One (sentence, score) pair per fragment per block, pooled by bincount.
    score_chunks: list[np.ndarray] = []
    sent_chunks: list[np.ndarray] = []
    ranks: list[float] = []
    for block in raw_blocks:
        scores = _block_fragment_scores(block, prefix_cumsum, gid_to_sent)
        owners = gid_to_sent[block.fragment_gids]
        known = owners >= 0
        score_chunks.append(scores[known])
        sent_chunks.append(owners[known])
        if block.rank is not None:
            ranks.append(block.rank)

    all_scores = np.concatenate(score_chunks) if score_chunks else np.zeros(0, np.float32)
    all_sents = np.concatenate(sent_chunks) if sent_chunks else np.zeros(0, np.int64)
    hits = np.bincount(all_sents, minlength=n_sentences).astype(np.float64)
    totals = np.bincount(all_sents, weights=all_scores.astype(np.float64), minlength=n_sentences)
    means = np.clip(np.divide(totals, np.maximum(hits, 1.0)), 0.0, 1.0)
    means[hits == 0] = 0.0

    keep = means > threshold
    prefix_len = int(info.get("prefix_length") or 0)
    if always_select_title and bool(keep.any()):
        # Force-keep the title sentence: the first prefix sentence when a
        # title prefix exists, else the first content sentence when the
        # title is the context's own first line.
        if prefix_len > 0:
            keep[0] = True
        elif info.get("title_is_first_sentence") and n_sentences > prefix_len:
            keep[prefix_len] = True

    keep_list = keep.tolist()
    kept = [text for text, flag in zip(sentences, keep_list) if flag]
    removed = [text for text, flag in zip(sentences, keep_list) if not flag]
    pruned_text = "".join(
        text for text, flag in zip(sentences[prefix_len:], keep_list[prefix_len:]) if flag
    )

    original_text = info["original_text"]
    compression = (len(original_text) - len(pruned_text)) / max(len(original_text), 1) * 100.0

    score: float | None = None
    if ranks:
        score = max(ranks) if use_best_reranker_score else ranks[0]
    if zero_score_when_empty and not pruned_text.strip():
        score = 0.0

    return ContextOutcome(
        pruned_text=pruned_text,
        score=score,
        compression=compression,
        kept=kept,
        removed=removed,
        title=_title_value(prefix_sentences),
        sentence_probs=[float(v) for v in means],
    )


def summarize_contexts(
    queries: list[str],
    contexts: list[list[Any]],
    contexts_info: dict[tuple[int, int], dict[str, Any]],
    *,
    threshold: float,
    always_select_title: bool,
    use_best_reranker_score: bool,
    first_line_as_title: bool,
    zero_score_when_empty: bool,
) -> list[list[ContextOutcome]]:
    """One :class:`ContextOutcome` per (query, context)."""
    return [
        [
            summarize_context(
                contexts_info.get((q_idx, c_idx)),
                entry,
                threshold=threshold,
                always_select_title=always_select_title,
                use_best_reranker_score=use_best_reranker_score,
                first_line_as_title=first_line_as_title,
                zero_score_when_empty=zero_score_when_empty,
            )
            for c_idx, entry in enumerate(contexts[q_idx])
        ]
        for q_idx, _ in enumerate(queries)
    ]


def reorder_outcomes(
    rows: list[list[ContextOutcome]], *, top_k: int | None
) -> list[list[ContextOutcome]]:
    """Per query: stable sort by descending score (None sorts last), then
    truncate to ``top_k`` (standalone:3204-3312)."""
    limit = None if top_k is None else max(0, int(top_k))

    def sort_key(outcome: ContextOutcome) -> float:
        return float("-inf") if outcome.score is None else float(outcome.score)

    return [sorted(row, key=sort_key, reverse=True)[:limit] for row in rows]


# Payload fields: (key, outcome attribute, default-when-empty).
_CORE_FIELDS = (
    ("pruned_context", "pruned_text", ""),
    ("reranking_score", "score", None),
    ("compression_rate", "compression", 0.0),
    ("title", "title", None),
)
_SENTENCE_FIELDS = (("kept_sentences", "kept", []), ("removed_sentences", "removed", []))
_PROB_FIELDS = (("sentence_probabilities", "sentence_probs", []),)


def _collapse(shape: str, grid: list[list[Any]], default: Any) -> Any:
    """Project a [query][context] value grid back to the caller's input
    shape (standalone:3748-3805)."""
    if not grid:
        return grid
    if shape == "str":
        return grid[0][0] if grid[0] else default
    if shape == "list":
        return grid[0]
    if shape == "aligned":
        return [row[0] if row else default for row in grid]
    return grid


def build_payload(
    shape: str,
    rows: list[list[ContextOutcome]],
    *,
    include_sentence_texts: bool,
    include_sentence_probs: bool,
) -> dict[str, Any]:
    fields = list(_CORE_FIELDS)
    if include_sentence_texts:
        fields += _SENTENCE_FIELDS
    if include_sentence_probs:
        fields += _PROB_FIELDS
    return {
        key: _collapse(shape, [[getattr(c, attr) for c in row] for row in rows], default)
        for key, attr, default in fields
    }
