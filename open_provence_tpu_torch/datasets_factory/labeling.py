"""Span-relevance labeling and teacher scoring for training data.

The port's copy of the JAX package's ``datasets_factory/labeling.py`` on
``train/data.py``'s ``RowTable``; the encoder teacher is the port's
``OpenProvenceEncoder`` (its ``predict_context`` and ``predict`` run the
model on the card).

Counterparts of the reference's dataset-factory stages:

* ``annotate_span_relevance`` — marks relevant chunks per (query, text) as a
  ``context_spans_relevance`` binary mask
  (scripts/context-relevance-datasets/add_context_spans_relevance.py, which
  uses a vLLM span-annotation teacher). Annotators are pluggable:
  - an OpenProvence checkpoint (``predict_context`` chunk decisions — the
    teacher on the card),
  - an LLM over an OpenAI-compatible endpoint with the reference's
    numbered-chunk prompt and index parsing (:316-348),
  - any injected callable (tests).
  Includes the reference's shard cache for interrupted-run resume
  (:151-174).

* ``add_teacher_scores`` — scores every (query, text) pair into a
  ``teacher_scores.<model>`` column
  (add_reranker_teacher_scores.py; the reference uses sentence-transformers
  CrossEncoder — here any OpenProvenceEncoder-style .predict works).
"""

from __future__ import annotations

import json
import logging
import re
from collections.abc import Callable, Iterable, Sequence
from pathlib import Path
from typing import Any

from ..train.data import RowTable

logger = logging.getLogger(__name__)

Annotator = Callable[[str, list[str]], list[int]]  # (query, chunks) → indices


# --- LLM annotator -----------------------------------------------------------


def build_chunk_prompt(query: str, chunks: list[str]) -> str:
    """Numbered-chunk user prompt (reference add_context_spans_relevance
    :316-318)."""
    chunk_block = "\n".join(f"[{idx + 1}] {text}" for idx, text in enumerate(chunks))
    return f"{query}\n---\n{chunk_block}"


def truncate_content(
    query: str, chunks: list[str], iteration: int
) -> tuple[str, list[str]]:
    """Iterative truncation to fit the teacher's context window
    (reference :320-334)."""
    if len(query) > 100:
        query = query[:100]
    if iteration == 1:
        chunks = [c[:200] + ("..." if len(c) > 200 else "") for c in chunks[:10]]
    elif iteration == 2:
        chunks = [c[:100] + ("..." if len(c) > 100 else "") for c in chunks[:10]]
    elif iteration == 3:
        chunks = [c[:50] + ("..." if len(c) > 50 else "") for c in chunks[:5]]
    else:
        chunks = ["none"]
    return query, chunks


def parse_indices(response: str, num_chunks: int) -> list[int]:
    """1-based numbers in the response → sorted unique 0-based indices
    (reference :340-348)."""
    indices = []
    for number in re.findall(r"\d+", response):
        idx = int(number) - 1
        if 0 <= idx < num_chunks:
            indices.append(idx)
    return sorted(set(indices))


def to_flags(indices: Iterable[int], num_chunks: int) -> list[int]:
    flags = [0] * num_chunks
    for idx in indices:
        if 0 <= idx < num_chunks:
            flags[idx] = 1
    return flags


def make_encoder_annotator(
    encoder: Any, *, token_threshold: float = 0.5, chunk_threshold: float = 0.5
) -> Annotator:
    """Use an OpenProvenceEncoder checkpoint as the span teacher: chunk
    predictions from predict_context become relevance flags."""

    def _annotate(query: str, chunks: list[str]) -> list[int]:
        doc = ""
        spans: list[tuple[int, int]] = []
        for chunk in chunks:
            start = len(doc)
            doc += chunk
            spans.append((start, len(doc)))
            doc += " "
        output = encoder.predict_context(
            (query, doc),
            spans,
            token_threshold=token_threshold,
            chunk_threshold=chunk_threshold,
        )
        return [i for i, p in enumerate(output.chunk_predictions) if p == 1]

    return _annotate


def make_openai_annotator(
    model: str,
    *,
    request_timeout: float = 120.0,
    base_url: str | None = None,
) -> Annotator:
    """LLM annotator over an OpenAI-compatible endpoint."""
    import os

    import httpx

    def _annotate(query: str, chunks: list[str]) -> list[int]:
        api_key = os.environ.get("OPENAI_API_KEY")
        if not api_key:
            raise OSError("OPENAI_API_KEY is not set.")
        url = (
            (base_url or os.environ.get("OPENAI_BASE_URL") or "https://api.openai.com/v1")
            .rstrip("/")
        )
        prompt = build_chunk_prompt(query, chunks)
        response = httpx.post(
            f"{url}/chat/completions",
            headers={"Authorization": f"Bearer {api_key}"},
            json={
                "model": model,
                "messages": [{"role": "user", "content": prompt}],
                "temperature": 0.0,
            },
            timeout=request_timeout,
        )
        response.raise_for_status()
        content = response.json()["choices"][0]["message"]["content"] or ""
        return parse_indices(content, len(chunks))

    return _annotate


# --- shard cache -------------------------------------------------------------


class ShardCache:
    """Resume support for interrupted labeling runs (reference :151-174):
    per-shard JSON files of computed relevance rows."""

    def __init__(self, cache_dir: str | Path, shard_size: int = 1000):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.shard_size = int(shard_size)

    def _shard_path(self, shard_idx: int) -> Path:
        return self.cache_dir / f"shard-{shard_idx:06d}.json"

    def load_shard(self, shard_idx: int) -> dict[str, list[list[int]]] | None:
        path = self._shard_path(shard_idx)
        if not path.exists():
            return None
        try:
            return json.loads(path.read_text())
        except json.JSONDecodeError:
            logger.warning("Corrupt cache shard %s — recomputing.", path)
            return None

    def save_shard(self, shard_idx: int, payload: dict[str, list[list[int]]]) -> None:
        path = self._shard_path(shard_idx)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(path)


# --- dataset-level operations -------------------------------------------------


def annotate_span_relevance(
    dataset: RowTable,
    annotator: Annotator,
    *,
    id_column: str = "id",
    query_column: str = "query",
    texts_column: str = "texts",
    spans_column: str = "context_spans",
    output_column: str = "context_spans_relevance",
    cache: ShardCache | None = None,
) -> RowTable:
    """Add a binary relevance mask per chunk for every (query, text)."""
    relevance_rows: list[list[list[int]]] = []
    shard_payload: dict[str, list[list[int]]] = {}
    shard_idx = 0

    def _flush() -> None:
        nonlocal shard_payload, shard_idx
        if cache is not None and shard_payload:
            cache.save_shard(shard_idx, shard_payload)
        shard_payload = {}
        shard_idx += 1

    cached_shard: dict[str, list[list[int]]] | None = None
    for row_idx, row in enumerate(dataset):
        if cache is not None and row_idx % cache.shard_size == 0:
            if row_idx > 0:
                _flush()
            cached_shard = cache.load_shard(shard_idx)

        row_id = str(row.get(id_column, row_idx))
        if cached_shard is not None and row_id in cached_shard:
            relevance_rows.append(cached_shard[row_id])
            shard_payload[row_id] = cached_shard[row_id]
            continue

        query = str(row[query_column])
        texts: Sequence[str] = row[texts_column]
        spans_per_text = row[spans_column]
        row_relevance: list[list[int]] = []
        for text, spans in zip(texts, spans_per_text):
            chunks = [str(text)[int(s): int(e)] for s, e in spans]
            indices = annotator(query, chunks)
            row_relevance.append(to_flags(indices, len(chunks)))
        relevance_rows.append(row_relevance)
        shard_payload[row_id] = row_relevance
    _flush()

    if output_column in dataset.column_names:
        dataset = dataset.remove_columns(output_column)
    return dataset.add_column(output_column, relevance_rows)


def add_teacher_scores(
    dataset: RowTable,
    predict_fn: Callable[[list[tuple[str, str]]], Sequence[float]],
    *,
    teacher_name: str,
    query_column: str = "query",
    texts_column: str = "texts",
    batch_size: int = 32,
) -> RowTable:
    """Score every (query, text) pair into ``teacher_scores.<teacher_name>``
    (reference add_reranker_teacher_scores.py)."""
    pairs: list[tuple[str, str]] = []
    counts: list[int] = []
    for row in dataset:
        texts = row[texts_column]
        counts.append(len(texts))
        pairs.extend((str(row[query_column]), str(t)) for t in texts)

    scores: list[float] = []
    for start in range(0, len(pairs), batch_size):
        chunk = pairs[start : start + batch_size]
        scores.extend(float(s) for s in predict_fn(chunk))

    column: list[list[float]] = []
    cursor = 0
    for count in counts:
        column.append(scores[cursor : cursor + count])
        cursor += count

    output_column = f"teacher_scores.{teacher_name}"
    if output_column in dataset.column_names:
        dataset = dataset.remove_columns(output_column)
    return dataset.add_column(output_column, column)
