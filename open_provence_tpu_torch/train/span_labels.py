"""Token-level pruning label generation from character spans.

Two strategies, behaviorally matching the reference collator
(open_provence/data_collator.py:322-707):

* v2 — measure each space-joined span prefix's token length to place exact
  token spans (tokenizer-agnostic, robust to subword merges at joins); the
  document's token offset inside the (query, document) pair is located with
  a probe encoding.
* v1 — offset-mapping + SEP/EOS boundary fallback.

Labels: -100 for query/special/tail tokens (ignored by the loss), 1 inside
relevant chunks, 0 inside non-relevant chunks.

TPU-first differences from the reference: these functions run once in a
dataset ``.map`` precompute (the collator then only pads fixed shapes), the
v2 prefix probes go through the tokenizer as ONE batched call instead of a
per-span Python loop, and the v1 painter is vectorized over numpy.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np

logger = logging.getLogger(__name__)

_PROBE_WORD = "test"


def _encode_lengths(tokenizer: Any, texts: list[Any], *, special: bool) -> list[int]:
    """Token count of each text (or [query, doc] pair) in one batched call."""
    if not texts:
        return []
    encoded = tokenizer(
        texts,
        add_special_tokens=special,
        padding=False,
        truncation=False,
        return_attention_mask=False,
    )
    return [len(ids) for ids in encoded["input_ids"]]


def _find_run(haystack: list[int], needle: list[int], start: int) -> int | None:
    """Leftmost index >= start where ``needle`` occurs in ``haystack``."""
    last = len(haystack) - len(needle)
    for at in range(start, last + 1):
        if haystack[at : at + len(needle)] == needle:
            return at
    return None


def _space_joined_prefixes(spans: list[str]) -> list[str]:
    """["a", "b", "c"] -> ["a", "a b", "a b c"]."""
    out: list[str] = []
    acc = ""
    for k, span in enumerate(spans):
        acc = span if k == 0 else f"{acc} {span}"
        out.append(acc)
    return out


def compute_span_token_positions(
    tokenizer: Any, query: str, spans: list[str]
) -> list[tuple[int, int]]:
    """Token-index range of each span within the encoded (query, document)
    pair (reference behavior: data_collator.py:504-632).

    The document's first token index is found by encoding (query, probe) and
    locating the probe's token ids after the query; each span's extent is the
    difference between consecutive space-joined prefix token lengths.
    """
    if not spans:
        return []

    single = {
        "add_special_tokens": True,
        "padding": False,
        "truncation": False,
        "return_attention_mask": False,
    }
    query_tokens = len(tokenizer([query], **single)["input_ids"][0])
    probe_pair = list(tokenizer([[query, _PROBE_WORD]], **single)["input_ids"][0])
    probe_ids = list(
        tokenizer(
            [_PROBE_WORD],
            add_special_tokens=False,
            padding=False,
            truncation=False,
            return_attention_mask=False,
        )["input_ids"][0]
    )
    doc_base = _find_run(probe_pair, probe_ids, query_tokens)
    if doc_base is None:
        doc_base = query_tokens

    # One batched encode of every prefix; span k occupies the token range
    # between prefix k-1's length and prefix k's length.
    prefix_lengths = _encode_lengths(
        tokenizer, _space_joined_prefixes(spans), special=False
    )
    edges = [0, *prefix_lengths]
    return [
        (doc_base + lo, doc_base + hi) for lo, hi in zip(edges[:-1], edges[1:])
    ]


def _squash_ws(text: str) -> str:
    return " ".join(text.split())


def validate_span_tokenization(
    tokenizer: Any,
    query: str,
    spans: list[str],
    span_positions: list[tuple[int, int]],
) -> bool:
    """Decode each span's token range back to text and accept if it matches
    the original up to whitespace/case, or at least contains every original
    word (reference behavior: data_collator.py:635-707)."""
    document = _space_joined_prefixes(spans)[-1] if spans else ""
    pair_ids = list(
        tokenizer(
            [[query, document]],
            add_special_tokens=True,
            padding=False,
            truncation=False,
            return_attention_mask=False,
        )["input_ids"][0]
    )
    for ordinal, (span, (lo, hi)) in enumerate(zip(spans, span_positions)):
        wanted = _squash_ws(span)
        got = _squash_ws(tokenizer.decode(pair_ids[lo:hi], skip_special_tokens=True))
        if wanted == got or wanted.lower() == got.lower():
            continue
        haystack = got.lower().replace(" ", "")
        if all(word in haystack for word in wanted.lower().split()):
            continue
        logger.warning(
            "Span %d decode mismatch: original=%r decoded=%r positions=%d-%d",
            ordinal, wanted, got, lo, hi,
        )
        return False
    return True


def labels_from_span_positions(
    seq_length: int,
    span_positions: list[tuple[int, int]],
    relevant_chunks: list[int],
) -> np.ndarray:
    """v2 label array: -100 baseline, then relevant spans painted 1, then
    non-relevant spans painted 0 — in that order, so an overlapping
    non-relevant span wins (reference behavior: data_collator.py:344-383)."""
    labels = np.full((seq_length,), -100, dtype=np.int64)
    wanted = set(relevant_chunks)
    for paint, is_relevant in ((1, True), (0, False)):
        for idx, (lo, hi) in enumerate(span_positions):
            if (idx in wanted) == is_relevant:
                labels[min(lo, seq_length) : min(hi, seq_length)] = paint
    return labels


def _mask_to_indices(mask: list[Any]) -> list[int]:
    return [i for i, bit in enumerate(mask) if bit == 1]


def normalize_relevant_chunks(
    relevant_chunks_raw: list[Any], chunks_pos: list[Any]
) -> list[list[int]]:
    """Per text, turn a binary mask like [1, 0, 1] into index form [0, 2]
    when its length equals that text's chunk count; anything else passes
    through as a list copy (reference behavior: data_collator.py:190-206)."""
    out: list[list[int]] = []
    for pos, entry in enumerate(relevant_chunks_raw):
        if not isinstance(entry, list):
            out.append(entry)
            continue
        looks_like_mask = (
            entry
            and pos < len(chunks_pos)
            and len(entry) == len(chunks_pos[pos])
            and all(bit in (0, 1) for bit in entry)
        )
        out.append(_mask_to_indices(entry) if looks_like_mask else list(entry))
    return out


def _document_token_window(
    input_ids: np.ndarray,
    *,
    sep_token_id: int | None,
    eos_token_id: int,
    has_sep_token: bool,
) -> tuple[int, int] | None:
    """[start, end) token range of the document half of the pair, from the
    first two separator (or EOS) occurrences."""
    marker = sep_token_id if (has_sep_token and sep_token_id is not None) else eos_token_id
    hits = np.flatnonzero(input_ids == marker)
    if hits.size < 2:
        return None
    skip = 1 if (has_sep_token and sep_token_id is not None) else 2
    return int(hits[0]) + skip, int(hits[1])


def generate_labels_v1(
    input_ids: np.ndarray,
    offsets: np.ndarray,
    chunk_positions: list[list[int]],
    relevant_chunks: list[int],
    *,
    sep_token_id: int | None,
    eos_token_id: int,
    has_sep_token: bool,
) -> np.ndarray:
    """Offset-mapping fallback for one pair, vectorized
    (reference behavior: data_collator.py:385-501).

    input_ids [L]; offsets [L, 2] char ranges. Tokens overlapping any
    relevant chunk's char range get 1; other document tokens 0; everything
    outside the document window -100.
    """
    length = int(input_ids.shape[0])
    window = _document_token_window(
        input_ids,
        sep_token_id=sep_token_id,
        eos_token_id=eos_token_id,
        has_sep_token=has_sep_token,
    )
    if window is None:
        return np.zeros((length,), dtype=np.int64)
    doc_lo, doc_hi = window

    starts = offsets[:, 0].astype(np.int64)
    ends = offsets[:, 1].astype(np.int64)
    real_token = (starts != 0) | (ends != 0)

    # Char offsets restart relative to the document; the shift is read from
    # the first real token in a short probe window at the document head.
    doc_shift = 0
    for probe in range(doc_lo, min(doc_lo + 5, doc_hi)):
        if real_token[probe]:
            doc_shift = int(starts[probe])
            break

    position = np.arange(length)
    in_window = (position >= doc_lo) & (position < doc_hi) & real_token
    overlaps = np.zeros((length,), dtype=bool)
    for chunk_idx in relevant_chunks:
        if 0 <= chunk_idx < len(chunk_positions):
            chunk_lo, chunk_hi = chunk_positions[chunk_idx]
            overlaps |= (starts - doc_shift < chunk_hi) & (ends - doc_shift > chunk_lo)

    labels = np.where(in_window & overlaps, 1, 0).astype(np.int64)
    labels[:doc_lo] = -100
    labels[doc_hi:] = -100
    return labels
