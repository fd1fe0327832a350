"""Sentence → token → fragment splitting and greedy block packing.

Host-side long-context pipeline with the same observable behavior as the
reference (modeling_open_provence_standalone.py:686-943, 2222-2259): every
device-side sequence stays ≤ max_length by cutting sentences into token
fragments and packing fragments into blocks (SURVEY §5.7).

Device-facing difference vs the reference: blocks are later padded to
*bucketed* fixed shapes (inference/engine.py) instead of pad-to-batch-max, so
XLA compiles a small, fixed set of programs. The packing plan itself is
computed by the native C++ op (open_provence_tpu_torch/native).
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from dataclasses import dataclass, replace
from time import perf_counter
from typing import Any

from .splitters import DEFAULT_ENGLISH_SENTENCE_MAX_CHARS, SentenceSplitter

# A fragment before decoding: (token_ids, sentence_idx, fragment_idx,
# global_idx) — the tuple layout is part of the golden-test contract.
Piece = tuple[list[int], int, int, int]


@dataclass(slots=True)
class FragmentRecord:
    """Decoded fragment metadata (counterpart of standalone:990-999)."""

    text: str
    sentence_index: int
    fragment_index: int
    global_index: int
    token_length: int
    token_ids: list[int]


def split_token_lists(
    token_lists: Sequence[Sequence[int]],
    max_fragment_tokens: int,
    *,
    keep_sentence_boundaries: bool = False,
) -> list[Piece]:
    """Cut each sentence's token list into fixed-stride fragments
    (standalone:686-713).

    With ``keep_sentence_boundaries``, a sentence that fits within the
    budget stays whole; longer sentences are strided regardless.
    """
    stride = max(1, int(max_fragment_tokens))
    pieces: list[Piece] = []
    for sent_idx, ids in enumerate(token_lists):
        ids = list(ids)
        n = len(ids)
        if n == 0:
            continue
        if keep_sentence_boundaries and n <= max_fragment_tokens:
            starts = [0]
        else:
            starts = range(0, n, stride)
        for frag_idx, lo in enumerate(starts):
            pieces.append((ids[lo : lo + stride], sent_idx, frag_idx, len(pieces)))
    return pieces


def collect_candidate_sentences(
    example: Mapping[str, Any], splitter: SentenceSplitter
) -> list[str]:
    """Prefix sentences, then either the caller's manual sentences or the
    splitter's output (standalone:615-630)."""
    manual = example.get("manual_sentences")
    body: Sequence[Any]
    if manual is not None:
        body = manual
    else:
        body = splitter(str(example.get("context_text", "")))
    head: Sequence[Any] = example.get("prefix_sentences") or []
    return [str(item) for item in (*head, *body) if item is not None]


def _split_multiline_sentence(text: str, strip_sentences: bool) -> list[str]:
    """Break a multi-line 'sentence' into its lines when it looks like a
    line-oriented list rather than prose (standalone:582-612): at least two
    non-blank lines, fewer .?! marks than lines, and no overlong line."""
    whole = [text.strip() if strip_sentences else text]
    if "\n" not in text:
        return whole
    lines = [
        seg
        for seg in text.splitlines(keepends=not strip_sentences)
        if seg.strip()
    ]
    if len(lines) <= 1:
        return whole
    if sum(text.count(mark) for mark in ".?!") >= len(lines):
        return whole
    if max(len(seg.strip()) for seg in lines) > DEFAULT_ENGLISH_SENTENCE_MAX_CHARS:
        return whole
    kept = [seg.strip() if strip_sentences else seg for seg in lines]
    kept = [seg for seg in kept if seg]
    return kept or whole


def fallback_sentence(context_text: str, strip_sentences: bool) -> str:
    if not strip_sentences:
        return context_text
    return context_text.strip() or context_text


def normalize_sentences(
    raw_sentences: Sequence[str], context_text: str, strip_sentences: bool
) -> list[str]:
    """Flatten multi-line entries and drop empties; fall back to the whole
    context when nothing survives (standalone:640-661)."""
    out = [
        piece
        for entry in raw_sentences
        if str(entry)
        for piece in _split_multiline_sentence(str(entry), strip_sentences)
        if piece
    ]
    return out or [fallback_sentence(context_text, strip_sentences)]


def tokenize_sentences(tokenizer: Any, sentences: Sequence[str]) -> list[list[int]]:
    """Batch-encode sentences without special tokens (standalone:664-672).

    Uses the adapter's Rust-direct ``encode_batch_ids`` when available (it
    skips the HF per-sequence Encoding→dict conversion)."""
    if not sentences:
        return []
    fast = getattr(tokenizer, "encode_batch_ids", None)
    if fast is not None:
        return fast(sentences)
    encoded = tokenizer(
        list(sentences), add_special_tokens=False, return_attention_mask=False
    )
    ids = (
        encoded.get("input_ids", [])
        if isinstance(encoded, Mapping)
        else getattr(encoded, "input_ids", [])
    )
    return [list(row) for row in ids]


_PAYLOAD_FIELDS = (
    "fragment_texts",
    "fragment_token_ids",
    "fragment_sentence_index",
    "fragment_fragment_index",
    "fragment_global_index",
)


def _pieces_to_payload(rows: Sequence[tuple[str, Piece]]) -> dict[str, list[Any]]:
    """Transpose (text, piece) rows into the columnar fragment payload."""
    payload: dict[str, list[Any]] = {field: [] for field in _PAYLOAD_FIELDS}
    for text, (ids, sent_idx, frag_idx, global_idx) in rows:
        payload["fragment_texts"].append(text)
        payload["fragment_token_ids"].append(list(ids))
        payload["fragment_sentence_index"].append(sent_idx)
        payload["fragment_fragment_index"].append(frag_idx)
        payload["fragment_global_index"].append(global_idx)
    return payload


def decode_and_filter_fragments(
    tokenizer: Any,
    pieces: Sequence[Piece],
    *,
    strip_sentences: bool,
) -> dict[str, list[Any]]:
    """Decode fragment token ids back to text and drop fragments whose text
    is empty (after stripping, when requested) (standalone:846-894)."""
    if not pieces:
        return _pieces_to_payload([])
    texts = tokenizer.batch_decode(
        [ids for ids, *_ in pieces],
        skip_special_tokens=True,
        clean_up_tokenization_spaces=False,
    )
    rows: list[tuple[str, Piece]] = []
    for text, piece in zip(texts, pieces):
        shown = text.strip() if strip_sentences else text
        if shown if strip_sentences else text:
            rows.append((shown, piece))
    return _pieces_to_payload(rows)


def _solid_id_cache(tokenizer: Any) -> tuple[set[int], set[int]]:
    """Per-tokenizer memo ``(solid, undecidable)``: an id is SOLID when its
    single-token decode (specials skipped, no cleanup) contains a clean
    character — neither whitespace nor U+FFFD. A solid id contributes a
    complete non-whitespace character that survives concatenation, so any
    fragment containing one decodes non-empty even after stripping; ids
    whose lone decode shows only whitespace/U+FFFD (byte-level tokens with
    partial UTF-8 sequences decode to U+FFFD) prove nothing by themselves —
    cross-token byte merges can't fool the shortcut because such ids are
    never classified solid.

    Thread note: preprocess worker threads share these sets. Set adds are
    GIL-atomic, and an id a thread hasn't seen classified yet merely sends
    its fragment down the exact real-decode path — keep decisions never
    flip."""
    cache = getattr(tokenizer, "_op_tpu_solid_ids", None)
    if cache is None:
        cache = (set(), set())
        try:
            setattr(tokenizer, "_op_tpu_solid_ids", cache)
        except Exception:
            pass
    return cache


def _classify_fragment_solidity(
    tokenizer: Any, pieces_per_job: Sequence[Sequence[Piece]]
) -> list[list[bool]]:
    """For every fragment: True when at least one of its token ids is solid
    (see :func:`_solid_id_cache` — the fragment's full decode is then
    provably non-empty after stripping); False means undecidable — only a
    real decode can apply the empty-fragment filter."""
    solid, undecidable = _solid_id_cache(tokenizer)
    known = solid | undecidable
    missing: list[int] = []
    for pieces in pieces_per_job:
        for ids, *_ in pieces:
            # Warm path: one C-level superset check per fragment instead of
            # a Python loop over every token.
            if known.issuperset(ids):
                continue
            for token in ids:
                if token not in known:
                    known.add(token)
                    missing.append(token)
    if missing:
        texts = tokenizer.batch_decode(
            [[token] for token in missing],
            skip_special_tokens=True,
            clean_up_tokenization_spaces=False,
        )
        for token, text in zip(missing, texts):
            if all(ch.isspace() or ch == "�" for ch in str(text)):
                undecidable.add(token)
            else:
                solid.add(token)
    # not isdisjoint == "contains at least one solid id" — a C-level scan
    # that stops at the first hit (the per-fragment Python all() genexpr
    # was itself ~15 ms per 256-pair call).
    return [
        [not solid.isdisjoint(ids) for ids, *_ in pieces]
        for pieces in pieces_per_job
    ]


def fragmentize_jobs(
    tokenizer: Any,
    jobs: Sequence[Mapping[str, Any]],
    *,
    max_fragment_tokens: int,
    splitter: SentenceSplitter,
    strip_sentences: bool,
    respect_sentence_boundaries: bool,
    decode_fragments: bool | str = True,
) -> list[dict[str, Any]]:
    """Fragmentize a CHUNK of preprocessing jobs with cross-job batched
    tokenizer calls (same observable per-job output as standalone:897-943).

    ``decode_fragments=False`` skips the fragment ``batch_decode`` and the
    empty-decode filtering pass, leaving every ``fragment_texts`` entry
    blank. The process() engine passes ``"filter_only"``: KEEP/DROP
    decisions identical to ``True`` (the all-UNK-fragment filter is
    load-bearing for parity with the reference), but ``fragment_texts``
    stay blank and the batch decode only runs for the rare fragments whose
    ids cannot prove themselves non-empty (see
    :func:`_classify_fragment_solidity`) — the engine never reads fragment
    text, and the full decode was ~10% of its host budget. Opting decoding
    fully out (``False``) is only safe for callers that reproduce the
    filtering some other way.

    The Rust tokenizer's per-call overhead dominates small batches, so the
    sentence encode and fragment decode each happen ONCE for the whole chunk
    (one ``encode_batch`` / one ``batch_decode``) and are split back per job.
    Stage timings (standalone:934-941) are measured per batch stage and
    attributed evenly across the chunk — their sum over a call is exact.

    ``cached_sentences`` / ``cached_token_lists`` short-circuit the split and
    tokenize stages when the engine precomputed them.
    """
    if not jobs:
        return []
    timings = dict.fromkeys(
        (
            "timing_sentence_collect",
            "timing_sentence_normalize",
            "timing_tokenize",
            "timing_fragment_split",
            "timing_fragment_decode",
        ),
        0.0,
    )
    context_texts = [str(job.get("context_text", "")) for job in jobs]

    # Stage 1: sentence collect + normalize (splitter is per-context work).
    sentences_per_job: list[list[str]] = []
    for job, context_text in zip(jobs, context_texts):
        cached_sentences = job.get("cached_sentences")
        if cached_sentences is None:
            tick = perf_counter()
            raw = collect_candidate_sentences(job, splitter)
            timings["timing_sentence_collect"] += perf_counter() - tick
            tick = perf_counter()
            sentences = normalize_sentences(raw, context_text, strip_sentences)
            timings["timing_sentence_normalize"] += perf_counter() - tick
        else:
            sentences = [str(s) for s in cached_sentences]
        sentences_per_job.append(sentences)

    # Stage 2: ONE batched encode across every job that needs tokenizing.
    tick = perf_counter()
    flat_sentences: list[str] = []
    for job, sentences in zip(jobs, sentences_per_job):
        if job.get("cached_token_lists") is None:
            flat_sentences.extend(sentences)
    flat_token_lists = tokenize_sentences(tokenizer, flat_sentences)
    token_lists_per_job: list[list[list[int]]] = []
    cursor = 0
    for job, sentences in zip(jobs, sentences_per_job):
        cached_tokens = job.get("cached_token_lists")
        if cached_tokens is None:
            n = len(sentences)
            token_lists_per_job.append(flat_token_lists[cursor : cursor + n])
            cursor += n
        else:
            token_lists_per_job.append([[int(t) for t in ids] for ids in cached_tokens])
    timings["timing_tokenize"] += perf_counter() - tick

    # Title-prefix token counts come from the NORMALIZED sentences' token
    # lists (reference standalone:2486-2489 counts cached_token_lists
    # entries) — tokenizing the raw prefix strings instead diverges when
    # normalization changes the text (e.g. the trailing "\n" on the last
    # prefix is stripped under strip_sentences, costing a token on BPE
    # tokenizers) and would shift every fragment window in postprocess.
    prefix_counts_per_job: list[list[int]] = []
    for job, token_lists in zip(jobs, token_lists_per_job):
        n_prefix = len(job.get("prefix_sentences") or [])
        prefix_counts_per_job.append([len(ids) for ids in token_lists[:n_prefix]])

    # Stage 3: fragment split (pure Python, cheap) + empty-context fallback.
    tick = perf_counter()
    pieces_per_job: list[list[Piece]] = [
        split_token_lists(
            token_lists,
            max_fragment_tokens,
            keep_sentence_boundaries=respect_sentence_boundaries,
        )
        for token_lists in token_lists_per_job
    ]
    for pos, pieces in enumerate(pieces_per_job):
        if not pieces:
            whole = fallback_sentence(context_texts[pos], strip_sentences)
            pieces_per_job[pos] = [
                (list(tokenizer.encode(whole, add_special_tokens=False)), 0, 0, 0)
            ]
    timings["timing_fragment_split"] += perf_counter() - tick

    def _combine(payloads: list[dict[str, list[Any]]]) -> list[dict[str, Any]]:
        timings["timing_fragment_decode"] += perf_counter() - tick
        share = {key: value / len(jobs) for key, value in timings.items()}
        return [
            {
                "sentences": sentences,
                "prefix_token_counts": counts,
                **share,
                **payload,
            }
            for sentences, counts, payload in zip(
                sentences_per_job, prefix_counts_per_job, payloads
            )
        ]

    # Stage 4: ONE batched decode across every fragment in the chunk.
    tick = perf_counter()
    if not decode_fragments:
        return _combine(
            [
                _pieces_to_payload([("", piece) for piece in pieces])
                for pieces in pieces_per_job
            ]
        )
    if decode_fragments == "filter_only":
        return _combine(
            _filter_only_payloads(tokenizer, pieces_per_job, strip_sentences)
        )
    flat_ids = [ids for pieces in pieces_per_job for ids, *_ in pieces]
    flat_texts = (
        tokenizer.batch_decode(
            flat_ids, skip_special_tokens=True, clean_up_tokenization_spaces=False
        )
        if flat_ids
        else []
    )
    payloads: list[dict[str, list[Any]]] = []
    cursor = 0
    for pieces in pieces_per_job:
        texts = flat_texts[cursor : cursor + len(pieces)]
        cursor += len(pieces)
        rows: list[tuple[str, Piece]] = []
        for text, piece in zip(texts, pieces):
            shown = text.strip() if strip_sentences else text
            if shown if strip_sentences else text:
                rows.append((shown, piece))
        payload = _pieces_to_payload(rows)
        if not payload["fragment_token_ids"]:
            # Everything decoded to empty text: keep the first fragment anyway
            # so downstream always sees at least one (standalone's fallback).
            ids, sent_idx, frag_idx, global_idx = pieces[0]
            decoded = tokenizer.decode(
                ids, skip_special_tokens=True, clean_up_tokenization_spaces=False
            )
            shown = decoded.strip() if strip_sentences else decoded
            payload = _pieces_to_payload([(shown, (ids, sent_idx, frag_idx, global_idx))])
        payloads.append(payload)
    return _combine(payloads)


def _filter_only_payloads(
    tokenizer: Any,
    pieces_per_job: Sequence[Sequence[Piece]],
    strip_sentences: bool,
) -> list[dict[str, list[Any]]]:
    """Apply the empty-fragment filter with KEEP/DROP decisions identical
    to the full-decode path, decoding only undecidable fragments; every
    surviving ``fragment_texts`` entry is blank."""
    solid_per_job = _classify_fragment_solidity(tokenizer, pieces_per_job)
    # Real decode for the undecidable minority, one crossing for the chunk.
    pending: list[tuple[int, int]] = [
        (job_pos, frag_pos)
        for job_pos, flags in enumerate(solid_per_job)
        for frag_pos, solid in enumerate(flags)
        if not solid
    ]
    if pending:
        decoded = tokenizer.batch_decode(
            [pieces_per_job[j][f][0] for j, f in pending],
            skip_special_tokens=True,
            clean_up_tokenization_spaces=False,
        )
        for (job_pos, frag_pos), text in zip(pending, decoded):
            keep = (
                bool(str(text).strip()) if strip_sentences else bool(str(text))
            )
            solid_per_job[job_pos][frag_pos] = keep
    payloads: list[dict[str, list[Any]]] = []
    for pieces, flags in zip(pieces_per_job, solid_per_job):
        rows = [("", piece) for piece, keep in zip(pieces, flags) if keep]
        if not rows:
            # Everything decoded to empty text: keep the first fragment
            # anyway so downstream always sees at least one (standalone's
            # fallback; text stays blank in this mode).
            rows = [("", pieces[0])]
        payloads.append(_pieces_to_payload(rows))
    return payloads


def fragmentize_job(
    tokenizer: Any,
    job: Mapping[str, Any],
    *,
    max_fragment_tokens: int,
    splitter: SentenceSplitter,
    strip_sentences: bool,
    respect_sentence_boundaries: bool,
) -> dict[str, Any]:
    """Full fragmentation of one preprocessing job (standalone:897-943):
    the single-job view of :func:`fragmentize_jobs`."""
    return fragmentize_jobs(
        tokenizer,
        [job],
        max_fragment_tokens=max_fragment_tokens,
        splitter=splitter,
        strip_sentences=strip_sentences,
        respect_sentence_boundaries=respect_sentence_boundaries,
    )[0]


def fragments_from_payload(payload: Mapping[str, Any]) -> list[FragmentRecord]:
    """Columnar fragment payload → FragmentRecord list.

    Fast path for well-formed payloads (what ``fragmentize_jobs`` emits:
    aligned columns, int indices) — one zip, no per-element casts or copies;
    records share ``token_ids`` lists with the payload, which nothing
    mutates (truncation builds new records). Ragged hand-built payloads take
    the defensive route."""
    texts = payload.get("fragment_texts") or []
    id_lists = payload.get("fragment_token_ids") or []
    sent_idxs = payload.get("fragment_sentence_index") or []
    frag_idxs = payload.get("fragment_fragment_index") or []
    global_idxs = payload.get("fragment_global_index") or []
    n = len(texts)
    if n == len(id_lists) == len(sent_idxs) == len(frag_idxs) == len(global_idxs):
        return [
            FragmentRecord(text, sent, frag, gid, len(ids), ids)
            for text, ids, sent, frag, gid in zip(
                texts, id_lists, sent_idxs, frag_idxs, global_idxs
            )
        ]
    records: list[FragmentRecord] = []
    for pos, text in enumerate(texts):
        ids = list(id_lists[pos]) if pos < len(id_lists) else []
        records.append(
            FragmentRecord(
                text=text,
                sentence_index=int(sent_idxs[pos]) if pos < len(sent_idxs) else 0,
                fragment_index=int(frag_idxs[pos]) if pos < len(frag_idxs) else 0,
                global_index=int(global_idxs[pos]) if pos < len(global_idxs) else pos,
                token_length=len(ids),
                token_ids=ids,
            )
        )
    return records


def truncate_fragment(
    tokenizer: Any, fragment: FragmentRecord, max_tokens: int
) -> FragmentRecord:
    """Clip an oversize fragment to ``max_tokens`` and re-decode its text
    (standalone:2082-2102)."""
    budget = max(1, max_tokens)
    if fragment.token_length <= budget:
        return fragment
    ids = fragment.token_ids[:budget]
    return replace(
        fragment,
        text=tokenizer.decode(
            ids, skip_special_tokens=True, clean_up_tokenization_spaces=False
        ),
        token_length=len(ids),
        token_ids=ids,
    )


def assemble_blocks(
    tokenizer: Any,
    max_length: int,
    query_token_length: int,
    sep_token_length: int,
    fragments: list[FragmentRecord],
) -> list[list[FragmentRecord]]:
    """Greedy packing of fragments into ≤max_length blocks
    (standalone:2222-2259): available = max_length − 2 specials; oversize
    fragments truncated to the remaining capacity. The packing plan is
    computed by the native op (open_provence_tpu_torch/native); truncation text
    decoding stays host-Python (it needs the tokenizer)."""
    if not fragments:
        return []
    room = max_length - 2  # [CLS], [SEP]
    fixed = query_token_length + sep_token_length
    capacity = max(1, room - fixed)

    from ..native import greedy_pack

    block_ids, new_lens, n_blocks = greedy_pack(
        [f.token_length for f in fragments], fixed, room
    )
    blocks: list[list[FragmentRecord]] = [[] for _ in range(n_blocks)]
    for fragment, block_id, new_len in zip(fragments, block_ids, new_lens):
        if new_len < fragment.token_length:
            fragment = truncate_fragment(tokenizer, fragment, capacity)
        blocks[int(block_id)].append(fragment)
    return blocks


def max_fragment_tokens_for(max_length: int, respect_sentence_boundaries: bool) -> int:
    """Fragment budget: half the window normally, the whole window (minus
    specials) when sentence boundaries must be respected (standalone:3490-3493)."""
    budget = max_length - 2 if respect_sentence_boundaries else max_length // 2
    return max(16, budget)
