"""Triplet → Provence-format dataset conversion.

The port's copy of the JAX package's ``datasets_factory/converter.py``, on
``train/data.py``'s ``RowTable`` in place of HF ``Dataset``: the converter
takes a ``RowTable``, a dict of them, or an HF ``Dataset`` / ``DatasetDict``
(read into row tables), and returns a dict of ``RowTable``s, whose rows,
split sizes and order are the JAX package's (``shuffle`` is HF's
permutation). Library form of the reference's
scripts/context-relevance-datasets/generate_ds_from_sentense_transformer.py:
(query, positive, negatives…) rows → {id, query, texts, context_spans,
labels}, with per-language sentence splitters (punkt for 16 languages when
its data is present, regex fallback otherwise; ja handled by the package's
splitter since fast-bunkai is Rust-only) and the 1%/≤5k automatic
validation/test split policy.  Field extraction and span location are
behaviorally identical to the reference (golden-tested in
tests/test_datasets_factory.py) but organised around table-driven field
chains and a cursor-based span locator.
"""

from __future__ import annotations

import logging
import re
from collections.abc import Callable, Sequence
from typing import Any, cast

from ..text.splitters import japanese_sentence_splitter
from ..train.data import RowTable, _from_hf

_LOG = logging.getLogger(__name__)

SplitFn = Callable[[str], list[str]]
SentenceSplitter = SplitFn  # back-compat alias

NLTK_PUNKT_LANG_CODES = {
    "da": "danish", "de": "german", "en": "english", "es": "spanish",
    "et": "estonian", "fi": "finnish", "fr": "french", "el": "greek",
    "it": "italian", "nb": "norwegian", "nl": "dutch", "pl": "polish",
    "pt": "portuguese", "sl": "slovene", "sv": "swedish", "tr": "turkish",
}
_ALIASES: dict[str, str] = {
    **NLTK_PUNKT_LANG_CODES,
    **{name: name for name in NLTK_PUNKT_LANG_CODES.values()},
    "no": "norwegian",
    "nn": "norwegian",
}

_GENERIC_SPLIT_PATTERN = re.compile(r".+?(?:[.!?。！？]+(?:\s+|$)|\n+|$)", re.S)


def generic_sentence_splitter(text: str) -> list[str]:
    pieces = [m.strip() for m in _GENERIC_SPLIT_PATTERN.findall(text)]
    found = [p for p in pieces if p]
    if found:
        return found
    whole = text.strip()
    return [whole] if whole else []


def _punkt_splitter(language_name: str) -> SentenceSplitter | None:
    try:
        import nltk

        tokenizer = nltk.data.load(f"tokenizers/punkt/{language_name}.pickle")
    except Exception:
        return None

    def _split(text: str) -> list[str]:
        return [s for s in tokenizer.tokenize(text) if s.strip()]

    return _split


def resolve_factory_splitter(language: str) -> SentenceSplitter:
    code = language.lower()
    if code == "ja":
        return lambda text: [s.strip() for s in japanese_sentence_splitter(text) if s.strip()]
    punkt_name = _ALIASES.get(code)
    if punkt_name is None:
        _LOG.warning(
            "No splitter registered for language '%s'; using regex fallback.", code
        )
        return generic_sentence_splitter
    punkt = _punkt_splitter(punkt_name)
    if punkt is None:
        _LOG.warning(
            "punkt data for '%s' unavailable; using regex fallback splitter.",
            punkt_name,
        )
        return generic_sentence_splitter
    return punkt


# --------------------------------------------------------------------------
# span extraction


def _locate(haystack: str, needle: str, cursor: int) -> int:
    """Leftmost occurrence at/after ``cursor``, else anywhere, else -1."""
    at = haystack.find(needle, cursor)
    return at if at >= 0 else haystack.find(needle)


def text_to_spans(text: str, splitter: SplitFn) -> list[list[int]]:
    """Char spans of the splitter's (stripped) sentences inside ``text``;
    a whole-text span when nothing splits (reference behavior:
    generate_ds_from_sentense_transformer.py:158-195)."""
    located: list[list[int]] = []
    cursor = 0
    for piece in splitter(text):
        piece = piece.strip()
        if not piece:
            continue
        at = _locate(text, piece, cursor)
        if at < 0:
            continue
        located.append([at, at + len(piece)])
        cursor = at + len(piece)
    if located:
        return located
    whole = text.strip()
    if not whole:
        return [[0, 0]]
    at = max(text.find(whole), 0)
    return [[at, at + len(whole)]]


# --------------------------------------------------------------------------
# field extraction (table-driven)

_QUERY_CHAIN = ("query", "question", "prompt")
_POSITIVE_CHAIN = ("answer", "positive", "pos", "target")
_NEGATIVE_PREFIXES = ("negative", "neg")


def _coerce_text(value: Any) -> str:
    if value is None:
        return ""
    if isinstance(value, str):
        return value
    if isinstance(value, list):
        parts = (str(item) for item in value if item)
        return " ".join(parts)
    return str(value)


def _first_truthy(example: dict[str, Any], chain: Sequence[str]) -> Any:
    for field in chain:
        value = example.get(field)
        if value:
            return value
    return None


def extract_fields(example: dict[str, Any]) -> tuple[str, str, list[str]]:
    """query/question/prompt + answer/positive/pos/target + negative*
    (reference behavior: generate_ds_from_sentense_transformer.py:198-222)."""
    query = _coerce_text(_first_truthy(example, _QUERY_CHAIN))
    if not query:
        raise ValueError("No query/question/prompt field in example.")
    positive = _coerce_text(_first_truthy(example, _POSITIVE_CHAIN))
    if not positive:
        raise ValueError("No answer/positive field in example.")
    negative_keys = sorted(
        k
        for k in example
        if isinstance(k, str) and k.startswith(_NEGATIVE_PREFIXES)
    )
    negatives = [
        text for k in negative_keys if (text := _coerce_text(example.get(k)))
    ]
    return query, positive, negatives


# --------------------------------------------------------------------------
# record assembly


def slugify_dataset_name(name: str, subset: str | None) -> str:
    slug = name.replace("/", "_")
    return slug if not subset else f"{slug}_{subset}"


def build_record(
    example: dict[str, Any], *, splitter: SentenceSplitter, idx: int,
    dataset_slug: str, split: str,
) -> dict[str, Any]:
    row_query, row_positive, row_negatives = extract_fields(example)
    texts = [row_positive, *row_negatives]
    return {
        "id": f"{dataset_slug}:{split}:{idx}",
        "query": row_query,
        "texts": texts,
        "context_spans": [text_to_spans(t, splitter) for t in texts],
        "labels": [1] + [0] * len(row_negatives),
    }


_EMPTY_COLUMNS = ("id", "query", "texts", "context_spans", "labels")


def convert_split(
    dataset: RowTable, *, splitter: SentenceSplitter, dataset_slug: str, split: str
) -> RowTable:
    records = [
        build_record(
            cast(dict[str, Any], row),
            splitter=splitter, idx=idx, dataset_slug=dataset_slug, split=split,
        )
        for idx, row in enumerate(dataset)
    ]
    if not records:
        return RowTable.from_dict({c: [] for c in _EMPTY_COLUMNS})
    return RowTable.from_list(records)


# --------------------------------------------------------------------------
# split policy: 1% (clamped to [1, 5000]) each for validation and test


def compute_split_size(row_count: int) -> int:
    """Rows to carve for one eval split out of ``total_rows``
    (reference behavior: generate_ds_from_sentense_transformer.py:367-375)."""
    if row_count <= 1:
        return 0
    one_percent = min(max(1, int(round(row_count * 0.01))), 5000)
    headroom = row_count - 1
    ceiling = headroom if headroom <= 1 else headroom // 2
    return min(one_percent, ceiling)


def _eval_carve_plan(total: int) -> tuple[int, int]:
    """(validation_size, test_size) leaving at least one training row."""
    if total == 0:
        raise ValueError("Cannot carve validation/test splits from an empty train split.")
    val = compute_split_size(total) or (1 if total > 1 else 0)
    test = compute_split_size(total - val) or (1 if total - val > 1 else 0)
    deficit = 1 - (total - val - test)
    if deficit > 0:
        if test > deficit:
            test -= deficit
        elif val > deficit:
            val -= deficit
        else:
            raise ValueError("Unable to allocate positive split sizes.")
    return val, test


def ensure_eval_splits(splits: dict[str, RowTable], seed: int) -> dict[str, RowTable]:
    """Carve validation/test out of a shuffled train when either is absent
    (reference behavior: generate_ds_from_sentense_transformer.py:360-411)."""
    if {"validation", "test"} <= splits.keys():
        return splits
    shuffled = splits["train"].shuffle(seed=seed)
    val, test = _eval_carve_plan(len(shuffled))
    return {
        **splits,
        "validation": shuffled.select(range(val)),
        "test": shuffled.select(range(val, val + test)),
        "train": shuffled.select(range(val + test, len(shuffled))),
    }


def _as_tables(dataset_dict: Any) -> dict[str, RowTable]:
    """A ``RowTable`` or a single HF ``Dataset`` as the split ``train``; a
    dict of them (an HF ``DatasetDict`` too) split by split."""
    if isinstance(dataset_dict, RowTable):
        return {"train": dataset_dict}
    if hasattr(dataset_dict, "to_list"):
        return {"train": _from_hf(dataset_dict)}
    return {
        name: ds if isinstance(ds, RowTable) else _from_hf(ds)
        for name, ds in dataset_dict.items()
    }


def convert_dataset_dict(
    dataset_dict: Any,
    *,
    language: str,
    dataset_slug: str,
    sample_size: int | None = None,
    seed: int = 42,
) -> dict[str, RowTable]:
    dataset_dict = _as_tables(dataset_dict)
    if "train" not in dataset_dict:
        raise ValueError("Conversion needs a 'train' split in the source dataset.")
    if sample_size is not None and sample_size <= 0:
        raise ValueError("sample_size must be positive if provided.")
    splitter = resolve_factory_splitter(language)

    def _maybe_sample(ds: RowTable) -> RowTable:
        if sample_size is None:
            return ds
        return ds.shuffle(seed=seed).select(range(min(sample_size, len(ds))))

    splits = ensure_eval_splits(
        {name: _maybe_sample(ds) for name, ds in dataset_dict.items()}, seed
    )
    return {
        name: convert_split(ds, splitter=splitter, dataset_slug=dataset_slug, split=name)
        for name, ds in splits.items()
    }
