"""Language-routed sentence splitting (host-side, device-free).

Behavioral counterpart of the reference's splitter stack
(modeling_open_provence_standalone.py:135-155, 1002-1143), built around
different machinery:

* ``is_japanese_fast`` — kana-density detector (regex scan, early exit),
* ``simple_sentence_splitter`` — Japanese splitter driven by a terminator
  scan over 。！？!? and newlines,
* English splitter — cut-point block segmentation at bullet-style headings,
  Punkt ``span_tokenize`` per block when its data is installed (with a
  regex span tokenizer for offline environments), whitespace-preserving
  sentence slices, deterministic overlong clipping,
* ``create_auto_sentence_splitter`` — kana detection routes ja vs en.

The reference prefers fast-bunkai for Japanese when installed
(standalone:1002-1016); this module mirrors that opportunism behind a lazy
import and otherwise uses the terminator-scan splitter, which matches the
reference's own documented fallback (standalone:1018-1029).
"""

from __future__ import annotations

import re
from collections.abc import Callable

SentenceSplitter = Callable[[str], list[str]]

DEFAULT_ENGLISH_SENTENCE_MAX_CHARS = 1200

SUPPORTED_SPLITTER_LANGUAGES = frozenset({"ja", "en", "auto"})

# Hiragana, katakana (incl. phonetic extensions), and half-width katakana
# letter ranges. Kanji intentionally excluded: the detector keys on kana
# density, so kanji-only CJK text (likely Chinese) is not routed to ja.
_KANA_RE = re.compile("[ぁ-ゖァ-ヺㇰ-ㇿｱ-ﾝ]")

# One leading bullet/number/letter marker followed by whitespace.
_BULLET_RE = re.compile(r"^\s*(?:[-*••]+|\d{1,4}[:.)]|[A-Za-z][:.)])\s+")

_JA_TERMINATOR_RE = re.compile("[。！？!?\n]")


def is_japanese_fast(text: str, window: int = 500, min_kana_per_window: int = 1) -> bool:
    """True when the text carries at least ``min_kana_per_window`` kana
    letters per ``window`` chars (reference standalone:135-155)."""
    if not text or text.isascii():
        return False
    need = -(-len(text) // window) * min_kana_per_window  # ceil-div
    if need <= 0:
        return False
    seen = 0
    for _ in _KANA_RE.finditer(text):
        seen += 1
        if seen >= need:
            return True
    return False


def simple_sentence_splitter(text: str) -> list[str]:
    """Japanese splitter: each sentence runs up to (and includes) the first
    terminator found at least one char past its start; the tail without a
    terminator is its own sentence (reference standalone:1018-1029)."""
    if not text:
        return []
    pieces: list[str] = []
    pos = 0
    n = len(text)
    while pos < n:
        hit = _JA_TERMINATOR_RE.search(text, pos + 1)
        if hit is None:
            pieces.append(text[pos:])
            break
        pieces.append(text[pos : hit.end()])
        pos = hit.end()
    return pieces


def _fast_bunkai():
    """Opportunistic fast-bunkai import (reference standalone:1002-1016);
    returns a splitter or None. Cached after first probe."""
    global _FAST_BUNKAI_SPLITTER, _FAST_BUNKAI_PROBED
    if _FAST_BUNKAI_PROBED:
        return _FAST_BUNKAI_SPLITTER
    _FAST_BUNKAI_PROBED = True
    try:
        from fast_bunkai import FastBunkai  # type: ignore[import-not-found]

        engine = FastBunkai()

        def _split(text: str) -> list[str]:
            return [piece for piece in engine(text) if piece]

        _FAST_BUNKAI_SPLITTER = _split
    except Exception:
        _FAST_BUNKAI_SPLITTER = None
    return _FAST_BUNKAI_SPLITTER


_FAST_BUNKAI_SPLITTER: SentenceSplitter | None = None
_FAST_BUNKAI_PROBED = False


def japanese_sentence_splitter(text: str) -> list[str]:
    """Japanese routing: fast-bunkai when installed, terminator-scan
    otherwise."""
    bunkai = _fast_bunkai()
    if bunkai is not None:
        return bunkai(text)
    return simple_sentence_splitter(text)


def _iter_english_blocks(text: str):
    """Yield ``(block_text, start, end)`` slices of ``text``, cutting before
    every bullet-style line except one at offset 0 (standalone:485-529).

    Implemented as cut-point segmentation: collect the offsets of bullet
    lines, then slice the text between consecutive cuts.
    """
    if not text:
        return
    cuts: list[int] = []
    offset = 0
    for line in text.splitlines(keepends=True):
        if offset and _BULLET_RE.match(line.rstrip("\r\n")):
            cuts.append(offset)
        offset += len(line)
    edges = [0, *cuts, len(text)]
    for lo, hi in zip(edges, edges[1:]):
        if hi > lo:
            yield text[lo:hi], lo, hi


def _clip_boundary(working: str, lo: int, hi: int) -> int:
    """Boundary for one overlong-clip chunk in ``(lo, hi]``: after the last
    newline if any, else after the last sentence punctuation, else ``hi``."""
    nl = working.rfind("\n", lo + 1, hi)
    if nl > lo:
        return nl + 1
    for idx in range(hi, lo, -1):
        if working[idx - 1] in ".?!;:\n":
            return idx
    return hi


def split_overlong_sentence(
    sentence: str,
    max_chars: int = DEFAULT_ENGLISH_SENTENCE_MAX_CHARS,
    *,
    preserve_whitespace: bool = False,
) -> list[str]:
    """Deterministically clip a sentence into ≤``max_chars`` chunks at
    newline-then-punctuation boundaries (standalone:532-579)."""
    working = sentence if preserve_whitespace else sentence.strip()
    if not working:
        return []
    if len(working) <= max_chars:
        return [working]

    out: list[str] = []
    lo, n = 0, len(working)
    while lo < n:
        hi = min(lo + max_chars, n)
        cut = _clip_boundary(working, lo, hi)
        piece = working[lo:cut] if preserve_whitespace else working[lo:cut].strip()
        if piece:
            out.append(piece)
        lo = cut
    return out or [working]


# --- English sentence span tokenization -----------------------------------

_PUNKT_CACHE: dict[str, object] = {}

_ABBREVIATIONS = frozenset(
    {
        "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "etc", "vs", "e.g",
        "i.e", "fig", "no", "vol", "inc", "ltd", "co", "corp", "dept", "univ",
        "approx", "est", "min", "max", "u.s", "u.k", "a.m", "p.m",
    }
)

_REGEX_SENT_END = re.compile(r"[.!?]+[\"')\]]*")


def load_punkt(language: str = "english"):
    """Load an NLTK punkt model if its data is present; never raises, never
    downloads. Cached per language."""
    if language in _PUNKT_CACHE:
        return _PUNKT_CACHE[language]
    model = None
    try:
        import nltk

        model = nltk.data.load(f"tokenizers/punkt/{language}.pickle")
    except Exception:
        model = None
    _PUNKT_CACHE[language] = model
    return model


def _regex_span_tokenize(text: str) -> list[tuple[int, int]]:
    """Punkt-like span tokenizer for offline environments: sentence ends at
    .!? runs not preceded by a known abbreviation/initial/number. Like punkt,
    spans exclude surrounding whitespace."""

    def _trimmed(start: int, end: int) -> tuple[int, int] | None:
        while start < end and text[start].isspace():
            start += 1
        while end > start and text[end - 1].isspace():
            end -= 1
        if start >= end:
            return None
        return start, end

    spans: list[tuple[int, int]] = []
    start = 0
    for match in _REGEX_SENT_END.finditer(text):
        end = match.end()
        # Candidate word before the punctuation.
        before = text[max(0, match.start() - 12) : match.start()]
        word_match = re.search(r"([A-Za-z][A-Za-z.]*)$", before)
        word = word_match.group(1).lower().rstrip(".") if word_match else ""
        if "." in match.group() and len(match.group().rstrip("\"')]")) == 1:
            if word in _ABBREVIATIONS or (len(word) == 1 and word.isalpha()):
                continue
            # Numeric like "3.14" — next char is a digit.
            if end < len(text) and text[end].isdigit():
                continue
        # Require whitespace-or-EOF after to end a sentence.
        if end < len(text) and not text[end].isspace():
            continue
        span = _trimmed(start, end)
        if span is not None:
            spans.append(span)
        start = end
    span = _trimmed(start, len(text))
    if span is not None:
        spans.append(span)
    return spans


class _EnglishSplitter:
    """Whitespace-preserving English splitter (standalone:1032-1117).

    Pipeline per input text: block segmentation at bullet headings →
    per-block sentence spans (punkt when available, regex otherwise) →
    each span extended through its trailing whitespace (bounded by the
    block) → overlong clipping. Concatenating the output reproduces the
    source text up to leading whitespace before the first sentence.
    """

    def __init__(self, max_chars: int, use_native: bool = True):
        if max_chars <= 0:
            raise ValueError("max_chars must be positive")
        self.max_chars = max_chars
        self.use_native = use_native

    def _spans(self, block_text: str) -> list[tuple[int, int]]:
        punkt = load_punkt()
        if punkt is not None:
            return list(punkt.span_tokenize(block_text))  # type: ignore[attr-defined]
        return _regex_span_tokenize(block_text)

    def _clip(self, segment: str) -> list[str]:
        return split_overlong_sentence(
            segment, max_chars=self.max_chars, preserve_whitespace=True
        )

    def __call__(self, text: str) -> list[str]:
        if not text:
            return []
        if self.use_native and load_punkt() is None:
            # Native fast path: the whole block/span/clip pipeline in one
            # C++ pass over ASCII text (same spans as the Python route
            # below; parity fuzz-tested in tests/test_native_ops.py).
            from ..native import en_split_spans

            spans = en_split_spans(text, self.max_chars)
            if spans is not None:
                return [text[lo:hi] for lo, hi in spans]
        sentences: list[str] = []
        for block_text, block_lo, block_hi in _iter_english_blocks(text):
            spans = self._spans(block_text)
            if not spans:
                if block_text.strip():
                    sentences.extend(self._clip(block_text))
                continue
            for span_lo, span_hi in spans:
                # Absorb trailing whitespace so the slices tile the block.
                end = block_lo + span_hi
                while end < block_hi and text[end].isspace():
                    end += 1
                segment = text[block_lo + span_lo : end]
                if segment.strip():
                    sentences.extend(self._clip(segment))
        if sentences:
            return sentences
        tail = text.strip()
        return [tail] if tail else []


def create_english_sentence_splitter(
    max_chars: int = DEFAULT_ENGLISH_SENTENCE_MAX_CHARS,
) -> SentenceSplitter:
    return _EnglishSplitter(max_chars)


_DEFAULT_ENGLISH_SENTENCE_SPLITTER = create_english_sentence_splitter()


def english_sentence_splitter(text: str) -> list[str]:
    return _DEFAULT_ENGLISH_SENTENCE_SPLITTER(text)


def create_auto_sentence_splitter(
    *,
    japanese_splitter: SentenceSplitter = japanese_sentence_splitter,
    english_splitter: SentenceSplitter = english_sentence_splitter,
    kana_window: int = 500,
    min_kana_per_window: int = 1,
) -> SentenceSplitter:
    def _route(text: str) -> list[str]:
        detected_ja = is_japanese_fast(
            text, window=kana_window, min_kana_per_window=min_kana_per_window
        )
        return japanese_splitter(text) if detected_ja else english_splitter(text)

    return _route


def resolve_sentence_splitter(
    splitter: SentenceSplitter | dict | None, language: str | None
) -> SentenceSplitter:
    """Splitter resolution: explicit callable > per-language mapping >
    built-in by language code (standalone:2007-2039)."""
    if isinstance(splitter, dict):
        if language is None:
            raise ValueError("language must be provided when sentence_splitter is a mapping")
        try:
            return splitter[language]
        except KeyError:
            raise ValueError(
                f"No sentence splitter registered for language '{language}'"
            ) from None
    if callable(splitter):
        return splitter
    lang = (language or "auto").lower()
    builders: dict[str, Callable[[], SentenceSplitter]] = {
        "auto": create_auto_sentence_splitter,
        "ja": lambda: japanese_sentence_splitter,
        "en": lambda: english_sentence_splitter,
    }
    if lang not in builders:
        raise ValueError(
            f"Unsupported language code for sentence splitting: '{lang}'. "
            "Supported values are 'auto', 'en', and 'ja'."
        )
    return builders[lang]()
