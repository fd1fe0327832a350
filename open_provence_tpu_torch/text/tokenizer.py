"""Host-side tokenizer adapter.

The device boundary of this framework starts at token IDs; tokenization stays
on the host (the reference relies on HF's Rust tokenizers the same way —
SURVEY §2.3). This adapter reproduces the reference's tokenizer edge
behaviors:

* the manual-specials probe for tokenizers (notably ModernBERT) that drop
  CLS/SEP when given pre-tokenized input (standalone:1501-1538),
* block input construction: [CLS] query [SEP] fragments [SEP] with
  token_type_ids and per-fragment token ranges recovered by subsequence
  search (standalone:2104-2196).
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any

from .fragmentation import FragmentRecord


def _resolve_special_token_id(*candidates: Any) -> int | None:
    for candidate in candidates:
        if isinstance(candidate, int):
            return candidate
    return None


def requires_manual_special_tokens(tokenizer: Any) -> bool:
    """Detect tokenizers that omit CLS/SEP in build_inputs_with_special_tokens
    for pre-tokenized input (standalone:1501-1538)."""
    try:
        query_tokens = tokenizer.encode("open provence query", add_special_tokens=False)
        context_tokens = tokenizer.encode("open provence document", add_special_tokens=False)
    except Exception:
        return False
    if not query_tokens or not context_tokens:
        return False
    try:
        built = tokenizer.build_inputs_with_special_tokens(query_tokens, context_tokens)
    except Exception:
        return False
    built = [int(token) for token in built]

    special_map = getattr(tokenizer, "special_tokens_map", {}) or {}
    cls_candidates = [
        getattr(tokenizer, "cls_token_id", None),
        special_map.get("cls_token_id"),
        getattr(tokenizer, "bos_token_id", None),
        special_map.get("bos_token_id"),
    ]
    cls_candidates = [v for v in cls_candidates if isinstance(v, int)]
    sep_candidates = [
        getattr(tokenizer, "sep_token_id", None),
        special_map.get("sep_token_id"),
        getattr(tokenizer, "eos_token_id", None),
        special_map.get("eos_token_id"),
    ]
    sep_candidates = [v for v in sep_candidates if isinstance(v, int)]

    missing_cls = bool(cls_candidates) and not any(t in cls_candidates for t in built)
    missing_sep = bool(sep_candidates) and not any(t in sep_candidates for t in built)
    return missing_cls or missing_sep


class TokenizerAdapter:
    """Wraps a HF-style tokenizer with the reference's runtime fixes."""

    def __init__(self, tokenizer: Any, max_length: int = 512):
        self.tokenizer = tokenizer
        self.max_length = int(max_length)
        # Lift model_max_length so host tokenization never truncates
        # (standalone:1391-1399).
        upper = max(getattr(tokenizer, "model_max_length", 0) or 0, 1_000_000)
        upper = max(upper, self.max_length)
        try:
            tokenizer.model_max_length = upper
        except Exception:
            pass

        self.manual_special_tokens = requires_manual_special_tokens(tokenizer)
        special_map = getattr(tokenizer, "special_tokens_map", {}) or {}
        if self.manual_special_tokens:
            self.manual_cls_token_id = _resolve_special_token_id(
                getattr(tokenizer, "cls_token_id", None),
                special_map.get("cls_token_id"),
                getattr(tokenizer, "bos_token_id", None),
                special_map.get("bos_token_id"),
            )
            self.manual_sep_token_id = _resolve_special_token_id(
                getattr(tokenizer, "sep_token_id", None),
                special_map.get("sep_token_id"),
                getattr(tokenizer, "eos_token_id", None),
                special_map.get("eos_token_id"),
            )
        else:
            self.manual_cls_token_id = None
            self.manual_sep_token_id = None

    # --- passthroughs ------------------------------------------------------

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.tokenizer(*args, **kwargs)

    def encode(self, *args: Any, **kwargs: Any) -> Any:
        return self.tokenizer.encode(*args, **kwargs)

    def encode_batch_ids(self, texts: Sequence[str]) -> list[list[int]]:
        """Token ids (no specials) for a batch of texts, skipping the HF
        wrapper's per-sequence Encoding→dict conversion (it builds offsets/
        masks nobody reads here — measured as the top host-prep cost).

        Falls back to the HF call when the backend carries sticky
        truncation/padding state (HF resets it per call; raw encode_batch
        would silently inherit it) or there is no fast backend."""
        texts = [str(t) for t in texts]
        if not texts:
            return []
        backend = getattr(self.tokenizer, "_tokenizer", None)
        if (
            backend is not None
            and getattr(backend, "truncation", None) is None
            and getattr(backend, "padding", None) is None
        ):
            try:
                # encode_batch_fast (tokenizers ≥0.20) skips offset/word-id
                # tracking nobody reads here — ~1.4x over encode_batch,
                # identical .ids.
                encode = getattr(backend, "encode_batch_fast", None) or backend.encode_batch
                encodings = encode(texts, add_special_tokens=False)
                # .ids already materializes a fresh Python list per encoding.
                return [e.ids for e in encodings]
            except Exception:
                pass
        encoded = self.tokenizer(
            texts, add_special_tokens=False, return_attention_mask=False
        )
        ids = (
            encoded.get("input_ids", [])
            if hasattr(encoded, "get")
            else getattr(encoded, "input_ids", [])
        )
        return [list(row) for row in ids]

    def decode(self, *args: Any, **kwargs: Any) -> Any:
        return self.tokenizer.decode(*args, **kwargs)

    def batch_decode(self, sequences: Any = None, /, *args: Any, **kwargs: Any) -> Any:
        # transformers' batch_decode is a PYTHON loop of per-sequence Rust
        # decode calls; the fast backend's decode_batch crosses into Rust
        # once. Semantics match exactly when no cleanup is requested (HF's
        # _decode with clean_up_tokenization_spaces=False is the raw Rust
        # decode).
        backend = getattr(self.tokenizer, "_tokenizer", None)
        if (
            sequences is not None
            and not args
            and backend is not None
            and hasattr(backend, "decode_batch")
            and kwargs.get("clean_up_tokenization_spaces") is False
            and set(kwargs) <= {"skip_special_tokens", "clean_up_tokenization_spaces"}
        ):
            skip = bool(kwargs.get("skip_special_tokens", False))
            try:
                # Sequences from the encode path are already list[int]; the
                # per-token int() sweep only exists for numpy-int callers.
                return backend.decode_batch(list(sequences), skip_special_tokens=skip)
            except Exception:
                return backend.decode_batch(
                    [[int(t) for t in seq] for seq in sequences],
                    skip_special_tokens=skip,
                )
        if sequences is None:
            return self.tokenizer.batch_decode(*args, **kwargs)
        return self.tokenizer.batch_decode(sequences, *args, **kwargs)

    @property
    def sep_token(self) -> str:
        return getattr(self.tokenizer, "sep_token", None) or ""

    @property
    def pad_token_id(self) -> int:
        raw = getattr(self.tokenizer, "pad_token_id", None)
        return int(raw) if raw is not None else 0

    def sep_token_ids(self) -> list[int]:
        return list(
            self.tokenizer.encode(self.sep_token or "", add_special_tokens=False)
        )

    # --- block input construction ------------------------------------------

    def prepare_block_inputs(
        self,
        query_tokens: Sequence[int],
        fragments: Sequence[FragmentRecord],
        *,
        want_token_type_ids: bool = True,
        context_start_hint: int | None = None,
    ) -> tuple[list[int], list[int], list[int] | None, list[tuple[int, int]]]:
        """[CLS] query [SEP] frag… [SEP] + attention mask + token_type_ids +
        per-fragment token ranges (standalone:2104-2196).

        ``want_token_type_ids=False`` skips the per-block HF token-type call
        (the engine's device path never feeds token types).
        ``context_start_hint`` skips the per-block subsequence search: the
        context offset depends only on the query and the specials layout, so
        callers batching many blocks of one query compute it once (from the
        first block's ``ranges[0][0]``) and pass it back for the rest."""
        tokenizer = self.tokenizer
        # map(int, ·) over a genexpr of per-token casts: this runs once per
        # block over up to max_length ids, and fragment/query ids are already
        # ints from the Rust encode path.
        query_list = list(map(int, query_tokens))
        context_tokens: list[int] = []
        for fragment in fragments:
            context_tokens.extend(fragment.token_ids)

        if self.manual_special_tokens:
            input_ids: list[int] = []
            if self.manual_cls_token_id is not None:
                input_ids.append(self.manual_cls_token_id)
            input_ids.extend(query_list)
            if self.manual_sep_token_id is not None:
                input_ids.append(self.manual_sep_token_id)
            input_ids.extend(context_tokens)
            if self.manual_sep_token_id is not None and context_tokens:
                input_ids.append(self.manual_sep_token_id)
        else:
            built_with_specials = tokenizer.build_inputs_with_special_tokens(
                query_list, context_tokens
            )
            if built_with_specials:
                input_ids = list(map(int, built_with_specials))
            else:
                input_ids = query_list + context_tokens

        attention_mask = [1] * len(input_ids)

        from ..native import find_subsequence

        ranges: list[tuple[int, int]] = []
        if context_tokens:
            # A hint is only a candidate: it must be verified against THIS
            # block's ids (a degenerate search result memoized from another
            # block — e.g. a context whose token run also appears inside the
            # query — must not propagate to unrelated blocks).
            hint = context_start_hint
            if hint is not None and (
                hint < 0
                or input_ids[hint : hint + len(context_tokens)] != context_tokens
            ):
                hint = None
            if hint is not None:
                context_start = hint
            else:
                context_start = find_subsequence(input_ids, context_tokens)
                if context_start < 0:
                    prefix_ids = tokenizer.build_inputs_with_special_tokens(
                        query_list, []
                    )
                    context_start = len(prefix_ids)
            cursor = context_start
            for fragment in fragments:
                start = cursor
                cursor += len(fragment.token_ids)
                ranges.append((start, cursor))

        if not want_token_type_ids:
            return input_ids, attention_mask, None, ranges

        token_type_ids: list[int] | None
        try:
            token_type_ids = tokenizer.create_token_type_ids_from_sequences(
                query_list, context_tokens
            )
        except Exception:
            token_type_ids = None
        else:
            if token_type_ids is not None:
                token_type_ids = list(map(int, token_type_ids))

        if token_type_ids is not None and len(token_type_ids) < len(input_ids):
            pad_value = token_type_ids[-1] if token_type_ids else 0
            token_type_ids = token_type_ids + [pad_value] * (
                len(input_ids) - len(token_type_ids)
            )
        if token_type_ids is None:
            token_type_ids = [0] * len(input_ids)
            context_start = ranges[0][0] if context_tokens else len(input_ids)
            for idx in range(context_start, len(input_ids)):
                token_type_ids[idx] = 1

        return input_ids, attention_mask, token_type_ids, ranges
