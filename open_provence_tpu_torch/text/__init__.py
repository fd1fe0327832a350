from .fragmentation import (
    FragmentRecord,
    assemble_blocks,
    fragmentize_job,
    fragments_from_payload,
    max_fragment_tokens_for,
    normalize_sentences,
    split_token_lists,
    truncate_fragment,
)
from .splitters import (
    SentenceSplitter,
    create_auto_sentence_splitter,
    create_english_sentence_splitter,
    english_sentence_splitter,
    is_japanese_fast,
    japanese_sentence_splitter,
    resolve_sentence_splitter,
    simple_sentence_splitter,
    split_overlong_sentence,
)
from .tokenizer import TokenizerAdapter, requires_manual_special_tokens

__all__ = [
    "FragmentRecord",
    "assemble_blocks",
    "fragmentize_job",
    "fragments_from_payload",
    "max_fragment_tokens_for",
    "normalize_sentences",
    "split_token_lists",
    "truncate_fragment",
    "SentenceSplitter",
    "create_auto_sentence_splitter",
    "create_english_sentence_splitter",
    "english_sentence_splitter",
    "is_japanese_fast",
    "japanese_sentence_splitter",
    "resolve_sentence_splitter",
    "simple_sentence_splitter",
    "split_overlong_sentence",
    "TokenizerAdapter",
    "requires_manual_special_tokens",
]
