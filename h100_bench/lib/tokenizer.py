"""The benchmark's tokenizer: one token a character (id = ord + 10).

A frozen copy of the repository's test tokenizers (``DummyTokenizer`` and
``PairDummyTokenizer``), so that the benchmark's traffic is sized in tokens
that no later change to the tests can move. The program and the reference
are handed the same instance; the reference reads only ``encode``.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

CLS, SEP, PAD = 1, 2, 0


class _Batch(dict):
    def __init__(self, input_ids):
        super().__init__(input_ids=input_ids)

    @property
    def input_ids(self):
        return self["input_ids"]


class CharTokenizer:
    """Char-ordinal tokenizer: token id = ord(char) + 10. CLS=1, SEP=2, PAD=0."""

    cls_token_id = CLS
    sep_token_id = SEP
    pad_token_id = PAD
    bos_token_id = None
    eos_token_id = None
    cls_token = "[CLS]"
    sep_token = "[SEP]"
    pad_token = "[PAD]"
    model_max_length = 1_000_000

    @property
    def special_tokens_map(self):
        return {"cls_token": self.cls_token, "sep_token": self.sep_token,
                "pad_token": self.pad_token}

    @staticmethod
    def _encode_text(text: str) -> list[int]:
        # ord(ch) + 10 for every character, computed in one numpy pass.
        return (np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32) + 10).tolist()

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = self._encode_text(text)
        return [CLS, *ids, SEP] if add_special_tokens else ids

    def __call__(self, texts, add_special_tokens: bool = True, return_attention_mask: bool = True,
                 **kwargs):
        if isinstance(texts, str):
            texts = [texts]
        return _Batch([self.encode(t, add_special_tokens=add_special_tokens) for t in texts])

    def decode(self, token_ids: Sequence[int], **kwargs) -> str:
        return "".join(chr(int(t) - 10) for t in token_ids if int(t) not in (CLS, SEP, PAD))

    def batch_decode(self, sequences, **kwargs):
        return [self.decode(seq, **kwargs) for seq in sequences]

    def build_inputs_with_special_tokens(self, ids0, ids1=None):
        if ids1 is None:
            return [CLS, *ids0, SEP]
        return [CLS, *ids0, SEP, *ids1, SEP]

    def create_token_type_ids_from_sequences(self, ids0, ids1=None):
        if ids1 is None:
            return [0] * (len(ids0) + 2)
        return [0] * (len(ids0) + 2) + [1] * (len(ids1) + 1)

    def get_vocab(self):
        return {"[CLS]": CLS, "[SEP]": SEP, "[PAD]": PAD}


class PairCharTokenizer(CharTokenizer):
    """Adds (query, document) pair encoding with padding, truncation and
    offset mappings: what the training collator asks of a tokenizer.
    Offsets are built only when asked for."""

    eos_token_id = SEP

    def _encode_pair(self, query: str, doc: str, offsets: bool):
        ids = [CLS, *self._encode_text(query), SEP, *self._encode_text(doc), SEP]
        if not offsets:
            return ids, None
        spans = ([(0, 0)] + [(i, i + 1) for i in range(len(query))] + [(0, 0)]
                 + [(i, i + 1) for i in range(len(doc))] + [(0, 0)])
        return ids, spans

    def __call__(self, texts, add_special_tokens: bool = True, return_attention_mask: bool = True,
                 padding=False, truncation=False, max_length=None,
                 return_offsets_mapping: bool = False, return_tensors=None, **kwargs):
        if isinstance(texts, str):
            texts = [texts]
        all_ids, all_offsets = [], []
        for item in texts:
            if (isinstance(item, (list, tuple)) and len(item) == 2
                    and all(isinstance(x, str) for x in item)):
                ids, offsets = self._encode_pair(item[0], item[1], return_offsets_mapping)
            else:
                text = item if isinstance(item, str) else "".join(item)
                ids = self.encode(text, add_special_tokens=add_special_tokens)
                offsets = ([(i, i + 1) for i in range(len(ids))]
                           if return_offsets_mapping else None)
            if truncation and max_length is not None:
                ids = ids[:max_length]
                offsets = offsets[:max_length] if offsets is not None else None
            all_ids.append(ids)
            all_offsets.append(offsets)
        attention = [[1] * len(ids) for ids in all_ids]
        if padding:
            target = (max_length if padding == "max_length" and max_length is not None
                      else max(len(ids) for ids in all_ids))
            for i, ids in enumerate(all_ids):
                pad_n = target - len(ids)
                all_ids[i] = ids + [PAD] * pad_n
                attention[i] = attention[i] + [0] * pad_n
                if return_offsets_mapping:
                    all_offsets[i] = all_offsets[i] + [(0, 0)] * pad_n
        out = _Batch(all_ids)
        out["attention_mask"] = attention
        if return_offsets_mapping:
            out["offset_mapping"] = all_offsets
        return out
