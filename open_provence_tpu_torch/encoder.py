"""OpenProvenceEncoder — the training-side model with predict/prune APIs.

Counterpart of the JAX package's ``encoder.py`` (reference
open_provence/encoder.py:48-1234): a two-head model exposing

* ``predict`` — raw ranking scores over (query, document) pairs with the
  Provence logits[:, 0] convention (encoder.py:317-326),
* ``predict_with_pruning`` — offset-mapping-based token-level document
  pruning with merged character ranges (encoder.py:345-528),
* ``predict_context`` — chunk-level evaluation against char spans
  (encoder.py:682-899),
* ``prune`` / ``prune_texts`` — simple pruning front-ends (encoder.py:901-999),
* ``save_pretrained`` / ``from_pretrained`` — merged safetensors layout
  loadable by both this class and the inference ``OpenProvenceModel``
  (encoder.py:1040-1234),
* ``export_ranking_model`` — backbone-only export (encoder.py:1204-1234).

The device boundary is one forward of the port's module under
``torch.inference_mode()`` on length- and row-bucketed inputs (on a CUDA card
it runs the port's kernels, on the CPU their plain versions); the
document-span resolution chain (token_type_ids → separators → offsets) runs
on the host on numpy, carried over from the JAX package unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from collections.abc import Mapping, Sequence
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .configs import OpenProvenceConfig
from .data_structures import OpenProvenceOutput, RerankingOpenProvenceOutput
from .inference.batching import bucket_batch, bucket_length, length_buckets, pad_block_batch
from .inference.engine import (
    DEFAULT_BUCKET_STEP,
    check_attention_impl,
    forward_logits,
    place_module,
)
from .models.hf_wrappers import ARCHITECTURES, AUTO_MAP
from .utils import safetensors_io

logger = logging.getLogger(__name__)


def _ranking_scores_from_logits(logits: np.ndarray) -> np.ndarray:
    """Raw logits score convention: class-0 column for ≥2 labels, squeeze
    for 1 label (reference encoder.py:317-326) — NOTE: no sigmoid here;
    predict() returns raw scores like the reference."""
    if logits.ndim > 1:
        if logits.shape[-1] == 1:
            return logits[..., 0]
        return logits[..., 0]
    return logits


def _trim_span(
    start: int,
    end: int,
    offsets: list[tuple[int, int]],
    special_tokens_mask: list[int] | None,
) -> tuple[int, int] | None:
    """(reference encoder.py:575-599)"""

    def is_special(idx: int) -> bool:
        if special_tokens_mask is not None and special_tokens_mask[idx] == 1:
            return True
        s, e = offsets[idx]
        return s == 0 and e == 0

    length = len(offsets)
    start = max(0, min(start, length))
    end = max(0, min(end, length))
    if end <= start:
        return None
    while start < end and is_special(start):
        start += 1
    while end > start and is_special(end - 1):
        end -= 1
    if end <= start:
        return None
    return start, end


def resolve_document_span(
    token_ids: np.ndarray,
    offsets: list[tuple[int, int]],
    token_type_ids: np.ndarray | None,
    special_tokens_mask: list[int] | None,
    *,
    sep_token_id: int | None,
    eos_token_id: int | None,
) -> tuple[int, int] | None:
    """token_type_ids → separator positions → offsets fallback chain
    (reference encoder.py:600-680)."""
    if token_type_ids is not None:
        doc_positions = np.nonzero(np.asarray(token_type_ids) == 1)[0]
        if doc_positions.size > 0:
            trimmed = _trim_span(
                int(doc_positions[0]),
                int(doc_positions[-1]) + 1,
                offsets,
                special_tokens_mask,
            )
            if trimmed is not None:
                return trimmed

    separator_ids = sorted(
        {int(t) for t in (eos_token_id, sep_token_id) if t is not None}
    )
    if separator_ids:
        positions: list[int] = []
        for sep_id in separator_ids:
            positions.extend(int(i) for i in np.nonzero(token_ids == sep_id)[0])
        positions = sorted(set(positions))
        if len(positions) >= 2:
            trimmed = _trim_span(positions[0] + 1, positions[-1], offsets, special_tokens_mask)
            if trimmed is not None:
                return trimmed
        elif positions:
            trimmed = _trim_span(
                positions[0] + 1, len(offsets), offsets, special_tokens_mask
            )
            if trimmed is not None:
                return trimmed

    def is_special(idx: int) -> bool:
        if special_tokens_mask is not None and special_tokens_mask[idx] == 1:
            return True
        s, e = offsets[idx]
        return s == 0 and e == 0

    first_non_special = None
    for idx in range(len(offsets)):
        if not is_special(idx):
            first_non_special = idx
            break
    if first_non_special is None:
        return None
    last_non_special = first_non_special
    for idx in range(len(offsets) - 1, first_non_special - 1, -1):
        if not is_special(idx):
            last_non_special = idx + 1
            break
    if last_non_special <= first_non_special:
        return None
    return first_non_special, last_non_special


def merge_kept_ranges(ranges: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merge overlapping character ranges (reference encoder.py:495-506)."""
    if not ranges:
        return []
    ranges = sorted(ranges)
    merged = [ranges[0]]
    for start, end in ranges[1:]:
        if start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def evaluate_chunks(
    chunks: Sequence[Sequence[int]],
    token_probs: np.ndarray,
    token_offsets: list[tuple[int, int]],
    token_threshold: float,
    chunk_threshold: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Chunk score = mean keep-prob of overlapping tokens; predicted 1 when
    the above-threshold token ratio ≥ chunk_threshold
    (reference encoder.py:841-899)."""
    chunk_scores, chunk_predictions = [], []
    for chunk_start, chunk_end in chunks:
        overlapping: list[float] = []
        for j, (token_start, token_end) in enumerate(token_offsets):
            if token_start != 0 or token_end != 0:
                if token_start < chunk_end and token_end > chunk_start:
                    overlapping.append(float(token_probs[j]))
        if overlapping:
            chunk_score = float(np.mean(overlapping))
            above = sum(1 for p in overlapping if p > token_threshold)
            chunk_pred = 1 if above / len(overlapping) >= chunk_threshold else 0
        else:
            chunk_score, chunk_pred = 0.0, 0
        chunk_scores.append(chunk_score)
        chunk_predictions.append(chunk_pred)
    return np.asarray(chunk_scores), np.asarray(chunk_predictions)


class OpenProvenceEncoder:
    """config + module + tokenizer with predict/prune APIs, on one device."""

    def __init__(
        self,
        model_name_or_path: str | Path | None = None,
        *,
        config: OpenProvenceConfig | None = None,
        state_dict: Mapping[str, torch.Tensor] | None = None,
        tokenizer: Any = None,
        num_labels: int | None = None,
        max_length: int = 512,
        pruning_config: dict[str, Any] | None = None,
        seed: int = 42,
        attention_impl: str = "auto",
        bucket_step: int | None = None,
        device: torch.device | str | None = None,
        dtype: torch.dtype | None = None,
    ):
        """Either ``config`` and ``state_dict`` (reference checkpoint names),
        or ``model_name_or_path``, a directory ``train/encoder_init.py``
        reads (an OpenProvence checkpoint, a ModernBERT checkpoint or a
        config alone; random weights from ``seed``). ``device`` defaults to
        the first CUDA card and raises where there is none; ``dtype`` to bf16
        on a card and the weights' own dtype on the CPU, as in
        ``OpenProvenceModel``. ``attention_impl`` must be one of ``auto``,
        ``xla``, ``pallas`` and is then ignored: the port runs one attention
        kernel for every shape. ``bucket_step`` is the length-bucket step
        (None: ``DEFAULT_BUCKET_STEP``, 64)."""
        check_attention_impl(attention_impl)
        if config is None or state_dict is None:
            if model_name_or_path is None:
                raise ValueError("Provide model_name_or_path or (config, state_dict).")
            from .train.encoder_init import init_encoder

            classifier_dropout = (pruning_config or {}).get(
                "classifier_dropout", (pruning_config or {}).get("dropout", 0.1)
            )
            config, _module, state_dict = init_encoder(
                model_name_or_path,
                num_labels=num_labels,
                max_length=max_length,
                classifier_dropout=classifier_dropout,
                seed=seed,
            )
        self.config = config
        self.model_name_or_path = str(model_name_or_path) if model_name_or_path else None
        self.mode = config.mode
        self.max_length = int(config.max_length)
        self.num_labels = config.num_labels
        self.device, self.module = place_module(config, state_dict, device, dtype)
        if tokenizer is None and model_name_or_path is not None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(str(model_name_or_path))
        self.tokenizer = tokenizer
        self.attention_impl = attention_impl
        self.bucket_step = int(DEFAULT_BUCKET_STEP if bucket_step is None else bucket_step)

    # --- device forward -------------------------------------------------------

    def _encode_and_forward(self, batch_pairs: list[tuple[str, str]], **tokenizer_kwargs):
        encoded = self.tokenizer(
            [list(p) for p in batch_pairs],
            padding=True,
            truncation=True,
            max_length=self.max_length,
            **tokenizer_kwargs,
        )
        ids_list = encoded["input_ids"]
        buckets = length_buckets(self.max_length, self.bucket_step)
        padded = pad_block_batch(
            [{"input_ids": ids} for ids in ids_list],
            bucket_length(max(len(ids) for ids in ids_list), buckets),
            bucket_batch(len(ids_list), max(len(ids_list), 1)),
            getattr(self.tokenizer, "pad_token_id", 0) or 0,
        )
        # The tokenizer pads the batch to its longest pair; its own mask
        # keeps those pads out of attention, so that a pair's outputs do not
        # depend on the pairs batched with it.
        for row, mask in enumerate(encoded.get("attention_mask") or []):
            padded["attention_mask"][row, : len(mask)] = mask
        ranking, keep = (
            t.cpu().numpy()
            for t in forward_logits(
                self.module, self.device, padded["input_ids"], padded["attention_mask"]
            )
        )
        return encoded, ranking, keep, padded["input_ids"]

    # --- predict APIs -----------------------------------------------------------

    def predict(
        self,
        sentences: Any,
        batch_size: int = 32,
        show_progress_bar: bool = False,
        convert_to_numpy: bool = True,
        convert_to_tensor: bool = False,
        apply_pruning: bool = False,
        pruning_threshold: float = 0.5,
        return_documents: bool = False,
    ):
        """Ranking scores for (query, document) pairs; with
        ``apply_pruning`` delegates to predict_with_pruning
        (reference encoder.py:247-344)."""
        if apply_pruning:
            return self.predict_with_pruning(
                sentences=sentences,
                batch_size=batch_size,
                pruning_threshold=pruning_threshold,
                return_documents=return_documents,
                show_progress_bar=show_progress_bar,
            )
        single_input = isinstance(sentences[0], str)
        pairs = [tuple(sentences)] if single_input else [tuple(p) for p in sentences]
        all_scores: list[float] = []
        for start in range(0, len(pairs), batch_size):
            chunk = pairs[start : start + batch_size]
            _, ranking, _, _ = self._encode_and_forward(chunk)
            scores = _ranking_scores_from_logits(ranking)[: len(chunk)]
            all_scores.extend(float(s) for s in scores)
        if convert_to_numpy and not convert_to_tensor:
            return np.asarray(all_scores)
        return all_scores

    def predict_with_pruning(
        self,
        sentences: Any,
        batch_size: int = 32,
        pruning_threshold: float = 0.5,
        return_documents: bool = False,
        show_progress_bar: bool = False,
    ):
        """Token-level document pruning via offset mappings
        (reference encoder.py:345-528)."""
        single_input = isinstance(sentences[0], str)
        pairs = [tuple(sentences)] if single_input else [tuple(p) for p in sentences]
        all_outputs: list[RerankingOpenProvenceOutput] = []

        for start in range(0, len(pairs), batch_size):
            chunk = pairs[start : start + batch_size]
            encoded, ranking, keep, input_ids = self._encode_and_forward(
                chunk,
                return_offsets_mapping=True,
                return_token_type_ids=True,
                return_special_tokens_mask=True,
            )
            scores = _ranking_scores_from_logits(ranking)
            offset_all = encoded.get("offset_mapping")
            type_all = encoded.get("token_type_ids")
            special_all = encoded.get("special_tokens_mask")

            for i, (_, document) in enumerate(chunk):
                offsets = [tuple(map(int, o)) for o in offset_all[i]]
                type_row = np.asarray(type_all[i]) if type_all is not None else None
                special_row = (
                    [int(v) for v in special_all[i]] if special_all is not None else None
                )
                doc_span = resolve_document_span(
                    input_ids[i][: len(offsets)],
                    offsets,
                    type_row,
                    special_row,
                    sep_token_id=getattr(self.tokenizer, "sep_token_id", None),
                    eos_token_id=getattr(self.tokenizer, "eos_token_id", None),
                )
                if doc_span is None:
                    output = RerankingOpenProvenceOutput(
                        ranking_scores=np.array([float(scores[i])]),
                        pruning_masks=np.array([[]]),
                        sentences=[[]],
                        compression_ratio=0.0,
                        num_pruned_sentences=0,
                    )
                    if return_documents:
                        output.pruned_documents = [""]
                    all_outputs.append(output)
                    continue

                doc_start, doc_end = doc_span
                doc_keep_probs = keep[i, doc_start:doc_end]
                doc_offsets = offsets[doc_start:doc_end]
                keep_mask = doc_keep_probs > pruning_threshold
                num_kept = int(keep_mask.sum())
                num_total = doc_end - doc_start
                compression_ratio = (
                    1.0 - (num_kept / num_total) if num_total > 0 else 0.0
                )

                pruned_doc = ""
                if return_documents:
                    kept_ranges = [
                        (s, e)
                        for flag, (s, e) in zip(keep_mask, doc_offsets)
                        if flag and not (s == 0 and e == 0)
                    ]
                    merged = merge_kept_ranges(kept_ranges)
                    pruned_doc = " ".join(str(document)[s:e] for s, e in merged)

                output = RerankingOpenProvenceOutput(
                    ranking_scores=np.array([float(scores[i])]),
                    pruning_masks=np.array([keep_mask]),
                    sentences=[[]],
                    compression_ratio=compression_ratio,
                    num_pruned_sentences=num_total - num_kept,
                )
                if return_documents:
                    output.pruned_documents = [pruned_doc]
                all_outputs.append(output)

        return all_outputs[0] if single_input else all_outputs

    def predict_context(
        self,
        sentences: Any,
        chunk_positions: Any,
        batch_size: int = 32,
        token_threshold: float = 0.5,
        chunk_threshold: float = 0.5,
        show_progress_bar: bool = False,
    ):
        """Chunk-level evaluation against char spans
        (reference encoder.py:682-838)."""
        single_input = isinstance(sentences[0], str)
        pairs = [tuple(sentences)] if single_input else [tuple(p) for p in sentences]
        chunks_list = [chunk_positions] if single_input else list(chunk_positions)
        all_outputs: list[OpenProvenceOutput] = []

        for start in range(0, len(pairs), batch_size):
            chunk_pairs = pairs[start : start + batch_size]
            chunk_chunks = chunks_list[start : start + batch_size]
            encoded, ranking, keep, input_ids = self._encode_and_forward(
                chunk_pairs,
                return_offsets_mapping=True,
                return_token_type_ids=True,
                return_special_tokens_mask=True,
            )
            scores = _ranking_scores_from_logits(ranking)
            offset_all = encoded.get("offset_mapping")
            type_all = encoded.get("token_type_ids")
            special_all = encoded.get("special_tokens_mask")

            for i in range(len(chunk_pairs)):
                chunks = chunk_chunks[i]
                if chunks and isinstance(chunks[0], (list, tuple)) and chunks and isinstance(
                    chunks[0][0], (list, tuple)
                ):
                    chunks = chunks[0]
                offsets = [tuple(map(int, o)) for o in offset_all[i]]
                type_row = np.asarray(type_all[i]) if type_all is not None else None
                special_row = (
                    [int(v) for v in special_all[i]] if special_all is not None else None
                )
                doc_span = resolve_document_span(
                    input_ids[i][: len(offsets)],
                    offsets,
                    type_row,
                    special_row,
                    sep_token_id=getattr(self.tokenizer, "sep_token_id", None),
                    eos_token_id=getattr(self.tokenizer, "eos_token_id", None),
                )
                if doc_span is None:
                    all_outputs.append(
                        OpenProvenceOutput(
                            ranking_scores=float(scores[i]),
                            chunk_predictions=np.array([]),
                            chunk_scores=np.array([]),
                            token_scores=np.array([]),
                            chunk_positions=list(chunks),
                            compression_ratio=0.0,
                        )
                    )
                    continue
                doc_start, doc_end = doc_span
                doc_keep_probs = keep[i, doc_start:doc_end]
                doc_offsets = offsets[doc_start:doc_end]
                chunk_scores, chunk_predictions = evaluate_chunks(
                    chunks, doc_keep_probs, doc_offsets, token_threshold, chunk_threshold
                )
                num_total = len(chunks)
                compression_ratio = (
                    1.0 - (float(chunk_predictions.sum()) / num_total)
                    if num_total > 0
                    else 0.0
                )
                all_outputs.append(
                    OpenProvenceOutput(
                        ranking_scores=float(scores[i]),
                        chunk_predictions=chunk_predictions,
                        chunk_scores=chunk_scores,
                        token_scores=doc_keep_probs,
                        chunk_positions=list(chunks),
                        compression_ratio=compression_ratio,
                    )
                )
        return all_outputs[0] if single_input else all_outputs

    # --- pruning front-ends -------------------------------------------------

    def prune(
        self,
        query: str,
        document: str,
        threshold: float = 0.5,
        min_sentences: int = 1,
        return_sentences: bool = False,
    ):
        """(reference encoder.py:901-938)"""
        output = self.predict_with_pruning(
            (query, document), pruning_threshold=threshold, return_documents=True
        )
        if return_sentences:
            return {
                "pruned_document": output.pruned_documents[0],
                "sentences": [],
                "pruning_masks": [],
                "ranking_score": float(output.ranking_scores[0])
                if output.ranking_scores is not None
                else None,
                "compression_ratio": output.compression_ratio,
                "num_pruned_sentences": 0,
            }
        return output.pruned_documents[0]

    def prune_texts(
        self,
        queries: list[str],
        texts: list[str],
        threshold: float = 0.5,
        batch_size: int = 32,
        return_tokens: bool = False,
        show_progress_bar: bool = False,
    ) -> list[dict[str, Any]]:
        """(reference encoder.py:940-999)"""
        pairs = [(q, t) for q, t in zip(queries, texts)]
        outputs = self.predict_with_pruning(
            sentences=pairs,
            batch_size=batch_size,
            pruning_threshold=threshold,
            return_documents=True,
            show_progress_bar=show_progress_bar,
        )
        results = []
        for i, output in enumerate(outputs):
            result = {
                "pruned_text": output.pruned_documents[0]
                if output.pruned_documents
                else texts[i],
                "kept_ratio": 1.0 - (output.compression_ratio or 0.0),
            }
            if return_tokens:
                result["pruning_mask"] = output.pruning_masks
            results.append(result)
        return results

    # --- checkpoint IO ---------------------------------------------------------

    def _host_state_dict(self) -> dict[str, torch.Tensor]:
        """The module's weights on the host in fp32 (the JAX package exports
        fp32 too); a bf16 encoder's weights are exported as their bf16
        values."""
        return {k: v.detach().float().cpu() for k, v in self.module.state_dict().items()}

    def _save_tokenizer(self, directory: Path) -> None:
        save_fn = getattr(self.tokenizer, "save_pretrained", None)
        if callable(save_fn):
            try:
                save_fn(str(directory))
            except Exception:  # tokenizer-specific; the weights are written
                logger.warning("Failed to save tokenizer files", exc_info=True)

    def save_pretrained(self, save_directory: str | Path) -> Path:
        """Merged ranking_model.* + pruning_head.* safetensors + config +
        tokenizer (reference encoder.py:1040-1094). The config gains the
        reference's self-describing ``auto_map`` and ``architectures``
        (encoder.py:1079-1085), as the JAX package writes them."""
        save_directory = Path(save_directory)
        save_directory.mkdir(parents=True, exist_ok=True)
        extras = dict(self.config.extras)
        extras.setdefault("architectures", list(ARCHITECTURES))
        dataclasses.replace(self.config, auto_map=dict(AUTO_MAP), extras=extras).save(
            save_directory
        )
        safetensors_io.save_file(self._host_state_dict(), save_directory / "model.safetensors")
        self._save_tokenizer(save_directory)
        return save_directory

    @classmethod
    def from_pretrained(
        cls,
        pretrained_model_name_or_path: str | Path,
        *,
        tokenizer: Any = None,
        **kwargs: Any,
    ) -> "OpenProvenceEncoder":
        """Load a checkpoint directory in any layout ``utils/hf_convert.py``
        accepts; the tokenizer files are read with transformers'
        ``AutoTokenizer`` only when ``tokenizer`` is None. ``kwargs`` go to
        the constructor (``device``, ``dtype``, ``bucket_step``, ...)."""
        from .utils.hf_convert import load_checkpoint

        config, state_dict = load_checkpoint(pretrained_model_name_or_path)
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(str(pretrained_model_name_or_path))
        return cls(
            model_name_or_path=pretrained_model_name_or_path,
            config=config,
            state_dict=state_dict,
            tokenizer=tokenizer,
            **kwargs,
        )

    def export_ranking_model(self, save_directory: str | Path) -> Path:
        """Backbone+classifier only, without the pruning head — a plain
        sequence-classification checkpoint (reference encoder.py:1204-1234)."""
        save_directory = Path(save_directory)
        save_directory.mkdir(parents=True, exist_ok=True)
        ranking_only = {
            k[len("ranking_model."):]: v
            for k, v in self._host_state_dict().items()
            if k.startswith("ranking_model.")
        }
        safetensors_io.save_file(ranking_only, save_directory / "model.safetensors")
        backbone = dict(self.config.base_model_config or {})
        backbone["num_labels"] = self.config.num_labels
        (save_directory / "config.json").write_text(json.dumps(backbone, indent=2))
        self._save_tokenizer(save_directory)
        return save_directory
