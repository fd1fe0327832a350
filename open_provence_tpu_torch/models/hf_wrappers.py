"""AutoModel-style wrapper classes over the two-head cross-encoder.

The port's counterpart of the JAX package's ``models/hf_wrappers.py``: the
reference exposes ``OpenProvenceForSequenceClassification`` and
``OpenProvenceForTokenClassification`` through HF ``auto_map``
(reference encoder.py:1079-1085, modeling_open_provence_standalone.py:
3814-3903), and the JAX package keeps their *class surface* (names, call
semantics, loss paths) as plain Python classes, reachable from the
installed package and from a standalone checkpoint bundle's shim
(utils/modeling_export.py). So does the port: these are plain classes, not
``transformers.PreTrainedModel`` subclasses, and the port imports no
transformers here.

The module is placed as ``OpenProvenceModel`` places it
(``inference/engine.py::place_module``): the first CUDA card in bf16 unless
``device`` / ``dtype`` say otherwise, the weights' own dtype on the CPU. The
forward runs under ``torch.inference_mode`` (the wrappers expose no
gradient; training goes through the trainer) at whatever (B, S) the caller
passes, with no bucketing.

Losses, in fp32:
  * sequence classification (standalone:1707-1716): ``num_labels == 1`` →
    mean BCE-with-logits on ``ranking_logits.reshape(-1)``; otherwise mean
    CE over ``num_labels`` classes (ignore_index −100).
  * token classification (standalone:3852-3881): CE over pruning logits
    restricted to ``attention_mask == 1`` positions; 0.0 when no position
    is active; NaN when every active label is −100 (torch
    ``CrossEntropyLoss``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import OpenProvenceConfig
from ..inference.engine import check_attention_impl, place_module


def _tensor(values: Any) -> torch.Tensor:
    """A tensor or array-like (numpy, lists) as a tensor, where it lies."""
    return values if torch.is_tensor(values) else torch.as_tensor(np.asarray(values))


@dataclass
class SequenceClassifierOutput:
    """Mirror of transformers' output: ``logits`` are the ranking logits;
    the pruning logits ride along as an extra field (standalone:1725-1731)."""

    loss: torch.Tensor | None
    logits: torch.Tensor
    ranking_logits: torch.Tensor
    pruning_logits: torch.Tensor
    hidden_states: torch.Tensor | None = None


@dataclass
class TokenClassifierOutput:
    """``logits`` are the pruning logits; ranking logits ride along
    (standalone:3893-3902)."""

    loss: torch.Tensor | None
    logits: torch.Tensor
    ranking_logits: torch.Tensor
    hidden_states: torch.Tensor | None = None


class OpenProvenceForSequenceClassification:
    """Ranking-logits view of the checkpoint (AutoModel surface parity)."""

    def __init__(
        self,
        config: OpenProvenceConfig,
        state_dict: Mapping[str, torch.Tensor],
        *,
        dtype: torch.dtype | None = None,
        attention_impl: str = "auto",
        device: torch.device | str | None = None,
    ):
        """``state_dict`` has the reference checkpoint names; ``device``
        defaults to the first CUDA card and ``dtype`` to bf16 there and to
        the weights' own dtype on the CPU. ``attention_impl`` must name one
        of the JAX engine's attention routes and is then ignored."""
        check_attention_impl(attention_impl)
        self.config = config
        self.num_labels = int(config.num_labels)
        self.attention_impl = attention_impl
        self.device, self.module = place_module(config, state_dict, device, dtype)

    @classmethod
    def from_pretrained(cls, path: str | Path, **kwargs: Any):
        """Load a checkpoint directory (config.json + model.safetensors in
        any layout ``utils/hf_convert.py`` accepts); ``kwargs`` go to the
        constructor."""
        from ..utils.hf_convert import load_checkpoint

        config, state_dict = load_checkpoint(path)
        return cls(config, state_dict, **kwargs)

    def _forward(
        self, input_ids: Any, attention_mask: Any
    ) -> tuple[torch.Tensor, torch.Tensor]:
        ids = _tensor(input_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        if attention_mask is None:
            mask = torch.ones(ids.shape, dtype=torch.int32)
        else:
            mask = _tensor(attention_mask).reshape(ids.shape)
        out = self.module(ids.to(self.device).long(), mask.to(self.device, torch.int32))
        return out["ranking_logits"], out["pruning_logits"]

    def _loss(self, ranking_logits: torch.Tensor, labels: Any) -> torch.Tensor:
        labels = _tensor(labels).to(ranking_logits.device)
        if self.num_labels == 1:
            return F.binary_cross_entropy_with_logits(
                ranking_logits.float().reshape(-1), labels.float().reshape(-1)
            )
        return F.cross_entropy(
            ranking_logits.float().reshape(-1, self.num_labels),
            labels.long().reshape(-1),
            ignore_index=-100,
        )

    @torch.inference_mode()
    def forward(
        self,
        input_ids: Any = None,
        attention_mask: Any = None,
        labels: Any = None,
        return_dict: bool | None = None,
        **kwargs: Any,
    ):
        if input_ids is None:
            raise ValueError("input_ids must be provided")
        ranking_logits, pruning_logits = self._forward(input_ids, attention_mask)
        loss = self._loss(ranking_logits, labels) if labels is not None else None
        if return_dict is False:
            out = (ranking_logits, pruning_logits)
            return (loss,) + out if loss is not None else out
        return SequenceClassifierOutput(
            loss=loss,
            logits=ranking_logits,
            ranking_logits=ranking_logits,
            pruning_logits=pruning_logits,
        )

    __call__ = forward


class OpenProvenceForTokenClassification(OpenProvenceForSequenceClassification):
    """Pruning-logits view with the masked token-CE loss
    (standalone:3834-3903)."""

    def __init__(self, config: OpenProvenceConfig, state_dict: Mapping[str, torch.Tensor], **kw):
        super().__init__(config, state_dict, **kw)
        self.num_labels = int(config.num_pruning_labels)

    @torch.inference_mode()
    def forward(
        self,
        input_ids: Any = None,
        attention_mask: Any = None,
        labels: Any = None,
        return_dict: bool | None = None,
        **kwargs: Any,
    ):
        if input_ids is None:
            raise ValueError("input_ids must be provided")
        ranking_logits, pruning_logits = self._forward(input_ids, attention_mask)
        loss = None
        if labels is not None:
            labels = _tensor(labels).to(pruning_logits.device).long()
            labels = labels.reshape(pruning_logits.shape[:-1])
            if attention_mask is not None:
                active = _tensor(attention_mask).to(labels.device).reshape(labels.shape) == 1
                labels = torch.where(active, labels, -100)
                n_active = int(active.sum())
            else:
                n_active = labels.numel()
            if n_active > 0:
                loss = F.cross_entropy(
                    pruning_logits.float().reshape(-1, self.num_labels),
                    labels.reshape(-1),
                    ignore_index=-100,
                )
            else:
                loss = torch.zeros((), dtype=torch.float32, device=pruning_logits.device)
        if return_dict is False:
            out = (pruning_logits,)
            return (loss,) + out if loss is not None else out
        return TokenClassifierOutput(
            loss=loss,
            logits=pruning_logits,
            ranking_logits=ranking_logits,
        )

    __call__ = forward


# Exported-config metadata: the reference writes these so checkpoints are
# self-describing (encoder.py:1079-1085). The module path names the bundle
# shim written next to exported weights (utils/modeling_export.py).
ARCHITECTURES = ["OpenProvenceForSequenceClassification"]
AUTO_MAP = {
    "AutoConfig": "modeling_open_provence_tpu.OpenProvenceConfig",
    "AutoModel": "modeling_open_provence_tpu.OpenProvenceForSequenceClassification",
    "AutoModelForSequenceClassification": (
        "modeling_open_provence_tpu.OpenProvenceForSequenceClassification"
    ),
    "AutoModelForTokenClassification": (
        "modeling_open_provence_tpu.OpenProvenceForTokenClassification"
    ),
}
