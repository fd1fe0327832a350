"""The two-head OpenProvence cross-encoder module.

One encoder forward gives both (reference
modeling_open_provence_standalone.py:1666-1739):

1. ranking logits — the sequence-classification head on the pooled final
   hidden state (score = sigmoid of logits[..., 0]), and
2. pruning logits — the token-classification head on the *pre-final-norm*
   last hidden states ([B, S, 2]; keep-prob = softmax[..., 1]).

In ``train()`` mode the same forward is the JAX module's
``deterministic=False`` call: both classifier dropouts apply, their masks
drawn from the ``generator`` the caller passes (the ranking head's first).
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs import ModernBertBackboneConfig, OpenProvenceConfig, PruningHeadConfig
from ..parallel.mesh import Mesh
from .heads import PruningHead
from .modernbert import ModernBertForSequenceClassification


class OpenProvenceModule(nn.Module):
    """ranking_model (ModernBERT + classifier) + pruning_head. Under a
    ``mesh`` (``parallel.Mesh``) the module runs this rank's rows of a
    batch and, with ``tensor_parallel``, holds this rank's shards of the
    attention and MLP weights (``parallel.shard_state_dict``)."""

    def __init__(
        self,
        backbone_config: ModernBertBackboneConfig,
        pruning_config: PruningHeadConfig,
        mesh: Mesh | None = None,
        tensor_parallel: bool = False,
    ):
        super().__init__()
        self.ranking_model = ModernBertForSequenceClassification(
            backbone_config, mesh, tensor_parallel
        )
        self.pruning_head = PruningHead(pruning_config, mesh)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor | None = None,
        *,
        generator: torch.Generator | None = None,
    ) -> dict[str, torch.Tensor]:
        outputs = self.ranking_model(input_ids, attention_mask, generator=generator)
        return {
            "ranking_logits": outputs["logits"],
            "pruning_logits": self.pruning_head(outputs["last_hidden_pre_norm"], generator),
            "last_hidden_pre_norm": outputs["last_hidden_pre_norm"],
            "last_hidden_state": outputs["last_hidden_state"],
        }


def build_module(
    config: OpenProvenceConfig, mesh: Mesh | None = None, tensor_parallel: bool = False
) -> OpenProvenceModule:
    return OpenProvenceModule(config.backbone(), config.pruning_head(), mesh, tensor_parallel)


def ranking_score_from_logits(ranking_logits: torch.Tensor) -> torch.Tensor:
    """sigmoid(logits[..., 0]) in fp32 — the Provence scoring convention for
    1- and 2-label heads (reference encoder.py:317-326)."""
    logits = ranking_logits.float()
    if logits.dim() >= 2 and logits.shape[-1] >= 1:
        logits = logits[..., 0]
    return 1.0 / (1.0 + torch.exp(-logits))


def keep_probs_from_logits(pruning_logits: torch.Tensor) -> torch.Tensor:
    """softmax(logits)[..., 1] in fp32 — per-token keep probability
    (standalone:2918-2924)."""
    logits = pruning_logits.float()
    logits = logits - logits.amax(dim=-1, keepdim=True)
    exp = torch.exp(logits)
    return (exp / exp.sum(dim=-1, keepdim=True))[..., 1]
