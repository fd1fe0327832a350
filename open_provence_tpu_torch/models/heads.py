"""Pruning head: dropout + Linear(hidden, num_labels) token classifier.

Counterpart of the JAX package's ``models/heads.py::PruningHead``: the
classifier dropout applies in ``train()`` mode only, with its mask drawn
from the ``torch.Generator`` the caller passes in. The sentence-pooling
losses are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs import PruningHeadConfig


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout`` applies it (keep with
    probability 1 − rate, scale kept values by 1 / (1 − rate)), the mask
    drawn from ``generator`` on x's device. Rate 0 is the identity."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator (generator=...)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class PruningHead(nn.Module):
    def __init__(self, config: PruningHeadConfig):
        super().__init__()
        self.classifier_dropout = config.classifier_dropout
        self.classifier = nn.Linear(config.hidden_size, config.num_labels)

    def forward(
        self, hidden_states: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        if self.training:
            hidden_states = dropout(hidden_states, self.classifier_dropout, generator)
        return self.classifier(hidden_states)
