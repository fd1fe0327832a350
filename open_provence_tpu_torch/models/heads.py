"""Pruning head: a Linear(hidden, num_labels) token classifier.

Counterpart of the JAX package's ``models/heads.py::PruningHead`` for
inference (dropout is not applied). The sentence-pooling losses belong to
training and come with it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs import PruningHeadConfig


class PruningHead(nn.Module):
    def __init__(self, config: PruningHeadConfig):
        super().__init__()
        self.classifier = nn.Linear(config.hidden_size, config.num_labels)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.classifier(hidden_states)
