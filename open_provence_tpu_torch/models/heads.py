"""Pruning head: dropout + Linear(hidden, num_labels) token classifier, plus
boundary-based sentence pooling.

Counterpart of the JAX package's ``models/heads.py``: the classifier dropout
applies in ``train()`` mode only, with its mask drawn from the
``torch.Generator`` the caller passes in. The default inference path ignores
sentence boundaries (the engine aggregates sentences); the boundary-pooled
sentence loss and prediction variants (reference open_provence_head.py
:147-281) are plain tensor functions that reduce over membership masks
instead of the reference's per-sentence loops.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs import PruningHeadConfig
from ..parallel.mesh import Mesh


def dropout(
    x: torch.Tensor,
    rate: float,
    generator: torch.Generator | None,
    mesh: Mesh | None = None,
    split_columns: bool = False,
) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout`` applies it (keep with
    probability 1 − rate, scale kept values by 1 / (1 − rate)), the mask
    drawn from ``generator`` on x's device. Rate 0 is the identity.

    Under a ``mesh`` x holds this rank's rows of the activation (its data
    coordinate's share of dim 0) and, with ``split_columns``, its model
    coordinate's share of the last dim: the mask is drawn for the whole
    activation and this rank's part taken, so the mesh changes no random
    number and every rank's generator stays in step."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator (generator=...)")
    rows, cols = 1, 1
    if mesh is not None:
        rows, cols = mesh.data, (mesh.model if split_columns else 1)
    shape = (x.shape[0] * rows, *x.shape[1:-1], x.shape[-1] * cols)
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    if rows > 1:
        keep = keep.narrow(0, mesh.data_rank * x.shape[0], x.shape[0])
    if cols > 1:
        keep = keep.narrow(-1, mesh.model_rank * x.shape[-1], x.shape[-1])
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class PruningHead(nn.Module):
    def __init__(self, config: PruningHeadConfig, mesh: Mesh | None = None):
        super().__init__()
        self.classifier_dropout = config.classifier_dropout
        self.mesh = mesh
        self.classifier = nn.Linear(config.hidden_size, config.num_labels)

    def forward(
        self, hidden_states: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        if self.training:
            hidden_states = dropout(hidden_states, self.classifier_dropout, generator, self.mesh)
        return self.classifier(hidden_states)


def _boundary_masks(
    boundaries: torch.Tensor, seq_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """boundaries [B, M, 2] (start, end; -1 padding) → token membership mask
    [B, M, S] and validity [B, M]."""
    starts, ends = boundaries[..., 0], boundaries[..., 1]
    valid = (starts != -1) & (ends != -1) & (ends > starts)
    positions = torch.arange(seq_len, device=boundaries.device)[None, None, :]
    member = (positions >= starts[..., None]) & (positions < ends[..., None])
    return member & valid[..., None], valid


def _gather_rows(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values [B, S, C] at positions index [B, M] → [B, M, C]."""
    return torch.gather(values, 1, index[..., None].expand(-1, -1, values.shape[-1]))


def pool_sentence_values(
    values: torch.Tensor,  # [B, S, C] per-token values (logits or probs)
    boundaries: torch.Tensor,  # [B, M, 2]
    pooling: str = "mean",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pool token values per sentence boundary → ([B, M, C] in values'
    dtype, valid [B, M]). Pooling ∈ {mean, max, first, last} (reference
    open_provence_head.py:186-199); sums run in fp32. Invalid boundaries
    yield zeros."""
    seq_len = values.shape[1]
    member, valid = _boundary_masks(boundaries, seq_len)  # [B,M,S], [B,M]
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    if pooling == "max":
        neg = torch.finfo(values.dtype).min
        masked = torch.where(member[..., None], values[:, None, :, :], neg)
        pooled = torch.where(valid[..., None], masked.amax(dim=2), zero)
    elif pooling == "first":
        first_idx = torch.argmax(member.to(torch.int8), dim=-1)  # first True; 0 when none
        pooled = torch.where(valid[..., None], _gather_rows(values, first_idx), zero)
    elif pooling == "last":
        positions = torch.arange(seq_len, device=values.device)[None, None, :]
        last_idx = torch.where(member, positions, -1).amax(dim=-1).clamp_min(0)
        pooled = torch.where(valid[..., None], _gather_rows(values, last_idx), zero)
    else:  # mean (default)
        member_f = member.to(torch.float32)
        sums = torch.einsum("bms,bsc->bmc", member_f, values.to(torch.float32))
        counts = member_f.sum(dim=-1, keepdim=True)
        pooled = (sums / counts.clamp_min(1.0)).to(values.dtype)
    return pooled, valid


def sentence_loss(
    logits: torch.Tensor,  # [B, S, C] token logits
    labels: torch.Tensor,  # [B, M] sentence labels
    boundaries: torch.Tensor,  # [B, M, 2]
    pooling: str = "mean",
) -> torch.Tensor:
    """CE over boundary-pooled sentence logits (reference
    open_provence_head.py:147-215), in fp32; invalid boundaries are
    excluded, and a batch with none gives 0."""
    pooled, valid = pool_sentence_values(logits.to(torch.float32), boundaries, pooling)
    log_probs = torch.log_softmax(pooled, dim=-1)
    safe_labels = torch.where(valid, labels, 0).long()
    picked = torch.gather(log_probs, -1, safe_labels[..., None])[..., 0]
    num_valid = valid.sum()
    loss = -torch.where(valid, picked, 0.0).sum() / num_valid.clamp_min(1)
    return torch.where(num_valid == 0, torch.zeros_like(loss), loss)


def predict_sentences(
    logits: torch.Tensor,  # [B, S, C] token logits
    boundaries: torch.Tensor,  # [B, M, 2]
    pooling: str = "mean",
) -> torch.Tensor:
    """Sentence probabilities by pooling fp32 token softmax probs
    (reference open_provence_head.py:217-281); invalid boundaries →
    uniform 1/C."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    pooled, valid = pool_sentence_values(probs, boundaries, pooling)
    return torch.where(valid[..., None], pooled, 1.0 / pooled.shape[-1])
