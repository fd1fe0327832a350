"""Joint ranking + pruning loss, in fp32.

Counterpart of the JAX package's ``train/losses.py``, with the reference
``OpenProvenceLoss`` semantics (open_provence/losses.py):

* ranking — MSE on the raw class-0 logits against teacher scores, weight
  0.05; BCE-with-logits for classification mode;
* pruning — token cross-entropy with ignore index −100, weight 1.0;
* a batch whose labels are all ignored gives a loss of 0; a non-finite
  pruning loss becomes 0.001.

Pure functions of (model outputs, batch), with the components returned for
logging. Under a data-parallel ``mesh`` each rank holds some rows of the
global batch, and every normalizer and special case is that of the global
batch, as in the JAX step: a rank divides its local sum by the count summed
over the data group, so its loss is its share of the global loss, the
shares sum to it and the data group sums its gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.mesh import DATA_AXIS, Mesh

IGNORE_INDEX = -100


def ranking_loss(
    ranking_logits: torch.Tensor,  # [P, num_labels] or [P]
    targets: torch.Tensor,  # [P] float
    pair_mask: torch.Tensor,  # [P] float, 1 = real pair
    *,
    is_regression: bool = True,
    use_raw_logits: bool = True,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    scores = ranking_logits[..., 0] if ranking_logits.dim() > 1 else ranking_logits
    scores = scores.float()
    targets = targets.float()
    pair_mask = pair_mask.float()
    denom = _global_sum(pair_mask.sum(), mesh).clamp_min(1.0)
    if is_regression and use_raw_logits:
        per_pair = (scores - targets) ** 2
    elif is_regression:
        per_pair = (torch.sigmoid(scores) - targets) ** 2
    else:  # BCE with logits
        per_pair = scores.clamp_min(0.0) - scores * targets + torch.log1p(torch.exp(-scores.abs()))
    return (per_pair * pair_mask).sum() / denom


def pruning_loss(
    pruning_logits: torch.Tensor,  # [P, L, 2]
    pruning_labels: torch.Tensor,  # [P, L] int, -100 = ignore
    pair_mask: torch.Tensor,  # [P]
    mesh: Mesh | None = None,
) -> torch.Tensor:
    valid = (pruning_labels != IGNORE_INDEX) & (pair_mask[:, None] > 0)
    labels = torch.where(valid, pruning_labels, 0).long()
    log_probs = F.log_softmax(pruning_logits.float(), dim=-1)
    picked = log_probs.gather(-1, labels[..., None])[..., 0]
    num_valid = _global_sum(valid.sum(), mesh)
    loss = -torch.where(valid, picked, 0.0).sum() / num_valid.clamp_min(1)
    loss = torch.where(num_valid == 0, torch.zeros_like(loss), loss)
    # Decided on the global loss: every rank's share, or 0.001 in all.
    shares = 1 if mesh is None else mesh.data
    finite = torch.isfinite(_global_sum(loss.detach(), mesh))
    return torch.where(finite, loss, torch.full_like(loss, 0.001 / shares))


def _global_sum(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``t`` summed over the data group (a detached copy; ``t`` itself
    without a mesh)."""
    if mesh is None or mesh.data == 1:
        return t
    return mesh.all_reduce(t.detach().clone(), DATA_AXIS)


def joint_loss(
    outputs: dict[str, torch.Tensor],
    batch: dict[str, torch.Tensor],
    *,
    ranking_weight: float = 0.05,
    pruning_weight: float = 1.0,
    is_regression: bool = True,
    use_raw_logits: bool = True,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(total, components); under a ``mesh`` this rank's shares of them."""
    r_loss = ranking_loss(
        outputs["ranking_logits"],
        batch["ranking_targets"],
        batch["pair_mask"],
        is_regression=is_regression,
        use_raw_logits=use_raw_logits,
        mesh=mesh,
    )
    p_loss = pruning_loss(
        outputs["pruning_logits"], batch["pruning_labels"], batch["pair_mask"], mesh
    )
    total = ranking_weight * r_loss + pruning_weight * p_loss
    return total, {"ranking_loss": r_loss, "pruning_loss": p_loss}


class OpenProvenceLoss:
    """Stateful wrapper over ``joint_loss`` with the reference class's API:
    call with (outputs, batch), read ``last_loss_components`` for logging.
    The model forward runs outside; pass its output dict here."""

    def __init__(
        self,
        model=None,
        ranking_loss_fn=None,
        pruning_loss_fn=None,
        ranking_weight: float = 0.05,
        pruning_weight: float = 1.0,
        is_regression: bool = True,
        use_raw_logits: bool = True,
    ):
        del model, ranking_loss_fn, pruning_loss_fn  # the functions above are built in
        self.ranking_weight = ranking_weight
        self.pruning_weight = pruning_weight
        self.is_regression = is_regression
        self.use_raw_logits = use_raw_logits
        self.last_loss_components: dict[str, torch.Tensor] = {}

    def __call__(self, outputs, batch):
        total, components = joint_loss(
            outputs,
            batch,
            ranking_weight=self.ranking_weight,
            pruning_weight=self.pruning_weight,
            is_regression=self.is_regression,
            use_raw_logits=self.use_raw_logits,
        )
        self.last_loss_components = components
        return total
