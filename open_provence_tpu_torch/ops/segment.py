"""Device-side fragment mean pooling.

Fragments are contiguous token ranges, so per-fragment sums are differences
of one [B, S] cumulative sum read by two [B, F] gathers; only the [B, F]
means cross to the host instead of [B, S] token probabilities. Plain torch
ops, as plain XLA ops computed it in the JAX package (``ops/segment.py``).
"""

from __future__ import annotations

import torch


def fragment_mean_pool_ranges(
    probs: torch.Tensor,   # [B, S] fp32 keep probabilities
    starts: torch.Tensor,  # [B, F] fragment start (inclusive)
    ends: torch.Tensor,    # [B, F] fragment end (exclusive); == start → empty
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (means [B, F], counts [B, F]). Empty slots get mean 0."""
    starts = starts.long()
    ends = ends.long()
    csum = torch.cumsum(probs.float(), dim=1)
    upper = torch.gather(csum, 1, (ends - 1).clamp_min(0))
    lower = torch.where(starts > 0, torch.gather(csum, 1, (starts - 1).clamp_min(0)), 0.0)
    counts = (ends - starts).clamp_min(0).float()
    nonempty = counts > 0
    sums = torch.where(nonempty, upper - lower, 0.0)
    means = torch.where(nonempty, sums / counts.clamp_min(1.0), 0.0)
    return means, counts
