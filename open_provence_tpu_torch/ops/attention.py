"""Plain attention, the numerics reference for the attention kernels, and
the dispatch over separate q, k, v.

``attention_plain`` is einsum attention with an additive mask and fp32
softmax, as the JAX package's ``ops/attention.py::xla_attention`` (which
matches HF eager attention, the path the published checkpoints were
evaluated with). The probabilities are cast to the q dtype before the
product with v.

``multi_head_attention`` is the JAX package's function of that name without
its ``impl`` argument, for callers that hold q, k, v apart: it is
``flash_attention`` (kernels 9 and 16 on CUDA tensors, their plain versions
on CPU tensors). On the card a head dim the kernels have no instance for
raises; on the CPU any head dim is computed.
"""

from __future__ import annotations

import torch

NEG_BIG = float(torch.finfo(torch.float32).min)


def attention_bias(
    padding_mask: torch.Tensor | None,
    seq_len: int,
    window: int | None,
    device: torch.device | str = "cpu",
) -> torch.Tensor | None:
    """Additive fp32 bias, [B, 1, S, S] (or [1, 1, S, S] for a window
    alone), or None: key padding and |i − j| > window each add
    −finfo(f32).max. padding_mask: [B, S], 1 for valid tokens."""
    bias = None
    if padding_mask is not None:
        key_ok = padding_mask[:, None, None, :].to(device=device, dtype=torch.bool)
        bias = torch.where(key_ok, 0.0, NEG_BIG).to(torch.float32)
    if window is not None:
        pos = torch.arange(seq_len, device=device)
        ok = (pos[:, None] - pos[None, :]).abs() <= window
        band = torch.where(ok, 0.0, NEG_BIG).to(torch.float32)[None, None]
        bias = band if bias is None else bias + band
    return bias


def attention_scores(
    q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor | None
) -> torch.Tensor:
    """Scaled, biased scores [B, H, S, S] in at least fp32."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * q.shape[-1] ** -0.5
    if bias is not None:
        scores = scores + bias.to(acc)
    return scores


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor | None
) -> torch.Tensor:
    """q/k/v: [B, H, S, D] → [B, H, S, D]; scores and softmax in fp32."""
    probs = torch.softmax(attention_scores(q, k, bias), dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Attention on q, k, v [B, H, S, D] → [B, H, S, D]. With
    ``rope=(cos, sin)`` q and k arrive unrotated. Differentiable in q, k, v."""
    from .flash_attention import flash_attention

    return flash_attention(q, k, v, padding_mask=padding_mask, window=window, rope=rope)
