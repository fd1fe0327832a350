"""Rotary position embeddings (rotate-half RoPE with a per-layer theta).

cos/sin tables are computed in float32 with numpy, as in the JAX package's
``ops/rotary.py``, and cast to the activation dtype where they are applied;
the packed attention kernel takes them cast to the qkv dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _rope_tables_np(seq_len: int, head_dim: int, theta: float) -> tuple[np.ndarray, np.ndarray]:
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    positions = np.arange(seq_len, dtype=np.float32)
    freqs = np.outer(positions, inv_freq)  # [S, D/2]
    emb = np.concatenate([freqs, freqs], axis=-1)  # [S, D]
    return np.cos(emb), np.sin(emb)


@functools.lru_cache(maxsize=64)
def rope_tables(
    seq_len: int,
    head_dim: int,
    theta: float,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [seq_len, head_dim], fp32 math cast to ``dtype`` on
    ``device``. Cached: one upload per (shape, theta, dtype, device), not
    one per layer call. Made outside inference mode even when first asked
    for inside it (serving), so a later training step may save them for
    its backward."""
    cos, sin = _rope_tables_np(int(seq_len), int(head_dim), float(theta))
    with torch.inference_mode(False):
        return (
            torch.from_numpy(cos).to(device=device, dtype=dtype),
            torch.from_numpy(sin).to(device=device, dtype=dtype),
        )


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k: [..., S, D]; cos, sin: [S, D], cast to q's dtype."""
    cos = cos.to(q.dtype)
    sin = sin.to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def rotary_adjoint(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``apply_rotary`` for one of q/k: g·cos −
    rotate_half(g·sin), each product in g's dtype (the JAX package's
    ``_rope_adjoint_mx``). g: [..., S, D]; cos, sin: [S, D]."""
    cos = cos.to(g.dtype)
    sin = sin.to(g.dtype)
    return g * cos - rotate_half(g * sin)
