"""Bias-free LayerNorm: kernel 1 (``kernels/csrc/layer_norm.cu``) and its
plain version.

ModernBERT's norms are all bias-free (norm_bias=false). Statistics are fp32
E[x] and E[x²] with var = max(E[x²] − E[x]², 0), as the JAX package's
``ops/layer_norm.py`` takes them; ``torch.nn.functional.layer_norm`` takes
them another way, so the plain version spells the formula out.
"""

from __future__ import annotations

import torch

from .. import kernels


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim; stats in at least fp32, output in x's dtype."""
    stat = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(stat)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.to(stat)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if not kernels.on_cuda(x):
        return layer_norm_plain(x, scale, eps)
    hidden = x.shape[-1]
    if scale.shape != (hidden,) or scale.dtype != x.dtype or scale.device != x.device:
        raise ValueError(f"scale must be [{hidden}] {x.dtype} on {x.device}")
    x2d = x.reshape(-1, hidden).contiguous()
    out = torch.empty_like(x2d)
    with torch.cuda.device(x.device):
        code = kernels.library().opt_layer_norm(
            kernels.ptr(x2d), kernels.ptr(scale.contiguous()), kernels.ptr(out),
            x2d.shape[0], hidden, float(eps), kernels.dtype_code(x), kernels.stream(x),
        )
    kernels.check(code, "layer_norm")
    return out.reshape(x.shape)
