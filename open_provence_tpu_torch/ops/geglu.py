"""LayerNorm folded into its GEMM: kernels 2 and 4
(``kernels/csrc/ln_gemm.cu``) and their plain versions.

* ``ln_matmul``: LN(x)·scale @ Wᵀ — attn_norm → Wqkv in layers 1 and up
  (JAX: ``ops/geglu.py::fused_ln_matmul``).
* ``ln_geglu``: act(LN(x)·scale @ Wi[:I]ᵀ) · (LN(x)·scale @ Wi[I:]ᵀ) —
  mlp_norm → Wi → act·gate (JAX: ``ops/geglu.py::fused_ln_geglu``).

Weights are in torch's ``[out, in]`` layout. Numerics follow the JAX
kernels: the normalized x is rounded to the storage dtype before the
product, products accumulate in fp32, and GeGLU rounds each half to the
storage dtype, applies the activation in fp32, rounds again and takes the
gate product in the storage dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .layer_norm import layer_norm_plain

# HF activation name -> (kernel code, plain fp32 function).
ACTIVATIONS = {
    "gelu": (0, lambda x: F.gelu(x, approximate="none")),
    "gelu_new": (1, lambda x: F.gelu(x, approximate="tanh")),
    "gelu_pytorch_tanh": (1, lambda x: F.gelu(x, approximate="tanh")),
    "relu": (2, F.relu),
    "silu": (3, F.silu),
    "swish": (3, F.silu),
}


def lookup_activation(name: str):
    """(kernel code, plain function) of an HF activation name."""
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unsupported activation: {name!r}") from None


def ln_matmul_plain(
    x2d: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LN(x2d)·scale [M, K] @ w[N, K]ᵀ → [M, N]."""
    return F.linear(layer_norm_plain(x2d, scale, eps), w)


def ln_geglu_plain(
    x2d: torch.Tensor, scale: torch.Tensor, wi: torch.Tensor, activation: str,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LN(x2d)·scale [M, K] @ wi[2I, K]ᵀ → act(first half) · second half, [M, I]."""
    act = lookup_activation(activation)[1]
    inp, gate = F.linear(layer_norm_plain(x2d, scale, eps), wi).chunk(2, dim=-1)
    return act(inp.float()).to(x2d.dtype) * gate


# The bf16 kernel keeps a CTA's normalized [64, K + 8] slab beside a 3-stage
# [128, 72] weight ring in shared memory, all bf16; the card gives a CTA at
# most 227 KB of it, less the 512 bytes of row statistics, so K <= 1368.
BF16_MAX_K = 1368


def _check_operands(x2d, scale, w, rows_of_w_per_out):
    m, k = x2d.shape
    if scale.shape != (k,) or w.dim() != 2 or w.shape[1] != k:
        raise ValueError(f"shapes: x {tuple(x2d.shape)}, scale {tuple(scale.shape)}, w {tuple(w.shape)}")
    if w.shape[0] % rows_of_w_per_out:
        raise ValueError(f"w rows {w.shape[0]} not divisible by {rows_of_w_per_out}")
    for t in (scale, w):
        if t.dtype != x2d.dtype or t.device != x2d.device:
            raise ValueError(f"operands must share x's dtype {x2d.dtype} and device {x2d.device}")
    if x2d.dtype == torch.bfloat16:
        if k % 8 or k > BF16_MAX_K:
            raise ValueError(f"the bf16 kernel takes K % 8 == 0 and K <= {BF16_MAX_K}, not {k}")
        kernels.require_16_byte_rows(x2d, scale, w)


def ln_matmul(
    x2d: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LN(x2d)·scale @ wᵀ: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not kernels.on_cuda(x2d):
        return ln_matmul_plain(x2d, scale, w, eps)
    x2d, scale, w = x2d.contiguous(), scale.contiguous(), w.contiguous()
    _check_operands(x2d, scale, w, 1)
    m, k = x2d.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_ln_matmul(
            kernels.ptr(x2d), kernels.ptr(scale), kernels.ptr(w),
            kernels.ptr(out), m, k, n, float(eps), kernels.dtype_code(x2d),
            kernels.stream(x2d),
        )
    kernels.check(code, "ln_matmul")
    return out


def ln_geglu(
    x2d: torch.Tensor, scale: torch.Tensor, wi: torch.Tensor, activation: str,
    eps: float = 1e-5,
) -> torch.Tensor:
    """act(LN(x2d)·scale @ wi[:I]ᵀ) · (LN(x2d)·scale @ wi[I:]ᵀ): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if not kernels.on_cuda(x2d):
        return ln_geglu_plain(x2d, scale, wi, activation, eps)
    act_code = lookup_activation(activation)[0]
    x2d, scale, wi = x2d.contiguous(), scale.contiguous(), wi.contiguous()
    _check_operands(x2d, scale, wi, 2)
    m, k = x2d.shape
    intermediate = wi.shape[0] // 2
    out = torch.empty((m, intermediate), dtype=x2d.dtype, device=x2d.device)
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_ln_geglu(
            kernels.ptr(x2d), kernels.ptr(scale), kernels.ptr(wi),
            kernels.ptr(out), m, k, intermediate, float(eps), act_code,
            kernels.dtype_code(x2d), kernels.stream(x2d),
        )
    kernels.check(code, "ln_geglu")
    return out
