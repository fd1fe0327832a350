"""Attention on the packed Wqkv output: kernel 3
(``kernels/csrc/flash_attention.cu``) and its plain version.

``flash_attention_packed`` takes the fused projection [B, S, 3·H·D] in HF
lane order (qkv, head, dim) and returns [B, S, H·D] ready for Wo, as the
JAX package's ``ops/flash_attention.py::flash_attention_packed`` does. The
kernel reads q/k/v through strides of that one buffer and applies rotary
in-kernel; global layers pass ``window=None``, local layers their
half-window (keys with |i − j| ≤ window are seen).
"""

from __future__ import annotations

import torch

from .. import kernels
from .attention import attention_bias, attention_plain
from .rotary import apply_rotary

KERNEL_HEAD_DIM = 64  # ModernBERT's, base and large


def _head_dim(qkv: torch.Tensor, num_heads: int) -> int:
    three_hd = qkv.shape[-1]
    if qkv.dim() != 3 or three_hd % (3 * num_heads):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not [B, S, 3·{num_heads}·D]")
    return three_hd // (3 * num_heads)


def attention_packed_plain(
    qkv: torch.Tensor,
    *,
    num_heads: int,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Unpack q/k/v, rotate, fp32-softmax attention, repack to [B, S, H·D]."""
    batch, seq_len, _ = qkv.shape
    head_dim = _head_dim(qkv, num_heads)
    q, k, v = qkv.reshape(batch, seq_len, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    if rope is not None:
        q, k = apply_rotary(q, k, rope[0], rope[1])
    bias = attention_bias(padding_mask, seq_len, window, device=qkv.device)
    out = attention_plain(q, k, v, bias)  # [B, H, S, D]
    return out.transpose(1, 2).reshape(batch, seq_len, num_heads * head_dim)


def flash_attention_packed(
    qkv: torch.Tensor,
    *,
    num_heads: int,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Packed attention: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if not kernels.on_cuda(qkv):
        return attention_packed_plain(
            qkv, num_heads=num_heads, padding_mask=padding_mask, window=window, rope=rope
        )
    batch, seq_len, _ = qkv.shape
    head_dim = _head_dim(qkv, num_heads)
    if head_dim != KERNEL_HEAD_DIM:
        raise ValueError(f"the packed kernel takes head_dim {KERNEL_HEAD_DIM}, not {head_dim}")
    if qkv.stride(2) != 1:
        qkv = qkv.contiguous()
    mask = None
    if padding_mask is not None:
        if padding_mask.shape != (batch, seq_len):
            raise ValueError(f"padding_mask {tuple(padding_mask.shape)} is not [{batch}, {seq_len}]")
        mask = padding_mask.to(device=qkv.device, dtype=torch.int32).contiguous()
    cos = sin = None
    if rope is not None:
        cos, sin = (t.to(device=qkv.device, dtype=qkv.dtype).contiguous() for t in rope)
        if cos.shape != (seq_len, head_dim) or sin.shape != (seq_len, head_dim):
            raise ValueError(f"rope tables must be [{seq_len}, {head_dim}]")
    if qkv.dtype == torch.bfloat16:
        kernels.require_16_byte_rows(qkv, *([] if cos is None else [cos, sin]))
    out = torch.empty(
        (batch, seq_len, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device
    )
    with torch.cuda.device(qkv.device):
        code = kernels.library().opt_flash_attention_packed(
            kernels.ptr(qkv), kernels.ptr(mask), kernels.ptr(cos), kernels.ptr(sin),
            kernels.ptr(out), batch, seq_len, num_heads, head_dim,
            qkv.stride(0), qkv.stride(1), -1 if window is None else int(window),
            head_dim**-0.5, kernels.dtype_code(qkv), kernels.stream(qkv),
        )
    kernels.check(code, "flash_attention_packed")
    return out
