"""Attention on the packed Wqkv output: kernel 3
(``kernels/csrc/flash_attention.cu``), its backward kernel 14
(``kernels/csrc/flash_attention_bwd.cu``) and their plain versions.

``flash_attention_packed`` takes the fused projection [B, S, 3·H·D] in HF
lane order (qkv, head, dim) and returns [B, S, H·D] ready for Wo, as the
JAX package's ``ops/flash_attention.py::flash_attention_packed`` does. The
kernel reads q/k/v through strides of that one buffer and applies rotary
in-kernel; global layers pass ``window=None``, local layers their
half-window (keys with |i − j| ≤ window are seen).

It is an autograd Function: on a CUDA tensor the forward and backward
launch the kernels, on a CPU tensor they run the plain versions. When qkv
needs a gradient the forward also emits the fp32 log-sum-exp [B, H, S] and
saves what the JAX ``_flash_packed_fwd`` saves (qkv, the mask, rope, out
and lse). Where autograd records nothing (serving) the wrapper calls the
forward directly, asks for no lse, and the kernel skips it. The backward
returns d(qkv) in qkv's lane order; the rope tables get no gradient.
"""

from __future__ import annotations

import torch

from .. import kernels
from .attention import attention_bias, attention_scores
from .rotary import apply_rotary, rotary_adjoint

KERNEL_HEAD_DIM = 64  # ModernBERT's, base and large


def _head_dim(qkv: torch.Tensor, num_heads: int) -> int:
    three_hd = qkv.shape[-1]
    if qkv.dim() != 3 or three_hd % (3 * num_heads):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not [B, S, 3·{num_heads}·D]")
    return three_hd // (3 * num_heads)


def _heads(qkv, num_heads, rope):
    """q, k (rotated) and v as [B, H, S, D]."""
    batch, seq_len, _ = qkv.shape
    head_dim = _head_dim(qkv, num_heads)
    q, k, v = qkv.reshape(batch, seq_len, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    if rope is not None:
        q, k = apply_rotary(q, k, rope[0], rope[1])
    return q, k, v


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] → [B, S, H·D]."""
    batch, heads, seq_len, head_dim = x.shape
    return x.transpose(1, 2).reshape(batch, seq_len, heads * head_dim)


def attention_packed_plain(
    qkv: torch.Tensor,
    *,
    num_heads: int,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
    return_lse: bool = False,
):
    """Unpack q/k/v, rotate, fp32-softmax attention, repack to [B, S, H·D].
    With ``return_lse`` also the log-sum-exp of the scores, [B, H, S]."""
    q, k, v = _heads(qkv, num_heads, rope)
    bias = attention_bias(padding_mask, qkv.shape[1], window, device=qkv.device)
    scores = attention_scores(q, k, bias)
    out = _merge(torch.matmul(torch.softmax(scores, dim=-1).to(q.dtype), v))
    return (out, torch.logsumexp(scores, dim=-1)) if return_lse else out


def attention_packed_bwd_plain(
    qkv: torch.Tensor,
    g: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    *,
    num_heads: int,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """d(qkv) [B, S, 3·H·D] for the cotangent g of the output, as kernel 14
    computes it: P = exp(scores − lse), δ = rowsum(g·out) from g cast to
    qkv's dtype, dS = P∘(g·vᵀ − δ); dv = Pᵀ·g with P rounded to qkv's dtype,
    dq = dS·k·scale and dk = dSᵀ·q·scale with dS rounded, then dq and dk
    rounded and put through the rope adjoint."""
    dtype = qkv.dtype
    acc = torch.promote_types(dtype, torch.float32)
    q, k, v = _heads(qkv, num_heads, rope)
    scale = q.shape[-1] ** -0.5
    bias = attention_bias(padding_mask, qkv.shape[1], window, device=qkv.device)
    p = torch.exp(attention_scores(q, k, bias) - lse[..., None].to(acc))
    batch, seq_len, hd = out.shape
    split = (batch, seq_len, num_heads, hd // num_heads)
    gh = g.to(dtype).reshape(split).transpose(1, 2).to(acc)
    delta = (gh * out.reshape(split).transpose(1, 2).to(acc)).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(gh, v.to(acc).transpose(-1, -2)) - delta)
    dv = torch.matmul(p.to(dtype).to(acc).transpose(-1, -2), gh).to(dtype)
    ds = ds.to(dtype).to(acc)
    dq = (torch.matmul(ds, k.to(acc)) * scale).to(dtype)
    dk = (torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale).to(dtype)
    if rope is not None:
        dq, dk = rotary_adjoint(dq, *rope), rotary_adjoint(dk, *rope)
    return torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)


def _forward_kernel(qkv, mask, cos, sin, num_heads, window, want_lse):
    batch, seq_len, _ = qkv.shape
    head_dim = _head_dim(qkv, num_heads)
    out = torch.empty(
        (batch, seq_len, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device
    )
    lse = None
    if want_lse:
        lse = torch.empty((batch, num_heads, seq_len), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        code = kernels.library().opt_flash_attention_packed(
            kernels.ptr(qkv), kernels.ptr(mask), kernels.ptr(cos), kernels.ptr(sin),
            kernels.ptr(out), kernels.ptr(lse), batch, seq_len, num_heads, head_dim,
            qkv.stride(0), qkv.stride(1), -1 if window is None else int(window),
            head_dim**-0.5, kernels.dtype_code(qkv), kernels.stream(qkv),
        )
    kernels.check(code, "flash_attention_packed")
    return out, lse


def _backward_kernel(qkv, mask, cos, sin, out, lse, g, num_heads, window):
    batch, seq_len, three_hd = qkv.shape
    head_dim = _head_dim(qkv, num_heads)
    g = g.to(qkv.dtype).contiguous()
    if qkv.dtype == torch.bfloat16:
        kernels.require_16_byte_rows(g, out)
    dqkv = torch.empty((batch, seq_len, three_hd), dtype=qkv.dtype, device=qkv.device)
    delta = torch.empty((batch, num_heads, seq_len), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        code = kernels.library().opt_flash_attention_packed_bwd(
            *(kernels.ptr(t) for t in (qkv, mask, cos, sin, out, lse, g, delta, dqkv)),
            batch, seq_len, num_heads, head_dim, qkv.stride(0), qkv.stride(1),
            -1 if window is None else int(window), head_dim**-0.5,
            kernels.dtype_code(qkv), kernels.stream(qkv),
        )
    kernels.check(code, "flash_attention_packed_bwd")
    return dqkv


def _prepare(qkv, num_heads, padding_mask, rope):
    """(qkv, mask, cos, sin) as the kernels take them on a CUDA tensor
    (int32 mask, tables cast to qkv's dtype, checked shapes); on a CPU
    tensor as given."""
    if not kernels.on_cuda(qkv):
        cos, sin = (None, None) if rope is None else rope
        return qkv, padding_mask, cos, sin
    batch, seq_len, _ = qkv.shape
    head_dim = _head_dim(qkv, num_heads)
    if head_dim != KERNEL_HEAD_DIM:
        raise ValueError(f"the packed kernel takes head_dim {KERNEL_HEAD_DIM}, not {head_dim}")
    if qkv.stride(2) != 1:
        qkv = qkv.contiguous()
    mask = cos = sin = None
    if padding_mask is not None:
        if padding_mask.shape != (batch, seq_len):
            raise ValueError(
                f"padding_mask {tuple(padding_mask.shape)} is not [{batch}, {seq_len}]"
            )
        mask = padding_mask.to(device=qkv.device, dtype=torch.int32).contiguous()
    if rope is not None:
        cos, sin = (t.to(device=qkv.device, dtype=qkv.dtype).contiguous() for t in rope)
        if cos.shape != (seq_len, head_dim) or sin.shape != (seq_len, head_dim):
            raise ValueError(f"rope tables must be [{seq_len}, {head_dim}]")
    if qkv.dtype == torch.bfloat16:
        kernels.require_16_byte_rows(qkv, *([] if cos is None else [cos, sin]))
    return qkv, mask, cos, sin


def _forward(qkv, mask, cos, sin, num_heads, window, want_lse):
    if kernels.on_cuda(qkv):
        return _forward_kernel(qkv, mask, cos, sin, num_heads, window, want_lse)
    kernels.count_plain("flash_attention_packed")
    rope = None if cos is None else (cos, sin)
    result = attention_packed_plain(
        qkv, num_heads=num_heads, padding_mask=mask, window=window, rope=rope,
        return_lse=want_lse,
    )
    return result if want_lse else (result, None)


def _backward(qkv, mask, cos, sin, out, lse, g, num_heads, window):
    if kernels.on_cuda(qkv):
        return _backward_kernel(qkv, mask, cos, sin, out, lse, g, num_heads, window)
    kernels.count_plain("flash_attention_packed_bwd")
    return attention_packed_bwd_plain(
        qkv, g, out, lse, num_heads=num_heads, padding_mask=mask, window=window,
        rope=None if cos is None else (cos, sin),
    )


class FlashAttentionPackedFunction(torch.autograd.Function):
    """Packed attention with its adjoint: kernels 3 and 14 for a CUDA
    tensor, the plain versions for a CPU tensor. ``mask``, ``cos`` and
    ``sin`` arrive as ``_prepare`` leaves them."""

    @staticmethod
    def forward(ctx, qkv, mask, cos, sin, num_heads, window):
        want_lse = ctx.needs_input_grad[0]
        out, lse = _forward(qkv, mask, cos, sin, num_heads, window, want_lse)
        if want_lse:
            ctx.save_for_backward(qkv, mask, cos, sin, out, lse)
        ctx.num_heads, ctx.window = num_heads, window
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, mask, cos, sin, out, lse = ctx.saved_tensors
        dqkv = _backward(qkv, mask, cos, sin, out, lse, g, ctx.num_heads, ctx.window)
        return dqkv, None, None, None, None, None


def flash_attention_packed(
    qkv: torch.Tensor,
    *,
    num_heads: int,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Packed attention: the CUDA kernels for a CUDA tensor, the plain
    versions for a CPU tensor; differentiable in qkv."""
    prepared = _prepare(qkv, num_heads, padding_mask, rope)
    if kernels.records_grad(qkv):
        return FlashAttentionPackedFunction.apply(*prepared, num_heads, window)
    return _forward(*prepared, num_heads, window, False)[0]


def flash_attention_packed_lse(
    qkv: torch.Tensor,
    *,
    num_heads: int,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward alone, returning (out, lse [B, H, S] fp32), with no
    autograd record: kernel 3 for a CUDA tensor, the plain version for a CPU
    tensor."""
    prepared = _prepare(qkv, num_heads, padding_mask, rope)
    return _forward(*prepared, num_heads, window, True)


def flash_attention_packed_bwd(
    qkv: torch.Tensor,
    g: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    *,
    num_heads: int,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """d(qkv) for the cotangent g of ``flash_attention_packed``'s output,
    given the forward's out and lse: kernel 14 for a CUDA tensor, the plain
    version for a CPU tensor."""
    qkv, mask, cos, sin = _prepare(qkv, num_heads, padding_mask, rope)
    return _backward(qkv, mask, cos, sin, out, lse, g, num_heads, window)
