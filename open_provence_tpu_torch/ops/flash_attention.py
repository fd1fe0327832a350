"""Attention kernels and their plain versions: the packed Wqkv output
(kernel 3 forward, kernel 14 backward) and separate q, k, v (kernels 9 and
16), all in ``kernels/csrc/flash_attention.cu`` and
``kernels/csrc/flash_attention_bwd.cu``.

``flash_attention_packed`` takes the fused projection [B, S, 3·H·D] in HF
lane order (qkv, head, dim) and returns [B, S, H·D] ready for Wo, as the
JAX package's ``ops/flash_attention.py::flash_attention_packed`` does.
``flash_attention`` takes q, k, v [B, H, S, D] of any strides with a unit
last stride and returns [B, H, S, D], as the JAX package's
``flash_attention`` does (without its block sizes: tiles are the kernel's
business here, and S need not be a multiple of anything). The kernels read
every operand through strides and apply rotary in-kernel; global layers
pass ``window=None``, local layers their half-window (keys with |i − j| ≤
window are seen). The head dim is one of ``kernels.ATTENTION_HEAD_DIMS``;
any head count.

One set of CUDA kernels behind one pair of C entry points
(``opt_flash_attention``, ``opt_flash_attention_bwd``) serves both: the
packed wrapper launches them on strided views of the buffer (q, k, v are
three offsets into it) and has them write into views of the [B, S, H·D]
output and of d(qkv), whatever the head layout is. Nothing is copied and the
model needs one call.

Both are autograd Functions: on a CUDA tensor the forward and backward
launch the kernels, on a CPU tensor they run the plain versions. When an
input needs a gradient the forward also emits the fp32 log-sum-exp
[B, H, S] and saves what the JAX ``custom_vjp`` saves (the inputs, the
mask, rope, out and lse). Where autograd records nothing (serving) the
wrapper calls the forward directly, asks for no lse, and the kernel skips
it. The backward returns d(qkv) in qkv's lane order, or dq, dk, dv; the
rope tables get no gradient. A row whose keys are all masked has lse =
−FLT_MAX on the card and finite probabilities (the JAX unpacked kernel
writes a +huge sentinel there); its gradients agree, its lse is not
compared.
"""

from __future__ import annotations

import torch

from .. import kernels
from .attention import attention_bias, attention_scores
from .rotary import apply_rotary, rotary_adjoint


def _head_dim(qkv: torch.Tensor, num_heads: int) -> int:
    three_hd = qkv.shape[-1]
    if qkv.dim() != 3 or three_hd % (3 * num_heads):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not [B, S, 3·{num_heads}·D]")
    return three_hd // (3 * num_heads)


def packed_views(qkv: torch.Tensor, num_heads: int):
    """q, k, v [B, H, S, D] as strided views of the packed buffer."""
    batch, seq_len, _ = qkv.shape
    head_dim = _head_dim(qkv, num_heads)
    return qkv.view(batch, seq_len, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4).unbind(0)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] → [B, S, H·D]."""
    batch, heads, seq_len, head_dim = x.shape
    return x.transpose(1, 2).reshape(batch, seq_len, heads * head_dim)


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H·D] → a [B, H, S, D] view."""
    batch, seq_len, hd = x.shape
    return x.view(batch, seq_len, num_heads, hd // num_heads).transpose(1, 2)


def attention_unpacked_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
    return_lse: bool = False,
):
    """Rotate q and k, fp32-softmax attention: [B, H, S, D]. With
    ``return_lse`` also the log-sum-exp of the scores, [B, H, S]."""
    if rope is not None:
        q, k = apply_rotary(q, k, rope[0], rope[1])
    bias = attention_bias(padding_mask, q.shape[2], window, device=q.device)
    scores = attention_scores(q, k, bias)
    out = torch.matmul(torch.softmax(scores, dim=-1).to(q.dtype), v)
    return (out, torch.logsumexp(scores, dim=-1)) if return_lse else out


def attention_unpacked_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    *,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) [B, H, S, D] for the cotangent g of the output, as
    kernels 14 and 16 compute them: P = exp(scores − lse), δ = rowsum(g·out)
    from g cast to q's dtype, dS = P∘(g·vᵀ − δ); dv = Pᵀ·g with P rounded to
    q's dtype, dq = dS·k·scale and dk = dSᵀ·q·scale with dS rounded, then dq
    and dk rounded and put through the rope adjoint."""
    dtype = q.dtype
    acc = torch.promote_types(dtype, torch.float32)
    if rope is not None:
        q, k = apply_rotary(q, k, rope[0], rope[1])
    scale = q.shape[-1] ** -0.5
    bias = attention_bias(padding_mask, q.shape[2], window, device=q.device)
    p = torch.exp(attention_scores(q, k, bias) - lse[..., None].to(acc))
    gh = g.to(dtype).to(acc)
    delta = (gh * out.to(acc)).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(gh, v.to(acc).transpose(-1, -2)) - delta)
    dv = torch.matmul(p.to(dtype).to(acc).transpose(-1, -2), gh).to(dtype)
    ds = ds.to(dtype).to(acc)
    dq = (torch.matmul(ds, k.to(acc)) * scale).to(dtype)
    dk = (torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale).to(dtype)
    if rope is not None:
        dq, dk = rotary_adjoint(dq, *rope), rotary_adjoint(dk, *rope)
    return dq, dk, dv


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
    result = attention_unpacked_plain(
        *packed_views(qkv, num_heads), padding_mask=padding_mask, window=window, rope=rope,
        return_lse=return_lse,
    )
    return (_merge(result[0]), result[1]) if return_lse else _merge(result)


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
    """d(qkv) [B, S, 3·H·D] for the cotangent g [B, S, H·D] of the output:
    ``attention_unpacked_bwd_plain`` on the buffer's views, repacked."""
    grads = attention_unpacked_bwd_plain(
        *packed_views(qkv, num_heads), _split(g, num_heads), _split(out, num_heads), lse,
        padding_mask=padding_mask, window=window, rope=rope,
    )
    return torch.cat([_merge(t) for t in grads], dim=-1)


def _window_arg(window: int | None) -> int:
    return -1 if window is None else int(window)


def _check_head_dim(head_dim: int) -> None:
    if head_dim not in kernels.ATTENTION_HEAD_DIMS:
        raise ValueError(
            f"the attention kernels are instantiated for head_dim in "
            f"{list(kernels.ATTENTION_HEAD_DIMS)}, not {head_dim}"
        )


def _prepare_mask_rope(x, batch, seq_len, head_dim, padding_mask, rope):
    """(mask, cos, sin) as the kernels take them beside the CUDA tensor x:
    an int32 mask [B, S], tables [S, D] cast to x's dtype."""
    mask = cos = sin = None
    if padding_mask is not None:
        if padding_mask.shape != (batch, seq_len):
            raise ValueError(
                f"padding_mask {tuple(padding_mask.shape)} is not [{batch}, {seq_len}]"
            )
        mask = padding_mask.to(device=x.device, dtype=torch.int32).contiguous()
    if rope is not None:
        cos, sin = (t.to(device=x.device, dtype=x.dtype).contiguous() for t in rope)
        if cos.shape != (seq_len, head_dim) or sin.shape != (seq_len, head_dim):
            raise ValueError(f"rope tables must be [{seq_len}, {head_dim}]")
        if x.dtype == torch.bfloat16:
            kernels.require_16_byte_rows(cos, sin)
    return mask, cos, sin


def _rope(cos, sin):
    return None if cos is None else (cos, sin)


# ---- separate q, k, v: kernels 9 and 16 ----------------------------------------


def _unit_last_stride(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _prepare_unpacked(q, k, v, padding_mask, rope):
    """(q, k, v, mask, cos, sin) as the kernels take them on CUDA tensors
    (unit last strides, int32 mask, tables cast to q's dtype, checked
    shapes); on CPU tensors as given."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one [B, H, S, D] shape; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not kernels.on_cuda(q):
        cos, sin = (None, None) if rope is None else rope
        return q, k, v, padding_mask, cos, sin
    if not (k.dtype == v.dtype == q.dtype and k.device == v.device == q.device):
        raise ValueError("q, k, v must share one dtype and device")
    batch, _, seq_len, head_dim = q.shape
    _check_head_dim(head_dim)
    kernels.dtype_code(q)
    q, k, v = (_unit_last_stride(t) for t in (q, k, v))
    return (q, k, v, *_prepare_mask_rope(q, batch, seq_len, head_dim, padding_mask, rope))


def _rotation_scratch(q, cos, backward: bool):
    """The scratch a bf16 launch rotates its streamed operands into, where
    the head dim's kernels do so and the call has rope tables; else None."""
    batch, heads, seq_len, head_dim = q.shape
    if q.dtype != torch.bfloat16 or cos is None:
        return None
    operands = kernels.attention_scratch_operands(head_dim, backward)
    if not operands:
        return None
    return torch.empty((operands, batch, heads, seq_len, head_dim), dtype=q.dtype,
                       device=q.device)


def _unpacked_forward_kernel(q, k, v, mask, cos, sin, window, want_lse, out=None):
    """Launch kernel 9. ``out`` is where the result goes: a new contiguous
    [B, H, S, D] tensor, or the strided view the caller passes."""
    batch, heads, seq_len, head_dim = q.shape
    if out is None:
        out = torch.empty((batch, heads, seq_len, head_dim), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        kernels.require_16_byte_rows(q, k, v, out)
    lse = None
    if want_lse:
        lse = torch.empty((batch, heads, seq_len), dtype=torch.float32, device=q.device)
    scratch = _rotation_scratch(q, cos, backward=False)
    with torch.cuda.device(q.device):
        code = kernels.library().opt_flash_attention(
            *(kernels.ptr(t) for t in (q, k, v, mask, cos, sin, out, lse, scratch)),
            batch, seq_len, heads, head_dim, kernels.strides_of(q, k, v, out),
            _window_arg(window), head_dim**-0.5, kernels.dtype_code(q), kernels.stream(q),
        )
    kernels.check(code, "flash_attention")
    return out, lse


def _unpacked_backward_kernel(q, k, v, mask, cos, sin, out, lse, g, window, grads=None):
    """Launch kernel 16. ``grads`` is where dq, dk, dv go: new contiguous
    tensors, or the strided views the caller passes."""
    batch, heads, seq_len, head_dim = q.shape
    g = _unit_last_stride(g.to(q.dtype))
    if grads is None:
        grads = tuple(
            torch.empty((batch, heads, seq_len, head_dim), dtype=q.dtype, device=q.device)
            for _ in range(3)
        )
    if q.dtype == torch.bfloat16:
        kernels.require_16_byte_rows(q, k, v, out, g, *grads)
    delta = torch.empty((batch, heads, seq_len), dtype=torch.float32, device=q.device)
    scratch = _rotation_scratch(q, cos, backward=True)
    with torch.cuda.device(q.device):
        code = kernels.library().opt_flash_attention_bwd(
            *(kernels.ptr(t) for t in (q, k, v, mask, cos, sin, out, lse, g, delta, scratch,
                                       *grads)),
            batch, seq_len, heads, head_dim, kernels.strides_of(q, k, v, out, g, *grads),
            _window_arg(window), head_dim**-0.5, kernels.dtype_code(q), kernels.stream(q),
        )
    kernels.check(code, "flash_attention_bwd")
    return grads


def _unpacked_forward(q, k, v, mask, cos, sin, window, want_lse):
    if kernels.on_cuda(q):
        return _unpacked_forward_kernel(q, k, v, mask, cos, sin, window, want_lse)
    kernels.count_plain("flash_attention")
    result = attention_unpacked_plain(
        q, k, v, padding_mask=mask, window=window, rope=_rope(cos, sin), return_lse=want_lse
    )
    return result if want_lse else (result, None)


def _unpacked_backward(q, k, v, mask, cos, sin, out, lse, g, window):
    if kernels.on_cuda(q):
        return _unpacked_backward_kernel(q, k, v, mask, cos, sin, out, lse, g, window)
    kernels.count_plain("flash_attention_bwd")
    return attention_unpacked_bwd_plain(
        q, k, v, g, out, lse, padding_mask=mask, window=window, rope=_rope(cos, sin)
    )


class FlashAttentionFunction(torch.autograd.Function):
    """Attention on separate q, k, v with its adjoint: kernels 9 and 16 for
    CUDA tensors, the plain versions for CPU tensors. ``mask``, ``cos`` and
    ``sin`` arrive as ``_prepare_unpacked`` leaves them."""

    @staticmethod
    def forward(ctx, q, k, v, mask, cos, sin, window):
        out, lse = _unpacked_forward(q, k, v, mask, cos, sin, window, True)
        ctx.save_for_backward(q, k, v, mask, cos, sin, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, cos, sin, out, lse = ctx.saved_tensors
        dq, dk, dv = _unpacked_backward(q, k, v, mask, cos, sin, out, lse, g, ctx.window)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Attention on q, k, v [B, H, S, D] → [B, H, S, D]: the CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors; differentiable in q, k
    and v. With ``rope`` q and k arrive unrotated."""
    prepared = _prepare_unpacked(q, k, v, padding_mask, rope)
    if kernels.records_grad(q, k, v):
        return FlashAttentionFunction.apply(*prepared, window)
    return _unpacked_forward(*prepared, window, False)[0]


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward alone, returning (out, lse [B, H, S] fp32), with no
    autograd record: kernel 9 for CUDA tensors, the plain version for CPU
    tensors."""
    return _unpacked_forward(*_prepare_unpacked(q, k, v, padding_mask, rope), window, True)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    *,
    padding_mask: torch.Tensor | None,
    window: int | None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the cotangent g of ``flash_attention``'s output,
    given the forward's out and lse: kernel 16 for CUDA tensors, the plain
    version for CPU tensors."""
    q, k, v, mask, cos, sin = _prepare_unpacked(q, k, v, padding_mask, rope)
    return _unpacked_backward(q, k, v, mask, cos, sin, _unit_last_stride(out), lse, g, window)


# ---- the packed buffer: kernels 3 and 14 ----------------------------------------


def _forward_kernel(qkv, mask, cos, sin, num_heads, window, want_lse):
    batch, seq_len, _ = qkv.shape
    out = torch.empty(
        (batch, seq_len, num_heads * _head_dim(qkv, num_heads)), dtype=qkv.dtype,
        device=qkv.device,
    )
    _, lse = _unpacked_forward_kernel(
        *packed_views(qkv, num_heads), mask, cos, sin, window, want_lse,
        out=_split(out, num_heads),
    )
    return out, lse


def _backward_kernel(qkv, mask, cos, sin, out, lse, g, num_heads, window):
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    _unpacked_backward_kernel(
        *packed_views(qkv, num_heads), mask, cos, sin, _split(out, num_heads), lse,
        _split(g.to(qkv.dtype).contiguous(), num_heads), window,
        grads=packed_views(dqkv, num_heads),
    )
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
    _check_head_dim(head_dim)
    if qkv.stride(2) != 1:
        qkv = qkv.contiguous()
    if qkv.dtype == torch.bfloat16:
        kernels.require_16_byte_rows(qkv)
    return (qkv, *_prepare_mask_rope(qkv, batch, seq_len, head_dim, padding_mask, rope))


def _forward(qkv, mask, cos, sin, num_heads, window, want_lse):
    if kernels.on_cuda(qkv):
        return _forward_kernel(qkv, mask, cos, sin, num_heads, window, want_lse)
    kernels.count_plain("flash_attention_packed")
    result = attention_packed_plain(
        qkv, num_heads=num_heads, padding_mask=mask, window=window, rope=_rope(cos, sin),
        return_lse=want_lse,
    )
    return result if want_lse else (result, None)


def _backward(qkv, mask, cos, sin, out, lse, g, num_heads, window):
    if kernels.on_cuda(qkv):
        return _backward_kernel(qkv, mask, cos, sin, out, lse, g, num_heads, window)
    kernels.count_plain("flash_attention_packed_bwd")
    return attention_packed_bwd_plain(
        qkv, g, out, lse, num_heads=num_heads, padding_mask=mask, window=window,
        rope=_rope(cos, sin),
    )


class FlashAttentionPackedFunction(torch.autograd.Function):
    """Packed attention with its adjoint: the kernels for a CUDA tensor, the
    plain versions for a CPU tensor. ``mask``, ``cos`` and ``sin`` arrive as
    ``_prepare`` leaves them."""

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
    autograd record: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    return _forward(*_prepare(qkv, num_heads, padding_mask, rope), num_heads, window, True)


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
    given the forward's out and lse: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    qkv, mask, cos, sin = _prepare(qkv, num_heads, padding_mask, rope)
    return _backward(qkv, mask, cos, sin, out, lse, g, num_heads, window)
