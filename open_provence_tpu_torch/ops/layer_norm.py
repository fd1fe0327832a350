"""LayerNorm: kernel 1 (``kernels/csrc/layer_norm.cu``), the residual add
fused into it (kernel 7), their backward kernel 10 (the same file) and the
plain versions of all three.

ModernBERT's norms are bias-free (norm_bias=false) and run on the kernels.
Statistics are fp32 E[x] and E[x²] with var = max(E[x²] − E[x]², 0), as the
JAX package's ``ops/layer_norm.py`` takes them;
``torch.nn.functional.layer_norm`` takes them another way, so the plain
versions spell the formula out. A norm that carries a bias (norm_bias=true
checkpoints) is ``layer_norm_plain`` with the bias on either device: plain
tensor ops, as it is plain XLA ops in the JAX package
(``layer_norm_reference``), differentiated by autograd.

``add_layer_norm(x, y, scale)`` returns (h, LN(h)) with h = x + y rounded
to the storage type before the norm reads it, so it equals an add followed
by ``layer_norm`` (JAX: ``fused_add_layer_norm``). Its backward is kernel
10 given the cotangent of h as ``gh``, which is added to dx in fp32 before
the one round; x and y both receive that dh.

``layer_norm`` is an autograd Function: on a CUDA tensor its forward and
backward launch the kernels, on a CPU tensor they run the plain versions,
so the module (not the caller) picks the path and ``grad_fn`` is set
whenever autograd records. Where it records nothing (``torch.no_grad``,
``inference_mode``, inputs that need no gradient, as in serving) the
wrapper calls the same forward without the Function. The backward saves
what the JAX ``custom_vjp`` saves (``_ln_fwd``: x and the scale) and
recomputes the statistics.
"""

from __future__ import annotations

import torch

from .. import kernels


def layer_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, bias: torch.Tensor | None = None
) -> torch.Tensor:
    """LayerNorm over the last dim; stats in at least fp32, output in x's
    dtype; the optional bias is added in the statistics' dtype before the
    round (the JAX package's ``layer_norm_reference``)."""
    stat = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(stat)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.to(stat)
    if bias is not None:
        y = y + bias.to(stat)
    return y.to(x.dtype)


def add_layer_norm_plain(
    x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, LN(h)) with h = x + y summed in at least fp32 and rounded to x's
    dtype; the norm reads the rounded h."""
    stat = torch.promote_types(x.dtype, torch.float32)
    h = (x.to(stat) + y.to(stat)).to(x.dtype)
    return h, layer_norm_plain(h, scale, eps)


def ln_rows(x2d: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, rstd) of each row in at least fp32: h = (x − mean)·rstd."""
    xf = x2d.to(torch.promote_types(x2d.dtype, torch.float32))
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    return (xf - mean) * rstd, rstd


def ln_adjoint(
    h: torch.Tensor, rstd: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The LN-adjoint row body, in h's dtype: dy is the cotangent of
    LN(x)·scale; returns dx = rstd·(dy·s − mean(dy·s) − h·mean(dy·s·h)) and
    dscale = Σ_rows dy·h."""
    ds = dy.to(h.dtype) * scale.to(h.dtype)
    dx = rstd * (
        ds - ds.mean(dim=-1, keepdim=True) - h * (ds * h).mean(dim=-1, keepdim=True)
    )
    return dx, (dy.to(h.dtype) * h).sum(dim=0)


def layer_norm_bwd_plain(
    x2d: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float = 1e-5,
    gh: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of LayerNorm, as the JAX package's ``_ln_bwd_xla``
    writes it: dx in x's dtype, dscale in the scale's. ``gh``, a cotangent
    that reaches x past the norm (the add + LN form's residual stream), is
    added to dx before the round, as ``_ln_bwd_kernel`` adds it."""
    h, rstd = ln_rows(x2d, eps)
    dx, dscale = ln_adjoint(h, rstd, scale, g)
    if gh is not None:
        dx = dx + gh.to(dx.dtype)
    return dx.to(x2d.dtype), dscale.to(scale.dtype)


def _check_scale(x2d: torch.Tensor, scale: torch.Tensor) -> None:
    hidden = x2d.shape[-1]
    if scale.shape != (hidden,) or scale.dtype != x2d.dtype or scale.device != x2d.device:
        raise ValueError(f"scale must be [{hidden}] {x2d.dtype} on {x2d.device}")


def _forward_kernel(x2d: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    _check_scale(x2d, scale)
    out = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_layer_norm(
            kernels.ptr(x2d), kernels.ptr(scale), kernels.ptr(out),
            x2d.shape[0], x2d.shape[1], float(eps), kernels.dtype_code(x2d),
            kernels.stream(x2d),
        )
    kernels.check(code, "layer_norm")
    return out


def _add_forward_kernel(x2d, y2d, scale, eps):
    _check_scale(x2d, scale)
    if y2d.shape != x2d.shape or y2d.dtype != x2d.dtype or y2d.device != x2d.device:
        raise ValueError(f"y must be {tuple(x2d.shape)} {x2d.dtype} on {x2d.device}")
    h, out = torch.empty_like(x2d), torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_add_layer_norm(
            kernels.ptr(x2d), kernels.ptr(y2d), kernels.ptr(scale), kernels.ptr(h),
            kernels.ptr(out), x2d.shape[0], x2d.shape[1], float(eps),
            kernels.dtype_code(x2d), kernels.stream(x2d),
        )
    kernels.check(code, "add_layer_norm")
    return h, out


def _backward_kernel(
    x2d: torch.Tensor, scale: torch.Tensor, g2d: torch.Tensor, eps: float,
    gh2d: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    rows, hidden = x2d.shape
    dx = torch.empty_like(x2d)
    dscale = torch.empty_like(scale)
    partial = kernels.ln_adjoint_partial(rows, hidden, x2d.device)
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_layer_norm_bwd(
            kernels.ptr(x2d), kernels.ptr(scale), kernels.ptr(g2d), kernels.ptr(gh2d),
            kernels.ptr(dx), kernels.ptr(dscale), kernels.ptr(partial), rows, hidden,
            float(eps), kernels.dtype_code(x2d), kernels.stream(x2d),
        )
    kernels.check(code, "layer_norm_bwd")
    return dx, dscale


def layer_norm_bwd(
    x2d: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float = 1e-5,
    gh: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of LayerNorm over rows of x2d, with ``gh`` (optional, a
    cotangent that reaches x past the norm) added into dx: kernel 10 for
    CUDA tensors, the plain version for CPU tensors."""
    if not kernels.on_cuda(x2d):
        kernels.count_plain("layer_norm_bwd")
        return layer_norm_bwd_plain(x2d, scale, g, eps, gh)
    x2d, scale = x2d.contiguous(), scale.contiguous()
    _check_scale(x2d, scale)
    g2d, gh2d = (
        None if t is None else t.reshape(x2d.shape).to(x2d.dtype).contiguous() for t in (g, gh)
    )
    x2d, scale, g2d, gh2d = (
        kernels.ln_adjoint_aligned(t, x2d.shape[1]) for t in (x2d, scale, g2d, gh2d)
    )
    return _backward_kernel(x2d, scale, g2d, eps, gh2d)


def _forward(x2d: torch.Tensor, scale: torch.Tensor, eps: float):
    """(out, x2d, scale): kernel 1 on a CUDA tensor, the plain version on a
    CPU tensor; x2d and scale as the backward takes them."""
    if kernels.on_cuda(x2d):
        x2d, scale = x2d.contiguous(), scale.contiguous()
        return _forward_kernel(x2d, scale, eps), x2d, scale
    kernels.count_plain("layer_norm")
    return layer_norm_plain(x2d, scale, eps), x2d, scale


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm over the last dim with its adjoint: kernels 1 and 10 for
    CUDA tensors, the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
        out, x2d, scale = _forward(x.reshape(-1, x.shape[-1]), scale, eps)
        ctx.save_for_backward(x2d, scale)
        ctx.eps = eps
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2d, scale = ctx.saved_tensors
        dx, dscale = layer_norm_bwd(x2d, scale, g.reshape(x2d.shape), ctx.eps)
        return dx.reshape(g.shape), dscale, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim: the CUDA kernels for a CUDA tensor, the
    plain versions for a CPU tensor; differentiable in x and the scale."""
    if kernels.records_grad(x, scale):
        return LayerNormFunction.apply(x, scale, eps)
    return _forward(x.reshape(-1, x.shape[-1]), scale, eps)[0].reshape(x.shape)


def _add_forward(x2d: torch.Tensor, y2d: torch.Tensor, scale: torch.Tensor, eps: float):
    """(h, LN(h), scale): kernel 7 on CUDA tensors, the plain version on CPU
    tensors; the scale as the backward takes it."""
    if kernels.on_cuda(x2d):
        scale = scale.contiguous()
        return (*_add_forward_kernel(x2d.contiguous(), y2d.contiguous(), scale, eps), scale)
    kernels.count_plain("add_layer_norm")
    return (*add_layer_norm_plain(x2d, y2d, scale, eps), scale)


class AddLayerNormFunction(torch.autograd.Function):
    """(x + y, LN(x + y)) with its adjoint: kernels 7 and 10 for CUDA
    tensors, the plain versions for CPU tensors. Saves what the JAX
    ``_add_ln_fwd`` saves: h and the scale."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, eps: float):
        hidden = x.shape[-1]
        h, normed, scale = _add_forward(x.reshape(-1, hidden), y.reshape(-1, hidden), scale, eps)
        ctx.save_for_backward(h, scale)
        ctx.eps = eps
        return h.reshape(x.shape), normed.reshape(x.shape)

    @staticmethod
    def backward(ctx, gh: torch.Tensor, gn: torch.Tensor):
        h, scale = ctx.saved_tensors
        dh, dscale = layer_norm_bwd(h, scale, gn.reshape(h.shape), ctx.eps, gh.reshape(h.shape))
        dh = dh.reshape(gh.shape)
        return dh, dh, dscale, None


def add_layer_norm(
    x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + y, LayerNorm(x + y)) in one pass: the CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors; differentiable in x, y and
    the scale."""
    if kernels.records_grad(x, y, scale):
        return AddLayerNormFunction.apply(x, y, scale, eps)
    hidden = x.shape[-1]
    h, normed, _ = _add_forward(x.reshape(-1, hidden), y.reshape(-1, hidden), scale, eps)
    return h.reshape(x.shape), normed.reshape(x.shape)
