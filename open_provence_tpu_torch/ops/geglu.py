"""LayerNorm folded into its GEMM: kernels 2 and 4
(``kernels/csrc/ln_gemm.cu``), their backward kernels 12 and 11
(``kernels/csrc/ln_gemm_bwd.cu``), the GeGLU GEMM without a norm (kernel 6,
``ln_gemm.cu``), the whole MLP in one kernel (kernel 8,
``kernels/csrc/mlp_tail.cu``, and its backward kernel 13,
``kernels/csrc/mlp_tail_bwd.cu``) and the plain versions of all seven.

* ``ln_matmul``: LN(x)·scale @ Wᵀ — attn_norm → Wqkv in layers 1 and up
  (JAX: ``ops/geglu.py::fused_ln_matmul``).
* ``ln_geglu``: act(LN(x)·scale @ Wi[:I]ᵀ) · (LN(x)·scale @ Wi[I:]ᵀ) —
  mlp_norm → Wi → act·gate (JAX: ``ops/geglu.py::fused_ln_geglu``).
* ``geglu``: act(x @ Wi[:I]ᵀ) · (x @ Wi[I:]ᵀ) on rows that are normalized
  already — the MLP of a norm_bias=true checkpoint, whose norm cannot fold
  into the GEMM (JAX: ``ops/geglu.py::fused_geglu``). Its backward is no
  kernel in the JAX package either (``_geglu_bwd`` is ``jax.vjp`` of the
  plain composition), so here it is autograd through ``geglu_plain`` on both
  devices, ``torch.matmul`` and all.
* ``ln_geglu_wo``: ``ln_geglu`` followed by Wo, (act·gate) @ Woᵀ, in one
  kernel, the [M, I] product never in device memory (JAX:
  ``ops/geglu.py::fused_ln_geglu_wo``). ``fuse_forward=False`` keeps the
  forward split (``ln_geglu`` then a plain product with Wo: the same rounding
  points, so the same values) and fuses only the backward, the JAX gate's
  ``bwd`` form.

Weights are in torch's ``[out, in]`` layout. Numerics follow the JAX
kernels: the normalized x is rounded to the storage dtype before the
product, products accumulate in fp32, and GeGLU rounds each half to the
storage dtype, applies the activation in fp32, rounds again and takes the
gate product in the storage dtype.

``ln_matmul`` and ``ln_geglu`` are autograd Functions: on CUDA tensors the
forward and backward launch the kernels, on CPU tensors they run the plain
versions; where autograd records nothing (serving) the wrappers call the
same forward without the Function. The backward saves what the JAX ``custom_vjp`` saves (x, the LN
scale and the weight) and recomputes the normalized rows. The plain
backwards write out what the JAX Pallas backwards compute: the normalized
rows rounded at the forward's point, the cotangent of the LN output dy in
fp32, and for GeGLU the rounding chain of ``_ln_geglu_bwd_kernel``; in fp32
that is exactly ``jax.vjp`` of the reference composition.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .layer_norm import layer_norm_plain, ln_adjoint, ln_rows

# HF activation name -> (kernel code, plain fp32 function).
ACTIVATIONS = {
    "gelu": (0, lambda x: F.gelu(x, approximate="none")),
    "gelu_new": (1, lambda x: F.gelu(x, approximate="tanh")),
    "gelu_pytorch_tanh": (1, lambda x: F.gelu(x, approximate="tanh")),
    "relu": (2, F.relu),
    "silu": (3, F.silu),
    "swish": (3, F.silu),
}


_INV_SQRT_2PI = 0.39894228040143268
_SQRT_2_OVER_PI = 0.79788456080286536


def _gelu_grad(x):
    cdf = 0.5 * (1.0 + torch.erf(x * 0.70710678118654752))
    return cdf + x * _INV_SQRT_2PI * torch.exp(-0.5 * x * x)


def _gelu_tanh_grad(x):
    t = torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x)))
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * (x * x))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def _silu_grad(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


# HF activation name -> its derivative, written out as the JAX package's
# ops/geglu.py::_KERNEL_ACTIVATION_GRADS writes it.
ACTIVATION_GRADS = {
    "gelu": _gelu_grad,
    "gelu_new": _gelu_tanh_grad,
    "gelu_pytorch_tanh": _gelu_tanh_grad,
    "relu": lambda x: (x > 0).to(x.dtype),
    "silu": _silu_grad,
    "swish": _silu_grad,
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
    acc = torch.promote_types(x2d.dtype, torch.float32)
    return act(inp.to(acc)).to(x2d.dtype) * gate


def geglu_plain(x2d: torch.Tensor, wi: torch.Tensor, activation: str) -> torch.Tensor:
    """x2d [M, K] @ wi[2I, K]ᵀ rounded to x's dtype → act(first half) in at
    least fp32, rounded, · second half: [M, I]."""
    act = lookup_activation(activation)[1]
    inp, gate = F.linear(x2d, wi).chunk(2, dim=-1)
    acc = torch.promote_types(x2d.dtype, torch.float32)
    return act(inp.to(acc)).to(x2d.dtype) * gate


def _normalized(x2d, scale, eps):
    """(xn, h, rstd): xn = LN(x)·s rounded to x's dtype (the forward's
    rounding point), promoted back to the statistics' dtype."""
    h, rstd = ln_rows(x2d, eps)
    xn = (h * scale.to(h.dtype)).to(x2d.dtype).to(h.dtype)
    return xn, h, rstd


def ln_matmul_bwd_plain(
    x2d: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dw) of ``ln_matmul_plain`` for the cotangent g [M, N]:
    dw = gᵀ·xn rounded once to w's dtype, dy = g·w in fp32, then the
    LN adjoint."""
    xn, h, rstd = _normalized(x2d, scale, eps)
    gf = g.to(h.dtype)
    dw = (gf.t() @ xn).to(w.dtype)
    dx, dscale = ln_adjoint(h, rstd, scale, gf @ w.to(h.dtype))
    return dx.to(x2d.dtype), dscale.to(scale.dtype), dw


def ln_geglu_bwd_plain(
    x2d: torch.Tensor, scale: torch.Tensor, wi: torch.Tensor, g: torch.Tensor,
    activation: str, eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dwi) of ``ln_geglu_plain`` for the cotangent g [M, I]:
    recompute [inp | gate] rounded to x's dtype, then a = act(inp) rounded,
    da = act′(inp), gi = g·da·gate and gg = g·a, each rounded; dwi =
    [gi | gg]ᵀ·xn rounded once, dy = [gi | gg]·wi in fp32, the LN adjoint."""
    act = lookup_activation(activation)[1]
    act_grad = ACTIVATION_GRADS[activation]
    dtype = x2d.dtype
    xn, h, rstd = _normalized(x2d, scale, eps)
    inp, gate = (xn @ wi.to(h.dtype).t()).to(dtype).to(h.dtype).chunk(2, dim=-1)
    a = act(inp).to(dtype).to(h.dtype)
    gf = g.to(h.dtype)
    cot = torch.cat([(gf * act_grad(inp) * gate).to(dtype), (gf * a).to(dtype)], dim=-1)
    cot = cot.to(h.dtype)
    dwi = (cot.t() @ xn).to(wi.dtype)
    dx, dscale = ln_adjoint(h, rstd, scale, cot @ wi.to(h.dtype))
    return dx.to(dtype), dscale.to(scale.dtype), dwi


def ln_geglu_wo_plain(
    x2d: torch.Tensor, scale: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
    activation: str, eps: float = 1e-5,
) -> torch.Tensor:
    """(act(LN(x2d)·scale @ wi[:I]ᵀ) · (LN(x2d)·scale @ wi[I:]ᵀ)) @ wo[K, I]ᵀ →
    [M, K], step by step with kernel 8's rounding points: the normalized
    rows, inp and gate rounded to x's dtype, act(inp) rounded, h = act·gate in
    x's dtype, every product summed in at least fp32 and rounded once."""
    dtype = x2d.dtype
    xn, _, _ = _normalized(x2d, scale, eps)
    acc = xn.dtype
    act = lookup_activation(activation)[1]
    inp, gate = (xn @ wi.to(acc).t()).to(dtype).chunk(2, dim=-1)
    h = act(inp.to(acc)).to(dtype) * gate
    return (h.to(acc) @ wo.to(acc).t()).to(dtype)


def ln_geglu_wo_bwd_plain(
    x2d: torch.Tensor, scale: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
    g: torch.Tensor, activation: str, eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dwi, dwo) of ``ln_geglu_wo_plain`` for the cotangent g
    [M, K], as kernel 13 computes them: recompute xn, [inp | gate] rounded,
    a = act(inp) rounded, h = a·gate rounded; dwo = gᵀ·h; dh = g·wo in fp32;
    gi = dh·act′(inp)·gate and gg = dh·a, each rounded; dwi = [gi | gg]ᵀ·xn,
    dy = [gi | gg]·wi in fp32, then the LN adjoint."""
    act = lookup_activation(activation)[1]
    act_grad = ACTIVATION_GRADS[activation]
    dtype = x2d.dtype
    xn, hn, rstd = _normalized(x2d, scale, eps)
    acc = hn.dtype
    inp, gate = (xn @ wi.to(acc).t()).to(dtype).to(acc).chunk(2, dim=-1)
    a = act(inp).to(dtype).to(acc)
    h = (a * gate).to(dtype).to(acc)
    gf = g.to(dtype).to(acc)
    dwo = (gf.t() @ h).to(wo.dtype)
    dh = gf @ wo.to(acc)
    cot = torch.cat([(dh * act_grad(inp) * gate).to(dtype), (dh * a).to(dtype)], dim=-1).to(acc)
    dwi = (cot.t() @ xn).to(wi.dtype)
    dx, dscale = ln_adjoint(hn, rstd, scale, cot @ wi.to(acc))
    return dx.to(dtype), dscale.to(scale.dtype), dwi, dwo


# The widest hidden size the whole-MLP kernels take: in bf16 a cluster of at
# most 8 CTAs of 128 output columns each (mlp_tail.cuh), in fp32 a row
# tile's output in registers (64 columns a thread, 16 threads a row).
GEGLU_WO_MAX_HIDDEN = kernels.MLP_TAIL_OUT_COLS * kernels.MLP_TAIL_MAX_CLUSTER


def geglu_wo_supported(k: int, intermediate: int, dtype: torch.dtype, activation: str) -> bool:
    """True where kernels 8 and 13 run on the card: an activation they know,
    fp32 or bf16, K up to 1024, and in bf16 K a multiple of 16 (one
    tensor-core step) and I a multiple of 8 (16-byte rows)."""
    if activation not in ACTIVATIONS or k > GEGLU_WO_MAX_HIDDEN:
        return False
    if dtype == torch.float32:
        return True
    return dtype == torch.bfloat16 and k % 16 == 0 and intermediate % 8 == 0


def _check_operands(x2d, scale, w, rows_of_w_per_out):
    """``scale`` is None for the GEMM without a norm."""
    m, k = x2d.shape
    if (scale is not None and scale.shape != (k,)) or w.dim() != 2 or w.shape[1] != k:
        raise ValueError(
            f"shapes: x {tuple(x2d.shape)}, scale {None if scale is None else tuple(scale.shape)}, "
            f"w {tuple(w.shape)}"
        )
    if w.shape[0] % rows_of_w_per_out:
        raise ValueError(f"w rows {w.shape[0]} not divisible by {rows_of_w_per_out}")
    others = [t for t in (scale, w) if t is not None]
    for t in others:
        if t.dtype != x2d.dtype or t.device != x2d.device:
            raise ValueError(f"operands must share x's dtype {x2d.dtype} and device {x2d.device}")
    if x2d.dtype == torch.bfloat16:
        if k % 8:
            raise ValueError(f"the bf16 kernel takes K % 8 == 0, not {k}")
        kernels.require_16_byte_rows(x2d, *others)


def _matmul_kernel(x2d, scale, w, eps):
    m, k = x2d.shape
    out = torch.empty((m, w.shape[0]), dtype=x2d.dtype, device=x2d.device)
    xn = torch.empty_like(x2d)  # scratch: the normalized rows
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_ln_matmul(
            kernels.ptr(x2d), kernels.ptr(scale), kernels.ptr(w), kernels.ptr(out),
            kernels.ptr(xn), m, k, w.shape[0], float(eps), kernels.dtype_code(x2d),
            kernels.stream(x2d),
        )
    kernels.check(code, "ln_matmul")
    return out


def _geglu_kernel(x2d, scale, wi, act_code, eps):
    m, k = x2d.shape
    intermediate = wi.shape[0] // 2
    out = torch.empty((m, intermediate), dtype=x2d.dtype, device=x2d.device)
    xn = torch.empty_like(x2d)  # scratch: the normalized rows
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_ln_geglu(
            kernels.ptr(x2d), kernels.ptr(scale), kernels.ptr(wi), kernels.ptr(out),
            kernels.ptr(xn), m, k, intermediate, float(eps), act_code,
            kernels.dtype_code(x2d), kernels.stream(x2d),
        )
    kernels.check(code, "ln_geglu")
    return out


def _bare_geglu_kernel(x2d, wi, act_code):
    m, k = x2d.shape
    intermediate = wi.shape[0] // 2
    out = torch.empty((m, intermediate), dtype=x2d.dtype, device=x2d.device)
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_geglu(
            kernels.ptr(x2d), kernels.ptr(wi), kernels.ptr(out), m, k, intermediate,
            act_code, kernels.dtype_code(x2d), kernels.stream(x2d),
        )
    kernels.check(code, "geglu")
    return out


def _bare_geglu_forward(x2d, wi, activation):
    """Kernel 6 on CUDA tensors, its plain version on CPU tensors."""
    act_code = lookup_activation(activation)[0]
    if kernels.on_cuda(x2d):
        x2d, wi = x2d.contiguous(), wi.contiguous()
        _check_operands(x2d, None, wi, 2)
        return _bare_geglu_kernel(x2d, wi, act_code)
    kernels.count_plain("geglu")
    return geglu_plain(x2d, wi, activation)


def _matmul_forward(x2d, scale, w, eps):
    """(out, x2d, scale, w): kernel 2 on CUDA tensors, the plain version on
    CPU tensors; the operands as the backward takes them."""
    if kernels.on_cuda(x2d):
        x2d, scale, w = x2d.contiguous(), scale.contiguous(), w.contiguous()
        _check_operands(x2d, scale, w, 1)
        return _matmul_kernel(x2d, scale, w, eps), x2d, scale, w
    kernels.count_plain("ln_matmul")
    return ln_matmul_plain(x2d, scale, w, eps), x2d, scale, w


def _geglu_forward(x2d, scale, wi, activation, eps):
    """(out, x2d, scale, wi): kernel 4 on CUDA tensors, the plain version on
    CPU tensors; the operands as the backward takes them."""
    act_code = lookup_activation(activation)[0]
    if kernels.on_cuda(x2d):
        x2d, scale, wi = x2d.contiguous(), scale.contiguous(), wi.contiguous()
        _check_operands(x2d, scale, wi, 2)
        return _geglu_kernel(x2d, scale, wi, act_code, eps), x2d, scale, wi
    kernels.count_plain("ln_geglu")
    return ln_geglu_plain(x2d, scale, wi, activation, eps), x2d, scale, wi


def _adjoint_operands(x2d, scale):
    """x2d and scale as the LN adjoint that ends each backward kernel takes
    them (ln_adjoint.cuh): a copy where its register instance needs one
    that is 16-byte aligned. Only fp32 can need it here: _check_operands has
    already refused a misaligned bf16 operand."""
    return (kernels.ln_adjoint_aligned(t, x2d.shape[1]) for t in (x2d, scale))


def _bwd_scratch(x2d, *dw_products):
    """xn (x's dtype), dy (fp32), the dscale partial rows and, in bf16, the
    fp32 partial sums of the weight gradients ``dw_products`` ((m, n, k)
    each; ``kernels.dw_partial``); None in fp32, which sums on FMA."""
    m, k = x2d.shape
    return (
        torch.empty_like(x2d),
        torch.empty((m, k), dtype=torch.float32, device=x2d.device),
        kernels.ln_adjoint_partial(m, k, x2d.device),
        kernels.dw_partial(dw_products, x2d.device) if x2d.dtype == torch.bfloat16 else None,
    )


def _ln_gemm_bwd_scratch(x2d, n):
    """The scratch of kernels 12 and 11 (dW [n, k]), by route
    (``kernels.ln_gemm_bwd_fused``), a function of the shape and dtype
    alone: (xn, rows, dy, partial, dw_partial). Fused: rows, fp32
    ``kernels.ln_gemm_bwd_rows(m, k)`` words (each row's mean and rstd, the
    row tiles' exchanged sums and arrival counts), and dscale's partial rows
    [ceil(m / 128), k], no dy. Split: ``_bwd_scratch``'s dy [m, k] fp32 and
    partial rows, no rows."""
    m, k = x2d.shape
    if not kernels.ln_gemm_bwd_fused(k, x2d.dtype):
        xn, dy, partial, dw_partial = _bwd_scratch(x2d, (m, n, k))
        return xn, None, dy, partial, dw_partial
    return (
        torch.empty_like(x2d),
        torch.empty(kernels.ln_gemm_bwd_rows(m, k), dtype=torch.float32, device=x2d.device),
        None,
        kernels.ln_gemm_bwd_partial(m, k, x2d.device),
        kernels.dw_partial([(m, n, k)], x2d.device),
    )


def _check_bwd(x2d, g, n):
    if g.shape != (x2d.shape[0], n) or g.dtype != x2d.dtype:
        raise ValueError(f"cotangent must be [{x2d.shape[0]}, {n}] {x2d.dtype}")
    if x2d.dtype == torch.bfloat16:
        if n % 8:
            raise ValueError(f"the bf16 backward takes output widths % 8 == 0, not {n}")
        kernels.require_16_byte_rows(g)


def _matmul_bwd_kernel(x2d, scale, w, g, eps):
    m, k = x2d.shape
    n = w.shape[0]
    _check_bwd(x2d, g, n)
    dx, dw, dscale = torch.empty_like(x2d), torch.empty_like(w), torch.empty_like(scale)
    xn, rows, dy, partial, dw_partial = _ln_gemm_bwd_scratch(x2d, n)
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_ln_matmul_bwd(
            *(kernels.ptr(t) for t in (x2d, scale, w, g, dx, dw, dscale, xn, rows, dy, partial,
                                       dw_partial)),
            m, k, n, kernels.dw_chunk_rows(m, n, k), float(eps), kernels.dtype_code(x2d),
            kernels.stream(x2d),
        )
    kernels.check(code, "ln_matmul_bwd")
    return dx, dscale, dw


def _geglu_bwd_kernel(x2d, scale, wi, g, act_code, eps):
    m, k = x2d.shape
    intermediate = wi.shape[0] // 2
    _check_bwd(x2d, g, intermediate)
    dx, dwi, dscale = torch.empty_like(x2d), torch.empty_like(wi), torch.empty_like(scale)
    xn, rows, dy, partial, dw_partial = _ln_gemm_bwd_scratch(x2d, 2 * intermediate)
    cot = torch.empty((m, 2 * intermediate), dtype=x2d.dtype, device=x2d.device)  # [gi | gg]
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_ln_geglu_bwd(
            *(kernels.ptr(t) for t in (x2d, scale, wi, g, dx, dwi, dscale, xn, cot, rows, dy,
                                       partial, dw_partial)),
            m, k, intermediate, kernels.dw_chunk_rows(m, 2 * intermediate, k), float(eps),
            act_code, kernels.dtype_code(x2d), kernels.stream(x2d),
        )
    kernels.check(code, "ln_geglu_bwd")
    return dx, dscale, dwi


def ln_matmul_bwd(
    x2d: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dw) of ``ln_matmul``: kernel 12 for CUDA tensors, the
    plain version for CPU tensors."""
    if not kernels.on_cuda(x2d):
        kernels.count_plain("ln_matmul_bwd")
        return ln_matmul_bwd_plain(x2d, scale, w, g, eps)
    x2d, scale, w = x2d.contiguous(), scale.contiguous(), w.contiguous()
    _check_operands(x2d, scale, w, 1)
    x2d, scale = _adjoint_operands(x2d, scale)
    return _matmul_bwd_kernel(x2d, scale, w, g.contiguous(), eps)


def ln_geglu_bwd(
    x2d: torch.Tensor, scale: torch.Tensor, wi: torch.Tensor, g: torch.Tensor,
    activation: str, eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dwi) of ``ln_geglu``: kernel 11 for CUDA tensors, the
    plain version for CPU tensors."""
    act_code = lookup_activation(activation)[0]
    if not kernels.on_cuda(x2d):
        kernels.count_plain("ln_geglu_bwd")
        return ln_geglu_bwd_plain(x2d, scale, wi, g, activation, eps)
    x2d, scale, wi = x2d.contiguous(), scale.contiguous(), wi.contiguous()
    _check_operands(x2d, scale, wi, 2)
    x2d, scale = _adjoint_operands(x2d, scale)
    return _geglu_bwd_kernel(x2d, scale, wi, g.contiguous(), act_code, eps)


def _check_wo(x2d, wi, wo, activation):
    k, intermediate = x2d.shape[1], wi.shape[0] // 2
    if wo.shape != (k, intermediate) or wo.dtype != x2d.dtype or wo.device != x2d.device:
        raise ValueError(
            f"wo must be [{k}, {intermediate}] {x2d.dtype} on {x2d.device}; got "
            f"{tuple(wo.shape)} {wo.dtype} on {wo.device}"
        )
    kernels.dtype_code(x2d)
    if not geglu_wo_supported(k, intermediate, x2d.dtype, activation):
        raise ValueError(
            f"the whole-MLP kernels take K <= {GEGLU_WO_MAX_HIDDEN} (bf16: K % 16 == 0 and "
            f"I % 8 == 0); got K={k}, I={intermediate}, {x2d.dtype}"
        )
    if x2d.dtype == torch.bfloat16:
        kernels.require_16_byte_rows(wo)


def _geglu_wo_operands(x2d, scale, wi, wo, activation):
    """The operands contiguous and checked, for a CUDA launch."""
    x2d, scale, wi, wo = (t.contiguous() for t in (x2d, scale, wi, wo))
    _check_operands(x2d, scale, wi, 2)
    _check_wo(x2d, wi, wo, activation)
    return x2d, scale, wi, wo


def _geglu_wo_forward(x2d, scale, wi, wo, activation, eps):
    """(out, x2d, scale, wi, wo): kernel 8 on CUDA tensors, the plain version
    on CPU tensors; the operands as the backward takes them."""
    act_code = lookup_activation(activation)[0]
    if not kernels.on_cuda(x2d):
        kernels.count_plain("ln_geglu_wo")
        return ln_geglu_wo_plain(x2d, scale, wi, wo, activation, eps), x2d, scale, wi, wo
    x2d, scale, wi, wo = _geglu_wo_operands(x2d, scale, wi, wo, activation)
    m, k = x2d.shape
    out, xn = torch.empty_like(x2d), torch.empty_like(x2d)  # xn: scratch, the normalized rows
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_ln_geglu_wo(
            *(kernels.ptr(t) for t in (x2d, scale, wi, wo, out, xn)), m, k, wi.shape[0] // 2,
            float(eps), act_code, kernels.dtype_code(x2d), kernels.stream(x2d),
        )
    kernels.check(code, "ln_geglu_wo")
    return out, x2d, scale, wi, wo


def ln_geglu_wo_bwd(
    x2d: torch.Tensor, scale: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
    g: torch.Tensor, activation: str, eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dwi, dwo) of ``ln_geglu_wo``: kernel 13 for CUDA tensors,
    the plain version for CPU tensors."""
    act_code = lookup_activation(activation)[0]
    if not kernels.on_cuda(x2d):
        kernels.count_plain("ln_geglu_wo_bwd")
        return ln_geglu_wo_bwd_plain(x2d, scale, wi, wo, g, activation, eps)
    x2d, scale, wi, wo = _geglu_wo_operands(x2d, scale, wi, wo, activation)
    x2d, scale = _adjoint_operands(x2d, scale)
    m, k = x2d.shape
    intermediate = wi.shape[0] // 2
    g = g.to(x2d.dtype).contiguous()
    _check_bwd(x2d, g, k)
    dx, dwi, dwo, dscale = (torch.empty_like(t) for t in (x2d, wi, wo, scale))
    dw_wi, dw_wo = (m, 2 * intermediate, k), (m, k, intermediate)  # dWi, dWo: (m, n, k)
    xn, dy, partial, dw_partial = _bwd_scratch(x2d, dw_wi, dw_wo)
    h = torch.empty((m, intermediate), dtype=x2d.dtype, device=x2d.device)
    cot = torch.empty((m, 2 * intermediate), dtype=x2d.dtype, device=x2d.device)
    with torch.cuda.device(x2d.device):
        code = kernels.library().opt_ln_geglu_wo_bwd(
            *(kernels.ptr(t) for t in (x2d, scale, wi, wo, g, dx, dwi, dwo, dscale, xn, h, cot,
                                       dy, partial, dw_partial)),
            m, k, intermediate, kernels.dw_chunk_rows(*dw_wi), kernels.dw_chunk_rows(*dw_wo),
            float(eps), act_code, kernels.dtype_code(x2d), kernels.stream(x2d),
        )
    kernels.check(code, "ln_geglu_wo_bwd")
    return dx, dscale, dwi, dwo


class LnMatmulFunction(torch.autograd.Function):
    """LN(x2d)·scale @ wᵀ with its adjoint: kernels 2 and 12 for CUDA
    tensors, the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, x2d, scale, w, eps):
        out, *operands = _matmul_forward(x2d, scale, w, eps)
        ctx.save_for_backward(*operands)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, scale, w = ctx.saved_tensors
        return (*ln_matmul_bwd(x2d, scale, w, g, ctx.eps), None)


class LnGegluFunction(torch.autograd.Function):
    """act(LN(x2d)·scale @ wi[:I]ᵀ)·(LN(x2d)·scale @ wi[I:]ᵀ) with its
    adjoint: kernels 4 and 11 for CUDA tensors, the plain versions for CPU
    tensors."""

    @staticmethod
    def forward(ctx, x2d, scale, wi, activation, eps):
        out, *operands = _geglu_forward(x2d, scale, wi, activation, eps)
        ctx.save_for_backward(*operands)
        ctx.activation, ctx.eps = activation, eps
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, scale, wi = ctx.saved_tensors
        return (*ln_geglu_bwd(x2d, scale, wi, g, ctx.activation, ctx.eps), None, None)


def ln_matmul(
    x2d: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LN(x2d)·scale @ wᵀ: the CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors; differentiable in x2d, scale and w."""
    if kernels.records_grad(x2d, scale, w):
        return LnMatmulFunction.apply(x2d, scale, w, eps)
    return _matmul_forward(x2d, scale, w, eps)[0]


def ln_geglu(
    x2d: torch.Tensor, scale: torch.Tensor, wi: torch.Tensor, activation: str,
    eps: float = 1e-5,
) -> torch.Tensor:
    """act(LN(x2d)·scale @ wi[:I]ᵀ) · (LN(x2d)·scale @ wi[I:]ᵀ): the CUDA
    kernels for CUDA tensors, the plain versions for CPU tensors;
    differentiable in x2d, scale and wi."""
    if kernels.records_grad(x2d, scale, wi):
        return LnGegluFunction.apply(x2d, scale, wi, activation, eps)
    return _geglu_forward(x2d, scale, wi, activation, eps)[0]


class LnGegluWoFunction(torch.autograd.Function):
    """The whole MLP, (act(LN(x2d)·scale @ wi[:I]ᵀ)·(LN(x2d)·scale @ wi[I:]ᵀ))
    @ woᵀ, with its adjoint: kernels 8 and 13 for CUDA tensors, the plain
    versions for CPU tensors. With ``fuse_forward`` false the forward is
    kernel 4 and a plain product with wo, and only the backward is fused."""

    @staticmethod
    def forward(ctx, x2d, scale, wi, wo, activation, eps, fuse_forward):
        if fuse_forward:
            out, *operands = _geglu_wo_forward(x2d, scale, wi, wo, activation, eps)
        else:
            hidden, *operands = _geglu_forward(x2d, scale, wi, activation, eps)
            out = F.linear(hidden, wo)
            operands.append(wo)
        ctx.save_for_backward(*operands)
        ctx.activation, ctx.eps = activation, eps
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, scale, wi, wo = ctx.saved_tensors
        grads = ln_geglu_wo_bwd(x2d, scale, wi, wo, g, ctx.activation, ctx.eps)
        return (*grads, None, None, None)


def ln_geglu_wo(
    x2d: torch.Tensor, scale: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
    activation: str, eps: float = 1e-5, *, fuse_forward: bool = True,
) -> torch.Tensor:
    """The whole MLP on rows x2d [M, K] → [M, K], wi [2I, K] and wo [K, I]
    in torch's layout: the CUDA kernels for CUDA tensors, the plain versions
    for CPU tensors; differentiable in x2d, scale, wi and wo. ``fuse_forward``
    false computes the forward as ``ln_geglu`` and a plain product with wo
    and fuses only the backward."""
    if kernels.records_grad(x2d, scale, wi, wo):
        return LnGegluWoFunction.apply(x2d, scale, wi, wo, activation, eps, fuse_forward)
    if fuse_forward:
        return _geglu_wo_forward(x2d, scale, wi, wo, activation, eps)[0]
    return F.linear(_geglu_forward(x2d, scale, wi, activation, eps)[0], wo)


class GegluFunction(torch.autograd.Function):
    """act(x2d @ wi[:I]ᵀ)·(x2d @ wi[I:]ᵀ): kernel 6 for CUDA tensors, the
    plain version for CPU tensors. The backward differentiates the plain
    composition on either device, as the JAX package's ``_geglu_bwd`` takes
    ``jax.vjp`` of its reference composition."""

    @staticmethod
    def forward(ctx, x2d, wi, activation):
        ctx.save_for_backward(x2d, wi)
        ctx.activation = activation
        return _bare_geglu_forward(x2d, wi, activation)

    @staticmethod
    def backward(ctx, g):
        x2d, wi = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = geglu_plain(x2d, wi, ctx.activation)
        return (*torch.autograd.grad(out, (x2d, wi), g.to(out.dtype)), None)


def geglu(x2d: torch.Tensor, wi: torch.Tensor, activation: str) -> torch.Tensor:
    """act(x2d @ wi[:I]ᵀ) · (x2d @ wi[I:]ᵀ): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; differentiable in x2d and
    wi."""
    if kernels.records_grad(x2d, wi):
        return GegluFunction.apply(x2d, wi, activation)
    return _bare_geglu_forward(x2d, wi, activation)
