"""Precision of the reference's matrix products.

``Precision()`` is exact fp32 (with TF32 off, ``modernbert.fp32_mode``).
``Precision(CONTROL)`` is the control: both operands of every product
rounded to float8 e4m3 with one scale per tensor (its largest magnitude
mapped to 448), then multiplied in fp32. That is the step below the bf16
that the configurations state, the one a later change could be tempted
to take. Under autograd the rounding passes the gradient straight through,
so the control trains as an fp8 forward would.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
# The control's precision.
CONTROL = "fp8"


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale, back in fp32."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return t + (q - t).detach()


class Precision:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", CONTROL):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.kind == CONTROL:
            x, w = round_fp8(x), round_fp8(w)
        return F.linear(x, w)
