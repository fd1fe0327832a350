from .attention import attention_bias, attention_plain
from .flash_attention import (
    FlashAttentionPackedFunction,
    attention_packed_bwd_plain,
    attention_packed_plain,
    flash_attention_packed,
    flash_attention_packed_bwd,
    flash_attention_packed_lse,
)
from .geglu import (
    LnGegluFunction,
    LnMatmulFunction,
    ln_geglu,
    ln_geglu_bwd,
    ln_geglu_bwd_plain,
    ln_geglu_plain,
    ln_matmul,
    ln_matmul_bwd,
    ln_matmul_bwd_plain,
    ln_matmul_plain,
)
from .layer_norm import (
    LayerNormFunction,
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_plain,
    layer_norm_plain,
)
from .rotary import apply_rotary, rope_tables, rotary_adjoint
from .segment import fragment_mean_pool_ranges

__all__ = [
    "attention_bias",
    "attention_plain",
    "FlashAttentionPackedFunction",
    "attention_packed_bwd_plain",
    "attention_packed_plain",
    "flash_attention_packed",
    "flash_attention_packed_bwd",
    "flash_attention_packed_lse",
    "LnGegluFunction",
    "LnMatmulFunction",
    "ln_geglu",
    "ln_geglu_bwd",
    "ln_geglu_bwd_plain",
    "ln_geglu_plain",
    "ln_matmul",
    "ln_matmul_bwd",
    "ln_matmul_bwd_plain",
    "ln_matmul_plain",
    "LayerNormFunction",
    "layer_norm",
    "layer_norm_bwd",
    "layer_norm_bwd_plain",
    "layer_norm_plain",
    "apply_rotary",
    "rope_tables",
    "rotary_adjoint",
    "fragment_mean_pool_ranges",
]
