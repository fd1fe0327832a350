from .attention import attention_bias, attention_plain
from .flash_attention import attention_packed_plain, flash_attention_packed
from .geglu import ln_geglu, ln_geglu_plain, ln_matmul, ln_matmul_plain
from .layer_norm import layer_norm, layer_norm_plain
from .rotary import apply_rotary, rope_tables
from .segment import fragment_mean_pool_ranges

__all__ = [
    "attention_bias",
    "attention_plain",
    "attention_packed_plain",
    "flash_attention_packed",
    "ln_geglu",
    "ln_geglu_plain",
    "ln_matmul",
    "ln_matmul_plain",
    "layer_norm",
    "layer_norm_plain",
    "apply_rotary",
    "rope_tables",
    "fragment_mean_pool_ranges",
]
