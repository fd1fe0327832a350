"""Fixed-shape bucketing for the inference engine.

The reference pads each inference batch to its longest block
(standalone:2832-2880). Here block inputs are padded to a small fixed set of
(batch, length) buckets, as in the JAX package: the kernels see a handful of
shapes, and the rows of one bucket batch together.
"""

from __future__ import annotations

import numpy as np


def length_buckets(max_length: int, step: int = 64) -> list[int]:
    """Bucket boundaries: multiples of ``step`` up to 1024, then geometric
    doubling up to max_length (always including max_length). Keeps the
    shape count logarithmic for long-context models (ModernBERT's 8192)
    while limiting padding waste at the common short lengths."""
    step = max(8, int(step))
    arithmetic_cap = min(max_length, 1024)
    buckets = list(range(step, arithmetic_cap + 1, step))
    size = buckets[-1] if buckets else step
    while size < max_length:
        size = min(size * 2, max_length)
        buckets.append(size)
    if not buckets or buckets[-1] != max_length:
        buckets.append(max_length)
    return buckets


def bucket_length(n: int, buckets: list[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def bucket_batch(n: int, max_batch: int) -> int:
    """Round batch size up to the next power of two, capped at max_batch."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def pad_block_batch(
    prepared: list[dict],
    seq_len: int,
    batch_size: int,
    pad_token_id: int,
) -> dict[str, np.ndarray]:
    """Pad a list of prepared block inputs to [batch_size, seq_len] arrays
    via the native fill op. Rows beyond len(prepared) are full padding
    (attention all zeros)."""
    from ..native import pad_block_batch_i32

    rows = [entry["input_ids"] for entry in prepared]
    input_ids, attention = pad_block_batch_i32(rows, seq_len, batch_size, pad_token_id)
    return {"input_ids": input_ids, "attention_mask": attention}
