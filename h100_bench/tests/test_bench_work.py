"""The work counts against hand counts at a tiny configuration."""

from __future__ import annotations

import pytest

from h100_bench.lib.work import (
    BF16,
    PEAK_BYTES,
    PEAK_FLOPS,
    Work,
    attended_pairs,
    forward_work,
    training_work,
)

TINY = {"hidden_size": 8, "intermediate_size": 12, "num_attention_heads": 2,
        "num_hidden_layers": 3, "global_attn_every_n_layers": 3, "local_attention": 4}


@pytest.mark.parametrize("length", [1, 2, 3, 4, 5, 9, 64])
@pytest.mark.parametrize("window", [None, 1, 2, 64])
def test_attended_pairs_against_brute_force(length, window):
    brute = sum(1 for i in range(length) for j in range(length)
                if window is None or abs(i - j) <= window)
    assert attended_pairs(length, window) == brute


def test_forward_work_by_hand():
    # Two sequences of 3 and 5 tokens, one forward batch.
    w = forward_work(TINY, [3, 5], batch_rows=32)
    h, i, t = 8, 12, 8
    per_token = 2 * (h * 3 * h + h * h + h * 2 * i + i * h)
    heads = 2 * 2 * (h * h + h) + 2 * t * h * 2
    assert w.flops["gemm"] == 3 * t * per_token + heads
    weights = h * 3 * h + h * h + h * 2 * i + i * h
    acts = t * ((h + 3 * h) + (h + h) + (h + 2 * i) + (i + h))
    head_bytes = 2 * 2 * h + t * (h + 2) + (h * h + 3 * h)
    assert w.bytes["gemm"] == BF16 * (3 * (acts + weights) + head_bytes)
    # Layer 0 global (all pairs), layers 1, 2 local with window 2.
    d_heads = 4 * h
    assert w.flops["attention_global"] == d_heads * (9 + 25)
    assert w.flops["attention_local"] == 2 * d_heads * (attended_pairs(3, 2) + attended_pairs(5, 2))
    assert w.bytes["attention_local"] == 2 * BF16 * 4 * t * h


def test_weights_count_once_per_batch():
    one = forward_work(TINY, [4] * 4, batch_rows=4)
    two = forward_work(TINY, [4] * 4, batch_rows=2)
    weights = 3 * (8 * 24 + 64 + 8 * 24 + 12 * 8) + 64 + 24
    assert two.bytes["gemm"] - one.bytes["gemm"] == BF16 * weights


def test_training_is_three_forwards_and_the_bound():
    f, t = forward_work(TINY, [7, 2], 8), training_work(TINY, [7, 2], 8)
    assert t.total_flops() == pytest.approx(3 * f.total_flops())
    w = Work()
    w.add("a", PEAK_FLOPS, 0.0)
    w.add("b", 0.0, 2 * PEAK_BYTES)
    assert w.bound_s(["a"]) == pytest.approx(1.0)
    assert w.bound_s(["a", "b"]) == pytest.approx(2.0)
