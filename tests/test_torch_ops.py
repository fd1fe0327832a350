"""The port's plain op versions against the JAX package's Pallas kernels.

Each plain PyTorch function (what the port runs on a CPU, and what its CUDA
kernel is held against on the card) is compared with the JAX function that
reaches the Pallas kernel, run in interpret mode on the CPU as the JAX
package's own kernel tests run it. Inputs come from numpy seeds; fp32;
tolerance atol = rtol = 1e-5 (different summation orders in fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from open_provence_tpu.ops.flash_attention import flash_attention_packed as jax_flash_packed
from open_provence_tpu.ops.geglu import fused_ln_geglu, fused_ln_matmul
from open_provence_tpu.ops.layer_norm import fused_layer_norm
from open_provence_tpu.ops.rotary import rope_tables as jax_rope_tables
from open_provence_tpu.ops.segment import fragment_mean_pool_ranges as jax_pool
from open_provence_tpu_torch.ops import (
    attention_packed_plain,
    flash_attention_packed,
    fragment_mean_pool_ranges,
    layer_norm,
    layer_norm_plain,
    ln_geglu,
    ln_geglu_plain,
    ln_matmul,
    ln_matmul_plain,
)
from open_provence_tpu_torch.ops.rotary import rope_tables

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _ln_inputs(rows=256, hidden=128, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, hidden)) * 3 + 1).astype(np.float32)
    scale = (rng.normal(size=(hidden,)) + 1).astype(np.float32)
    return x, scale


def test_layer_norm_plain_matches_pallas():
    x, scale = _ln_inputs(128, 256)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused_layer_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    np.testing.assert_allclose(layer_norm_plain(_t(x), _t(scale)).numpy(), ref, **TOL)
    # On a CPU tensor the dispatching wrapper is the plain version.
    np.testing.assert_allclose(layer_norm(_t(x), _t(scale)).numpy(), ref, **TOL)


def test_ln_matmul_plain_matches_pallas():
    x, scale = _ln_inputs(256, 128, seed=1)
    w_kn = (np.random.default_rng(2).normal(size=(128, 384)) * 0.05).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(
            fused_ln_matmul(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(w_kn), 1e-5)
        )
    w = _t(w_kn.T)  # torch [out, in]
    np.testing.assert_allclose(ln_matmul_plain(_t(x), _t(scale), w).numpy(), ref, **TOL)
    np.testing.assert_allclose(ln_matmul(_t(x), _t(scale), w).numpy(), ref, **TOL)


@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh", "relu", "silu"])
def test_ln_geglu_plain_matches_pallas(act):
    x, scale = _ln_inputs(256, 128, seed=3)
    wi_kn = (np.random.default_rng(4).normal(size=(128, 384)) * 0.05).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(
            fused_ln_geglu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(wi_kn), act, 1e-5)
        )
    wi = _t(wi_kn.T)  # [2I, K]: input half rows first, then gate half
    out = ln_geglu_plain(_t(x), _t(scale), wi, act).numpy()
    assert out.shape == (256, 192)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(ln_geglu(_t(x), _t(scale), wi, act).numpy(), ref, **TOL)


@pytest.mark.parametrize("seq", [128, 256])
@pytest.mark.parametrize("window", [None, 64])
def test_attention_packed_plain_matches_pallas(seq, window):
    batch, heads, dim = 2, 2, 64
    rng = np.random.default_rng(5 + seq)
    qkv = rng.normal(size=(batch, seq, 3 * heads * dim)).astype(np.float32)
    mask = np.ones((batch, seq), np.int32)
    mask[0, seq - 37:] = 0  # ragged: row 0 padded, row 1 full
    cos, sin = jax_rope_tables(seq, dim, 10000.0)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(
            jax_flash_packed(
                jnp.asarray(qkv), num_heads=heads, padding_mask=jnp.asarray(mask),
                window=window, rope=(cos, sin),
            )
        )
    rope = rope_tables(seq, dim, 10000.0)
    np.testing.assert_array_equal(rope[0].numpy(), np.asarray(cos))
    kwargs = dict(num_heads=heads, padding_mask=_t(mask), window=window, rope=rope)
    valid = mask.astype(bool)  # padded query rows are discarded by the model
    for fn in (attention_packed_plain, flash_attention_packed):
        out = fn(_t(qkv), **kwargs).numpy()
        assert out.shape == (batch, seq, heads * dim)
        np.testing.assert_allclose(out[valid], ref[valid], **TOL)


def test_fragment_mean_pool_matches_jax_with_empty_slots():
    rng = np.random.default_rng(7)
    probs = rng.uniform(size=(3, 64)).astype(np.float32)
    starts = np.array([[0, 5, 20, 0], [3, 3, 10, 40], [0, 0, 0, 0]], np.int32)
    ends = np.array([[5, 20, 64, 0], [3, 10, 40, 64], [1, 0, 0, 0]], np.int32)
    ref_means, ref_counts = (np.asarray(a) for a in jax_pool(probs, starts, ends))
    means, counts = fragment_mean_pool_ranges(_t(probs), _t(starts), _t(ends))
    np.testing.assert_allclose(means.numpy(), ref_means, **TOL)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    # Empty slots: mean 0, count 0 (the engine maps them to the 1.0 sentinel).
    empty = starts == ends
    assert np.all(means.numpy()[empty] == 0.0) and np.all(counts.numpy()[empty] == 0)
    direct = [probs[b, s:e].mean() for b, s, e in [(0, 5, 20), (1, 10, 40), (2, 0, 1)]]
    np.testing.assert_allclose(means.numpy()[[0, 1, 2], [1, 2, 0]], direct, **TOL)
