"""The port's plain op versions, forward and backward, against the JAX
package's Pallas kernels.

Each plain PyTorch function (what the port runs on a CPU, and what its CUDA
kernel is held against on the card) is compared with the JAX function that
reaches the Pallas kernel, run in interpret mode on the CPU as the JAX
package's own kernel tests run it. Inputs come from numpy seeds; fp32;
tolerance atol = rtol = 1e-5 (different summation orders in fp32).
"""

import jax
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
    attention_packed_bwd_plain,
    attention_packed_plain,
    flash_attention_packed,
    flash_attention_packed_bwd,
    flash_attention_packed_lse,
    fragment_mean_pool_ranges,
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_plain,
    layer_norm_plain,
    ln_geglu,
    ln_geglu_bwd_plain,
    ln_geglu_plain,
    ln_matmul,
    ln_matmul_bwd_plain,
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


# --- backward: the plain adjoints against the Pallas backward kernels -------
#
# jax.vjp of each JAX function reaches its Pallas backward kernel (rows 10,
# 11, 12 and 14 of the TPU kernel table) under interpret mode; the port's
# plain backward gets the same inputs. fp32, atol = rtol = 1e-5. The GEMM
# cotangents are drawn at 0.1, so that dW (a sum over 256 rows) stays O(1)
# and the tolerance measures summation order, not the size of the sums.


def test_layer_norm_bwd_plain_matches_pallas():
    from open_provence_tpu.ops import layer_norm as jax_ln

    x, scale = _ln_inputs(256, 128, seed=11)
    g = np.random.default_rng(12).normal(size=x.shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref_dx, ref_ds = jax_ln._ln_bwd(1e-5, (jnp.asarray(x), jnp.asarray(scale)), jnp.asarray(g))
    for fn in (layer_norm_bwd_plain, layer_norm_bwd):
        dx, ds = fn(_t(x), _t(scale), _t(g))
        np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), **TOL)
        np.testing.assert_allclose(ds.numpy(), np.asarray(ref_ds), **TOL)


def _vjp_pallas(fn, args, g):
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
        return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def test_ln_matmul_bwd_plain_matches_pallas():
    x, scale = _ln_inputs(256, 128, seed=13)
    w_kn = (np.random.default_rng(14).normal(size=(128, 384)) * 0.05).astype(np.float32)
    g = (np.random.default_rng(15).normal(size=(256, 384)) * 0.1).astype(np.float32)
    ref_dx, ref_ds, ref_dw = _vjp_pallas(
        lambda a, s, w: fused_ln_matmul(a, s, w, 1e-5), (x, scale, w_kn), g
    )
    dx, ds, dw = ln_matmul_bwd_plain(_t(x), _t(scale), _t(w_kn.T), _t(g))
    np.testing.assert_allclose(dx.numpy(), ref_dx, **TOL)
    np.testing.assert_allclose(ds.numpy(), ref_ds, **TOL)
    np.testing.assert_allclose(dw.numpy(), ref_dw.T, **TOL)


@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh", "silu"])
def test_ln_geglu_bwd_plain_matches_pallas(act):
    x, scale = _ln_inputs(256, 128, seed=16)
    wi_kn = (np.random.default_rng(17).normal(size=(128, 128)) * 0.1).astype(np.float32)
    g = (np.random.default_rng(18).normal(size=(256, 64)) * 0.1).astype(np.float32)
    ref_dx, ref_ds, ref_dwi = _vjp_pallas(
        lambda a, s, w: fused_ln_geglu(a, s, w, act, 1e-5), (x, scale, wi_kn), g
    )
    dx, ds, dwi = ln_geglu_bwd_plain(_t(x), _t(scale), _t(wi_kn.T), _t(g), act)
    np.testing.assert_allclose(dx.numpy(), ref_dx, **TOL)
    np.testing.assert_allclose(ds.numpy(), ref_ds, **TOL)
    np.testing.assert_allclose(dwi.numpy(), ref_dwi.T, **TOL)


@pytest.mark.parametrize("window", [None, 32])
def test_attention_packed_bwd_plain_matches_pallas(window):
    """The fused one-pass backward (S ≤ 1024). The cotangent is zero on
    padded rows, as the model's loss makes it: a padded row whose keys are
    all masked has no meaningful softmax on either side."""
    batch, seq, heads, dim = 2, 256, 2, 64
    rng = np.random.default_rng(19)
    qkv = rng.normal(size=(batch, seq, 3 * heads * dim)).astype(np.float32)
    mask = np.ones((batch, seq), np.int32)
    mask[0, seq - 77:] = 0
    g = rng.normal(size=(batch, seq, heads * dim)).astype(np.float32) * mask[..., None]
    cos, sin = jax_rope_tables(seq, dim, 10000.0)
    (ref,) = _vjp_pallas(
        lambda q: jax_flash_packed(
            q, num_heads=heads, padding_mask=jnp.asarray(mask), window=window, rope=(cos, sin)
        ),
        (qkv,),
        g,
    )
    kw = dict(num_heads=heads, padding_mask=_t(mask), window=window,
              rope=rope_tables(seq, dim, 10000.0))
    out, lse = flash_attention_packed_lse(_t(qkv), **kw)
    for fn in (attention_packed_bwd_plain, flash_attention_packed_bwd):
        dqkv = fn(_t(qkv), _t(g), out, lse, **kw).numpy()
        assert dqkv.shape == qkv.shape
        np.testing.assert_allclose(dqkv, ref, **TOL)


def _gradcheck_inputs(seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(6, 16, generator=gen, dtype=torch.float64).requires_grad_()
    s = (torch.randn(16, generator=gen, dtype=torch.float64) + 1).requires_grad_()
    w = torch.randn(24, 16, generator=gen, dtype=torch.float64).requires_grad_()
    return x, s, w


@pytest.mark.parametrize("which", ["layer_norm", "ln_matmul", "ln_geglu", "attention"])
def test_plain_functions_gradcheck_fp64(which):
    """Each autograd Function's plain backward is the derivative of its plain
    forward (fp64, a few rows)."""
    x, s, w = _gradcheck_inputs(20)
    if which == "layer_norm":
        assert torch.autograd.gradcheck(lambda a, b: layer_norm(a, b), (x, s))
    elif which == "ln_matmul":
        assert torch.autograd.gradcheck(lambda a, b, c: ln_matmul(a, b, c), (x, s, w))
    elif which == "ln_geglu":
        for act in ("gelu", "gelu_pytorch_tanh", "silu"):
            assert torch.autograd.gradcheck(lambda a, b, c: ln_geglu(a, b, c, act), (x, s, w))
    else:
        batch, seq, heads, dim = 2, 9, 2, 8
        qkv = torch.randn(batch, seq, 3 * heads * dim, dtype=torch.float64).requires_grad_()
        mask = torch.ones(batch, seq, dtype=torch.int32)
        mask[1, 5:] = 0
        rope = rope_tables(seq, dim, 10000.0, torch.float64)
        for window in (None, 2):
            def f(q, window=window):
                out = flash_attention_packed(
                    q, num_heads=heads, padding_mask=mask, window=window, rope=rope
                )
                return out * mask[..., None]  # padded rows carry no cotangent

            # fast_mode checks random projections of the Jacobian, not all
            # of its 288 columns: the full check costs a forward each.
            assert torch.autograd.gradcheck(f, (qkv,), fast_mode=True)
