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


@pytest.mark.parametrize("rows,hidden,out", [(1, 200, 100), (77, 136, 452), (130, 200, 260)])
def test_ln_gemm_match_jax_at_tile_edges(rows, hidden, out):
    """Kernels 2 and 4 at the GEMM engine's tile edges scaled down: one row,
    a K that is no multiple of 64 and output widths that are no multiple of
    the tile (nor, for 452 and 100 columns, of 8). The Pallas kernels take
    only K and N in multiples of 128, so the JAX side is its plain reference,
    as the JAX package's own tests run it there. fp32, atol = rtol = 1e-5."""
    from open_provence_tpu.ops.geglu import _ln_geglu_reference, _ln_matmul_reference

    x, scale = _ln_inputs(rows, hidden, seed=rows)
    w_kn = (np.random.default_rng(out).normal(size=(hidden, out)) * 0.05).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(w_kn))
    w = _t(w_kn.T)  # torch [out, in]
    ref = np.asarray(_ln_matmul_reference(*args, 1e-5))
    np.testing.assert_allclose(ln_matmul(_t(x), _t(scale), w).numpy(), ref, **TOL)
    for act in ("gelu", "silu"):
        ref = np.asarray(_ln_geglu_reference(*args, act, 1e-5))
        got = ln_geglu(_t(x), _t(scale), w, act).numpy()
        assert got.shape == (rows, out // 2)
        np.testing.assert_allclose(got, ref, **TOL)


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


# (rows, hidden) of the LN adjoint's cases: the first is the original one;
# then the widths of the port's register instances (768, 1024), a multiple
# of 256 (256), a multiple of 8 that is not (264) and a width that is no
# multiple of 8 (36), at 1, 37 and 256 rows. The JAX package takes its
# Pallas kernel where hidden % 128 == 0 and rows % 8 == 0, its XLA adjoint
# elsewhere.
LN_BWD_SHAPES = [(256, 128)] + [
    (rows, hidden) for hidden in (768, 1024, 256, 264, 36) for rows in (1, 37, 256)
]


@pytest.mark.parametrize("rows,hidden", LN_BWD_SHAPES)
def test_layer_norm_bwd_plain_matches_pallas(rows, hidden):
    from open_provence_tpu.ops import layer_norm as jax_ln

    x, scale = _ln_inputs(rows, hidden, seed=11)
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


# Contraction depths of dW = gᵀ·xn: one row tile, and a longer one whose
# cotangent is scaled by sqrt(256 / rows) so that dW stays O(1).
BWD_ROWS = [256, 1024]


@pytest.mark.parametrize("rows", BWD_ROWS)
def test_ln_matmul_bwd_plain_matches_pallas(rows):
    x, scale = _ln_inputs(rows, 128, seed=13)
    w_kn = (np.random.default_rng(14).normal(size=(128, 384)) * 0.05).astype(np.float32)
    g = (np.random.default_rng(15).normal(size=(rows, 384)) * 0.1
         * np.sqrt(256 / rows)).astype(np.float32)
    ref_dx, ref_ds, ref_dw = _vjp_pallas(
        lambda a, s, w: fused_ln_matmul(a, s, w, 1e-5), (x, scale, w_kn), g
    )
    dx, ds, dw = ln_matmul_bwd_plain(_t(x), _t(scale), _t(w_kn.T), _t(g))
    np.testing.assert_allclose(dx.numpy(), ref_dx, **TOL)
    np.testing.assert_allclose(ds.numpy(), ref_ds, **TOL)
    np.testing.assert_allclose(dw.numpy(), ref_dw.T, **TOL)


@pytest.mark.parametrize("rows", BWD_ROWS)
@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh", "silu"])
def test_ln_geglu_bwd_plain_matches_pallas(act, rows):
    x, scale = _ln_inputs(rows, 128, seed=16)
    wi_kn = (np.random.default_rng(17).normal(size=(128, 128)) * 0.1).astype(np.float32)
    g = (np.random.default_rng(18).normal(size=(rows, 64)) * 0.1
         * np.sqrt(256 / rows)).astype(np.float32)
    ref_dx, ref_ds, ref_dwi = _vjp_pallas(
        lambda a, s, w: fused_ln_geglu(a, s, w, act, 1e-5), (x, scale, wi_kn), g
    )
    dx, ds, dwi = ln_geglu_bwd_plain(_t(x), _t(scale), _t(wi_kn.T), _t(g), act)
    np.testing.assert_allclose(dx.numpy(), ref_dx, **TOL)
    np.testing.assert_allclose(ds.numpy(), ref_ds, **TOL)
    np.testing.assert_allclose(dwi.numpy(), ref_dwi.T, **TOL)


# (m, n, k) of the weight gradients the kernels split: kernels 11 / 12 at
# base width (dW [2304, 768]) over a training batch, a ragged one and twice
# as many rows; kernel 13's dWo [768, 1152]; the edge cases of the card
# tests (less than one chunk, a ragged k-step, ragged widths); one row.
DW_SHAPES = [
    (16384, 2304, 768), (16384 - 37, 2304, 768), (32768, 2304, 768), (16384, 768, 1152),
    (64, 256, 768), (77, 456, 200), (16384 - 37, 464, 200), (1, 8, 8),
]


@pytest.mark.parametrize("m,n,k", DW_SHAPES)
def test_dw_chunk_rule_covers_every_row_once(m, n, k):
    """The split of dW = Gᵀ·X over its m rows: chunks of one length, a whole
    number of k-steps, that cover rows 0 .. m - 1 once and in order, the
    last one non-empty; at most DW_CTAS CTAs unless a single chunk; every
    chunk but the last at least DW_MIN_STEPS k-steps. The rule reads only
    the shape, so the same call always gives the same split."""
    from open_provence_tpu_torch import kernels

    rows, chunks = kernels.dw_chunk_rows(m, n, k), kernels.dw_chunks(m, n, k)
    assert rows % kernels.DW_STEP == 0 and rows == kernels.dw_chunk_rows(m, n, k)
    bounds = [(c * rows, min(m, (c + 1) * rows)) for c in range(chunks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == m and bounds[-1][0] < m
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    tiles = -(-n // kernels.DW_TILE[0]) * -(-k // kernels.DW_TILE[1])
    assert chunks == 1 or tiles * chunks <= kernels.DW_CTAS
    assert chunks == 1 or rows >= kernels.DW_MIN_STEPS * kernels.DW_STEP


def test_dw_chunk_rule_at_base_width():
    """The split the training step runs: dW [2304, 768] over 16384 rows is 54
    tiles in 2 chunks of 8192 rows (128 k-steps), 108 CTAs; the ragged batch
    keeps the chunk length and shortens only the last chunk; kernel 13's dWo
    [768, 1152] is 30 tiles in 4 chunks."""
    from open_provence_tpu_torch import kernels

    assert (kernels.dw_chunk_rows(16384, 2304, 768), kernels.dw_chunks(16384, 2304, 768)) == (
        8192, 2)
    assert (kernels.dw_chunk_rows(16384 - 37, 2304, 768),
            kernels.dw_chunks(16384 - 37, 2304, 768)) == (8192, 2)
    assert kernels.dw_chunks(16384, 768, 1152) == 4
    assert kernels.dw_chunks(64, 256, 768) == 1


@pytest.mark.parametrize("m,n,k", DW_SHAPES)
def test_bwd_scratch_holds_the_chunks(m, n, k):
    """The scratch the backward wrappers allocate for the split: bf16 holds
    every chunk's fp32 [n, k] partial sums; fp32, which sums on FMA in one
    pass, gets none. Kernel 13's two weight gradients share one buffer, as
    large as the larger needs."""
    import importlib

    from open_provence_tpu_torch import kernels

    geglu = importlib.import_module("open_provence_tpu_torch.ops.geglu")  # the module, not the op
    x2d = torch.empty((m, k), dtype=torch.bfloat16)
    xn, dy, partial, dw_partial = geglu._bwd_scratch(x2d, (m, n, k))
    assert xn.shape == (m, k) and dy.shape == (m, k) and dy.dtype == torch.float32
    assert partial.shape == (-(-m // kernels.LN_ADJOINT_ROWS), k)
    assert dw_partial.dtype == torch.float32
    assert dw_partial.numel() == kernels.dw_chunks(m, n, k) * n * k
    assert geglu._bwd_scratch(x2d.float(), (m, n, k))[3] is None
    wo = (m, k, n // 2)
    both = geglu._bwd_scratch(x2d, (m, n, k), wo)[3]
    assert both.numel() == max(kernels.dw_chunks(m, n, k) * n * k,
                               kernels.dw_chunks(*wo) * k * (n // 2))


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


def _holed_mask(batch, seq, rng):
    """A key mask that is no prefix: single padded keys scattered through
    every row and, in row 0, a wholly padded stretch of 130 keys (at least one
    aligned 64-key tile without a valid key) inside the valid run; row 1 also
    ends in padding."""
    mask = (rng.random((batch, seq)) > 0.05).astype(np.int32)
    mask[0, 70:200] = 0
    mask[1, seq - 45:] = 0
    mask[:, 0] = 1
    return mask


@pytest.mark.parametrize("window", [None, 16])
def test_attention_plain_matches_pallas_on_a_mask_with_holes(window):
    """What leaving out key tiles without a valid key must keep: on a mask
    with holes and a wholly padded stretch, every valid row of the plain
    forward agrees with the Pallas kernel (fp32, 1e-4)."""
    batch, seq, heads, dim = 2, 384, 2, 64
    rng = np.random.default_rng(23)
    qkv = rng.normal(size=(batch, seq, 3 * heads * dim)).astype(np.float32)
    mask = _holed_mask(batch, seq, rng)
    cos, sin = jax_rope_tables(seq, dim, 10000.0)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(
            jax_flash_packed(
                jnp.asarray(qkv), num_heads=heads, padding_mask=jnp.asarray(mask),
                window=window, rope=(cos, sin),
            )
        )
    kwargs = dict(num_heads=heads, padding_mask=_t(mask), window=window,
                  rope=rope_tables(seq, dim, 10000.0))
    valid = mask.astype(bool)
    for fn in (attention_packed_plain, flash_attention_packed):
        out = fn(_t(qkv), **kwargs).numpy()
        np.testing.assert_allclose(out[valid], ref[valid], **TOL)


@pytest.mark.parametrize("window", [None, 16])
def test_attention_bwd_plain_matches_pallas_on_a_mask_with_holes(window):
    """The same for the backward, the cotangent zero on padded rows: dq, dk
    and dv of every row, padded keys included (theirs are zero)."""
    batch, seq, heads, dim = 2, 384, 2, 64
    rng = np.random.default_rng(29)
    qkv = rng.normal(size=(batch, seq, 3 * heads * dim)).astype(np.float32)
    mask = _holed_mask(batch, seq, rng)
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
        np.testing.assert_allclose(dqkv, ref, **TOL)
    # A padded key gets no gradient: its probability is exactly 0 for every
    # row with a valid key in reach, and the other rows' cotangent is 0.
    dk, dv = dqkv[..., heads * dim:2 * heads * dim], dqkv[..., 2 * heads * dim:]
    assert not dk[mask == 0].any() and not dv[mask == 0].any()


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


# --- long context: the banded forward and the split backward ----------------
#
# At 1024 <= S <= 4096 the JAX package routes window layers to its banded
# forward kernel, and past S = 1024 every layer's backward to the split dq and
# dk/dv kernels. The port has one forward and one backward kernel for all S;
# their plain versions are held against those JAX kernels here.


def _rope_stack(seq, dim, theta):
    cos, sin = jax_rope_tables(seq, dim, theta)
    return jnp.stack([cos, sin])


@pytest.mark.parametrize("heads", [2, 4])
def test_attention_plain_matches_banded_pallas_at_1024(heads, monkeypatch):
    """The static banded kernel (active at S = 1024, window 64), ragged mask:
    out and lse on valid rows within 2e-5 (the JAX package's own tolerance
    between its banded and grid kernels)."""
    from open_provence_tpu.ops.flash_attention import _flash_forward_packed, banded_sub_blocks

    monkeypatch.setenv("OPEN_PROVENCE_TPU_BANDED", "1")
    seq, dim, window = 1024, 64, 64
    assert banded_sub_blocks(seq, seq, window) is not None
    rng = np.random.default_rng(40 + heads)
    qkv = rng.normal(size=(1, seq, 3 * heads * dim)).astype(np.float32)
    mask = np.ones((1, seq), np.int32)
    mask[0, 900:] = 0
    with pltpu.force_tpu_interpret_mode():
        ref_out, ref_lse = _flash_forward_packed(
            jnp.asarray(qkv), heads, jnp.asarray(mask), _rope_stack(seq, dim, 10000.0),
            window, seq, 256, emit_lse=True,
        )
    ref_lse = np.asarray(ref_lse).reshape(1, heads, seq)
    valid = mask.astype(bool)
    kw = dict(num_heads=heads, padding_mask=_t(mask), window=window,
              rope=rope_tables(seq, dim, 10000.0))
    out, lse = flash_attention_packed_lse(_t(qkv), **kw)
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref_out)[valid], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        lse.numpy().transpose(0, 2, 1)[valid], ref_lse.transpose(0, 2, 1)[valid],
        atol=2e-5, rtol=2e-5,
    )
    # A padding row: every in-band key masked. The plain lse stays finite.
    assert np.isfinite(lse.numpy()).all()


@pytest.mark.parametrize("seq", [256, 512])
@pytest.mark.parametrize("window", [None, 64])
def test_attention_bwd_plain_matches_split_pallas(seq, window, monkeypatch):
    """The split dq and dk/dv kernels (what S > 1024 runs), called with
    128-blocks at a size interpret mode can finish: d(qkv) within 1e-5 of
    the largest gradient."""
    from open_provence_tpu.ops.flash_attention import (
        _flash_backward_packed, _flash_forward_packed, _fused_bwd_sub_blocks,
    )

    monkeypatch.setenv("OPEN_PROVENCE_TPU_BWD_FUSED", "0")
    assert _fused_bwd_sub_blocks(seq, window) is None  # the split path
    batch, heads, dim = 1, 2, 64
    rng = np.random.default_rng(50 + seq)
    qkv = rng.normal(size=(batch, seq, 3 * heads * dim)).astype(np.float32)
    mask = np.ones((batch, seq), np.int32)
    mask[0, seq - 61:] = 0
    g = rng.normal(size=(batch, seq, heads * dim)).astype(np.float32) * mask[..., None]
    rope = _rope_stack(seq, dim, 160000.0)
    with pltpu.force_tpu_interpret_mode():
        j_out, j_lse = _flash_forward_packed(
            jnp.asarray(qkv), heads, jnp.asarray(mask), rope, window, 128, 128, emit_lse=True
        )
        ref = np.asarray(_flash_backward_packed(
            jnp.asarray(qkv), heads, jnp.asarray(mask), rope, j_out, j_lse, jnp.asarray(g),
            window, 128, 128,
        ))
    kw = dict(num_heads=heads, padding_mask=_t(mask), window=window,
              rope=rope_tables(seq, dim, 160000.0))
    out, lse = flash_attention_packed_lse(_t(qkv), **kw)
    dqkv = attention_packed_bwd_plain(_t(qkv), _t(g), out, lse, **kw).numpy()
    np.testing.assert_allclose(dqkv, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_rope_tables_are_cached_per_length():
    """A table made for S = 512 is never handed out for 2048: the cache key
    holds the length, and the values are the fp32 tables cast once."""
    short = rope_tables(512, 64, 10000.0, torch.bfloat16)
    long = rope_tables(2048, 64, 10000.0, torch.bfloat16)
    assert short[0].shape == (512, 64) and long[0].shape == (2048, 64)
    assert rope_tables(512, 64, 10000.0, torch.bfloat16)[0] is short[0]
    cos, _ = jax_rope_tables(2048, 64, 10000.0)
    assert torch.equal(long[0], _t(np.array(cos)).to(torch.bfloat16))
    assert torch.equal(long[0][:512], short[0])


# --- the bias-carrying layouts: GeGLU without a norm, add + LayerNorm --------


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_geglu_plain_matches_pallas_and_its_gradient(act):
    from open_provence_tpu.ops.geglu import fused_geglu
    from open_provence_tpu_torch.ops import geglu, geglu_plain

    rng = np.random.default_rng(60)
    x = rng.normal(size=(128, 128)).astype(np.float32)
    wi_kn = (rng.normal(size=(128, 128)) * 0.1).astype(np.float32)
    g = (rng.normal(size=(128, 64)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused_geglu(jnp.asarray(x), jnp.asarray(wi_kn), act))
    ref_dx, ref_dwi = _vjp_pallas(lambda a, w: fused_geglu(a, w, act), (x, wi_kn), g)
    wi = _t(wi_kn.T)
    np.testing.assert_allclose(geglu_plain(_t(x), wi, act).numpy(), ref, **TOL)
    xt, wt = _t(x).requires_grad_(), wi.clone().requires_grad_()
    out = geglu(xt, wt, act)
    assert type(out.grad_fn).__name__ == "GegluFunctionBackward"
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    dx, dwi = torch.autograd.grad(out, (xt, wt), _t(g))
    np.testing.assert_allclose(dx.numpy(), ref_dx, **TOL)
    np.testing.assert_allclose(dwi.numpy(), ref_dwi.T, **TOL)


def test_add_layer_norm_plain_matches_both_jax_routes():
    """(h, LN(h)) against the fused add + LN kernel and against an add
    followed by the LN kernel: the kernel normalizes the rounded sum, so the
    three agree."""
    from open_provence_tpu.ops.layer_norm import fused_add_layer_norm
    from open_provence_tpu_torch.ops import add_layer_norm, add_layer_norm_plain

    x, scale = _ln_inputs(64, 128, seed=61)
    y = np.random.default_rng(62).normal(size=x.shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref_h, ref_n = (np.asarray(t) for t in fused_add_layer_norm(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(scale), 1e-5))
        ref_n2 = np.asarray(fused_layer_norm(jnp.asarray(x) + jnp.asarray(y),
                                             jnp.asarray(scale), 1e-5))
    for fn in (add_layer_norm_plain, add_layer_norm):
        h, n = fn(_t(x), _t(y), _t(scale))
        np.testing.assert_allclose(h.numpy(), ref_h, **TOL)
        np.testing.assert_allclose(n.numpy(), ref_n, **TOL)
        np.testing.assert_allclose(n.numpy(), ref_n2, **TOL)
    h3, n3 = add_layer_norm(_t(x).reshape(4, 16, 128), _t(y).reshape(4, 16, 128), _t(scale))
    assert h3.shape == n3.shape == (4, 16, 128)


@pytest.mark.parametrize("rows,hidden", LN_BWD_SHAPES)
def test_add_layer_norm_bwd_with_gh_matches_pallas(rows, hidden):
    """The add + LN adjoint: kernel 10 with the residual cotangent gh, via
    jax.vjp of _add_ln_core; and without gh the adjoint is what it was."""
    from open_provence_tpu.ops.layer_norm import _add_ln_core
    from open_provence_tpu_torch.ops import add_layer_norm

    x, scale = _ln_inputs(rows, hidden, seed=63)
    rng = np.random.default_rng(64)
    y, gh, gn = (rng.normal(size=x.shape).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, s: _add_ln_core(a, b, s, 1e-5),
                         jnp.asarray(x), jnp.asarray(y), jnp.asarray(scale))
        ref_dx, ref_dy, ref_ds = (np.asarray(t) for t in vjp((jnp.asarray(gh), jnp.asarray(gn))))
    np.testing.assert_array_equal(ref_dx, ref_dy)
    h = _t(x) + _t(y)
    for fn in (layer_norm_bwd_plain, layer_norm_bwd):
        dh, ds = fn(h, _t(scale), _t(gn), 1e-5, _t(gh))
        np.testing.assert_allclose(dh.numpy(), ref_dx, **TOL)
        np.testing.assert_allclose(ds.numpy(), ref_ds, **TOL)
        # gh = None: bit for bit what the two-argument form gives.
        none = fn(h, _t(scale), _t(gn), 1e-5, None)
        plain = fn(h, _t(scale), _t(gn))
        assert all(torch.equal(a, b) for a, b in zip(none, plain))
        assert torch.equal(dh, (none[0] + _t(gh)))
    # Through the autograd Function, both outputs used.
    xt, yt, st = _t(x).requires_grad_(), _t(y).requires_grad_(), _t(scale).requires_grad_()
    ht, nt = add_layer_norm(xt, yt, st)
    assert type(ht.grad_fn).__name__ == "AddLayerNormFunctionBackward"
    dx, dy, ds = torch.autograd.grad((ht, nt), (xt, yt, st), (_t(gh), _t(gn)))
    np.testing.assert_allclose(dx.numpy(), ref_dx, **TOL)
    assert torch.equal(dx, dy)
    np.testing.assert_allclose(ds.numpy(), ref_ds, **TOL)


def test_layer_norm_plain_with_bias_matches_jax_reference():
    from open_provence_tpu.ops.layer_norm import layer_norm_reference

    x, scale = _ln_inputs(32, 128, seed=65)
    bias = np.random.default_rng(66).normal(size=(128,)).astype(np.float32)
    ref = np.asarray(layer_norm_reference(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5))
    np.testing.assert_allclose(
        layer_norm_plain(_t(x), _t(scale), 1e-5, _t(bias)).numpy(), ref, **TOL)


@pytest.mark.parametrize("which", ["geglu", "add_layer_norm"])
def test_bias_layout_functions_gradcheck_fp64(which):
    from open_provence_tpu_torch.ops import add_layer_norm, geglu

    x, s, w = _gradcheck_inputs(21)
    if which == "geglu":
        assert torch.autograd.gradcheck(lambda a, b: geglu(a, b, "gelu"), (x, w))
    else:
        y = torch.randn(6, 16, dtype=torch.float64).requires_grad_()
        assert torch.autograd.gradcheck(lambda a, b, c: add_layer_norm(a, b, c), (x, y, s))
