"""The last four TPU kernels' counterparts on the CPU against the JAX package:
attention on separate q, k, v (``flash_attention`` and its ``jax.vjp``) and
the whole MLP in one kernel (``fused_ln_geglu_wo`` and its vjp), each Pallas
kernel run in interpret mode as the JAX package's own tests run it, held
against the port's plain versions; then the modules whose head layouts leave
the JAX package's packed kernel, and the module with the whole-MLP gate on.

Inputs come from numpy seeds. fp32 tolerances are 1e-4 of each tensor's
largest value (sums in other orders; the JAX attention kernel folds a
power-of-two scale into q). bf16, the whole MLP only: forward atol = rtol =
3e-2 and gradients 2e-2 of each tensor's largest value, the tolerances the
card-side tests state for kernels 4 and 11 (both sides round at the same
points, but a sum beside a bf16 rounding boundary can land one ulp apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from open_provence_tpu.configs import OpenProvenceConfig as JaxConfig
from open_provence_tpu.models.model import build_module as build_jax_module
from open_provence_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from open_provence_tpu.ops.geglu import _ln_geglu_wo_forward, fused_ln_geglu_wo
from open_provence_tpu.ops.rotary import rope_tables as jax_rope_tables
from open_provence_tpu.utils.hf_convert import flax_params_to_hf
from open_provence_tpu_torch import kernels, ops
from open_provence_tpu_torch.configs import OpenProvenceConfig
from open_provence_tpu_torch.models.model import build_module
from open_provence_tpu_torch.models.modernbert import MLP_TAIL_GATE
from open_provence_tpu_torch.utils.convert import state_dict_from_flax


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel=1e-4, err_msg=""):
    """Within ``rel`` of the reference tensor's largest value."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12),
                               err_msg=err_msg)


# --- attention on separate q, k, v: rows 9 and 16 -----------------------------


def _attention_case(shape, seed):
    batch, heads, seq, dim = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    mask = np.ones((batch, seq), np.int32)
    mask[0, seq - 37:] = 0
    g = rng.normal(size=shape).astype(np.float32) * mask[:, None, :, None]
    return q, k, v, mask, g


@pytest.mark.parametrize("shape", [(2, 3, 128, 32), (1, 3, 128, 256), (2, 4, 128, 64),
                                   (1, 2, 128, 128)],
                         ids=["3x32", "3x256", "4x64", "2x128"])
@pytest.mark.parametrize("window", [None, 16])
def test_unpacked_attention_plain_matches_pallas(shape, window):
    """``_flash_kernel`` and, through jax.vjp, ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel`` against the port's unpacked plain forward and
    backward and the dispatching wrappers (on CPU tensors: the plain
    versions, through the autograd Function). The cotangent is zero on padded
    query rows and the output is compared on valid rows, as the model uses
    them."""
    batch, heads, seq, dim = shape
    q, k, v, mask, g = _attention_case(shape, seed=dim + (window or 0))
    cos, sin = jax_rope_tables(seq, dim, 10000.0)
    kw = dict(padding_mask=jnp.asarray(mask), window=window, rope=(cos, sin))
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, **kw),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref_grads = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    ref = np.asarray(ref)
    valid = np.broadcast_to(mask.astype(bool)[:, None, :], (batch, heads, seq))
    tkw = dict(padding_mask=_t(mask), window=window,
               rope=ops.rope_tables(seq, dim, 10000.0))
    out, lse = ops.attention_unpacked_plain(_t(q), _t(k), _t(v), **tkw, return_lse=True)
    assert out.shape == shape and lse.shape == shape[:3]
    _close(out.numpy()[valid], ref[valid])
    for got, want in zip(ops.attention_unpacked_bwd_plain(_t(q), _t(k), _t(v), _t(g), out, lse,
                                                          **tkw), ref_grads):
        _close(got, want)
    # The wrappers on CPU tensors: the same values, the autograd Function.
    kernels.reset_launch_counts()
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    recorded = ops.flash_attention(*leaves, **tkw)
    assert type(recorded.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert torch.equal(recorded.detach(), out)
    for got, want in zip(torch.autograd.grad(recorded, leaves, _t(g)), ref_grads):
        _close(got, want)
    assert torch.equal(ops.flash_attention(_t(q), _t(k), _t(v), **tkw), out)
    out2, lse2 = ops.flash_attention_lse(_t(q), _t(k), _t(v), **tkw)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    counts = kernels.plain_counts()
    assert counts["flash_attention"] == 3 and counts["flash_attention_bwd"] == 1
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("heads,dim", [(3, 32), (3, 256), (4, 64), (2, 128)])
@pytest.mark.parametrize("window", [None, 16])
def test_unpacked_plain_on_views_of_a_packed_buffer_equals_packed_plain(heads, dim, window):
    """The packed plain versions are the unpacked ones on strided views of
    the buffer: bit for bit, forward, lse and backward."""
    batch, seq = 2, 48
    rng = np.random.default_rng(heads * dim)
    qkv = _t(rng.normal(size=(batch, seq, 3 * heads * dim)).astype(np.float32))
    mask = torch.ones(batch, seq, dtype=torch.int32)
    mask[1, 30:] = 0
    g = _t(rng.normal(size=(batch, seq, heads * dim)).astype(np.float32)) * mask[..., None]
    kw = dict(padding_mask=mask, window=window, rope=ops.rope_tables(seq, dim, 160000.0))
    views = ops.packed_views(qkv, heads)
    assert all(v.shape == (batch, heads, seq, dim) and v.data_ptr() >= qkv.data_ptr()
               and v.stride() == (seq * 3 * heads * dim, dim, 3 * heads * dim, 1) for v in views)
    out, lse = ops.attention_packed_plain(qkv, num_heads=heads, **kw, return_lse=True)
    out_u, lse_u = ops.attention_unpacked_plain(*views, **kw, return_lse=True)

    def merge(x):
        return x.transpose(1, 2).reshape(batch, seq, heads * dim)

    assert torch.equal(merge(out_u), out) and torch.equal(lse_u, lse)
    dqkv = ops.attention_packed_bwd_plain(qkv, g, out, lse, num_heads=heads, **kw)
    grads = ops.attention_unpacked_bwd_plain(
        *views, g.view(batch, seq, heads, dim).transpose(1, 2), out_u, lse_u, **kw)
    assert torch.equal(torch.cat([merge(t) for t in grads], dim=-1), dqkv)


def test_attention_route_and_refusals():
    """``multi_head_attention`` is ``flash_attention``: the plain version for
    CPU tensors of any head dim; the message for a head dim the kernels have
    no instance for; the packed names read the one kernel's launch count."""
    assert kernels.ATTENTION_HEAD_DIMS == (32, 64, 128, 256)
    kernels.reset_launch_counts()
    kernels.count_launch("flash_attention")
    kernels.count_launch("flash_attention_bwd")
    counts = kernels.launch_counts()
    assert list(counts) == list(kernels.KERNELS)
    assert {name for name, n in counts.items() if n} == {
        "flash_attention", "flash_attention_bwd", "flash_attention_packed",
        "flash_attention_packed_bwd"}
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts().values())
    from open_provence_tpu_torch.ops.flash_attention import _check_head_dim

    _check_head_dim(256)
    with pytest.raises(ValueError, match=r"instantiated for head_dim in \[32, 64, 128, 256\]"):
        _check_head_dim(48)
    with pytest.raises(ValueError, match="must share one"):
        ops.flash_attention(torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 9, 32),
                            torch.zeros(1, 2, 8, 32), padding_mask=None, window=None)
    # On the CPU every head dim runs the plain version, counted.
    rng = np.random.default_rng(0)
    q, k, v = (_t(rng.normal(size=(1, 2, 16, 48)).astype(np.float32)) for _ in range(3))
    mask = torch.ones(1, 16, dtype=torch.int32)
    rope = ops.rope_tables(16, 48, 10000.0)
    kernels.reset_launch_counts()
    out = ops.multi_head_attention(q, k, v, padding_mask=mask, window=4, rope=rope)
    assert kernels.plain_counts()["flash_attention"] == 1
    qr, kr = ops.apply_rotary(q, k, *rope)
    want = ops.attention_plain(qr, kr, v, ops.attention_bias(mask, 16, 4))
    assert torch.equal(out, want)


# --- the whole MLP in one kernel: rows 8 and 13 ------------------------------


def _mlp_case(dtype):
    rng = np.random.default_rng(70)
    m, k, inter = 128, 128, 64
    x = (rng.normal(size=(m, k)) * 2 + 0.5).astype(np.float32)
    scale = (rng.normal(size=(k,)) * 0.1 + 1).astype(np.float32)
    wi_kn = (rng.normal(size=(k, 2 * inter)) * k**-0.5).astype(np.float32)
    wo_ik = (rng.normal(size=(inter, k)) * inter**-0.5).astype(np.float32)
    g = (rng.normal(size=(m, k)) * 0.1).astype(np.float32)
    return tuple(jnp.asarray(a, dtype=dtype) for a in (x, scale, wi_kn, wo_ik, g))


def _to_torch(a, dtype):
    return _t(np.asarray(a.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_geglu_wo_plain_matches_pallas(dtype):
    """``_ln_geglu_wo_kernel`` and, through jax.vjp, ``_ln_geglu_wo_bwd_kernel``
    (M = 128, K = 128, I = 64, gelu) against ``ln_geglu_wo_plain`` and
    ``ln_geglu_wo_bwd_plain`` and the dispatching wrapper."""
    jdtype = jnp.dtype(dtype)
    tdtype = getattr(torch, dtype)
    x, scale, wi_kn, wo_ik, g = _mlp_case(jdtype)
    with pltpu.force_tpu_interpret_mode():
        ref = _ln_geglu_wo_forward(x, scale, wi_kn, wo_ik, "gelu", 1e-5)
        _, vjp = jax.vjp(lambda a, s, w1, w2: fused_ln_geglu_wo(a, s, w1, w2, "gelu", 1e-5),
                         x, scale, wi_kn, wo_ik)
        ref_grads = vjp(g)
    ref = np.asarray(ref.astype(jnp.float32))
    ref_dx, ref_ds, ref_dwi, ref_dwo = (np.asarray(t.astype(jnp.float32)) for t in ref_grads)
    xt, st, gt = (_to_torch(a, tdtype) for a in (x, scale, g))
    wi, wo = _to_torch(wi_kn.T, tdtype), _to_torch(wo_ik.T, tdtype)  # torch's [out, in]
    fwd_rel, bwd_rel = (1e-4, 1e-4) if dtype == "float32" else (3e-2, 2e-2)
    out = ops.ln_geglu_wo_plain(xt, st, wi, wo, "gelu")
    assert out.dtype == tdtype and out.shape == (128, 128)
    if dtype == "float32":
        _close(out, ref, fwd_rel)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, atol=fwd_rel, rtol=fwd_rel)
    wants = (ref_dx, ref_ds, ref_dwi.T, ref_dwo.T)
    for name, got, want in zip(("dx", "dscale", "dwi", "dwo"),
                               ops.ln_geglu_wo_bwd_plain(xt, st, wi, wo, gt, "gelu"), wants):
        assert got.dtype == tdtype
        _close(got, want, bwd_rel, err_msg=name)
    # The wrapper on CPU tensors, both forms of the forward: the Function.
    for fuse_forward in (True, False):
        kernels.reset_launch_counts()
        leaves = [t.clone().requires_grad_() for t in (xt, st, wi, wo)]
        recorded = ops.ln_geglu_wo(*leaves, "gelu", fuse_forward=fuse_forward)
        assert type(recorded.grad_fn).__name__ == "LnGegluWoFunctionBackward"
        if fuse_forward:
            assert torch.equal(recorded.detach(), out)
        elif dtype == "float32":
            _close(recorded, ref, fwd_rel)
        for name, got, want in zip(("dx", "dscale", "dwi", "dwo"),
                                   torch.autograd.grad(recorded, leaves, gt), wants):
            _close(got, want, bwd_rel, err_msg=name)
        counts = {k: n for k, n in kernels.plain_counts().items() if n}
        assert counts == ({"ln_geglu_wo": 1, "ln_geglu_wo_bwd": 1} if fuse_forward
                          else {"ln_geglu": 1, "ln_geglu_wo_bwd": 1})
        with torch.no_grad():
            direct = ops.ln_geglu_wo(xt, st, wi, wo, "gelu", fuse_forward=fuse_forward)
        assert direct.grad_fn is None and torch.equal(direct, recorded.detach())


@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh", "relu", "silu"])
def test_ln_geglu_wo_plain_is_the_split_path_and_its_derivative(act):
    """fp32: the whole-MLP plain forward equals kernel 4's plain version
    followed by Wo, and its plain backward is autograd of that composition."""
    rng = np.random.default_rng(71)
    x = _t(rng.normal(size=(40, 32)).astype(np.float32)).requires_grad_()
    scale = _t((rng.normal(size=(32,)) * 0.1 + 1).astype(np.float32)).requires_grad_()
    wi = _t((rng.normal(size=(48, 32)) * 0.2).astype(np.float32)).requires_grad_()
    wo = _t((rng.normal(size=(32, 24)) * 0.2).astype(np.float32)).requires_grad_()
    g = _t(rng.normal(size=(40, 32)).astype(np.float32))
    split = torch.nn.functional.linear(ops.ln_geglu_plain(x, scale, wi, act), wo)
    assert torch.equal(ops.ln_geglu_wo_plain(x, scale, wi, wo, act), split.detach())
    wants = torch.autograd.grad(split, (x, scale, wi, wo), g)
    for got, want in zip(ops.ln_geglu_wo_bwd_plain(x, scale, wi, wo, g, act), wants):
        _close(got, want.numpy(), 1e-5)


def test_geglu_wo_supported_states_what_the_kernels_take():
    assert ops.geglu_wo_supported(768, 1152, torch.bfloat16, "gelu")
    assert ops.geglu_wo_supported(1024, 2624, torch.bfloat16, "gelu")
    assert ops.geglu_wo_supported(100, 36, torch.float32, "silu")  # fp32: any widths
    assert not ops.geglu_wo_supported(1536, 1152, torch.bfloat16, "gelu")  # K past 1024
    assert not ops.geglu_wo_supported(776, 1152, torch.bfloat16, "gelu")  # K % 16
    assert not ops.geglu_wo_supported(768, 1148, torch.bfloat16, "gelu")  # I % 8
    assert not ops.geglu_wo_supported(768, 1152, torch.float16, "gelu")
    assert not ops.geglu_wo_supported(768, 1152, torch.float32, "tanh")


# --- modules: head layouts off the packed TPU kernel, and the gate -----------

BACKBONE = dict(
    vocab_size=512, hidden_size=128, intermediate_size=192, num_hidden_layers=3,
    max_position_embeddings=512, local_attention=64, global_attn_every_n_layers=3,
    pad_token_id=0, num_labels=1,
)
MODULES = {
    # name: (backbone overrides, JAX environment)
    "4x32": (dict(num_attention_heads=4), {}),
    "3x64": (dict(num_attention_heads=3, hidden_size=192, intermediate_size=128), {}),
    "fused_mlp": (dict(num_attention_heads=2), {"OPEN_PROVENCE_TPU_FUSED_MLP_TAIL": "1"}),
}


def _config_dict(overrides):
    backbone = {**BACKBONE, **overrides}
    return dict(base_model_config=backbone, num_labels=1, max_length=256,
                pruning_config={"hidden_size": backbone["hidden_size"],
                                "classifier_dropout": 0.0})


def _inputs(seq, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 512, size=(2, seq)).astype(np.int32)
    mask = np.ones((2, seq), np.int32)
    mask[1, seq // 2 + 7:] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.fixture(scope="module", params=list(MODULES))
def sides(request):
    """The JAX module with its Pallas kernels interpreted (attention_impl
    "pallas": these head layouts take its unpacked kernel) and the port's
    module on the same weights; the port's gate is set while its module is
    built. Forward outputs and the gradients of one weighted loss, computed
    once under one fresh jit each."""
    name = request.param
    overrides, jax_env = MODULES[name]
    mp = pytest.MonkeyPatch()
    mp.setenv("OPEN_PROVENCE_TPU_PALLAS_INTERPRET", "1")
    for key, value in jax_env.items():
        mp.setenv(key, value)
    try:
        jax_config = JaxConfig(**_config_dict(overrides))
        jax_module = build_jax_module(jax_config)
        params = jax.device_get(jax_module.init(
            jax.random.PRNGKey(2), np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32),
            attention_impl="xla")["params"])
        config = OpenProvenceConfig(**_config_dict(overrides))
        module = build_module(config)  # reads the gate
        module.load_state_dict(state_dict_from_flax(params, config))
        hidden = config.backbone().hidden_size
        ids, mask = _inputs(128, seed=21)
        rng = np.random.default_rng(22)
        weights = (rng.normal(size=(2, 1)).astype(np.float32),
                   rng.normal(size=(2, 128, 2)).astype(np.float32) * mask[..., None],
                   rng.normal(size=(2, 128, hidden)).astype(np.float32) * mask[..., None] * 0.1)

        def loss_of(out, as_tensor):
            return sum((out[key] * as_tensor(w)).sum() for key, w in zip(
                ("ranking_logits", "pruning_logits", "last_hidden_state"), weights))

        def jax_loss(p):
            out = jax_module.apply({"params": p}, ids, mask, attention_impl="pallas")
            return loss_of(out, jnp.asarray), out

        (j_loss, ref), j_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
        ref, j_grads = jax.device_get(ref), jax.device_get(j_grads)
    finally:
        mp.undo()
    return dict(name=name, params=params, jax_config=jax_config, config=config, module=module,
                ids=ids, mask=mask, ref=ref, j_loss=float(j_loss), j_grads=j_grads,
                loss_of=loss_of)


def test_new_layout_weights_carry_over(sides):
    """``state_dict_from_flax`` against the HF export: Wqkv's lane order is
    (qkv, head, dim) whatever the head layout."""
    sd = state_dict_from_flax(sides["params"], sides["config"])
    hf = flax_params_to_hf(sides["params"], sides["jax_config"])
    assert set(sd) == set(hf) == set(sides["module"].state_dict())
    for key, value in hf.items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)


def test_new_layout_modules_match_jax(sides):
    module, mask = sides["module"].eval(), sides["mask"]
    kernels.reset_launch_counts()
    with torch.inference_mode():
        out = module(torch.from_numpy(sides["ids"]).long(), torch.from_numpy(mask))
    used = {k for k, n in kernels.plain_counts().items() if n}
    mlp = "ln_geglu_wo" if sides["name"] == "fused_mlp" else "ln_geglu"
    assert used == {"layer_norm", "ln_matmul", "flash_attention_packed", mlp}, used
    valid, ref = mask.astype(bool), sides["ref"]
    np.testing.assert_allclose(out["ranking_logits"].numpy(), ref["ranking_logits"],
                               atol=1e-4, rtol=1e-4)
    for key in ("pruning_logits", "last_hidden_pre_norm", "last_hidden_state"):
        np.testing.assert_allclose(out[key].numpy()[valid], ref[key][valid], atol=1e-4,
                                   rtol=1e-4, err_msg=key)


def test_new_layout_gradients_match_jax_grad(sides):
    module, config = sides["module"], sides["config"]
    want = state_dict_from_flax(sides["j_grads"], config)
    module.train()  # dropout rates are 0: the training graph, no masks
    kernels.reset_launch_counts()
    out = module(torch.from_numpy(sides["ids"]).long(), torch.from_numpy(sides["mask"]))
    loss = sides["loss_of"](out, torch.from_numpy)
    named = dict(module.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    module.eval()
    used = {k for k, n in kernels.plain_counts().items() if n}
    assert ("ln_geglu_wo_bwd" in used) == (sides["name"] == "fused_mlp")
    assert ("ln_geglu_bwd" in used) == (sides["name"] != "fused_mlp")
    np.testing.assert_allclose(float(loss.detach()), sides["j_loss"], rtol=1e-4)
    assert set(grads) == set(want)
    for key, w in want.items():
        _close(grads[key], w.numpy(), 1e-4, err_msg=f"{sides['name']} {key}")


@pytest.mark.parametrize("heads", [24, 3])
def test_base_width_head_layouts_carry_over_and_route(heads):
    """The two base-width layouts of the card-side path (24 heads of 32,
    3 heads of 256; one layer): the converted weights equal the HF export,
    and the port's forward (its one call to the packed wrapper) matches the
    JAX module on its XLA path."""
    overrides = dict(hidden_size=768, intermediate_size=1152, num_attention_heads=heads,
                     num_hidden_layers=1)
    jax_config = JaxConfig(**_config_dict(overrides))
    jax_module = build_jax_module(jax_config)
    params = jax.device_get(jax_module.init(
        jax.random.PRNGKey(3), np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32),
        attention_impl="xla")["params"])
    config = OpenProvenceConfig(**_config_dict(overrides))
    assert config.backbone().head_dim == 768 // heads
    sd = state_dict_from_flax(params, config)
    for key, value in flax_params_to_hf(params, jax_config).items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)
    module = build_module(config)
    module.load_state_dict(sd)
    ids, mask = _inputs(64, seed=heads)
    ref = jax.device_get(jax.jit(
        lambda p, i, m: jax_module.apply({"params": p}, i, m, attention_impl="xla"))(
            params, ids, mask))
    with torch.inference_mode():
        out = module.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    valid = mask.astype(bool)
    np.testing.assert_allclose(out["pruning_logits"].numpy()[valid], ref["pruning_logits"][valid],
                               atol=1e-4, rtol=1e-4)


def test_mlp_tail_gate_values(monkeypatch):
    from open_provence_tpu_torch.models.modernbert import MLP_TAIL_DEFAULT, mlp_tail_gate

    monkeypatch.delenv(MLP_TAIL_GATE, raising=False)
    assert mlp_tail_gate() == MLP_TAIL_DEFAULT and MLP_TAIL_DEFAULT in ("0", "1", "bwd")
    for value in ("0", "1", "bwd"):
        monkeypatch.setenv(MLP_TAIL_GATE, value)
        assert mlp_tail_gate() == value
        module = build_module(OpenProvenceConfig(**_config_dict(dict(num_attention_heads=2))))
        layer = module.ranking_model.model.layers[1]
        assert layer.mlp.fused_tail == value
    monkeypatch.setenv(MLP_TAIL_GATE, "yes")
    with pytest.raises(ValueError, match="must be 0, 1 or bwd"):
        mlp_tail_gate()
    # A bias in the MLP, or dropout before Wo, keeps the split route.
    monkeypatch.setenv(MLP_TAIL_GATE, "1")
    module = build_module(OpenProvenceConfig(**_config_dict(
        dict(num_attention_heads=2, mlp_bias=True)))).eval()
    kernels.reset_launch_counts()
    ids, mask = _inputs(32, seed=1)
    with torch.inference_mode():
        module(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert kernels.plain_counts()["ln_geglu_wo"] == 0
    dropped = build_module(OpenProvenceConfig(**_config_dict(
        dict(num_attention_heads=2, mlp_dropout=0.1))))
    assert dropped.ranking_model.model.layers[0].mlp.fused_tail == "0"
