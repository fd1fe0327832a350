"""The port's OpenProvenceModule on the CPU against the JAX module.

One tiny config that satisfies every Pallas gate of the JAX package (hidden
128, 2 heads of 64, intermediate 192, 3 layers: one global, two local with
local_attention 64), one weight set: the JAX module's params, moved to the
port by ``state_dict_from_flax``. The JAX side runs once on its XLA path and
once with every Pallas kernel interpreted (OPEN_PROVENCE_TPU_PALLAS_INTERPRET
=1), each under a fresh ``jax.jit``; the port runs its plain versions.
Tolerance 1e-4 on fp32 logits (3 layers of fp32 sums in other orders).
"""

import jax
import numpy as np
import pytest
import torch

from open_provence_tpu.configs import ModernBertBackboneConfig as JaxBackboneConfig
from open_provence_tpu.configs import OpenProvenceConfig as JaxConfig
from open_provence_tpu.models.model import build_module as build_jax_module
from open_provence_tpu.utils.hf_convert import flax_params_to_hf
from open_provence_tpu_torch.configs import OpenProvenceConfig
from open_provence_tpu_torch.models.model import build_module
from open_provence_tpu_torch.utils.convert import init_params, state_dict_from_flax

BACKBONE = dict(
    vocab_size=512, hidden_size=128, intermediate_size=192, num_hidden_layers=3,
    num_attention_heads=2, max_position_embeddings=512, local_attention=64,
    global_attn_every_n_layers=3, pad_token_id=0, num_labels=1,
)


def _config_dict():
    return dict(
        base_model_config=dict(BACKBONE),
        num_labels=1,
        pruning_config={"hidden_size": 128, "classifier_dropout": 0.0},
        max_length=256,
    )


@pytest.fixture(scope="module")
def jax_side():
    # Each side gets its own config object (the JAX configs are hashed).
    config = JaxConfig(**_config_dict())
    assert JaxBackboneConfig(**BACKBONE).layer_window(1) == 32
    module = build_jax_module(config)
    params = module.init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32),
        attention_impl="xla",
    )["params"]
    return config, module, jax.device_get(params)


@pytest.fixture(scope="module")
def torch_module(jax_side):
    config = OpenProvenceConfig(**_config_dict())
    module = build_module(config)
    module.load_state_dict(state_dict_from_flax(jax_side[2], config))
    return module.eval()


def _inputs(seq, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 512, size=(2, seq)).astype(np.int32)
    mask = np.ones((2, seq), np.int32)
    mask[1, seq // 2 + 7:] = 0  # ragged
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("seq", [128, 256])
@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas_interpret"])
def test_module_matches_jax(jax_side, torch_module, monkeypatch, seq, pallas):
    _config, module, params = jax_side
    if pallas:
        monkeypatch.setenv("OPEN_PROVENCE_TPU_PALLAS_INTERPRET", "1")
    ids, mask = _inputs(seq, seed=seq + int(pallas))
    run = jax.jit(lambda p, i, m: module.apply({"params": p}, i, m))  # fresh trace
    ref = jax.device_get(run(params, ids, mask))
    with torch.inference_mode():
        out = torch_module(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(
        out["ranking_logits"].numpy(), ref["ranking_logits"], atol=1e-4, rtol=1e-4
    )
    valid = mask.astype(bool)
    np.testing.assert_allclose(
        out["pruning_logits"].numpy()[valid], ref["pruning_logits"][valid],
        atol=1e-4, rtol=1e-4,
    )


def test_state_dict_from_flax_matches_hf_export(jax_side, torch_module):
    config, _module, params = jax_side
    hf = flax_params_to_hf(params, config)
    sd = state_dict_from_flax(params, OpenProvenceConfig(**_config_dict()))
    assert set(sd) == set(hf)
    for key, value in hf.items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)
    # ... and they are exactly the port module's parameter names.
    assert set(sd) == set(torch_module.state_dict())


def test_init_params_shapes_and_distributions():
    config = OpenProvenceConfig(**_config_dict())
    sd = init_params(config, torch.Generator().manual_seed(0))
    module = build_module(config)
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in module.state_dict().items()
    }
    module.load_state_dict(sd)
    emb = sd["ranking_model.model.embeddings.tok_embeddings.weight"]
    assert abs(emb.std().item() - 128**-0.5) < 0.01
    wi = sd["ranking_model.model.layers.1.mlp.Wi.weight"]  # lecun normal, fan_in 128
    assert abs(wi.std().item() - 128**-0.5) < 0.01
    assert wi.abs().max().item() <= 2 * 128**-0.5 / 0.87962566103423978 + 1e-6
    assert torch.equal(sd["ranking_model.model.final_norm.weight"], torch.ones(128))
    assert torch.equal(sd["pruning_head.classifier.bias"], torch.zeros(2))
    again = init_params(config, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)


# --- the bias-carrying checkpoint layouts ------------------------------------
#
# Each of norm_bias, attention_bias and mlp_bias (and all three) against the
# JAX module with its weights carried over by state_dict_from_flax; the
# biases are drawn at random, since init leaves them 0. Each side has its own
# config object and the JAX oracle of a layout is built once. Logits and both
# hidden states within 1e-4; gradients within 1e-4 of each tensor's largest.

LAYOUTS = {
    "norm_bias": dict(norm_bias=True),
    "attention_bias": dict(attention_bias=True),
    "mlp_bias": dict(mlp_bias=True),
    "all_three": dict(norm_bias=True, attention_bias=True, mlp_bias=True),
}


def _layout_config_dict(flags):
    cfg = _config_dict()
    cfg["base_model_config"].update(flags)
    return cfg


def _randomize_biases(tree, rng):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _randomize_biases(value, rng)
        elif key == "bias":
            out[key] = rng.normal(size=value.shape).astype(np.float32) * 0.1
        else:
            out[key] = np.asarray(value)
    return out


@pytest.fixture(scope="module", params=list(LAYOUTS))
def layout_sides(request):
    flags = LAYOUTS[request.param]
    jax_config = JaxConfig(**_layout_config_dict(flags))
    jax_module = build_jax_module(jax_config)
    params = jax_module.init(
        jax.random.PRNGKey(1), np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32),
        attention_impl="xla",
    )["params"]
    params = _randomize_biases(jax.device_get(params), np.random.default_rng(7))
    config = OpenProvenceConfig(**_layout_config_dict(flags))
    module = build_module(config)
    sd = state_dict_from_flax(params, config)
    hf = flax_params_to_hf(params, jax_config)
    assert set(sd) == set(hf) == set(module.state_dict())
    for key, value in hf.items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)
    module.load_state_dict(sd)
    return request.param, flags, jax_module, params, config, module.eval()


def test_bias_layouts_carry_their_bias_leaves(layout_sides):
    name, flags, _jm, _params, _config, module = layout_sides
    keys = set(module.state_dict())
    pre = "ranking_model.model.layers.1."
    assert (pre + "attn_norm.bias" in keys) == bool(flags.get("norm_bias"))
    assert ("ranking_model.model.final_norm.bias" in keys) == bool(flags.get("norm_bias"))
    assert ("ranking_model.head.norm.bias" in keys) == bool(flags.get("norm_bias"))
    assert (pre + "attn.Wqkv.bias" in keys) == (pre + "attn.Wo.bias" in keys) == bool(
        flags.get("attention_bias"))
    assert (pre + "mlp.Wi.bias" in keys) == (pre + "mlp.Wo.bias" in keys) == bool(
        flags.get("mlp_bias"))
    assert any(float(v.abs().max()) > 0 for k, v in module.state_dict().items()
               if k.endswith(".bias") and "classifier" not in k and "dense" not in k), name


def test_bias_layouts_route_to_their_kernels(layout_sides):
    """Which wrappers a forward goes through (on the CPU: their plain
    versions), layout by layout, as the JAX module routes them."""
    from open_provence_tpu_torch import kernels

    name, flags, _jm, _params, _config, module = layout_sides
    ids, mask = _inputs(128, seed=3)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        module(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    used = {k for k, n in kernels.plain_counts().items() if n}
    expect = {
        "norm_bias": {"flash_attention_packed", "geglu"},
        "attention_bias": {"layer_norm", "flash_attention_packed", "ln_geglu"},
        "mlp_bias": {"layer_norm", "ln_matmul", "flash_attention_packed", "add_layer_norm"},
        "all_three": {"flash_attention_packed"},
    }[name]
    assert used == expect, (name, used)
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas_interpret"])
def test_bias_layouts_match_jax(layout_sides, monkeypatch, pallas):
    name, _flags, jax_module, params, _config, module = layout_sides
    if pallas:
        # Every Pallas kernel interpreted, the fused add + LN one included
        # (it is behind a switch in the JAX package; the port always takes it).
        monkeypatch.setenv("OPEN_PROVENCE_TPU_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("OPEN_PROVENCE_TPU_ADD_LN", "1")
    ids, mask = _inputs(128, seed=11 + int(pallas))
    run = jax.jit(lambda p, i, m: jax_module.apply({"params": p}, i, m))  # fresh trace
    ref = jax.device_get(run(params, ids, mask))
    with torch.inference_mode():
        out = module(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    valid = mask.astype(bool)
    np.testing.assert_allclose(
        out["ranking_logits"].numpy(), ref["ranking_logits"], atol=1e-4, rtol=1e-4, err_msg=name)
    for key in ("pruning_logits", "last_hidden_pre_norm", "last_hidden_state"):
        np.testing.assert_allclose(
            out[key].numpy()[valid], ref[key][valid], atol=1e-4, rtol=1e-4, err_msg=f"{name} {key}")


def test_bias_layouts_gradients_match_jax_grad(layout_sides):
    name, _flags, jax_module, params, config, module = layout_sides
    import jax.numpy as jnp

    ids, mask = _inputs(128, seed=13)
    rng = np.random.default_rng(14)
    w_rank = rng.normal(size=(2, 1)).astype(np.float32)
    w_prune = rng.normal(size=(2, 128, 2)).astype(np.float32) * mask[..., None]
    w_hidden = rng.normal(size=(2, 128, 128)).astype(np.float32) * mask[..., None] * 0.1

    def jax_loss(p):
        out = jax_module.apply({"params": p}, ids, mask)
        return ((out["ranking_logits"] * w_rank).sum() + (out["pruning_logits"] * w_prune).sum()
                + (out["last_hidden_state"] * w_hidden).sum())

    j_loss, j_grads = jax.jit(jax.value_and_grad(jax_loss))(
        jax.tree_util.tree_map(jnp.asarray, params))
    want = state_dict_from_flax(jax.device_get(j_grads), config)

    module.train()  # dropout rates are 0: the training graph, no masks
    out = module(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    loss = ((out["ranking_logits"] * torch.from_numpy(w_rank)).sum()
            + (out["pruning_logits"] * torch.from_numpy(w_prune)).sum()
            + (out["last_hidden_state"] * torch.from_numpy(w_hidden)).sum())
    named = dict(module.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    module.eval()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-4)
    assert set(grads) == set(want)
    for key, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            grads[key].numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-12),
            err_msg=f"{name} {key}")
