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
