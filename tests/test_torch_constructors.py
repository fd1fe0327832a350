"""The port's constructors take the JAX package's keywords.

The engine, the encoder and the trainer of both packages are built with
the same keyword arguments, the JAX defaults spelled out
(``attention_impl="auto"``, ``bucket_step=None``): the port accepts each,
and off the TPU picks the JAX package's bucket step (64). The port checks
``attention_impl`` as the JAX routes name it and refuses another name.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import open_provence_tpu as jop
import open_provence_tpu_torch as top
from open_provence_tpu.encoder import OpenProvenceEncoder as JaxEncoder
from open_provence_tpu.inference import OpenProvenceModel as JaxModel
from open_provence_tpu.models.model import build_module as build_jax_module
from open_provence_tpu.parallel.mesh import create_mesh as jax_create_mesh
from open_provence_tpu.train.trainer import OpenProvenceTrainer as JaxTrainer
from open_provence_tpu_torch import OpenProvenceEncoder, OpenProvenceModel
from open_provence_tpu_torch.train import OpenProvenceTrainer
from open_provence_tpu_torch.utils.convert import state_dict_from_flax
from tests.dummy_tokenizers import DummyTokenizer, PairDummyTokenizer

IMPLS = ("auto", "xla", "pallas")


def tiny_config(pkg):
    backbone = pkg.ModernBertBackboneConfig(
        vocab_size=128, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=64, local_attention=8,
        pad_token_id=0, num_labels=1,
    )
    return pkg.OpenProvenceConfig(
        base_model_config=backbone.to_dict(), num_labels=1, max_length=32,
        pruning_config={"hidden_size": 32, "classifier_dropout": 0.0},
    )


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's state dict) of one seeded init."""
    ids = np.zeros((1, 8), np.int32)
    params = jax.device_get(build_jax_module(tiny_config(jop)).init(
        jax.random.PRNGKey(0), ids, np.ones_like(ids))["params"])
    return params, state_dict_from_flax(params, tiny_config(top))


def build(kind: str, pkg, weights, tmp_path, **kwargs):
    """The ``kind`` entry point of ``pkg`` (the JAX package or the port)."""
    jax_side = pkg is jop
    params, sd = weights
    config = tiny_config(pkg)
    device = {} if jax_side else {"device": "cpu"}
    if kind == "engine":
        cls = JaxModel if jax_side else OpenProvenceModel
        return cls(config, params if jax_side else sd, DummyTokenizer(), **device, **kwargs)
    if kind == "encoder":
        if jax_side:
            return JaxEncoder(config=config, params=params, tokenizer=PairDummyTokenizer(),
                              **kwargs)
        return OpenProvenceEncoder(config=config, state_dict=sd, tokenizer=PairDummyTokenizer(),
                                   **device, **kwargs)
    mesh = {"mesh": jax_create_mesh(devices=jax.devices()[:1])} if jax_side else {}
    cls = JaxTrainer if jax_side else OpenProvenceTrainer
    return cls(config, params if jax_side else sd, PairDummyTokenizer(),
               output_dir=tmp_path / ("jax" if jax_side else "port"), bf16=False,
               **mesh, **device, **kwargs)


@pytest.mark.parametrize("kind", ["engine", "encoder", "trainer"])
def test_constructors_take_the_jax_keywords(weights, tmp_path, kind):
    """Every attention route the JAX constructor names, and for the engine
    and the encoder ``bucket_step=None``, which both packages read as the
    same step off the TPU."""
    extra = {} if kind == "trainer" else {"bucket_step": None}
    for impl in IMPLS:
        want = build(kind, jop, weights, tmp_path, attention_impl=impl, **extra)
        got = build(kind, top, weights, tmp_path, attention_impl=impl, **extra)
        if kind != "trainer":
            assert got.bucket_step == want.bucket_step == 64
            assert got.attention_impl == want.attention_impl == impl
    if kind != "trainer":
        got = build(kind, top, weights, tmp_path, bucket_step=16)
        assert got.bucket_step == 16


@pytest.mark.parametrize("kind", ["engine", "encoder", "trainer"])
def test_constructors_refuse_another_attention_route(weights, tmp_path, kind):
    with pytest.raises(ValueError, match="attention_impl must be one of"):
        build(kind, top, weights, tmp_path, attention_impl="flash")


def test_from_pretrained_passes_the_route_on(weights, tmp_path):
    """``from_pretrained(attention_impl=...)`` reaches the constructor, and
    ``bucket_step=None`` goes through ``kwargs``."""
    trainer = build("trainer", top, weights, tmp_path)
    directory = trainer.export_model(tmp_path / "export")
    model = OpenProvenceModel.from_pretrained(directory, tokenizer=DummyTokenizer(),
                                              device="cpu", attention_impl="xla",
                                              bucket_step=None)
    assert (model.attention_impl, model.bucket_step) == ("xla", 64)
    out = model.process("q", "First sentence. Second one.", threshold=0.0, show_progress=False)
    assert out["pruned_context"] == "First sentence. Second one."
    assert torch.equal(trainer.full_state_dict()["pruning_head.classifier.weight"],
                       weights[1]["pruning_head.classifier.weight"])
