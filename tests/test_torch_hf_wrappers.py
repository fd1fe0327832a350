"""The port's AutoModel-surface wrappers (``models/hf_wrappers.py``) against
the JAX package's, on the CPU: the tiny configs and batch of
tests/test_hf_wrappers.py, one weight set (the JAX init moved by
``state_dict_from_flax``).

Tolerances: logits within ATOL + RTOL·|JAX| (fp32 sums in other orders,
as tests/test_torch_model.py); losses within LOSS_RTOL of the JAX
wrappers' and of torch's BCEWithLogitsLoss / CrossEntropyLoss on the
port's own logits. The edge cases are exact: no active position gives 0.0,
active positions whose labels are all -100 give NaN.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from open_provence_tpu.configs import ModernBertBackboneConfig as JaxBackboneConfig
from open_provence_tpu.configs import OpenProvenceConfig as JaxConfig
from open_provence_tpu.models import hf_wrappers as jax_wrappers
from open_provence_tpu.models.model import OpenProvenceModule as JaxModule
from open_provence_tpu_torch import OpenProvenceEncoder
from open_provence_tpu_torch.configs import ModernBertBackboneConfig, OpenProvenceConfig
from open_provence_tpu_torch.models import hf_wrappers
from open_provence_tpu_torch.utils.convert import state_dict_from_flax
from tests.dummy_tokenizers import DummyTokenizer

VOCAB = 128
ATOL = RTOL = 1e-4
LOSS_RTOL = 1e-4


def _config(cls, backbone_cls, num_labels):
    backbone = backbone_cls(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=64, local_attention=16,
        global_attn_every_n_layers=3, pad_token_id=0, num_labels=num_labels,
    )
    return cls(base_model_config=backbone.to_dict(), num_labels=num_labels,
               pruning_config={"hidden_size": 32, "classifier_dropout": 0.0}, max_length=64)


def _tiny(num_labels: int):
    jax_config = _config(JaxConfig, JaxBackboneConfig, num_labels)
    params = JaxModule(
        backbone_config=jax_config.backbone(), pruning_config=jax_config.pruning_head()
    ).init(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32),
           attention_impl="xla")["params"]
    config = _config(OpenProvenceConfig, ModernBertBackboneConfig, num_labels)
    return {"jax_config": jax_config, "params": params, "config": config,
            "state_dict": state_dict_from_flax(jax.device_get(params), config)}


@pytest.fixture(scope="module")
def tiny1():
    return _tiny(1)


@pytest.fixture(scope="module")
def tiny2():
    return _tiny(2)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    ids = rng.integers(4, VOCAB, size=(3, 12)).astype(np.int32)
    mask = np.ones((3, 12), dtype=np.int32)
    mask[1, 8:] = 0
    mask[2, 5:] = 0
    return ids, mask


def _pair(tiny, cls_name: str):
    jax_model = getattr(jax_wrappers, cls_name)(tiny["jax_config"], tiny["params"],
                                                attention_impl="xla")
    port_model = getattr(hf_wrappers, cls_name)(tiny["config"], tiny["state_dict"],
                                                device="cpu")
    return jax_model, port_model


def _close(got: torch.Tensor, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               atol=atol, rtol=rtol)


def _loss_close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_seq_cls_logits_and_fields(tiny1, batch):
    jax_model, model = _pair(tiny1, "OpenProvenceForSequenceClassification")
    ids, mask = batch
    out, ref = model(ids, mask), jax_model(ids, mask)
    assert out.loss is None and out.hidden_states is None
    assert out.logits.shape == (3, 1) and out.pruning_logits.shape == (3, 12, 2)
    assert out.logits.dtype == torch.float32 and not out.logits.requires_grad
    assert torch.equal(out.logits, out.ranking_logits)
    _close(out.logits, ref.logits)
    valid = mask.astype(bool)
    _close(out.pruning_logits[torch.from_numpy(valid)], np.asarray(ref.pruning_logits)[valid])
    tup = model(ids, mask, return_dict=False)
    assert isinstance(tup, tuple) and len(tup) == 2
    assert torch.equal(tup[0], out.logits) and torch.equal(tup[1], out.pruning_logits)
    # tensors in, and the forward alias
    again = model.forward(torch.from_numpy(ids), torch.from_numpy(mask))
    assert torch.equal(again.logits, out.logits)


def test_seq_cls_bce_loss(tiny1, batch):
    jax_model, model = _pair(tiny1, "OpenProvenceForSequenceClassification")
    ids, mask = batch
    labels = np.array([1.0, 0.0, 1.0], dtype=np.float32)
    out = model(ids, mask, labels=labels)
    _loss_close(out.loss, jax_model(ids, mask, labels=labels).loss)
    want = torch.nn.BCEWithLogitsLoss()(out.logits.view(-1), torch.tensor(labels))
    _loss_close(out.loss, want)
    loss, ranking, pruning = model(ids, mask, labels=labels, return_dict=False)
    assert float(loss) == float(out.loss) and pruning.shape == (3, 12, 2)


def test_seq_cls_ce_loss(tiny2, batch):
    jax_model, model = _pair(tiny2, "OpenProvenceForSequenceClassification")
    ids, mask = batch
    labels = np.array([1, 0, 1], dtype=np.int32)
    out = model(ids, mask, labels=labels)
    assert out.logits.shape == (3, 2)
    _close(out.logits, jax_model(ids, mask).logits)
    _loss_close(out.loss, jax_model(ids, mask, labels=labels).loss)
    want = torch.nn.CrossEntropyLoss()(out.logits.view(-1, 2), torch.tensor(labels).long())
    _loss_close(out.loss, want)
    ignored = np.array([1, -100, 0], dtype=np.int32)
    _loss_close(model(ids, mask, labels=ignored).loss,
                jax_model(ids, mask, labels=ignored).loss)


def test_token_cls_masked_ce(tiny1, batch):
    jax_model, model = _pair(tiny1, "OpenProvenceForTokenClassification")
    ids, mask = batch
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 2, size=ids.shape).astype(np.int32)
    labels[0, :2] = -100  # ignored inside the active region too
    out = model(ids, mask, labels=labels)
    assert out.logits.shape == (3, 12, 2) and out.ranking_logits.shape == (3, 1)
    _loss_close(out.loss, jax_model(ids, mask, labels=labels).loss)
    active = torch.from_numpy(mask).view(-1) == 1
    want = torch.nn.CrossEntropyLoss()(out.logits.view(-1, 2)[active],
                                       torch.from_numpy(labels).long().view(-1)[active])
    _loss_close(out.loss, want)
    # without a mask every position is active
    _loss_close(model(ids, labels=labels).loss, jax_model(ids, labels=labels).loss)
    loss, pruning = model(ids, mask, labels=labels, return_dict=False)
    assert float(loss) == float(out.loss) and torch.equal(pruning, out.logits)
    assert len(model(ids, mask, return_dict=False)) == 1


def test_token_cls_edge_cases(tiny1):
    jax_model, model = _pair(tiny1, "OpenProvenceForTokenClassification")
    ids = np.full((1, 8), 4, dtype=np.int32)
    # no active position: 0.0
    mask = np.zeros((1, 8), dtype=np.int32)
    labels = np.ones((1, 8), dtype=np.int32)
    out = model(ids, mask, labels=labels)
    assert float(out.loss) == 0.0 == float(jax_model(ids, mask, labels=labels).loss)
    # active positions whose labels are all -100: NaN, as the JAX wrapper
    mask = np.ones((1, 8), dtype=np.int32)
    ignored = np.full((1, 8), -100, dtype=np.int32)
    assert np.isnan(float(model(ids, mask, labels=ignored).loss))
    assert np.isnan(float(jax_model(ids, mask, labels=ignored).loss))


def test_token_cls_matches_the_sequence_view(tiny1, batch):
    _, seq = _pair(tiny1, "OpenProvenceForSequenceClassification")
    _, tok = _pair(tiny1, "OpenProvenceForTokenClassification")
    ids, mask = batch
    assert torch.equal(seq(ids, mask).pruning_logits, tok(ids, mask).logits)
    assert tok.num_labels == 2 and seq.num_labels == 1


def test_one_row_and_no_mask(tiny1, batch):
    """A 1-D input_ids is a batch of one; a None mask is all ones."""
    jax_model, model = _pair(tiny1, "OpenProvenceForSequenceClassification")
    ids = batch[0][0]
    out = model(ids)
    assert out.logits.shape == (1, 1) and out.pruning_logits.shape == (1, 12, 2)
    _close(out.logits, jax_model(ids).logits)
    ones = np.ones((1, 12), np.int32)
    assert torch.equal(model(ids[None], ones).logits, out.logits)
    with pytest.raises(ValueError, match="input_ids"):
        model(None)
    with pytest.raises(ValueError, match="attention_impl"):
        hf_wrappers.OpenProvenceForSequenceClassification(
            tiny1["config"], tiny1["state_dict"], device="cpu", attention_impl="mosaic")


def test_dtype_and_device_placement(tiny1, batch):
    model = hf_wrappers.OpenProvenceForSequenceClassification(
        tiny1["config"], tiny1["state_dict"], device="cpu", dtype=torch.bfloat16)
    out = model(*batch, labels=np.array([1.0, 0.0, 1.0]))
    assert out.logits.dtype == torch.bfloat16 and out.loss.dtype == torch.float32
    assert model.device == torch.device("cpu")


def test_from_pretrained_and_auto_map(tmp_path, tiny1, batch):
    out_dir = OpenProvenceEncoder(config=tiny1["config"], state_dict=tiny1["state_dict"],
                                  tokenizer=DummyTokenizer(), device="cpu"
                                  ).save_pretrained(tmp_path / "ckpt")
    cfg = json.loads((out_dir / "config.json").read_text())
    assert cfg["auto_map"] == hf_wrappers.AUTO_MAP == jax_wrappers.AUTO_MAP
    assert cfg["architectures"] == hf_wrappers.ARCHITECTURES == jax_wrappers.ARCHITECTURES
    ids, mask = batch
    direct = hf_wrappers.OpenProvenceForSequenceClassification(
        tiny1["config"], tiny1["state_dict"], device="cpu")
    for name in ("OpenProvenceForSequenceClassification", "OpenProvenceForTokenClassification"):
        loaded = getattr(hf_wrappers, name).from_pretrained(out_dir, device="cpu",
                                                            attention_impl="xla")
        assert torch.equal(loaded(ids, mask).ranking_logits, direct(ids, mask).logits)
    # the JAX wrapper reads the port's export
    jax_loaded = jax_wrappers.OpenProvenceForSequenceClassification.from_pretrained(
        out_dir, attention_impl="xla")
    _close(direct(ids, mask).logits, jax_loaded(ids, mask).logits)


def test_package_names_the_wrappers():
    import open_provence_tpu_torch as port
    from open_provence_tpu_torch import modeling_open_provence_tpu as shim
    from open_provence_tpu import modeling_open_provence_tpu as jax_shim

    assert port.OpenProvenceForTokenClassification is hf_wrappers.OpenProvenceForTokenClassification
    assert shim.__all__ == jax_shim.__all__
    assert shim.DEFAULT_PROCESS_THRESHOLD == jax_shim.DEFAULT_PROCESS_THRESHOLD
    for name in shim.__all__[1:]:
        assert getattr(shim, name).__module__.startswith("open_provence_tpu_torch."), name
