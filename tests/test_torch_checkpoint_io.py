"""The port's checkpoint entry points against the JAX package's, on the CPU.

* ``utils/hf_convert.py::load_checkpoint`` on the three accepted layouts
  (merged, legacy root-level keys, a flat backbone without ``model.``) and
  every bias layout, each written here from one seeded ``init_params`` state
  dict: the same logits as the JAX ``load_checkpoint`` + module on the same
  files (fp32, 1e-5).
* ``OpenProvenceModel.from_pretrained`` on a directory the port's trainer
  exported: the same ``process()`` output as the JAX engine's
  ``from_pretrained`` on it; its errors.
* The raw-prediction APIs against the JAX engine's on the fixtures of
  tests/test_process_engine.py: ranges equal, probabilities within 1e-5,
  threshold sweeps equal.
* A float64 oracle: a transformers ModernBERT saved with ``save_pretrained``
  (root-level keys) loads through ``init_encoder`` and ``load_checkpoint``
  to the same ranking logits in float64.

Each JAX oracle is built once, with the default gates.
"""

import jax
import numpy as np
import pytest
import torch

from open_provence_tpu.configs import ModernBertBackboneConfig as JaxBackboneConfig
from open_provence_tpu.configs import OpenProvenceConfig as JaxConfig
from open_provence_tpu.inference import OpenProvenceModel as JaxModel
from open_provence_tpu.models.model import build_module as build_jax_module
from open_provence_tpu.utils.hf_convert import load_checkpoint as jax_load_checkpoint
from open_provence_tpu_torch import (
    ModernBertBackboneConfig,
    OpenProvenceConfig,
    OpenProvenceModel,
    build_module,
    init_params,
)
from open_provence_tpu_torch.encoder import OpenProvenceEncoder
from open_provence_tpu_torch.train import OpenProvenceTrainer
from open_provence_tpu_torch.train.encoder_init import init_encoder
from open_provence_tpu_torch.utils import safetensors_io
from open_provence_tpu_torch.utils.convert import state_dict_from_flax
from open_provence_tpu_torch.utils.hf_convert import (
    detect_architecture,
    load_checkpoint,
    normalize_state_dict,
)

from tests.dummy_tokenizers import DummyTokenizer

BACKBONE = dict(
    vocab_size=512, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
    num_attention_heads=2, max_position_embeddings=128, local_attention=16,
    global_attn_every_n_layers=3, pad_token_id=0, num_labels=1,
)
BIAS_LAYOUTS = {
    "none": {},
    "norm_bias": dict(norm_bias=True),
    "attention_bias": dict(attention_bias=True),
    "mlp_bias": dict(mlp_bias=True),
    "all_three": dict(norm_bias=True, attention_bias=True, mlp_bias=True),
}
CONTEXT = "First sentence about sushi. Second one about work. Third about plants."
LONG_CONTEXT = " ".join(f"Sentence number {i} talks about topic {i}." for i in range(40))


def _config(cls, backbone_cls, **flags):
    return cls(
        base_model_config=backbone_cls(**BACKBONE, **flags).to_dict(),
        num_labels=1,
        pruning_config={"hidden_size": 32, "classifier_dropout": 0.0},
        max_length=64,
    )


def _seeded_state_dict(config, seed=0):
    """init_params with every bias drawn at random (init leaves them 0)."""
    gen = torch.Generator().manual_seed(seed)
    sd = init_params(config, gen)
    return {k: torch.randn(v.shape, generator=gen) * 0.1 if k.endswith(".bias") else v
            for k, v in sd.items()}


def _legacy(sd):
    """Root-level keys: no ranking_model. prefix (standalone:1452-1464)."""
    return {k.removeprefix("ranking_model."): v for k, v in sd.items()}


def _flat(sd):
    """A flat backbone: ranking_model.embeddings.* without model."""
    return {k.replace("ranking_model.model.", "ranking_model.", 1): v for k, v in sd.items()}


CHECKPOINT_LAYOUTS = {"merged": dict, "legacy_root_level": _legacy, "flat_backbone": _flat}


def _write(directory, config, sd):
    config.save(directory)
    safetensors_io.save_file(sd, directory / "model.safetensors")
    return directory


def _ids_and_mask():
    rng = np.random.default_rng(3)
    ids = rng.integers(3, BACKBONE["vocab_size"], size=(2, 24)).astype(np.int32)
    mask = np.ones((2, 24), dtype=np.int32)
    mask[1, 17:] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("bias", list(BIAS_LAYOUTS))
@pytest.mark.parametrize("layout", list(CHECKPOINT_LAYOUTS))
def test_load_checkpoint_matches_jax(tmp_path, layout, bias):
    config = _config(OpenProvenceConfig, ModernBertBackboneConfig, **BIAS_LAYOUTS[bias])
    sd = _seeded_state_dict(config)
    # A key no module reads is dropped, as the JAX mapping ignores it.
    extended = {**sd, "ranking_model.unused.weight": torch.ones(3)}
    written = CHECKPOINT_LAYOUTS[layout](extended)
    assert (written.keys() == extended.keys()) == (layout == "merged")
    directory = _write(tmp_path, config, written)

    loaded_config, loaded = load_checkpoint(directory)
    assert loaded_config.to_dict() == config.to_dict()
    assert set(loaded) == set(sd)
    for key, value in sd.items():
        assert torch.equal(loaded[key], value), key

    jax_config, params = jax_load_checkpoint(directory)
    ids, mask = _ids_and_mask()
    ref = build_jax_module(jax_config).apply(
        {"params": params}, ids, mask, deterministic=True, attention_impl="xla"
    )
    module = build_module(loaded_config).eval()
    module.load_state_dict(loaded)
    with torch.no_grad():
        out = module(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    for key in ("ranking_logits", "pruning_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-5, rtol=1e-5)


def test_normalize_and_detect_match_jax():
    from open_provence_tpu.utils.hf_convert import detect_architecture as jax_detect
    from open_provence_tpu.utils.hf_convert import normalize_state_dict as jax_normalize

    config = _config(OpenProvenceConfig, ModernBertBackboneConfig)
    sd = dict(init_params(config, torch.Generator().manual_seed(0)))
    for layout in CHECKPOINT_LAYOUTS.values():
        written = layout(sd)
        assert list(normalize_state_dict(written)) == list(jax_normalize(written))
        assert detect_architecture(list(written)) == jax_detect(list(written)) == "modernbert"
    for keys in (["bert.embeddings.word_embeddings.weight"], ["roberta.encoder.x"], ["w"]):
        assert detect_architecture(keys) == jax_detect(keys)


def test_load_checkpoint_errors(tmp_path):
    config = _config(OpenProvenceConfig, ModernBertBackboneConfig)
    config.save(tmp_path)
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        load_checkpoint(tmp_path)
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        OpenProvenceModel.from_pretrained(tmp_path, tokenizer=DummyTokenizer(), device="cpu")
    sd = init_params(config, torch.Generator().manual_seed(0))
    del sd["ranking_model.model.layers.1.mlp.Wo.weight"]
    safetensors_io.save_file(sd, tmp_path / "model.safetensors")
    with pytest.raises(KeyError, match="layers.1.mlp.Wo.weight"):
        load_checkpoint(tmp_path)
    # The JAX loader refuses the same file with the same error type.
    with pytest.raises(KeyError):
        jax_load_checkpoint(tmp_path)


@pytest.mark.parametrize("entry", ["model", "encoder"])
def test_entry_points_refuse_a_bad_attention_impl_and_a_missing_card(tmp_path, monkeypatch, entry):
    config = _config(OpenProvenceConfig, ModernBertBackboneConfig)
    _write(tmp_path, config, init_params(config, torch.Generator().manual_seed(0)))
    load = (OpenProvenceModel if entry == "model" else OpenProvenceEncoder).from_pretrained
    with pytest.raises(ValueError, match="attention_impl"):
        load(tmp_path, tokenizer=DummyTokenizer(), device="cpu", attention_impl="flash")
    for impl in ("auto", "xla", "pallas"):
        assert load(tmp_path, tokenizer=DummyTokenizer(), device="cpu", attention_impl=impl)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="first CUDA card"):
        load(tmp_path, tokenizer=DummyTokenizer())


# --- from_pretrained on the trainer's export, against the JAX engine --------


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A directory OpenProvenceTrainer.export_model wrote after one step,
    loaded by both engines' from_pretrained."""
    from tests.dummy_tokenizers import PairDummyTokenizer
    from open_provence_tpu_torch.train.collator import OpenProvenceDataCollator

    tmp = tmp_path_factory.mktemp("export")
    config = _config(OpenProvenceConfig, ModernBertBackboneConfig)
    trainer = OpenProvenceTrainer(
        config, init_params(config, torch.Generator().manual_seed(1)), PairDummyTokenizer(),
        output_dir=tmp / "run", learning_rate=1e-2, total_steps=4, bf16=False, seed=5,
        device="cpu",
    )
    rows = [{"query": "q", "texts": ["abc def. ghi."], "context_spans": [[[0, 8], [9, 13]]],
             "context_spans_relevance": [[1, 0]], "labels": [1], "teacher_score": [0.8]}]
    batch = OpenProvenceDataCollator(
        tokenizer=PairDummyTokenizer(), max_length=64, scores_column="teacher_score",
        chunks_pos_column="context_spans", relevant_chunks_column="context_spans_relevance",
        pad_pairs_to=2,
    )(rows)
    for _ in range(2):  # the first step's learning rate is 0
        trainer.train_one_step(batch)
    directory = trainer.export_model(tmp / "export")
    jax_model = JaxModel.from_pretrained(
        directory, tokenizer=DummyTokenizer(), attention_impl="xla", bucket_step=16
    )
    torch_model = OpenProvenceModel.from_pretrained(
        directory, tokenizer=DummyTokenizer(), device="cpu", bucket_step=16
    )
    return directory, jax_model, torch_model


def _flat_list(x):
    if isinstance(x, list):
        return [v for item in x for v in _flat_list(item)]
    return [x]


PROCESS_CASES = {
    "str": (("what food?", CONTEXT), {}),
    "nested": ((["q1", "q2"], [[CONTEXT, "extra doc."], ["Pre-split one.", "Two."]]), {}),
    "threshold_0": (("q", CONTEXT), {"threshold": 0.0}),
    "long_threshold_half": (("q", [CONTEXT, LONG_CONTEXT]), {"threshold": 0.5}),
    "title_prefix": (("q", [CONTEXT, LONG_CONTEXT]), {"title": "Sushi Title"}),
}


@pytest.mark.parametrize("case", list(PROCESS_CASES))
def test_from_pretrained_process_matches_jax(exported, case):
    _, jax_model, torch_model = exported
    args, kwargs = PROCESS_CASES[case]
    kwargs = dict(kwargs, show_progress=False, return_sentence_metrics=True)
    ref, out = jax_model.process(*args, **kwargs), torch_model.process(*args, **kwargs)
    for key in ("pruned_context", "title", "kept_sentences", "removed_sentences"):
        assert out.get(key) == ref.get(key), key
    for key in ("reranking_score", "sentence_probabilities", "compression_rate"):
        np.testing.assert_allclose(np.asarray(_flat_list(out[key]), float),
                                   np.asarray(_flat_list(ref[key]), float), atol=1e-5)


def test_from_pretrained_takes_max_length_and_the_weights_dtype(exported):
    directory, _, torch_model = exported
    assert torch_model.module.ranking_model.classifier.weight.dtype == torch.float32
    assert torch_model.max_length == 64
    shorter = OpenProvenceModel.from_pretrained(
        directory, tokenizer=DummyTokenizer(), device="cpu", max_length=32,
        dtype=torch.float64,
    )
    assert shorter.max_length == shorter.config.max_length == 32
    assert shorter.module.ranking_model.classifier.weight.dtype == torch.float64


# --- the raw-prediction APIs -------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    jax_config = _config(JaxConfig, JaxBackboneConfig)
    params = build_jax_module(jax_config).init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32),
        attention_impl="xla",
    )["params"]
    jax_model = JaxModel(jax_config, params, DummyTokenizer(), attention_impl="xla",
                         bucket_step=16)
    config = _config(OpenProvenceConfig, ModernBertBackboneConfig)
    torch_model = OpenProvenceModel(
        config, state_dict_from_flax(jax.device_get(params), config), DummyTokenizer(),
        device="cpu", bucket_step=16,
    )
    return jax_model, torch_model


def _same_raw(ref, out):
    assert out.query == ref.query and out.contexts == ref.contexts
    assert out.context_ranges == ref.context_ranges
    assert out.pruning_probs.dtype == np.float32 and out.pruning_probs.shape == ref.pruning_probs.shape
    np.testing.assert_allclose(out.pruning_probs, ref.pruning_probs, atol=1e-5)
    np.testing.assert_allclose(out.ranking_score, ref.ranking_score, atol=1e-5)


RAW_CASES = {
    "fixture": ("query", [["First chunk text. ", "Second chunk here."]], None),
    "three_rows": ("query", [["First chunk text. ", "Second."], ["Only one context."],
                             ["a. ", "b. ", "c."]], None),
    "per_row_queries_in_steps": (["q1", "q2", "q3"], [["Alpha one. ", "Beta."], ["Gamma."],
                                                      [LONG_CONTEXT[:90], "Tail."]], 2),
    "empty_row": ("q", [[], ["Some text."]], None),
}


@pytest.mark.parametrize("case", list(RAW_CASES))
def test_raw_predictions_batch_matches_jax(engines, case):
    jax_model, torch_model = engines
    query, contexts_batch, step = RAW_CASES[case]
    ref = jax_model.get_raw_predictions_batch(query, contexts_batch, batch_size=step)
    out = torch_model.get_raw_predictions_batch(query, contexts_batch, batch_size=step)
    assert len(out) == len(ref) == sum(1 for c in contexts_batch if c)
    for r, o in zip(ref, out):
        _same_raw(r, o)


def test_raw_predictions_single_and_errors(engines):
    jax_model, torch_model = engines
    contexts = ["First chunk text. ", "Second chunk here."]
    _same_raw(jax_model.get_raw_predictions("query", contexts),
              torch_model.get_raw_predictions("query", contexts))
    assert torch_model.get_raw_predictions_batch("q", []) == []
    with pytest.raises(ValueError, match="count must match"):
        torch_model.get_raw_predictions_batch(["q1", "q2"], [["a."]])


@pytest.mark.parametrize("use_majority", [False, True])
def test_predict_with_thresholds_matches_jax(engines, use_majority):
    jax_model, torch_model = engines
    contexts = ["First chunk text. ", "Second chunk here.", ""]
    thresholds = [0.0, 0.25, 0.5, 0.75, 1.0]
    ref = jax_model.predict_with_thresholds("query", contexts, thresholds,
                                            use_majority=use_majority)
    out = torch_model.predict_with_thresholds("query", contexts, thresholds,
                                              use_majority=use_majority)
    assert out["predictions"] == ref["predictions"]
    assert out["predictions"][0.0] == [1, 1, 1] and out["predictions"][1.0] == [0, 0, 1]
    assert out["context_ranges"] == ref["context_ranges"]
    np.testing.assert_allclose(out["pruning_probs"], ref["pruning_probs"], atol=1e-5)


# --- a float64 oracle: transformers' ModernBERT -------------------------------


def test_hf_modernbert_checkpoint_loads_to_its_logits_in_float64(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf_config = transformers.ModernBertConfig(
        **{k: v for k, v in BACKBONE.items() if k != "pad_token_id"}, pad_token_id=0,
        bos_token_id=1, eos_token_id=2, cls_token_id=1, sep_token_id=2,
        classifier_pooling="cls", attn_implementation="eager", reference_compile=False,
    )
    torch.manual_seed(0)
    hf_model = transformers.ModernBertForSequenceClassification(hf_config).eval()
    hf_model.save_pretrained(tmp_path / "hf")  # root-level keys: model.*, head.*, classifier.*
    written = safetensors_io.load_file(tmp_path / "hf" / "model.safetensors")
    assert not any(k.startswith("ranking_model.") for k in written)

    ids, mask = _ids_and_mask()
    with torch.no_grad():
        want = hf_model.double()(input_ids=torch.from_numpy(ids).long(),
                                 attention_mask=torch.from_numpy(mask).long()).logits

    # init_encoder on the HF directory: the backbone and its classifier load,
    # the pruning head starts fresh.
    config, module, sd = init_encoder(tmp_path / "hf", num_labels=1, max_length=64,
                                      classifier_dropout=0.0, seed=0)
    for key, value in written.items():
        assert torch.equal(sd[f"ranking_model.{key}"], value), key
    # load_checkpoint on the same file beside an OpenProvence config and a
    # pruning head: the legacy root-level layout.
    written.update({k: v for k, v in sd.items() if k.startswith("pruning_head.")})
    _, loaded = load_checkpoint(_write(tmp_path / "ckpt", config, written))
    from_file = build_module(config)
    from_file.load_state_dict(loaded)
    for name, model in (("init_encoder", module), ("load_checkpoint", from_file)):
        model = model.double().eval()
        with torch.no_grad():
            got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))["ranking_logits"]
        assert got.dtype == torch.float64
        # float64 on both sides: they differ by summation order alone.
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-8, rtol=1e-8,
                                   err_msg=name)
