"""The port's process() against the JAX engine's, on the CPU.

Same tiny random weights (the JAX module's params, moved by
``state_dict_from_flax``), same char-ordinal DummyTokenizer, the cases of
tests/test_process_engine.py. ``pruned_context`` and every sentence's
keep/drop decision must match exactly; scores and sentence probabilities
within 1e-5 (fp32 sums in other orders).
"""

import jax
import numpy as np
import pytest

from open_provence_tpu.configs import ModernBertBackboneConfig as JaxBackboneConfig
from open_provence_tpu.configs import OpenProvenceConfig as JaxConfig
from open_provence_tpu.inference import OpenProvenceModel as JaxModel
from open_provence_tpu.models.model import build_module as build_jax_module
from open_provence_tpu_torch.configs import ModernBertBackboneConfig, OpenProvenceConfig
from open_provence_tpu_torch.inference import OpenProvenceModel
from open_provence_tpu_torch.utils.convert import state_dict_from_flax

from tests.dummy_tokenizers import DummyTokenizer

BACKBONE = dict(
    vocab_size=512, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
    num_attention_heads=2, max_position_embeddings=128, local_attention=16,
    global_attn_every_n_layers=3, pad_token_id=0, num_labels=1,
)
CONTEXT = "First sentence about sushi. Second one about work. Third about plants."
LONG_CONTEXT = " ".join(f"Sentence number {i} talks about topic {i}." for i in range(40))


def _config(cls, backbone_cls):
    return cls(
        base_model_config=backbone_cls(**BACKBONE).to_dict(),
        num_labels=1,
        pruning_config={"hidden_size": 32, "classifier_dropout": 0.0},
        max_length=64,
    )


@pytest.fixture(scope="module")
def engines():
    jax_config = _config(JaxConfig, JaxBackboneConfig)
    params = build_jax_module(jax_config).init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32),
        attention_impl="xla",
    )["params"]
    jax_model = JaxModel(
        jax_config, params, DummyTokenizer(), attention_impl="xla", bucket_step=16
    )
    config = _config(OpenProvenceConfig, ModernBertBackboneConfig)
    torch_model = OpenProvenceModel(
        config, state_dict_from_flax(jax.device_get(params), config), DummyTokenizer(),
        device="cpu", bucket_step=16,
    )
    return jax_model, torch_model


def _flat(x):
    if isinstance(x, list):
        return [v for item in x for v in _flat(item)]
    return [x]


def _assert_same(ref, out):
    for key in ("pruned_context", "title", "kept_sentences", "removed_sentences"):
        assert out.get(key) == ref.get(key), key
    for key in ("reranking_score", "sentence_probabilities", "compression_rate"):
        got, want = _flat(out.get(key)), _flat(ref.get(key))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_allclose(np.asarray(g, float), np.asarray(w, float), atol=1e-5)


CASES = {
    "str": (("what food?", CONTEXT), {}),
    "list": (("q", [CONTEXT, "Another document. More text."]), {}),
    "aligned": ((["q1", "q2"], [CONTEXT, "Second doc text."]), {}),
    "nested": (
        (["q1", "q2"], [[CONTEXT, "extra doc."], ["Pre-split one.", "Pre-split two."]]),
        {},
    ),
    "threshold_0": (("q", CONTEXT), {"threshold": 0.0}),
    "threshold_1": (("q", CONTEXT), {"threshold": 1.0}),
    "threshold_half": (("q", [CONTEXT, LONG_CONTEXT]), {"threshold": 0.5}),
    "explicit_title_prefix": (("q", CONTEXT), {"title": "Sushi Title", "threshold": 0.0}),
    "title_prefix_pruning": (("q", [CONTEXT, LONG_CONTEXT]), {"title": "Sushi Title"}),
    "first_line_as_title": (
        ("q", "Title Line\nBody sentence one. Body sentence two."),
        {"first_line_as_title": True},
    ),
    "reorder_top_k": (
        ("q", [CONTEXT, "Doc two text.", "Doc three text."]),
        {"reorder": True, "top_k": 2},
    ),
    "long_multiblock": (("q", LONG_CONTEXT), {}),
    "long_multiblock_threshold_0": (("q", LONG_CONTEXT), {"threshold": 0.0}),
    "small_batches_pipelined": (
        ("q", [f"Sentence {i} about sushi and topic {i}. Second thought on {i}." for i in range(12)]),
        {"batch_size": 3, "preprocess_batch_size": 2},
    ),
}


@pytest.mark.parametrize("case", list(CASES))
def test_process_matches_jax(engines, case):
    jax_model, torch_model = engines
    args, kwargs = CASES[case]
    kwargs = dict(
        kwargs, show_progress=False, return_sentence_metrics=True, return_sentence_texts=True
    )
    ref = jax_model.process(*args, **kwargs)
    out = torch_model.process(*args, **kwargs)
    _assert_same(ref, out)
    if kwargs.get("threshold") == 0.0:
        assert _flat(out["pruned_context"]) == _flat(args[1])
    if kwargs.get("threshold") == 1.0:
        assert out["pruned_context"] == "" and out["reranking_score"] == 0.0


@pytest.mark.parametrize(
    "args",
    [(["q1", "q2"], [CONTEXT]), (["q1", "q2"], [[CONTEXT], "plain"])],
    ids=["count", "nesting"],
)
def test_process_shape_errors_match(engines, args):
    for model in engines:
        with pytest.raises(ValueError):
            model.process(*args, show_progress=False)


def test_warmup_runs_every_bucket(engines):
    _jax_model, torch_model = engines
    assert torch_model.warmup(batch_size=2) == [(2, n) for n in (16, 32, 48, 64)]
