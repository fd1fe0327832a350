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
    assert torch_model.warmup(batch_size=2) == [
        key for n in (16, 32, 48, 64) for key in ((2, n), (2, n, 16))
    ]
    assert torch_model.warmup(batch_size=2, include_pooled=False) == [
        (2, n) for n in (16, 32, 48, 64)
    ]


def test_warmup_matches_the_jax_engine(engines):
    """The JAX engine's signature (names, kinds, defaults), and the same
    (rows, length) and (rows, length, fragment cap) keys for the same
    arguments: the pooled forward at each cap rounded to a power of two of
    at least 16."""
    import inspect

    jax_model, torch_model = engines

    def params(fn):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]

    assert params(torch_model.warmup) == params(jax_model.warmup)
    for kwargs in ({"batch_size": 3, "lengths": [16, 48]},
                   {"batch_size": 2, "lengths": [32], "fragment_caps": (5, 17)}):
        assert torch_model.warmup(**kwargs) == jax_model.warmup(**kwargs), kwargs
    assert torch_model.warmup(lengths=[16])[0] == (32, 16)  # process()'s default rows


class _SpyDispatcher:
    """Wraps the engine's dispatcher and records how process() built it and
    the rows of every forward it ran."""

    def __init__(self, monkeypatch, torch_model):
        from open_provence_tpu_torch.inference import engine

        self.built, self.rows = [], []
        real, spy = engine._BlockDispatcher, self

        class Dispatcher(real):
            def __init__(self, model, batch_size, **kwargs):
                spy.built.append((batch_size, kwargs["pipeline"]))
                super().__init__(model, batch_size, **kwargs)

        forward = torch_model._forward

        def counted(ids, mask):
            spy.rows.append(ids.shape[0])
            return forward(ids, mask)

        monkeypatch.setattr(engine, "_BlockDispatcher", Dispatcher)
        monkeypatch.setattr(torch_model, "_forward", counted)


def test_process_batch_size_zero_takes_one_row(engines, monkeypatch):
    """batch_size=0 dispatches one row a forward and None 32, as the JAX
    engine's max(batch_size, 1) and its GPU default do."""
    jax_model, torch_model = engines
    spy = _SpyDispatcher(monkeypatch, torch_model)
    args = ("q", [CONTEXT, "Another document. More text.", LONG_CONTEXT])
    for batch_size, rows in ((0, 1), (None, 32)):
        spy.built.clear()
        spy.rows.clear()
        out = torch_model.process(*args, batch_size=batch_size, show_progress=False)
        assert [b for b, _ in spy.built] == [rows]
        assert spy.rows and max(spy.rows) <= rows
        if batch_size == 0:
            assert set(spy.rows) == {1} and len(spy.rows) > 2
        _assert_same(jax_model.process(*args, batch_size=batch_size, show_progress=False), out)


def test_pipeline_gate_turns_off_the_early_flush(engines, monkeypatch):
    """OPEN_PROVENCE_TPU_PIPELINE=0 builds the dispatcher with
    pipeline=False, as in the JAX engine; the output does not change."""
    _jax_model, torch_model = engines
    spy = _SpyDispatcher(monkeypatch, torch_model)
    args, kwargs = CASES["small_batches_pipelined"]
    kwargs = dict(kwargs, show_progress=False, return_sentence_metrics=True)
    monkeypatch.delenv("OPEN_PROVENCE_TPU_PIPELINE", raising=False)
    pipelined = torch_model.process(*args, **kwargs)
    monkeypatch.setenv("OPEN_PROVENCE_TPU_PIPELINE", "0")
    gated = torch_model.process(*args, **kwargs)
    assert [p for _, p in spy.built] == [True, False]
    _assert_same(pipelined, gated)


# --- long context: max_length past 1024 --------------------------------------
#
# Buckets past 1024 double, and max_length itself is appended whatever it is:
# 1536 with a step of 512 gives 512, 1024, 1536. One document fills the 1536
# bucket and spills 500-odd tokens into a second block (the 1024 bucket), one
# fits a single long block, one is short. Three JAX compiles.

LONG_MAX = 1536
DOC_2_BLOCKS = " ".join(f"Sentence number {i} talks about topic {i} at length." for i in range(40))
DOC_1_BLOCK = " ".join(f"Line {i} is about plants and rivers." for i in range(35))


@pytest.fixture(scope="module")
def long_engines():
    def config(cls, backbone_cls):
        backbone = dict(BACKBONE, max_position_embeddings=2048)
        return cls(
            base_model_config=backbone_cls(**backbone).to_dict(), num_labels=1,
            pruning_config={"hidden_size": 32, "classifier_dropout": 0.0}, max_length=LONG_MAX,
        )

    jax_config = config(JaxConfig, JaxBackboneConfig)
    params = build_jax_module(jax_config).init(
        jax.random.PRNGKey(2), np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32),
        attention_impl="xla",
    )["params"]
    jax_model = JaxModel(
        jax_config, params, DummyTokenizer(), attention_impl="xla", bucket_step=512
    )
    torch_config = config(OpenProvenceConfig, ModernBertBackboneConfig)
    torch_model = OpenProvenceModel(
        torch_config, state_dict_from_flax(jax.device_get(params), torch_config),
        DummyTokenizer(), device="cpu", bucket_step=512,
    )
    return jax_model, torch_model


def test_long_context_buckets():
    from open_provence_tpu.inference.batching import length_buckets as jax_buckets
    from open_provence_tpu_torch.inference.batching import length_buckets

    for max_length, step in ((LONG_MAX, 512), (2048, 64), (3000, 128), (8192, 64)):
        buckets = length_buckets(max_length, step)
        assert buckets == jax_buckets(max_length, step)
        assert buckets[-1] == max_length and buckets == sorted(set(buckets))
    assert length_buckets(2048, 64)[-2:] == [1024, 2048]
    assert length_buckets(3000, 128)[-3:] == [1024, 2048, 3000]


@pytest.mark.parametrize("threshold", [None, 0.0, 0.5])
def test_process_past_1024_matches_jax(long_engines, threshold):
    jax_model, torch_model = long_engines
    assert len(DOC_2_BLOCKS) > LONG_MAX > len(DOC_1_BLOCK) > 1024
    seen = []
    forward = torch_model._forward_pooled

    def spy(ids, mask, *rest):
        seen.append((ids.shape[1], mask.sum(axis=1).tolist()))
        return forward(ids, mask, *rest)

    torch_model._forward_pooled = spy
    kwargs = dict(show_progress=False, return_sentence_metrics=True, return_sentence_texts=True)
    if threshold is not None:
        kwargs["threshold"] = threshold
    args = ("what about plants?", [DOC_2_BLOCKS, DOC_1_BLOCK, CONTEXT])
    try:
        out = torch_model.process(*args, **kwargs)
    finally:
        del torch_model._forward_pooled
    ref = jax_model.process(*args, **kwargs)
    _assert_same(ref, out)
    if threshold == 0.0:
        assert out["pruned_context"] == args[1]
    # The long buckets were really run, with rows filled past 1024 tokens,
    # and the document that fits max_length went out as one block.
    by_len = {seq: sorted(n for n in rows if n) for seq, rows in seen}
    assert set(by_len) == {512, 1024, LONG_MAX}
    assert len(by_len[LONG_MAX]) == 2 and by_len[LONG_MAX][0] > 1024
    assert by_len[LONG_MAX][1] > LONG_MAX - 16  # filled to the last sentence that fits
    assert len(by_len[1024]) == 1 and len(by_len[512]) == 1  # the spill, the short document


def test_warmup_walks_the_long_buckets(long_engines):
    _jax_model, torch_model = long_engines
    assert torch_model.warmup(batch_size=1) == [
        key for n in (512, 1024, LONG_MAX) for key in ((1, n), (1, n, 16))
    ]


def test_engine_without_a_device_needs_a_card():
    """device=None means the first card: on a machine without one the engine
    raises and names device="cpu", which runs."""
    import torch

    from open_provence_tpu_torch import init_params

    config = _config(OpenProvenceConfig, ModernBertBackboneConfig)
    sd = init_params(config, torch.Generator().manual_seed(0))
    if torch.cuda.is_available():
        assert OpenProvenceModel(config, sd, DummyTokenizer()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            OpenProvenceModel(config, sd, DummyTokenizer())
    model = OpenProvenceModel(config, sd, DummyTokenizer(), device="cpu", bucket_step=16)
    assert model.process("q", CONTEXT, threshold=0.0)["pruned_context"] == CONTEXT
