"""The port's OpenProvenceEncoder, encoder_init and sentence pooling against
the JAX package's, on the CPU.

Both encoders hold one weight set: the JAX encoder is built on the toy
backbone of ``scripts/make_toy_assets.py`` (its WordLevel fast tokenizer
gives real offsets and token_type_ids), saved with ``save_pretrained``, and
the port's encoder loads that directory. Every case of
tests/test_encoder_api.py runs on both: scores within 1e-5; pruned
documents, masks, compression ratios and chunk predictions equal. The
pooling functions of ``models/heads.py`` are held to the JAX ones in every
mode, invalid boundaries included (1e-6).
"""

import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from open_provence_tpu.encoder import OpenProvenceEncoder as JaxEncoder
from open_provence_tpu.models import heads as jax_heads
from open_provence_tpu.train.encoder_init import init_encoder as jax_init_encoder
from open_provence_tpu.utils.hf_convert import flax_params_to_hf
from open_provence_tpu_torch import OpenProvenceEncoder, OpenProvenceModel
from open_provence_tpu_torch.models import heads
from open_provence_tpu_torch.train.encoder_init import init_encoder
from open_provence_tpu_torch.utils import safetensors_io

REPO_ROOT = Path(__file__).resolve().parent.parent
PAIRS = [
    ("what about sushi ?", "sushi is the best dish . budget deadline boring ."),
    ("what about plants ?", "water the plants . sushi market far away ."),
]


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    sys.path.insert(0, str(REPO_ROOT / "scripts"))
    from make_toy_assets import build_backbone_dir, build_tokenizer

    tmp = tmp_path_factory.mktemp("enc")
    tokenizer, vocab_size = build_tokenizer(tmp / "backbone")
    build_backbone_dir(tmp / "backbone", vocab_size)
    jax_encoder = JaxEncoder(
        tmp / "backbone", tokenizer=tokenizer, max_length=64, attention_impl="xla",
        bucket_step=16,
    )
    saved = jax_encoder.save_pretrained(tmp / "jax_saved")
    torch_encoder = OpenProvenceEncoder.from_pretrained(
        saved, tokenizer=tokenizer, device="cpu", bucket_step=16
    )
    jax_encoder.tokenizer = Unpadded(tokenizer)
    return jax_encoder, torch_encoder, tmp


class Unpadded:
    """The tokenizer with ``padding`` off, for the JAX encoder: it attends
    every id the tokenizer gives it (its mask is each row's length), so the
    tokenizer's pads inside a batch would count as tokens. Without them it
    attends each pair's own tokens, as the port does with the tokenizer's
    mask."""

    def __init__(self, tokenizer):
        self._tokenizer = tokenizer

    def __call__(self, *args, **kwargs):
        return self._tokenizer(*args, **{**kwargs, "padding": False})

    def __getattr__(self, name):
        return getattr(self._tokenizer, name)


def _doc_boundary():
    doc = PAIRS[0][1]
    boundary = doc.index(". ") + 2
    return [(0, boundary), (boundary, len(doc))]


def _same(ref, out, path="out"):
    """Equal structure and values; floats within 1e-5."""
    if isinstance(ref, dict):
        assert set(out) == set(ref), path
        for key in ref:
            _same(ref[key], out[key], f"{path}.{key}")
    elif isinstance(ref, (list, tuple)):
        assert len(out) == len(ref), path
        for i, (r, o) in enumerate(zip(ref, out)):
            _same(r, o, f"{path}[{i}]")
    elif hasattr(ref, "to_dict"):
        assert type(out).__name__ == type(ref).__name__, path
        _same(ref.to_dict(), out.to_dict(), path)
    elif isinstance(ref, (float, np.floating)) or (
            isinstance(ref, np.ndarray) and ref.dtype.kind == "f"):
        np.testing.assert_allclose(np.asarray(out, float), np.asarray(ref, float), atol=1e-5,
                                   err_msg=path)
    else:
        assert np.array_equal(np.asarray(out), np.asarray(ref)), path


ENCODER_CASES = {
    "predict_batch": lambda e: e.predict(PAIRS, batch_size=2),
    "predict_single": lambda e: e.predict(PAIRS[0]),
    "predict_small_batches": lambda e: e.predict(PAIRS * 3, batch_size=4),
    "predict_apply_pruning": lambda e: e.predict(
        PAIRS, apply_pruning=True, pruning_threshold=0.5, return_documents=True),
    "pruning_threshold_0": lambda e: e.predict_with_pruning(
        PAIRS[0], pruning_threshold=0.0, return_documents=True),
    "pruning_threshold_1": lambda e: e.predict_with_pruning(
        PAIRS[0], pruning_threshold=1.0, return_documents=True),
    "pruning_batch_half": lambda e: e.predict_with_pruning(
        PAIRS, pruning_threshold=0.5, return_documents=True),
    "context_token_0": lambda e: e.predict_context(
        PAIRS[0], _doc_boundary(), token_threshold=0.0, chunk_threshold=0.5),
    "context_token_1": lambda e: e.predict_context(
        PAIRS[0], _doc_boundary(), token_threshold=1.0, chunk_threshold=0.5),
    "context_batch_half": lambda e: e.predict_context(
        PAIRS, [_doc_boundary(), [(0, 10), (10, 20), (20, 43)]], token_threshold=0.5,
        chunk_threshold=0.5),
    "prune": lambda e: e.prune(*PAIRS[0], threshold=0.0),
    "prune_return_sentences": lambda e: e.prune(*PAIRS[0], threshold=0.5,
                                                return_sentences=True),
    "prune_texts_0": lambda e: e.prune_texts([p[0] for p in PAIRS], [p[1] for p in PAIRS],
                                             threshold=0.0),
    "prune_texts_half_tokens": lambda e: e.prune_texts(
        [p[0] for p in PAIRS], [p[1] for p in PAIRS], threshold=0.5, return_tokens=True),
}


@pytest.mark.parametrize("case", list(ENCODER_CASES))
def test_encoder_matches_jax(encoders, case):
    jax_encoder, torch_encoder, _ = encoders
    ref, out = ENCODER_CASES[case](jax_encoder), ENCODER_CASES[case](torch_encoder)
    _same(ref, out)


def test_a_pair_scores_the_same_whatever_its_batch(encoders):
    """The tokenizer pads a batch to its longest pair; those pads are no
    tokens: a pair's score and keep probabilities do not depend on the pairs
    batched with it (the second pair is a token shorter than the first)."""
    _, enc, _ = encoders
    short = PAIRS[1]
    alone = enc.predict([short], batch_size=1)
    beside = enc.predict([PAIRS[0], short], batch_size=2)
    np.testing.assert_allclose(beside[1], alone[0], atol=1e-5)
    chunks = [[(0, len(pair[1]))] for pair in PAIRS]
    want = enc.predict_context([short], chunks[1:])[0]
    got = enc.predict_context(PAIRS, chunks)[1]
    assert len(got.token_scores) == len(want.token_scores) > 0
    np.testing.assert_allclose(got.token_scores, want.token_scores, atol=1e-5)


def test_encoder_thresholds_keep_and_empty_the_document(encoders):
    """The contract of tests/test_encoder_api.py on the port alone."""
    _, enc, _ = encoders
    scores = enc.predict(PAIRS, batch_size=2)
    assert isinstance(scores, np.ndarray) and scores.shape == (2,)
    out = enc.predict_with_pruning(PAIRS[0], pruning_threshold=0.0, return_documents=True)
    assert out.compression_ratio == 0.0 and out.num_pruned_sentences == 0
    assert "sushi" in out.pruned_documents[0]
    out = enc.predict_with_pruning(PAIRS[0], pruning_threshold=1.0, return_documents=True)
    assert out.compression_ratio == 1.0 and out.pruned_documents[0] == ""
    out = enc.predict_context(PAIRS[0], _doc_boundary(), token_threshold=0.0)
    assert out.chunk_predictions.tolist() == [1, 1] and out.compression_ratio == 0.0
    assert all(r["kept_ratio"] == 1.0 for r in enc.prune_texts(
        [p[0] for p in PAIRS], [p[1] for p in PAIRS], threshold=0.0))


def test_save_pretrained_round_trips_through_both_packages(encoders, tmp_path):
    jax_encoder, torch_encoder, tmp = encoders
    before = torch_encoder.config.to_dict()
    saved = torch_encoder.save_pretrained(tmp_path / "ckpt")
    assert torch_encoder.config.to_dict() == before
    assert (saved / "model.safetensors").exists() and (saved / "tokenizer.json").exists()
    # The same config.json as the JAX package writes for the same model.
    assert json.loads((saved / "config.json").read_text()) == json.loads(
        (tmp / "jax_saved" / "config.json").read_text())
    orig = torch_encoder.predict(PAIRS)
    again = OpenProvenceEncoder.from_pretrained(saved, tokenizer=torch_encoder.tokenizer,
                                                device="cpu", bucket_step=16)
    np.testing.assert_array_equal(again.predict(PAIRS), orig)
    in_jax = JaxEncoder.from_pretrained(saved, tokenizer=Unpadded(torch_encoder.tokenizer),
                                        attention_impl="xla", bucket_step=16)
    np.testing.assert_allclose(in_jax.predict(PAIRS), orig, atol=1e-5)
    # The same checkpoint serves through the port's inference engine.
    model = OpenProvenceModel.from_pretrained(saved, tokenizer=torch_encoder.tokenizer,
                                              device="cpu", bucket_step=16)
    result = model.process(PAIRS[0][0], PAIRS[0][1], threshold=0.0, show_progress=False)
    assert result["pruned_context"] == PAIRS[0][1]


def test_export_ranking_model_matches_jax(encoders, tmp_path):
    jax_encoder, torch_encoder, _ = encoders
    ours = torch_encoder.export_ranking_model(tmp_path / "ours")
    theirs = jax_encoder.export_ranking_model(tmp_path / "theirs")
    mine = safetensors_io.load_file(ours / "model.safetensors")
    want = safetensors_io.load_file(theirs / "model.safetensors")
    assert mine.keys() == want.keys()
    assert not any(k.startswith("pruning_head") for k in mine) and "classifier.weight" in mine
    for key, value in want.items():
        assert mine[key].dtype == value.dtype == torch.float32
        assert torch.equal(mine[key], value), key
    assert json.loads((ours / "config.json").read_text()) == json.loads(
        (theirs / "config.json").read_text())


# --- encoder_init --------------------------------------------------------------


def test_init_encoder_builds_the_jax_config_for_each_directory_kind(encoders, tmp_path):
    jax_encoder, torch_encoder, tmp = encoders
    kinds = {
        "config_only": (tmp / "backbone", dict(num_labels=None)),
        "open_provence": (tmp / "jax_saved", dict(num_labels=1)),
    }
    for name, (directory, kw) in kinds.items():
        raw = (directory / "config.json").read_text()
        config, module, sd = init_encoder(directory, max_length=48, classifier_dropout=0.2,
                                          seed=3, **kw)
        jax_config, jax_module, params = jax_init_encoder(
            directory, max_length=48, classifier_dropout=0.2, seed=3, **kw)
        assert config.to_dict() == jax_config.to_dict(), name
        assert (directory / "config.json").read_text() == raw  # the file is not touched
        want = flax_params_to_hf(params, jax_config)
        assert {k: tuple(v.shape) for k, v in sd.items()} == {
            k: tuple(v.shape) for k, v in want.items()}, name
        assert all(torch.equal(t, sd[k]) for k, t in module.state_dict().items())
        if name == "open_provence":  # every tensor from the file
            for key, value in want.items():
                np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)
        else:  # seeded random init: the same draw for the same seed
            again = init_encoder(directory, max_length=48, classifier_dropout=0.2, seed=3)[2]
            assert all(torch.equal(again[k], v) for k, v in sd.items())


def test_init_encoder_keeps_a_fresh_tensor_where_shapes_differ(encoders, caplog):
    _, _, tmp = encoders
    with caplog.at_level(logging.WARNING, logger="open_provence_tpu_torch.train.encoder_init"):
        config, _, sd = init_encoder(tmp / "jax_saved", num_labels=2, max_length=64, seed=0)
    saved = safetensors_io.load_file(tmp / "jax_saved" / "model.safetensors")
    assert config.num_labels == 2 and sd["ranking_model.classifier.weight"].shape[0] == 2
    assert "Shape mismatch for ranking_model.classifier.weight" in caplog.text
    assert torch.equal(sd["ranking_model.head.dense.weight"],
                       saved["ranking_model.head.dense.weight"])
    with pytest.raises(FileNotFoundError, match="not found"):
        init_encoder(tmp / "missing")


def test_encoder_from_a_directory_and_its_refusals(encoders, monkeypatch):
    _, torch_encoder, tmp = encoders
    enc = OpenProvenceEncoder(tmp / "backbone", tokenizer=torch_encoder.tokenizer,
                              max_length=64, device="cpu", bucket_step=16, seed=7,
                              pruning_config={"dropout": 0.0})
    assert enc.config.pruning_config["classifier_dropout"] == 0.0
    assert enc.predict(PAIRS).shape == (2,)
    assert enc.module.ranking_model.classifier.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="model_name_or_path"):
        OpenProvenceEncoder(device="cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        OpenProvenceEncoder(tmp / "backbone", tokenizer=enc.tokenizer, device="cpu",
                            attention_impl="flash")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="first CUDA card"):
        OpenProvenceEncoder(tmp / "backbone", tokenizer=enc.tokenizer)


def test_encoder_is_a_lazy_export():
    import open_provence_tpu_torch
    from open_provence_tpu_torch.encoder import OpenProvenceEncoder as direct

    assert open_provence_tpu_torch.OpenProvenceEncoder is direct
    assert "OpenProvenceEncoder" in open_provence_tpu_torch.__all__
    with pytest.raises(AttributeError):
        open_provence_tpu_torch.NoSuchName  # noqa: B018


# --- sentence pooling -----------------------------------------------------------


def _pooling_case(seed=0, batch=3, seq=12, n_sent=5):
    """Random logits; boundaries with -1 padding, an empty span (end ==
    start), a reversed one and a span running to the end."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(batch, seq, 2)).astype(np.float32)
    boundaries = np.full((batch, n_sent, 2), -1, dtype=np.int64)
    for b in range(batch):
        cursor = 0
        for s in range(n_sent - 2):
            length = int(rng.integers(1, 4))
            boundaries[b, s] = [cursor, min(cursor + length, seq)]
            cursor += length
    boundaries[0, -2] = [5, 5]
    boundaries[1, -2] = [7, 4]
    boundaries[2, -2] = [9, seq]
    boundaries[2, -1] = [-1, 3]
    labels = rng.integers(0, 2, size=(batch, n_sent))
    return logits, boundaries, labels


POOLING_FUNCTIONS = {
    "pool": lambda m, lg, bd, lb, p: m.pool_sentence_values(lg, bd, p),
    "loss": lambda m, lg, bd, lb, p: m.sentence_loss(lg, lb, bd, p),
    "predict": lambda m, lg, bd, lb, p: m.predict_sentences(lg, bd, p),
}


@pytest.mark.parametrize("function", list(POOLING_FUNCTIONS))
@pytest.mark.parametrize("pooling", ["mean", "max", "first", "last"])
def test_sentence_pooling_matches_jax(function, pooling):
    logits, boundaries, labels = _pooling_case()
    fn = POOLING_FUNCTIONS[function]
    ref = fn(jax_heads, logits, boundaries, labels, pooling)
    out = fn(heads, *(torch.from_numpy(a) for a in (logits, boundaries, labels)), pooling)
    ref, out = (r if isinstance(r, tuple) else (r,) for r in (ref, out))
    for r, o in zip(ref, out):
        assert o.shape == tuple(np.shape(r))
        if o.dtype == torch.bool:
            assert np.array_equal(o.numpy(), np.asarray(r))
        else:
            assert o.dtype == torch.float32
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_sentence_loss_without_a_valid_boundary_is_zero():
    logits = torch.randn(2, 6, 2, generator=torch.Generator().manual_seed(0))
    boundaries = torch.full((2, 3, 2), -1, dtype=torch.int64)
    labels = torch.ones(2, 3, dtype=torch.int64)
    assert heads.sentence_loss(logits, labels, boundaries).item() == 0.0
    probs = heads.predict_sentences(logits, boundaries)
    assert torch.equal(probs, torch.full((2, 3, 2), 0.5))
