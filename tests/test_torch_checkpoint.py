"""The port's training checkpoints and losses, on the CPU.

* ``utils/safetensors_io.py`` writes the same bytes as the ``safetensors``
  package and reads its files.
* A trained model exported by the port's trainer loads in the JAX package
  (``load_safetensors_state_dict`` → ``normalize_state_dict`` →
  ``hf_to_flax_params``) and gives the same logits.
* Save, resume and continue gives the parameters of an uninterrupted run,
  dropout masks included; rotation, resume resolution and the loop.
* The losses against the JAX package's, edge cases included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save as st_save

import open_provence_tpu as jop
import open_provence_tpu_torch as top
from open_provence_tpu.models.model import build_module as build_jax_module
from open_provence_tpu.train import losses as jax_losses
from open_provence_tpu.utils.hf_convert import (
    hf_to_flax_params,
    load_safetensors_state_dict,
    normalize_state_dict,
)
from open_provence_tpu_torch.train import OpenProvenceTrainer, resolve_resume_checkpoint_path
from open_provence_tpu_torch.train import losses
from open_provence_tpu_torch.train.collator import OpenProvenceDataCollator
from open_provence_tpu_torch.utils import safetensors_io
from tests.dummy_tokenizers import PairDummyTokenizer


def test_safetensors_io_writes_the_package_bytes(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "b.weight": torch.randn(3, 5, generator=gen),
        "a.bias": torch.randn(7, generator=gen).to(torch.bfloat16),
        "count": torch.tensor(12, dtype=torch.int64),
        "z": torch.randn(2, 2, generator=gen, dtype=torch.float64),
        "h": torch.randn(4, generator=gen).to(torch.float16),
        "ids": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "mask": torch.tensor([True, False]),
        "empty": torch.zeros(0, 4),
    }
    for metadata in (None, {"format": "pt"}):
        path = tmp_path / "mine.safetensors"
        safetensors_io.save_file(tensors, path, metadata=metadata)
        assert path.read_bytes() == st_save(tensors, metadata=metadata)
        theirs = st_load_file(str(path))
        mine = safetensors_io.load_file(path)
        assert mine.keys() == theirs.keys() == tensors.keys()
        for name, t in tensors.items():
            assert mine[name].dtype == t.dtype and mine[name].shape == t.shape
            assert torch.equal(mine[name], t) and torch.equal(theirs[name], t)


def tiny_config(pkg, dropout=0.0):
    backbone = pkg.ModernBertBackboneConfig(
        vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=128, local_attention=16,
        pad_token_id=0, num_labels=1,
    )
    return pkg.OpenProvenceConfig(
        base_model_config=backbone.to_dict(), num_labels=1,
        pruning_config={"hidden_size": 64, "classifier_dropout": dropout}, max_length=48,
    )


def batch(shift=0.0):
    rows = [
        {"query": "q one", "texts": ["abc def. ghi.", "jkl mno pq."],
         "context_spans": [[[0, 8], [9, 13]], [[0, 11]]],
         "context_spans_relevance": [[1, 0], [1]], "labels": [1, 0],
         "teacher_score": [0.8 - shift, 0.3 + shift]},
        {"query": "two", "texts": ["rst uvw. xyz ab."],
         "context_spans": [[[0, 8], [9, 16]]], "context_spans_relevance": [[0, 1]],
         "labels": [1], "teacher_score": [0.6]},
    ]
    collator = OpenProvenceDataCollator(
        tokenizer=PairDummyTokenizer(), max_length=48, scores_column="teacher_score",
        chunks_pos_column="context_spans", relevant_chunks_column="context_spans_relevance",
        pad_pairs_to=4,
    )
    return collator(rows)


def trainer(tmp_path, dropout=0.0, **kw):
    config = tiny_config(top, dropout)
    params = top.init_params(config, torch.Generator().manual_seed(1))
    return OpenProvenceTrainer(
        config, params, PairDummyTokenizer(), output_dir=tmp_path, learning_rate=3e-3,
        total_steps=8, bf16=False, seed=5, device="cpu", **kw,
    )


def test_exported_model_loads_in_jax_with_the_same_logits(tmp_path):
    t = trainer(tmp_path)
    t.train_one_step(batch())
    export = t.export_model(tmp_path / "export")

    config = jop.OpenProvenceConfig.load(export)
    sd = normalize_state_dict(load_safetensors_state_dict(export / "model.safetensors"))
    params = hf_to_flax_params(sd, config)
    b = batch(0.1)
    ref = build_jax_module(config).apply(
        {"params": params}, jnp.asarray(b["input_ids"]), jnp.asarray(b["attention_mask"]),
    )
    module = top.build_module(top.OpenProvenceConfig.load(export)).eval()
    module.load_state_dict(safetensors_io.load_file(export / "model.safetensors"))
    with torch.no_grad():
        out = module(torch.as_tensor(b["input_ids"]).long(), torch.as_tensor(b["attention_mask"]))
    for key in ("ranking_logits", "pruning_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-5, rtol=1e-5)


def test_save_resume_continue_matches_uninterrupted(tmp_path):
    """Dropout 0.1 on the pruning head, so the resumed run must also replay
    the generator's masks."""
    steps = [batch(0.01 * i) for i in range(4)]
    straight = trainer(tmp_path / "a", dropout=0.1)
    for b in steps[:2]:
        straight.train_one_step(b)
    ckpt = straight.save_checkpoint()
    assert {p.name for p in ckpt.iterdir()} >= {
        "config.json", "model.safetensors", "optimizer.safetensors", "trainer_state.json",
    }
    losses_after = [straight.train_one_step(b)["loss"] for b in steps[2:]]

    resumed = trainer(tmp_path / "b", dropout=0.1)
    resumed.load_checkpoint(resolve_resume_checkpoint_path(tmp_path / "a").checkpoint_dir)
    assert resumed.step == 2
    assert [resumed.train_one_step(b)["loss"] for b in steps[2:]] == losses_after
    for name, p in straight.params.items():
        assert torch.equal(p, resumed.params[name]), name


def test_train_loop_logs_evaluates_and_rotates(tmp_path):
    logs = []
    t = trainer(tmp_path, save_total_limit=1, log_fn=logs.append)
    t.train(lambda: iter([batch(), batch(0.05)]), total_steps=4,
            eval_batches=lambda: iter([batch()]), eval_steps=2, logging_steps=1,
            save_steps=2)
    assert t.step == 4
    assert [e["step"] for e in logs if "loss" in e] == [1, 2, 3, 4]
    assert {"eval_loss", "eval_ranking_loss", "eval_pruning_loss"} <= set(logs[2])
    kept = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("checkpoint-"))
    assert t.best_checkpoint.name in kept and len(kept) <= 2
    with pytest.raises(FileNotFoundError):
        resolve_resume_checkpoint_path(tmp_path / "nope")


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    rank_logits = rng.normal(size=(5, 1)).astype(np.float32)
    targets = rng.uniform(size=5).astype(np.float32)
    pair_mask = np.array([1, 1, 1, 0, 1], np.float32)
    prune_logits = rng.normal(size=(5, 7, 2)).astype(np.float32)
    labels = rng.integers(0, 2, size=(5, 7))
    labels[:, :2] = -100
    t = torch.as_tensor
    for kw in ({}, {"use_raw_logits": False}, {"is_regression": False}):
        np.testing.assert_allclose(
            float(losses.ranking_loss(t(rank_logits), t(targets), t(pair_mask), **kw)),
            float(jax_losses.ranking_loss(rank_logits, targets, pair_mask, **kw)), rtol=1e-6,
        )
    np.testing.assert_allclose(
        float(losses.pruning_loss(t(prune_logits), t(labels), t(pair_mask))),
        float(jax_losses.pruning_loss(prune_logits, labels, pair_mask)), rtol=1e-6,
    )
    outputs = {"ranking_logits": t(rank_logits), "pruning_logits": t(prune_logits)}
    b = {"ranking_targets": t(targets), "pair_mask": t(pair_mask), "pruning_labels": t(labels)}
    loss_fn = losses.OpenProvenceLoss()
    total = loss_fn(outputs, b)
    ref, _ = jax_losses.joint_loss(
        {k: v.numpy() for k, v in outputs.items()}, {k: v.numpy() for k, v in b.items()}
    )
    np.testing.assert_allclose(float(total), float(ref), rtol=1e-6)
    assert set(loss_fn.last_loss_components) == {"ranking_loss", "pruning_loss"}
    # Every label ignored: 0; a non-finite loss: the 0.001 guard.
    ignored = torch.full((5, 7), -100)
    assert float(losses.pruning_loss(t(prune_logits), ignored, t(pair_mask))) == 0.0
    nan_logits = t(prune_logits).clone()
    nan_logits[0, 3] = float("nan")
    assert float(losses.pruning_loss(nan_logits, t(labels), t(pair_mask))) == pytest.approx(0.001)
