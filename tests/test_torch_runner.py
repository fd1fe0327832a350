"""The port's YAML runner and CLI against the JAX package's, and backbone
dropout, on the CPU.

* ``apply_cli_overrides`` gives the same argument dataclasses as the JAX
  one on the same argv.
* Both runners' ``train(..., max_steps_override=3)`` start from one
  checkpoint directory written from the JAX init (``flax_params_to_hf``):
  the toy 2-layer backbone of ``scripts/make_toy_assets.py``, max_length
  64, fp32, no dropout; the losses logged in ``checkpoint-3`` agree at REL.
* What the port refuses: the ``eval_datasets`` hook (ROADMAP A.7), a mesh
  (A.6), ``device=None`` without a card.
* Backbone dropout: the rate and 1/(1 - rate) scaling at each of the JAX
  module's sites, the identity in eval mode, gradients equal with and
  without per-layer recompute, and a bit-exact resume.
* A ``slow`` subprocess run of ``python -m open_provence_tpu_torch.train.cli``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from open_provence_tpu.train import config as jax_config
from open_provence_tpu.train import runner as jax_runner
from open_provence_tpu_torch import ModernBertBackboneConfig, OpenProvenceConfig, init_params
from open_provence_tpu_torch.models.heads import dropout
from open_provence_tpu_torch.models.model import build_module
from open_provence_tpu_torch.ops.geglu import ln_geglu
from open_provence_tpu_torch.train import OpenProvenceDataCollator, OpenProvenceTrainer
from open_provence_tpu_torch.train import config as port_config
from open_provence_tpu_torch.train import runner as port_runner
from tests.dummy_tokenizers import PairDummyTokenizer

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import make_toy_assets  # noqa: E402

REL = 1e-4


def _toy_yaml(model_dir: Path, dataset: Path, out_dir: Path, **training) -> str:
    settings = {
        "output_dir": str(out_dir), "optimizer": "adafactor", "learning_rate": 1.0e-3,
        "per_device_train_batch_size": 2, "gradient_accumulation_steps": 1,
        "logging_steps": 1, "save_steps": 3, "eval_steps": 3, "save_total_limit": 2,
        "bf16": False, "load_best_model_at_end": False, "num_train_epochs": 1,
        "per_device_eval_batch_size": 2, "report_to": [], "attention_impl": "xla",
        "mesh_data": 1, "device": "cpu", **training,
    }
    lines = ["model_args:", f'  model_name_or_path: "{model_dir}"',
             "  classifier_dropout: 0.0", "  max_length: 64", "data_args:",
             f'  dataset_name: "{dataset}"', '  teacher_column: "teacher_score"',
             "training_args:"]
    lines += [f"  {k}: {json.dumps(v)}" for k, v in settings.items()]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy backbone (2 layers), its fast tokenizer, 12 dataset rows and
    an OpenProvence checkpoint of the JAX init of that backbone."""
    from open_provence_tpu.train.encoder_init import init_encoder as jax_init_encoder
    from open_provence_tpu.utils.hf_convert import flax_params_to_hf, save_safetensors_state_dict

    root = tmp_path_factory.mktemp("runner")
    backbone = root / "backbone"
    _, vocab_size = make_toy_assets.build_tokenizer(backbone)
    make_toy_assets.build_backbone_dir(backbone, vocab_size)
    cfg = json.loads((backbone / "config.json").read_text())
    cfg.update(num_hidden_layers=2, max_position_embeddings=128)
    (backbone / "config.json").write_text(json.dumps(cfg))
    tokenizer, _ = make_toy_assets.build_tokenizer(backbone)
    make_toy_assets.build_dataset(root / "dataset", tokenizer, rows=12, seed=0)
    config, _, params = jax_init_encoder(backbone, max_length=64, classifier_dropout=0.0, seed=0)
    checkpoint = root / "checkpoint"
    config.save(checkpoint)
    save_safetensors_state_dict(flax_params_to_hf(params, config),
                                checkpoint / "model.safetensors")
    return {"root": root, "backbone": backbone, "tokenizer": tokenizer,
            "dataset": root / "dataset", "checkpoint": checkpoint}


def _parse(module, toy, name: str, **training):
    path = toy["root"] / f"{name}.yaml"
    path.write_text(_toy_yaml(toy["checkpoint"], toy["dataset"], toy["root"] / name, **training))
    return module.parse_config_file(str(path))


OVERRIDES = {
    "bare": ["--learning_rate", "1e-4", "--subset", "freq2"],
    "qualified": ["--training_args.seed", "7", "--data_args.items", "3"],
    "bool": ["--bf16", "true", "--do_eval", "no"],
    "none": ["--output_dir", "none", "--eval_datasets", "null"],
    "leftover": ["extra", "--max_length", "128"],
}


@pytest.mark.parametrize("case", list(OVERRIDES))
def test_cli_overrides_match_jax(case, toy):
    jax_args = _parse(jax_config, toy, "overrides")
    port_args = _parse(port_config, toy, "overrides")
    jax_left = jax_runner.apply_cli_overrides(OVERRIDES[case], *jax_args)
    port_left = port_runner.apply_cli_overrides(OVERRIDES[case], *port_args)
    assert port_left == jax_left
    for jax_obj, port_obj in zip(jax_args, port_args):
        theirs = dict(vars(jax_obj))
        ours = {k: v for k, v in vars(port_obj).items() if k in theirs}
        assert ours == theirs
    assert vars(port_args[2])["device"] == "cpu"


@pytest.mark.parametrize("argv", [["--nope", "1"], ["--model_args.seed", "1"], ["--bf16"]])
def test_bad_overrides_exit_like_jax(argv, toy):
    for module, runner in ((jax_config, jax_runner), (port_config, port_runner)):
        with pytest.raises(SystemExit):
            runner.apply_cli_overrides(argv, *_parse(module, toy, "bad"))


def _logged(checkpoint: Path) -> list[dict]:
    history = json.loads((checkpoint / "trainer_state.json").read_text())["log_history"]
    return [h for h in history if "loss" in h]


def test_runner_losses_match_jax(toy):
    """Both runners train 3 steps from one checkpoint; the losses logged at
    every step agree at REL."""
    outputs = {}
    for name, module, runner in (("jax", jax_config, jax_runner),
                                 ("port", port_config, port_runner)):
        args = _parse(module, toy, f"parity_{name}", do_eval=False)
        final = runner.train(*args, tokenizer=toy["tokenizer"], max_steps_override=3)
        assert Path(final).name == "final_model"
        outputs[name] = _logged(toy["root"] / f"parity_{name}" / "checkpoint-3")
    jax_logs, port_logs = outputs["jax"], outputs["port"]
    assert [h["step"] for h in port_logs] == [h["step"] for h in jax_logs] == [1, 2, 3]
    for ours, theirs in zip(port_logs, jax_logs):
        for key in ("loss", "ranking_loss", "pruning_loss"):
            assert abs(ours[key] / theirs[key] - 1) <= REL, (key, ours, theirs)
    assert port_logs[-1]["loss"] != port_logs[0]["loss"]


def test_eval_datasets_hook_raises_until_ported(toy):
    model_args, data_args, training_args = _parse(port_config, toy, "eval_hook")
    data_args.dataset_name = str(toy["root"] / "no_such_dataset")  # never read
    training_args.eval_datasets = {"config": "configs/eval_datasets/ja.yaml"}
    with pytest.raises(NotImplementedError, match="A.7"):
        port_runner.train(model_args, data_args, training_args, tokenizer=toy["tokenizer"])
    with pytest.raises(NotImplementedError, match="A.7"):
        port_runner.main([str(toy["root"] / "eval_hook.yaml"), "--eval-datasets-model", "x"])
    port_runner.apply_cli_overrides(["--eval_datasets", "none"], model_args, data_args,
                                    training_args)
    assert training_args.eval_datasets is None


def test_a_mesh_raises(toy):
    with pytest.raises(NotImplementedError, match="A.6"):
        _parse(port_config, toy, "mesh", mesh_model=2)
    with pytest.raises(NotImplementedError, match="A.6"):
        _parse(port_config, toy, "mesh", mesh_data=4)
    args = _parse(port_config, toy, "mesh")
    port_runner.apply_cli_overrides(["--mesh_model", "2"], *args)
    with pytest.raises(NotImplementedError, match="A.6"):
        port_runner.train(*args, tokenizer=toy["tokenizer"])


def test_device_none_without_a_card_raises(toy, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model_args, data_args, training_args = _parse(port_config, toy, "no_card", device=None)
    assert training_args.device is None
    data_args.dataset_name = str(toy["root"] / "no_such_dataset")  # never read
    with pytest.raises(RuntimeError, match="first CUDA card"):
        port_runner.train(model_args, data_args, training_args, tokenizer=toy["tokenizer"])


# --- backbone dropout ------------------------------------------------------

RATES = dict(attention_dropout=0.25, embedding_dropout=0.25, mlp_dropout=0.25)


def _dropout_config(layers: int = 2, **rates):
    backbone = ModernBertBackboneConfig(
        vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=layers,
        num_attention_heads=2, local_attention=16, pad_token_id=0, num_labels=1, **rates)
    return OpenProvenceConfig(base_model_config=backbone.to_dict(), num_labels=1, max_length=48,
                              pruning_config={"hidden_size": 64, "classifier_dropout": 0.1})


def _module(config, sd):
    module = build_module(config)
    module.load_state_dict(sd)
    return module


def _ids(batch=4, seq=32, seed=1):
    ids = torch.randint(3, 250, (batch, seq), generator=torch.Generator().manual_seed(seed))
    mask = torch.ones(batch, seq, dtype=torch.int32)
    mask[1, 20:] = 0
    return ids, mask


def test_backbone_dropout_rate_and_scaling_at_each_site():
    config = _dropout_config(**RATES)
    model = _module(config, init_params(config, torch.Generator().manual_seed(0))).ranking_model
    backbone = model.model
    ids, mask = _ids(batch=16, seq=48)
    rate = RATES["embedding_dropout"]

    def dropped(site, *args):
        """The site's output in train mode (generator seeded 3) against
        eval mode: every element is 0 or the eval value / (1 - rate)."""
        with torch.no_grad():
            want = site.eval()(*args)
            got = site.train()(*args, generator=torch.Generator().manual_seed(3))
        zero = got == 0
        assert torch.equal(got[~zero], (want / (1 - rate))[~zero])
        assert abs(zero.float().mean().item() - rate) < 0.02
        return got

    x = dropped(backbone.embeddings, ids)
    layer = backbone.layers[1]
    dropped(layer.attn, x, mask, layer.attn_norm.weight, layer.eps)
    # The MLP's site lies between act·gate and Wo: its output is Wo of the
    # dropped hidden, the mask drawn from the same generator state.
    x2d = x.reshape(-1, x.shape[-1])
    with torch.no_grad():
        got = layer.mlp.train()(x, layer.mlp_norm.weight, layer.eps,
                                torch.Generator().manual_seed(3))
        hidden = ln_geglu(x2d, layer.mlp_norm.weight, layer.mlp.Wi.weight,
                          layer.mlp.activation, layer.eps)
        want = layer.mlp.Wo(dropout(hidden, rate, torch.Generator().manual_seed(3)))
    torch.testing.assert_close(got, want.reshape(x.shape), rtol=0, atol=0)
    assert not torch.allclose(got, layer.mlp.eval()(x, layer.mlp_norm.weight, layer.eps))


def test_backbone_dropout_is_the_identity_in_eval_mode():
    config, plain = _dropout_config(**RATES), _dropout_config()
    sd = init_params(config, torch.Generator().manual_seed(0))
    ids, mask = _ids()
    with torch.no_grad():
        got = _module(config, sd).eval()(ids, mask)
        want = _module(plain, sd).eval()(ids, mask)
        trained = _module(config, sd).train()(ids, mask, generator=torch.Generator())
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert not torch.equal(trained["pruning_logits"], want["pruning_logits"])


def _dropout_batch():
    rows = [{"query": "what about kyoto", "texts": [f"kyoto has temples {i}. rivers run. "
                                                    "budget plants grow near the market."],
             "context_spans": [[[0, 20], [20, 32], [32, 68]]],
             "context_spans_relevance": [[1, 0, 0]], "labels": [1],
             "teacher_score": [0.2 + 0.2 * i]} for i in range(3)]
    return OpenProvenceDataCollator(
        tokenizer=PairDummyTokenizer(), max_length=48, scores_column="teacher_score",
        chunks_pos_column="context_spans", relevant_chunks_column="context_spans_relevance",
        pad_pairs_to=4)(rows)


def _dropout_trainer(config, sd, out_dir, remat=False):
    return OpenProvenceTrainer(config, sd, PairDummyTokenizer(), output_dir=out_dir,
                               learning_rate=1e-3, total_steps=10, bf16=False,
                               gradient_checkpointing=remat, device="cpu")


def test_recompute_draws_the_forward_masks(tmp_path):
    """torch.utils.checkpoint restores the global RNG, not the trainer's
    generator: the layer's recompute must draw the masks its forward drew,
    and leave the generator where the forward left it."""
    config = _dropout_config(layers=3, **RATES)
    sd = init_params(config, torch.Generator().manual_seed(0))
    batch = _dropout_batch()
    runs = {}
    for remat in (False, True):
        trainer = _dropout_trainer(config, sd, tmp_path / str(remat), remat=remat)
        loss, _, grads = trainer.loss_and_grads(batch)
        runs[remat] = (loss, grads, trainer.generator.get_state())
    (loss, grads, state), (loss_r, grads_r, state_r) = runs[False], runs[True]
    assert torch.equal(loss, loss_r) and torch.equal(state, state_r)
    for name, grad in grads.items():
        assert torch.equal(grad, grads_r[name]), name


def test_resume_with_backbone_dropout_is_bit_exact(tmp_path):
    config = _dropout_config(**RATES)
    sd = init_params(config, torch.Generator().manual_seed(0))
    batch = _dropout_batch()
    trainer = _dropout_trainer(config, sd, tmp_path / "run")
    for _ in range(2):
        trainer.log(trainer.train_one_step(batch))
    checkpoint = trainer.save_checkpoint()
    after = trainer.train_one_step(batch)["loss"]
    fresh = _dropout_trainer(config, sd, tmp_path / "resumed")
    fresh.load_checkpoint(checkpoint)
    assert fresh.log_history == trainer.log_history
    assert fresh.train_one_step(batch)["loss"] == after
    for name, p in trainer.params.items():
        assert torch.equal(p, fresh.params[name]), name


# --- the CLI end to end (slow) ----------------------------------------------


@pytest.mark.slow
def test_cli_trains_exports_and_reloads(toy):
    """``python -m open_provence_tpu_torch.train.cli`` on the toy config with
    device cpu: checkpoints, final_model with the tokenizer, the override,
    and the export reloads in the port's from_pretrained and encoder."""
    from open_provence_tpu_torch import OpenProvenceEncoder, OpenProvenceModel

    out_dir = toy["root"] / "cli"
    config = toy["root"] / "cli.yaml"
    config.write_text(_toy_yaml(toy["backbone"], toy["dataset"], out_dir, logging_steps=2))
    proc = subprocess.run(
        [sys.executable, "-m", "open_provence_tpu_torch.train.cli", str(config),
         "--learning_rate", "5e-4"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    checkpoints = sorted(out_dir.glob("checkpoint-*"))
    assert 0 < len(checkpoints) <= 2
    for ckpt in checkpoints:
        for name in ("optimizer.safetensors", "trainer_state.json", "model.safetensors"):
            assert (ckpt / name).exists(), (ckpt, name)
    final = out_dir / "final_model"
    for name in ("config.json", "model.safetensors", "tokenizer.json"):
        assert (final / name).exists(), name
    recorded = json.loads((final / "training_args.json").read_text())
    assert float(recorded["training_args"]["learning_rate"]) == pytest.approx(5e-4)
    model = OpenProvenceModel.from_pretrained(final, device="cpu", bucket_step=16)
    text = "sushi market dish . travel spring budget ."
    assert model.process("what about sushi ?", text, threshold=0.0)["pruned_context"] == text
    encoder = OpenProvenceEncoder.from_pretrained(final, device="cpu")
    scores = encoder.predict([("what about sushi ?", "sushi market dish .")])
    assert len(scores) == 1 and np.isfinite(scores).all()
