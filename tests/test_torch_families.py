"""The repo's shipped checkpoint families through the port, on the CPU.

The families are the four training configs of ``configs/``: xsmall (H 256,
I 1024, 4 heads of 64), base (H 512, I 2048, 8 x 64), large (H 768, I 3072,
12 x 64, trained at ``mesh_model: 2``) and the gte ModernBERT-base one
(``chip_smoke.py`` phase 18 drives the first three on a card).

* Both packages' ``parse_config_file`` read every shipped YAML to the same
  argument dataclasses (the port's ``device`` aside).
* The JAX module and the port's give the same ranking score and keep-probs
  at each family's full H, I and heads (2 layers, vocab 512, B=2, S=128,
  fp32) from one weight set (``state_dict_from_flax``), within 1e-4.
* One adafactor step of both trainers at xsmall width (2 layers) with 2
  queries a micro-batch x 4 micro-batches: loss 1e-4 relative, gradients
  1e-4 and the update 1e-3 of each tensor's largest.
* The port's runner from the large YAML (``--mesh_model 2``) on two gloo
  ranks against one process (``--mesh_model 1``), 2 layers at tiny widths.
* Phase 18's assets: a seeded family backbone directory reloads at its
  widths (``init_encoder``, and an export through ``from_pretrained``), and
  each family's YAML keeps every shipped key but the ones phase 18 names.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import open_provence_tpu as jop
import open_provence_tpu_torch as top
from open_provence_tpu.models.model import build_module as build_jax_module
from open_provence_tpu.parallel.mesh import create_mesh as jax_create_mesh
from open_provence_tpu.train import config as jax_config
from open_provence_tpu.train.trainer import OpenProvenceTrainer as JaxTrainer
from open_provence_tpu_torch import keep_probs_from_logits, ranking_score_from_logits
from open_provence_tpu_torch.models.model import build_module
from open_provence_tpu_torch.parallel.dryrun import run_ranks
from open_provence_tpu_torch.train import OpenProvenceDataCollator, OpenProvenceTrainer
from open_provence_tpu_torch.train import config as port_config
from open_provence_tpu_torch.utils.convert import state_dict_from_flax
from tests.dummy_tokenizers import DummyTokenizer, PairDummyTokenizer

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))
WIDTHS = {name: {k: family[k] for k in ("hidden_size", "intermediate_size",
                                         "num_attention_heads")}
          for name, family in chip_smoke.FAMILIES.items()}
REL = 1e-4


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_both_packages_parse_the_shipped_config_alike(path):
    jax_args = jax_config.parse_config_file(str(path))
    port_args = port_config.parse_config_file(str(path))
    for want, got in zip(jax_args, port_args):
        got = dataclasses.asdict(got)
        if isinstance(want, jax_config.PruningTrainingArguments):
            assert got.pop("device") is None
        assert got == dataclasses.asdict(want)


def family_config(pkg, name: str, layers: int = 2, vocab: int = 512, max_length: int = 128,
                  **widths):
    """``pkg``'s config at family ``name``'s widths (and ``widths``), the
    first ``layers`` layers, a vocab of ``vocab``."""
    backbone = pkg.ModernBertBackboneConfig(
        vocab_size=vocab, num_hidden_layers=layers, pad_token_id=0, num_labels=1,
        **{**WIDTHS[name], **widths})
    return pkg.OpenProvenceConfig(
        base_model_config=backbone.to_dict(), num_labels=1,
        pruning_config={"hidden_size": backbone.hidden_size, "classifier_dropout": 0.0},
        max_length=max_length)


def jax_params(config, seed: int = 0):
    module = build_jax_module(config)
    ids = np.zeros((1, 8), np.int32)
    return module, jax.device_get(
        module.init(jax.random.PRNGKey(seed), ids, np.ones_like(ids), attention_impl="xla")
        ["params"])


@pytest.mark.parametrize("name", list(WIDTHS))
def test_family_forward_matches_jax(name):
    module, params = jax_params(family_config(jop, name))
    config = family_config(top, name)
    port = build_module(config)
    port.load_state_dict(state_dict_from_flax(params, config))
    port.eval()
    rng = np.random.default_rng(17)
    ids = rng.integers(3, 512, size=(2, 128)).astype(np.int32)
    mask = np.ones((2, 128), np.int32)
    mask[1, 71:] = 0
    ids[mask == 0] = 0
    ref = jax.device_get(jax.jit(lambda p, i, m: module.apply({"params": p}, i, m))(
        params, ids, mask))
    with torch.inference_mode():
        out = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    valid = mask.astype(bool)
    np.testing.assert_allclose(
        ranking_score_from_logits(out["ranking_logits"]).numpy(),
        ranking_score_from_logits(torch.from_numpy(np.array(ref["ranking_logits"]))).numpy(),
        rtol=0, atol=REL)
    np.testing.assert_allclose(
        keep_probs_from_logits(out["pruning_logits"]).numpy()[valid],
        keep_probs_from_logits(torch.from_numpy(np.array(ref["pruning_logits"]))).numpy()[valid],
        rtol=0, atol=REL)


def features(shift: float) -> list[dict]:
    """Two queries: 3 pairs, padded to 4 (2 queries x 2 texts)."""
    return [
        {"query": "what is kyoto", "texts": ["kyoto is a city. it has temples.", "ramen is food."],
         "context_spans": [[[0, 17], [18, 32]], [[0, 14]]],
         "context_spans_relevance": [[1, 0], [0]], "labels": [1, 0],
         "teacher_score": [0.9 - shift, 0.2 + shift]},
        {"query": "rivers", "texts": ["the river runs. budget plants grow near the market."],
         "context_spans": [[[0, 15], [16, 51]]], "context_spans_relevance": [[1, 0]],
         "labels": [1], "teacher_score": [0.7 + shift]},
    ]


def assert_close_to_scale(got: dict, want: dict, rel: float) -> None:
    """Each tensor within ``rel`` of its own largest magnitude."""
    assert got.keys() == want.keys()
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-12),
                                   err_msg=key)


def test_xsmall_trainer_step_with_accumulation_matches_jax(tmp_path):
    """2 queries a micro-batch x 4 micro-batches (the shipped xsmall config
    takes 32 x 1, large 16 x 4): the averaged gradients before any step,
    then two steps (the first at the warmup's lr 0) and the update."""
    accum, seq = 4, 128
    collator = OpenProvenceDataCollator(
        tokenizer=PairDummyTokenizer(), max_length=seq, scores_column="teacher_score",
        chunks_pos_column="context_spans", relevant_chunks_column="context_spans_relevance",
        pad_pairs_to=4)
    micro = [collator(features(0.05 * i)) for i in range(accum)]
    jconfig, config = family_config(jop, "xsmall", max_length=seq), family_config(
        top, "xsmall", max_length=seq)
    _, params = jax_params(jconfig)
    start = state_dict_from_flax(params, config)
    kw = dict(learning_rate=1e-3, total_steps=10, bf16=False, gradient_accumulation_steps=accum)
    jt = JaxTrainer(jconfig, params, PairDummyTokenizer(), output_dir=tmp_path / "jax",
                    mesh=jax_create_mesh(devices=jax.devices()[:1]), **kw)
    pt = OpenProvenceTrainer(config, copy.deepcopy(start), PairDummyTokenizer(),
                             output_dir=tmp_path / "port", device="cpu", **kw)

    def jax_loss(p, mb):
        batch = {k: jnp.asarray(v) for k, v in mb.items()}
        return jt._loss_for_batch(p, batch, None, deterministic=True)[0]

    grad = jax.jit(jax.value_and_grad(jax_loss))
    losses, grads = zip(*(grad(jt.state.params, mb) for mb in micro))
    want = {k: v.numpy() for k, v in state_dict_from_flax(
        jax.device_get(jax.tree.map(lambda *g: sum(g) / accum, *grads)), config).items()}
    loss, _, got = pt.loss_and_grads(micro)
    np.testing.assert_allclose(float(loss), float(np.mean(losses)), rtol=REL)
    assert_close_to_scale({k: v.detach().numpy() for k, v in got.items()}, want, REL)
    for _ in range(2):
        metrics = jt.train_one_step(micro), pt.train_one_step(micro)
        np.testing.assert_allclose(metrics[1]["loss"], metrics[0]["loss"], rtol=REL)
    jax_now = state_dict_from_flax(jax.device_get(jt.state.params), config)
    assert_close_to_scale({k: (v.detach() - start[k]).numpy() for k, v in pt.params.items()},
                          {k: (jax_now[k] - start[k]).numpy() for k in start}, 1e-3)
    assert max(float((jax_now[k] - start[k]).abs().max()) for k in start) > 0


def family_sources(root: Path, teacher: str) -> Path:
    """24 + 6 rows of make_toy_assets.py's schema as JSON lines, their
    teacher column named ``teacher``."""
    from open_provence_tpu_torch.train.data import write_jsonl_splits

    assets = chip_smoke.load_by_path(REPO / "scripts" / "make_toy_assets.py")
    rng = random.Random(3)
    rows = []
    for _ in range(30):
        row = assets.make_row(rng, None, rng.choice(assets.WORDS))
        row[teacher] = row.pop("teacher_score")
        rows.append(row)
    return write_jsonl_splits({"train": rows[:24], "validation": rows[24:]}, root / "data")


def _large_yaml_rank(rank: int, config_path: str, argv: list) -> None:
    from open_provence_tpu_torch.train import runner

    args = port_config.parse_config_file(config_path)
    assert not runner.apply_cli_overrides(argv, *args)
    runner.train(*args, tokenizer=PairDummyTokenizer(), max_steps_override=2)


def test_runner_trains_the_large_yaml_at_mesh_model_2(tmp_path):
    """The large YAML (16 queries x 4 micro-batches, mesh_model 2) with
    phase 18's replaced keys, fp32 at lr 1e-2 with a loss logged a step, on
    a tiny 2-layer backbone: two gloo ranks train tensor-parallel as one
    process does with ``--mesh_model 1``, loss for loss and update for
    update, and export whole tensors."""
    from open_provence_tpu_torch.train.encoder_init import init_encoder
    from open_provence_tpu_torch.utils import safetensors_io

    shipped = yaml.safe_load((REPO / chip_smoke.FAMILIES["large"]["yaml"]).read_text())
    (teacher,) = {spec["teacher_column"] for spec in shipped["data_args"]["datasets"]}
    data = family_sources(tmp_path, teacher)
    backbone = tmp_path / "backbone"
    backbone.mkdir()
    tiny = family_config(top, "large", hidden_size=64, intermediate_size=96,
                         num_attention_heads=2).backbone()
    (backbone / "config.json").write_text(json.dumps(tiny.to_dict()))
    paths = {}
    for name in ("mesh", "one"):
        paths[name] = chip_smoke.p18_yaml(
            shipped, tmp_path / f"{name}.yaml", backbone, {"a": data, "b": data},
            tmp_path / "unused_eval.yaml", tmp_path / name, bf16=False, learning_rate=1e-2,
            logging_steps=1, save_steps=2, eval_datasets=None, device="cpu")
    short = ["--max_length", "128"]  # the toy rows' length
    run_ranks(_large_yaml_rank, 2, str(paths["mesh"]), ["--mesh_model", "2", *short])
    _large_yaml_rank(0, str(paths["one"]), ["--mesh_model", "1", *short])
    logs = {k: json.loads((tmp_path / k / "checkpoint-2" / "trainer_state.json").read_text())
            for k in paths}
    assert logs["mesh"]["mesh"] == [1, 2] and logs["mesh"]["tensor_parallel"] is True
    assert logs["one"]["mesh"] == [1, 1]
    got, want = ([h["loss"] for h in logs[k]["log_history"] if "loss" in h] for k in paths)
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    start = init_encoder(backbone, max_length=128, classifier_dropout=0.0, seed=42)[2]
    weights = {k: safetensors_io.load_file(tmp_path / k / "final_model" / "model.safetensors")
               for k in paths}
    # Phase 16's and 18's limit on the update (STEP_UPDATE_TOL): under
    # tensor parallelism the four micro-batches' gradients meet in another
    # order, which moves one element of head.dense's 4096 by 1.1e-4 of the
    # tensor's largest update.
    assert_close_to_scale({k: (weights["mesh"][k] - start[k]).numpy() for k in start},
                          {k: (weights["one"][k] - start[k]).numpy() for k in start},
                          chip_smoke.STEP_UPDATE_TOL)


def test_seeded_family_directory_reloads_at_its_widths(tmp_path):
    """xsmall at full width and depth, vocab 102400: phase 18's backbone
    directory loads through ``init_encoder`` (backbone and prediction head
    from the file, the heads fresh), and the model exported at those widths
    serves through ``from_pretrained`` with the state dict's weights."""
    from open_provence_tpu_torch import OpenProvenceEncoder, OpenProvenceModel, init_params
    from open_provence_tpu_torch.train import init_encoder
    from tests.dummy_tokenizers import PairDummyTokenizer as Pair

    config = chip_smoke.family_config("xsmall")
    sd = init_params(config, torch.Generator().manual_seed(18))
    directory = chip_smoke.backbone_dir(config, sd, tmp_path / "backbone")
    loaded_config, _, loaded = init_encoder(directory, max_length=512, classifier_dropout=0.0)
    backbone = loaded_config.backbone()
    assert (backbone.vocab_size, backbone.hidden_size, backbone.intermediate_size,
            backbone.num_hidden_layers, backbone.num_attention_heads) == (102400, 256, 1024, 10, 4)
    from_file = [k for k in sd if k.startswith(("ranking_model.model.", "ranking_model.head."))]
    assert all(torch.equal(loaded[k], sd[k]) for k in from_file)
    assert not torch.equal(loaded["ranking_model.classifier.weight"],
                           sd["ranking_model.classifier.weight"])
    OpenProvenceEncoder(config=config, state_dict=sd, tokenizer=Pair(),
                        device="cpu").save_pretrained(tmp_path / "export")
    model = OpenProvenceModel.from_pretrained(tmp_path / "export", tokenizer=DummyTokenizer(),
                                              device="cpu", bucket_step=64)
    assert model.config.backbone().to_dict() == config.backbone().to_dict()
    assert all(torch.equal(v, sd[k]) for k, v in model.module.state_dict().items())
    text = "First sentence about kyoto. Second one about ramen."
    assert model.process("kyoto?", text, threshold=0.0, show_progress=False)[
        "pruned_context"] == text


@pytest.mark.parametrize("name", list(WIDTHS))
def test_phase18_yaml_replaces_only_the_named_keys(tmp_path, name):
    """Phase 18's config of each family: the backbone, phase 14's two
    sources under the YAML's teacher column, the eval config and the output
    directory replaced; every other shipped value kept, as both packages'
    ``parse_config_file`` read it."""
    shipped = yaml.safe_load((REPO / chip_smoke.FAMILIES[name]["yaml"]).read_text())
    sources = {"a": tmp_path / "a", "b": tmp_path / "b"}
    path = chip_smoke.p18_yaml(shipped, tmp_path / "run.yaml", tmp_path / "backbone", sources,
                               tmp_path / "eval.yaml", tmp_path / "out")
    model_args, data_args, training_args = port_config.parse_config_file(str(path))
    want = port_config.parse_config_file(str(REPO / chip_smoke.FAMILIES[name]["yaml"]))
    assert model_args.model_name_or_path == str(tmp_path / "backbone")
    assert training_args.output_dir == str(tmp_path / "out")
    assert training_args.eval_datasets == {**want[2].eval_datasets,
                                           "config": str(tmp_path / "eval.yaml")}
    (teacher,) = {spec["teacher_column"] for spec in shipped["data_args"]["datasets"]}
    assert [(d["dataset_name"], d["teacher_column"]) for d in data_args.datasets] == [
        (str(sources["a"]), teacher), (str(sources["b"]), teacher)]
    for got, ref in zip((model_args, data_args, training_args), want):
        got, ref = dataclasses.asdict(got), dataclasses.asdict(ref)
        for key in ("model_name_or_path", "datasets", "output_dir", "eval_datasets"):
            got.pop(key, None), ref.pop(key, None)
        assert got == ref
