"""The port's training path against the JAX package's, on the CPU.

* The gradient fault: ``loss.backward()`` through the port's module runs
  through the four autograd Functions (their ``grad_fn`` nodes are in the
  graph) and its gradients equal ``jax.grad`` of the JAX trainer's
  ``_loss_for_batch``.
* The optimizer against optax, step for step.
* The trainer against the JAX ``OpenProvenceTrainer``, three steps, with
  gradient accumulation 1 and 2.

Tiny config: 2 layers (one global, one ±32 local), H = 128, I = 128, 2 heads
of 64, S = 128; three real pairs and one padding pair. fp32, dropout 0.
Each side gets its own config object, and the JAX oracle is built once per
module (both faults of ROADMAP queue C).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import open_provence_tpu as jop
import open_provence_tpu_torch as top
from open_provence_tpu.models.model import build_module as build_jax_module
from open_provence_tpu.parallel.mesh import create_mesh
from open_provence_tpu.train.collator import OpenProvenceDataCollator as JaxCollator
from open_provence_tpu.train.trainer import OpenProvenceTrainer as JaxTrainer
from open_provence_tpu.train.trainer import make_optimizer as jax_make_optimizer
from open_provence_tpu_torch import kernels
from open_provence_tpu_torch.train import OpenProvenceDataCollator, OpenProvenceTrainer
from open_provence_tpu_torch.train.optim import make_optimizer
from open_provence_tpu_torch.utils.convert import state_dict_from_flax
from tests.dummy_tokenizers import PairDummyTokenizer

SEQ = 128
REL = 1e-4


def tiny_config(pkg):
    backbone = pkg.ModernBertBackboneConfig(
        vocab_size=256, hidden_size=128, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=256, local_attention=64,
        pad_token_id=0, num_labels=1,
    )
    return pkg.OpenProvenceConfig(
        base_model_config=backbone.to_dict(), num_labels=1,
        pruning_config={"hidden_size": 128, "classifier_dropout": 0.0}, max_length=SEQ,
    )


def features(shift=0.0):
    return [
        {
            "query": "what is kyoto",
            "texts": ["kyoto is a city. it has temples.", "ramen is food."],
            "context_spans": [[[0, 17], [18, 32]], [[0, 14]]],
            "context_spans_relevance": [[1, 0], [0]],
            "labels": [1, 0],
            "teacher_score": [0.9 - shift, 0.2 + shift],
        },
        {
            "query": "rivers",
            "texts": ["the river runs. budget plants grow near the market."],
            "context_spans": [[[0, 15], [16, 51]]],
            "context_spans_relevance": [[1, 0]],
            "labels": [1],
            "teacher_score": [0.7 + shift],
        },
    ]


COLLATOR_ARGS = dict(
    max_length=SEQ, scores_column="teacher_score", chunks_pos_column="context_spans",
    relevant_chunks_column="context_spans_relevance", pad_pairs_to=4,
)


def collate(shift=0.0):
    """Three real pairs and one padding pair, from the port's collator; the
    JAX collator gives the same arrays."""
    batch = OpenProvenceDataCollator(tokenizer=PairDummyTokenizer(), **COLLATOR_ARGS)(
        features(shift)
    )
    ref = JaxCollator(tokenizer=PairDummyTokenizer(), **COLLATOR_ARGS)(features(shift))
    assert batch.keys() == ref.keys()
    for key in batch:
        np.testing.assert_array_equal(batch[key], ref[key])
    assert batch["pair_mask"].tolist() == [1.0, 1.0, 1.0, 0.0]
    return batch


@functools.lru_cache(maxsize=None)
def jax_params():
    module = build_jax_module(tiny_config(jop))
    ids = np.zeros((1, 8), np.int32)
    return jax.device_get(module.init(jax.random.PRNGKey(0), ids, np.ones_like(ids))["params"])


def jax_trainer(tmp_path, accum=1):
    return JaxTrainer(
        tiny_config(jop), jax_params(), PairDummyTokenizer(), output_dir=tmp_path,
        learning_rate=1e-3, total_steps=10, bf16=False, gradient_accumulation_steps=accum,
        mesh=create_mesh(devices=jax.devices()[:1]),
    )


def port_trainer(tmp_path, accum=1):
    config = tiny_config(top)
    return OpenProvenceTrainer(
        config, state_dict_from_flax(jax_params(), config), PairDummyTokenizer(),
        output_dir=tmp_path, learning_rate=1e-3, total_steps=10, bf16=False,
        gradient_accumulation_steps=accum, device="cpu",
    )


def assert_close_to_scale(got: dict, want: dict, rel=REL):
    """Each tensor within rel of its own largest magnitude."""
    assert got.keys() == want.keys()
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)


def grad_fn_names(t: torch.Tensor) -> set[str]:
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(next_fn for next_fn, _ in fn.next_functions)
    return names


def test_backward_runs_through_the_functions_and_matches_jax_grad(tmp_path):
    batch = collate()
    jt = jax_trainer(tmp_path / "jax")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jt._loss_for_batch(p, jbatch, None, deterministic=True), has_aux=True
    ))(jt.state.params)
    config = tiny_config(top)
    want = {k: v.numpy() for k, v in state_dict_from_flax(jax.device_get(j_grads), config).items()}

    pt = port_trainer(tmp_path / "port")
    kernels.reset_launch_counts()
    loss, _ = pt._loss_for_batch(pt.params, pt._prepare_batch(batch), deterministic=True)
    names = grad_fn_names(loss)
    for fn in ("LayerNormFunction", "LnMatmulFunction", "LnGegluFunction",
               "FlashAttentionPackedFunction"):
        assert f"{fn}Backward" in names, (fn, sorted(names))
    grads = torch.autograd.grad(loss, list(pt.params.values()))
    # On CPU tensors every kernel wrapper of the bias-free layout, forward
    # and backward, took its plain version, and none launched a kernel.
    plain = kernels.plain_counts()
    assert all(plain[name] > 0 for name in kernels.DEFAULT_PATH_KERNELS), plain
    assert plain["add_layer_norm"] == plain["geglu"] == 0
    assert set(kernels.launch_counts().values()) == {0}
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=REL)
    assert_close_to_scale({k: g.numpy() for k, g in zip(pt.params, grads)}, want)


@pytest.mark.parametrize("optim", ["adafactor", "adamw"])
@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_optimizer_matches_optax_step_for_step(optim, schedule):
    """Ten steps on factored (both dims ≥ 128, either one larger) and
    unfactored shapes, with the global-norm clip active every step."""
    rng = np.random.default_rng(3)
    shapes = {"wide": (160, 256), "tall": (300, 130), "narrow": (130, 64), "vec": (96,),
              "small": (3, 5)}
    params = {k: (rng.normal(size=s) * 0.5).astype(np.float32) for k, s in shapes.items()}
    kw = dict(learning_rate=1e-2, total_steps=10, warmup_ratio=0.2,
              lr_scheduler_type=schedule, optim=optim, max_grad_norm=1.0)
    jopt, topt = jax_make_optimizer(**kw), make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)  # one compile, not one per eager op and shape
    for _ in range(10):
        grads = {k: (rng.normal(size=s) * 3).astype(np.float32) for k, s in shapes.items()}
        assert np.sqrt(sum((g**2).sum() for g in grads.values())) > 1.0  # clipped
        ju, jstate = jupdate({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = topt.update({k: torch.tensor(g) for k, g in grads.items()}, tstate, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)


@functools.lru_cache(maxsize=None)
def jax_trajectory(tmp_dir, accum):
    """Losses and parameters (port names) of three JAX trainer steps."""
    trainer = jax_trainer(tmp_dir, accum)
    config = tiny_config(top)
    losses, params = [], []
    for step in range(3):
        batch = [collate(), collate(0.05)] if accum == 2 else collate(0.02 * step)
        losses.append(trainer.train_one_step(batch)["loss"])
        params.append(state_dict_from_flax(jax.device_get(trainer.state.params), config))
    return losses, params


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_matches_jax_trainer(tmp_path_factory, accum):
    losses, params = jax_trajectory(str(tmp_path_factory.mktemp("jax")), accum)
    trainer = port_trainer(tmp_path_factory.mktemp("port"), accum)
    for step in range(3):
        batch = [collate(), collate(0.05)] if accum == 2 else collate(0.02 * step)
        metrics = trainer.train_one_step(batch)
        assert set(metrics) == {"loss", "ranking_loss", "pruning_loss"}
        np.testing.assert_allclose(metrics["loss"], losses[step], rtol=REL)
        assert_close_to_scale(
            {k: v.detach().numpy() for k, v in trainer.params.items()},
            {k: v.numpy() for k, v in params[step].items()},
        )
    assert trainer.step == 3
    with pytest.raises(ValueError):
        trainer.train_one_step(collate() if accum == 2 else [collate(), collate()])


def test_trainer_device_follows_its_parameters(tmp_path):
    """With no device=, the trainer runs where its parameters lie, or on the
    first CUDA card for CPU and numpy parameters, and raises where there is no
    card; only an explicit device moves parameters to the CPU."""
    from open_provence_tpu_torch.train.trainer import resolve_device

    meta = {"w": torch.empty(2, device="meta"), "b": np.zeros(2)}
    assert resolve_device(meta, None) == torch.device("meta")
    assert resolve_device(meta, "cpu") == torch.device("cpu")
    for params in ({"w": np.zeros(2)}, {"w": torch.zeros(2)}):
        if torch.cuda.is_available():
            assert resolve_device(params, None) == torch.device("cuda", 0)
        else:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                resolve_device(params, None)
    pt = port_trainer(tmp_path)
    assert pt.device == torch.device("cpu")
    assert {p.device for p in pt.params.values()} == {torch.device("cpu")}


def test_trainer_without_a_device_needs_a_card(tmp_path):
    """device=None means the first card: on a machine without one the
    trainer raises and names device="cpu", which runs."""
    config = tiny_config(top)
    args = (config, state_dict_from_flax(jax_params(), config), PairDummyTokenizer())
    kw = dict(output_dir=tmp_path, learning_rate=1e-3, total_steps=10, bf16=False)
    if torch.cuda.is_available():
        assert OpenProvenceTrainer(*args, **kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            OpenProvenceTrainer(*args, **kw)
    assert np.isfinite(OpenProvenceTrainer(*args, **kw, device="cpu").train_one_step(collate())["loss"])


def test_training_after_serving_in_inference_mode(tmp_path):
    """The rope tables are cached; made first under inference mode (as the
    engine serves), they must still be usable by a training step."""
    pt = port_trainer(tmp_path)
    module = top.build_module(tiny_config(top)).eval()
    module.load_state_dict({k: v.detach() for k, v in pt.params.items()})
    batch = {k: torch.as_tensor(v) for k, v in collate().items()}
    with torch.inference_mode():
        module(batch["input_ids"].long(), batch["attention_mask"])
    assert np.isfinite(pt.train_one_step(collate())["loss"])


def test_gradient_checkpointing_gives_the_same_gradients(tmp_path):
    """Per-layer recompute in the backward (the JAX package's remat)."""
    batch = collate()
    results = []
    for remat in (False, True):
        config = tiny_config(top)
        pt = OpenProvenceTrainer(
            config, state_dict_from_flax(jax_params(), config), PairDummyTokenizer(),
            output_dir=tmp_path / str(remat), bf16=False, gradient_checkpointing=remat,
            device="cpu",
        )
        assert pt.module.ranking_model.model.gradient_checkpointing is remat
        loss, _, grads = pt.loss_and_grads(batch)
        results.append((float(loss), {k: g.numpy() for k, g in grads.items()}))
    assert results[0][0] == results[1][0]
    assert_close_to_scale(results[1][1], results[0][1], rel=1e-6)


# --- long context: one step past S = 1024 -------------------------------------

LONG_SEQ = 1280


def long_config(pkg):
    backbone = pkg.ModernBertBackboneConfig(
        vocab_size=256, hidden_size=128, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=2048, local_attention=64,
        pad_token_id=0, num_labels=1,
    )
    return pkg.OpenProvenceConfig(
        base_model_config=backbone.to_dict(), num_labels=1,
        pruning_config={"hidden_size": 128, "classifier_dropout": 0.0}, max_length=LONG_SEQ,
    )


def long_batch():
    """One pair whose document runs past 1024 tokens, one that is short, one
    padding pair; the same arrays from both collators."""
    sentences = [f"sentence {i} about rivers and temples." for i in range(36)]
    spans, pos = [], 0
    for s in sentences:
        spans.append([pos, pos + len(s)])
        pos += len(s) + 1
    rows = [
        {"query": "rivers", "texts": [" ".join(sentences)], "context_spans": [spans],
         "context_spans_relevance": [[i % 3 == 0 for i in range(36)]], "labels": [1],
         "teacher_score": [0.8]},
        features()[1],
    ]
    args = dict(COLLATOR_ARGS, max_length=LONG_SEQ, pad_pairs_to=3)
    batch = OpenProvenceDataCollator(tokenizer=PairDummyTokenizer(), **args)(rows)
    ref = JaxCollator(tokenizer=PairDummyTokenizer(), **args)(rows)
    for key in batch:
        np.testing.assert_array_equal(batch[key], ref[key])
    assert batch["input_ids"].shape == (3, LONG_SEQ)
    assert batch["attention_mask"][0].sum() > 1024 and batch["pair_mask"].tolist() == [1, 1, 0]
    return batch


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "gradient_checkpointing"])
def test_trainer_step_past_1024_matches_jax_trainer(tmp_path, remat):
    """Two steps at S = 1280 (the first has learning rate 0): the loss and
    every parameter against the JAX trainer, with and without per-layer
    recompute."""
    batch = long_batch()
    params = jax_params()  # the same widths: S enters no parameter shape
    jt = JaxTrainer(
        long_config(jop), params, PairDummyTokenizer(), output_dir=tmp_path / "jax",
        learning_rate=1e-3, total_steps=10, bf16=False, gradient_checkpointing=remat,
        mesh=create_mesh(devices=jax.devices()[:1]),
    )
    config = long_config(top)
    pt = OpenProvenceTrainer(
        config, state_dict_from_flax(params, config), PairDummyTokenizer(),
        output_dir=tmp_path / "port", learning_rate=1e-3, total_steps=10, bf16=False,
        gradient_checkpointing=remat, device="cpu",
    )
    for _ in range(2):
        want = jt.train_one_step(batch)
        got = pt.train_one_step(batch)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL)
    assert_close_to_scale(
        {k: v.detach().numpy() for k, v in pt.params.items()},
        {k: v.numpy() for k, v in
         state_dict_from_flax(jax.device_get(jt.state.params), config).items()},
    )
