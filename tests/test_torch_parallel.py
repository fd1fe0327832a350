"""The port's data and tensor parallelism against one process, on the CPU.

The port's counterpart of ``tests/test_tensor_parallel.py`` and
``tests/test_sharded_inference.py``. Four ``gloo`` ranks (one spawn of
``parallel.dryrun.run_ranks`` serves every mesh case) train and serve under
the meshes 2 x 1 and 1 x 2 (on ranks {0, 1} and {2, 3} at once) and 2 x 2,
and every number must be one process's on the same global batch and
weights:

* fp32 loss within 1e-6 relative, every gradient within 1e-5 and the
  update of a 3-step adafactor run within 1e-4 of each tensor's largest
  value (the JAX package's gate for its own tensor parallelism: identical
  losses, gradients and parameter trajectories);
* the cases: the default layout (the norm scales folded into kernels 2 and
  4, whose gradients tensor parallelism leaves partial), ``norm_bias``,
  ``mlp_bias`` + ``attention_bias``, the whole-MLP gate at ``1``, every
  dropout at 0.1 (the masks are drawn for the global activation, so the
  mesh changes no random number), gradient accumulation, hidden 128
  (adafactor factors the full Wo, not its shard), hidden 256 with
  intermediate 64 (the split dim of Wi is the smaller factored dim, so
  ``v_row`` is the sharded factor) and adamw;
* under tensor parallelism a rank holds only its shards of the split
  tensors (masters, gradients, optimizer state) in one process's state
  keys; ``full_state_dict()`` gathers the whole masters; gradients are
  summed over the data group alone and the optimizer makes a few batched
  all-reduces a step;
* a checkpoint (whole tensors) written at 1 x 2 resumes at 2 x 1 and at
  1 x 1, and one written at 1 x 1 resumes at 1 x 2, on the same
  trajectory; ``gather_state_dict`` inverts ``shard_state_dict``;
* ``process()`` under 2 x 1 and 1 x 2; the YAML runner under
  ``mesh_data: 2``; ``dryrun_multichip(4, device="cpu")``; the mesh's loss
  against the JAX package's single-device trainer, and the 1 x 2 update
  against the JAX trainer's own tensor parallelism.

Tiny widths: 3 layers, H 64, I 96, 4 heads of 16, S 32, 8 pairs (one a
padding pair, ragged lengths, so the data ranks hold different numbers of
valid tokens).
"""

from __future__ import annotations

import contextlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from open_provence_tpu_torch import ModernBertBackboneConfig, OpenProvenceConfig, init_params
from open_provence_tpu_torch.parallel.dryrun import dryrun_multichip, run_ranks
from open_provence_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    gather_state_dict,
    param_sharding_rules,
    shard_state_dict,
    state_sharding_rules,
)
from open_provence_tpu_torch.train.trainer import OpenProvenceTrainer

SEQ, PAIRS, STEPS = 32, 8, 3
LOSS_REL, GRAD_REL, UPDATE_REL = 1e-6, 1e-5, 1e-4
# The bias layout's update is held to its own floor: adafactor divides an
# unfactored tensor's gradient by its running RMS element by element, and
# the biases of Wqkv and Wi have elements 1e-5 of their tensor's largest, so
# fp32 reduction order alone moves their update past 1e-4 of the largest:
# test_bias_layout_update_floor measures that floor in one process. adamw
# divides every gradient by its running RMS element by element, so an
# element whose gradient cancels to 1e-5 of its tensor's largest takes a
# full-size step that fp32 rounding can move: one ulp of the weights moves
# the update past 1e-4 of the largest in one process
# (test_adamw_update_floor).
UPDATE_REL_BY_CASE = {"bias": 1e-2, "adamw": 1e-3}
GATE = "OPEN_PROVENCE_TPU_FUSED_MLP_TAIL"
CASES = {
    "base": {},
    "norm_bias": {"norm_bias": True},
    "bias": {"mlp_bias": True, "attention_bias": True},
    "gate1": {},
    "dropout": {"embedding_dropout": 0.1, "attention_dropout": 0.1, "mlp_dropout": 0.1},
    "accum": {},
    "h128": {"hidden_size": 128, "intermediate_size": 192, "num_hidden_layers": 2},
    # mlp.Wi [128, 256] splits along dim 0, the smaller of its factored dims.
    "h256": {"hidden_size": 256, "intermediate_size": 64, "num_hidden_layers": 2},
    "adamw": {},
    "bf16": {},
}
TRAINER_ARGS = {"adamw": {"optim": "adamw"}}
# (ranks, mesh) of each run: the two pair meshes run side by side.
PAIR_CASES = {"2x1": ["base"], "1x2": ["base", "h128", "h256", "adamw"]}
FULL_CASES = ["base", "norm_bias", "bias", "gate1", "dropout", "accum", "bf16"]


def case_config(case: str, **overrides) -> OpenProvenceConfig:
    settings = dict(
        vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
        num_attention_heads=4, max_position_embeddings=128, local_attention=8,
        pad_token_id=0, num_labels=1,
    )
    settings.update(CASES[case])
    settings.update(overrides)
    backbone = ModernBertBackboneConfig(**settings)
    dropout = 0.1 if case == "dropout" else 0.0
    return OpenProvenceConfig(
        base_model_config=backbone.to_dict(), num_labels=1, max_length=64,
        pruning_config={"hidden_size": backbone.hidden_size, "classifier_dropout": dropout},
    )


def case_weights(case: str) -> dict[str, torch.Tensor]:
    """Seeded weights, the biases and norm scales randomized so they act."""
    gen = torch.Generator().manual_seed(7)
    sd = init_params(case_config(case), gen)
    for name, t in sd.items():
        if name.endswith(".bias") or (t.dim() == 1 and "norm" in name):
            sd[name] = t + 0.1 * torch.randn(t.shape, generator=gen)
    return sd


def make_batch(seed: int, pairs: int = PAIRS, seq: int = SEQ) -> dict[str, np.ndarray]:
    """Ragged rows (8 to S tokens), the first four labels ignored, the last
    pair a padding pair."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(8, seq + 1, size=pairs)
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask > 0, rng.integers(1, 250, size=(pairs, seq)), 0).astype(np.int32)
    labels = np.where(mask > 0, rng.integers(0, 2, size=(pairs, seq)), -100)
    labels[:, :4] = -100
    pair_mask = np.ones(pairs, np.float32)
    pair_mask[-1] = 0.0
    return {
        "input_ids": ids, "attention_mask": mask, "pruning_labels": labels.astype(np.int64),
        "ranking_targets": rng.uniform(size=pairs).astype(np.float32),
        "pair_mask": pair_mask, "batch_indices": np.arange(pairs, dtype=np.int32),
        "doc_indices": np.zeros(pairs, dtype=np.int32),
    }


@contextlib.contextmanager
def gate(value: str | None):
    old = os.environ.get(GATE)
    if value is not None:
        os.environ[GATE] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(GATE, None)
        else:
            os.environ[GATE] = old


def make_trainer(case: str, sd, mesh: Mesh, out_dir, **kwargs) -> OpenProvenceTrainer:
    with gate("1" if case == "gate1" else None):
        return OpenProvenceTrainer(
            case_config(case), sd, None, output_dir=out_dir, learning_rate=1e-2,
            total_steps=10, warmup_ratio=0.1, bf16=case == "bf16", mesh=mesh, tensor_parallel=True,
            gradient_accumulation_steps=2 if case == "accum" else 1, device="cpu",
            **TRAINER_ARGS.get(case, {}), **kwargs,
        )


def run_case(case: str, sd, mesh: Mesh, out_dir, save_at: int | None = None,
             order: np.ndarray | None = None) -> dict:
    """The loss, components and gradients of the first step, then STEPS
    adafactor steps (the first at learning rate 0): their losses and the
    final parameters, whole (``full_state_dict``); and the shapes this
    rank held. ``order`` permutes the pairs of every batch."""
    trainer = make_trainer(case, sd, mesh, out_dir)
    start_whole = all(torch.equal(t, sd[k]) for k, t in trainer.full_state_dict().items())
    batches = [make_batch(seed) for seed in range(STEPS + 1)]
    if order is not None:
        batches = [{k: v if k in ("batch_indices", "doc_indices") else v[order]
                     for k, v in b.items()} for b in batches]

    def step_input(i):
        return [batches[i], batches[i + 1]] if case == "accum" else batches[i]

    state = trainer.generator.get_state()
    loss, components, grads = trainer.loss_and_grads(step_input(0))
    trainer.generator.set_state(state)  # the training steps draw the same masks
    grad_shapes = {k: tuple(g.shape) for k, g in grads.items()}
    grads = gather_state_dict(grads, mesh) if trainer.tensor_parallel else grads
    losses = []
    for i in range(STEPS):
        losses.append(trainer.train_one_step(step_input(i))["loss"])
        if save_at == i + 1:
            trainer.save_checkpoint()
    return {
        "loss": float(loss), "components": {k: float(v) for k, v in components.items()},
        "grads": {k: g.clone() for k, g in grads.items()} if mesh.is_main else None,
        "losses": losses, "params": trainer.full_state_dict(),
        "opt_keys": sorted(trainer.opt_state), "start_whole": start_whole,
        "shapes": {"params": {k: tuple(p.shape) for k, p in trainer.params.items()},
                   "grads": grad_shapes,
                   "state": {k: tuple(v.shape) for k, v in trainer.opt_state.items()}},
    }


def resume_case(sd, mesh: Mesh, checkpoint) -> dict:
    """Steps 2 and 3 of ``base`` from the checkpoint written after step 1."""
    trainer = make_trainer("base", sd, mesh, checkpoint.parent)
    trainer.load_checkpoint(checkpoint)
    losses = [trainer.train_one_step(make_batch(seed))["loss"] for seed in range(1, STEPS)]
    return {"losses": losses, "params": trainer.full_state_dict(), "step": trainer.step}


@contextlib.contextmanager
def all_reduces():
    """Record the element count of every ``torch.distributed.all_reduce``
    made inside the block."""
    calls, real = [], dist.all_reduce

    def recording(t, *args, **kwargs):
        calls.append(t.numel())
        return real(t, *args, **kwargs)

    dist.all_reduce = recording
    try:
        yield calls
    finally:
        dist.all_reduce = real


def collectives_case(case: str, sd, mesh: Mesh, out_dir) -> dict:
    """The all-reduces of one step's gradient sum and of its optimizer
    update (element counts), and the elements of this rank's gradients."""
    trainer = make_trainer(case, sd, mesh, out_dir)
    _, _, grads = trainer.loss_and_grads(make_batch(0))
    with all_reduces() as summed:
        trainer._sum_gradients({k: g.clone() for k, g in grads.items()})
    with all_reduces() as optimizer:
        trainer.apply_gradients(grads)
    split = sum(param_sharding_rules(k, g.shape) is not None for k, g in grads.items())
    return {"sum": summed, "optimizer": optimizer, "split": split,
            "local": sum(g.numel() for g in grads.values())}


def _served(model, questions, contexts) -> dict:
    out = model.process(questions, contexts, threshold=0.5, show_progress=False,
                        return_sentence_metrics=True, batch_size=4)
    return {k: out[k] for k in ("pruned_context", "reranking_score", "sentence_probabilities")}


def serve_inputs():
    questions = [f"question {i}?" for i in range(6)]
    contexts = [
        f"Sentence number {i} is about topic {i}. Another line {i} here. A third one." * (1 + i % 2)
        for i in range(6)
    ]
    return questions, contexts


def serve_case(sd, mesh: Mesh | None, tensor_parallel: bool) -> dict:
    from open_provence_tpu_torch import OpenProvenceModel
    from tests.dummy_tokenizers import DummyTokenizer

    model = OpenProvenceModel(case_config("base"), sd, DummyTokenizer(), device="cpu",
                              bucket_step=16, mesh=mesh, tensor_parallel=tensor_parallel)
    return _served(model, *serve_inputs())


def _mesh_rank(rank: int, weights: dict, out_dir: str) -> dict:
    """Every case of the module on one of four ranks."""
    out_dir = Path(out_dir)
    pair_meshes = {"2x1": create_mesh(2, 1, devices=[0, 1]),
                   "1x2": create_mesh(1, 2, devices=[2, 3])}
    full = create_mesh(2, 2)
    results = {}
    for label, mesh in pair_meshes.items():
        if mesh is None:
            continue
        for case in PAIR_CASES[label]:
            save_at = 1 if (label, case) == ("1x2", "base") else None
            results[f"{label}/{case}"] = run_case(case, weights[case], mesh,
                                                  out_dir / f"{label}_{case}", save_at)
        local = shard_state_dict(weights["base"], mesh)
        results[f"{label}/gathered"] = gather_state_dict(local, mesh)
        results[f"{label}/process"] = serve_case(weights["base"], mesh, mesh.model > 1)
    dist.barrier()  # the 1 x 2 checkpoint is written
    if pair_meshes["2x1"] is not None:
        results["2x1/resume"] = resume_case(weights["base"], pair_meshes["2x1"],
                                            out_dir / "1x2_base" / "checkpoint-1")
    else:
        results["1x2/resume"] = resume_case(weights["base"], pair_meshes["1x2"],
                                            out_dir / "one_base" / "checkpoint-1")
        for case in ("base", "h128", "adamw"):
            results[f"1x2/collectives/{case}"] = collectives_case(
                case, weights[case], pair_meshes["1x2"], out_dir / f"c_{case}")
    for case in FULL_CASES:
        results[f"2x2/{case}"] = run_case(case, weights[case], full, out_dir / f"2x2_{case}")
    results["2x2/collectives/h128"] = collectives_case("h128", weights["h128"], full,
                                                       out_dir / "c_2x2")
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process's results by case, each rank's results)."""
    out_dir = tmp_path_factory.mktemp("mesh")
    weights = {case: case_weights(case) for case in CASES}
    single = {case: run_case(case, weights[case], Mesh(), out_dir / f"one_{case}",
                             save_at=1 if case == "base" else None)
              for case in CASES}
    ranks = run_ranks(_mesh_rank, 4, weights, str(out_dir))
    return single, ranks, weights, out_dir


def jax_config():
    import open_provence_tpu as jop

    return jop.OpenProvenceConfig.from_dict(case_config("base").to_dict())


def assert_close_to_scale(got: dict, want: dict, rel: float, what: str) -> None:
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name].double(), want[name].double()
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g - w).abs().max())
        assert err <= rel * scale, f"{what} {name}: {err:.3e} > {rel} x {scale:.3e}"


def mesh_results(ranks, key):
    """The main rank's result of ``key`` and every rank's that has it."""
    mains = [r[key] for r in ranks if key in r and r[key].get("grads") is not None]
    assert len(mains) == 1, key
    return mains[0], [r[key] for r in ranks if key in r]


RUNS = [(f"{label}/{case}", case) for label, cases in PAIR_CASES.items() for case in cases]
RUNS += [(f"2x2/{case}", case) for case in FULL_CASES if case != "bf16"]


@pytest.mark.parametrize("key,case", RUNS, ids=[k for k, _ in RUNS])
def test_mesh_matches_one_process(runs, key, case):
    """Loss (1e-6 relative), components, every gradient (1e-5 of each
    tensor's largest value) and a 3-step trajectory (losses; update 1e-4),
    the same on every rank of the mesh."""
    single, ranks, weights, _ = runs
    want = single[case]
    got, every = mesh_results(ranks, key)
    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    for name, value in want["components"].items():
        assert abs(got["components"][name] - value) <= LOSS_REL * max(abs(value), 1e-12), name
    assert_close_to_scale(got["grads"], want["grads"], GRAD_REL, f"{key} gradient")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_REL, atol=0)
    start = weights[case]
    updates = {k: got["params"][k] - start[k] for k in start}
    want_updates = {k: want["params"][k] - start[k] for k in start}
    assert_close_to_scale(updates, want_updates, UPDATE_REL_BY_CASE.get(case, UPDATE_REL),
                          f"{key} update")
    for other in every:
        assert other["losses"] == got["losses"]
        for name, p in other["params"].items():
            assert torch.equal(p, got["params"][name]), f"ranks disagree on {name}"


def update_error(got: dict, want: dict, start: dict) -> float:
    """The largest difference of two runs' updates, over each tensor's
    largest update."""
    return max(float(((got[k] - want[k]).abs().max() / (want[k] - start[k]).abs().max()))
               for k in start)


def test_bias_layout_update_floor(runs, tmp_path):
    """The floor the bias layout's update tolerance stands on: one process,
    the same batches with their pairs permuted (the same loss, summed in
    another order), moves the 3-step update of ``mlp_bias`` +
    ``attention_bias`` by more than the default 1e-4 of a tensor's largest,
    and by less than the 1e-2 the mesh is held to; the default layout stays
    under 1e-4."""
    single, _, weights, _ = runs
    order = np.array([3, 1, 0, 2, 6, 5, 4, 7])
    floors = {}
    for case in ("bias", "base"):
        permuted = run_case(case, weights[case], Mesh(), tmp_path / case, order=order)
        floors[case] = update_error(permuted["params"], single[case]["params"], weights[case])
    assert UPDATE_REL < floors["bias"] < UPDATE_REL_BY_CASE["bias"], floors
    assert floors["base"] < UPDATE_REL, floors


def test_adamw_update_floor(runs, tmp_path):
    """The floor adamw's update tolerance stands on: one process, from the
    weights moved by one ulp each (seeded directions), moves the 3-step
    adamw update by more than 1e-4 of a tensor's largest, and by less than
    the 1e-3 the mesh is held to."""
    single, _, weights, _ = runs
    gen = torch.Generator().manual_seed(1)
    nudged = {k: torch.nextafter(v, torch.where(torch.rand(v.shape, generator=gen) < 0.5,
                                                -torch.inf, torch.inf))
              for k, v in weights["adamw"].items()}
    moved = run_case("adamw", nudged, Mesh(), tmp_path / "adamw")
    floor = update_error(moved["params"], single["adamw"]["params"], weights["adamw"])
    assert UPDATE_REL < floor < UPDATE_REL_BY_CASE["adamw"], floor


def test_bf16_mesh_step(runs):
    """The bf16 step (each rank's shards cast to bf16) under 2 x 2 against
    one process's bf16 step, the same on every rank. In bf16 the mesh
    rounds differently by design: a row-parallel Wo gives each rank a
    partial sum rounded to bf16 (one ulp, 2^-8 of it) before the sum over
    the model group, where one process rounds the whole sum once, and a
    folded norm's dscale is summed from bf16 partials alike; the rounding
    then runs through every later layer. Held: losses 2e-2 relative (the
    kernels' bf16 tolerance), gradients 5e-2 of each tensor's largest."""
    single, ranks, _, _ = runs
    want = single["bf16"]
    got, every = mesh_results(ranks, "2x2/bf16")
    np.testing.assert_allclose([got["loss"], *got["losses"]], [want["loss"], *want["losses"]],
                               rtol=2e-2, atol=0)
    assert_close_to_scale(got["grads"], want["grads"], 5e-2, "bf16 gradient")
    assert all(other["losses"] == got["losses"] for other in every)


def test_folded_norm_scale_gradients_are_summed_over_the_model_axis(runs):
    """Kernels 2 and 4 (and their backwards 12, 11) fold attn_norm and
    mlp_norm into the column-parallel GEMM, which under tensor parallelism
    gives each rank its columns' share of the scale's gradient: every layer's
    norm-scale gradient under 1 x 2 and 2 x 2 is the whole one, nonzero."""
    single, ranks, _, _ = runs
    want = single["base"]["grads"]
    names = [n for n in want if n.endswith(("attn_norm.weight", "mlp_norm.weight"))]
    assert any(".layers.1.attn_norm." in n for n in names) and len(names) == 5
    for key in ("1x2/base", "2x2/base"):
        got, _ = mesh_results(ranks, key)
        for name in names:
            g, w = got["grads"][name], want[name]
            assert float(w.abs().max()) > 0
            torch.testing.assert_close(g, w, rtol=0, atol=GRAD_REL * float(w.abs().max()),
                                       msg=f"{key} {name}")


def test_optimizer_sees_whole_tensors_at_hidden_128(runs):
    """At hidden 128 / intermediate 192 adafactor factors the full attn.Wo
    [128, 128] and mlp.Wo [128, 192]; their tp = 2 shards [128, 64] and
    [128, 96] fall under min_dim_size_to_factor. The trainer keeps and
    updates whole tensors, so its state is that of one process."""
    from open_provence_tpu_torch.train.optim import _factored_dims

    single, ranks, _, _ = runs
    got, _ = mesh_results(ranks, "1x2/h128")
    assert got["opt_keys"] == single["h128"]["opt_keys"]
    assert "v_row/ranking_model.model.layers.0.attn.Wo.weight" in got["opt_keys"]
    assert _factored_dims((128, 128), 128) is not None
    assert _factored_dims((128, 64), 128) is None


def shard_shape(shape: tuple, rule) -> tuple:
    if rule is None:
        return shape
    return tuple(n // 2 if d == rule[0] else n for d, n in enumerate(shape))


TP_RUNS = [k for k, _ in RUNS if not k.startswith("2x1/")] + ["2x2/bf16"]


@pytest.mark.parametrize("key", TP_RUNS)
def test_tensor_parallel_ranks_hold_shards(runs, key):
    """Under a model axis of 2 each rank's masters, gradients and optimizer
    state hold shard shapes for the split tensors (whole shapes for the
    rest), in one process's state keys; ``full_state_dict()`` gave the
    whole weights back at the start."""
    single, ranks, _, _ = runs
    case = key.split("/")[1]
    want = single[case]["shapes"]
    state_rules = state_sharding_rules(want["params"])
    every = [r[key] for r in ranks if key in r]
    assert len(every) == (2 if key.startswith("1x2/") else 4)
    split = 0
    for got in every:
        assert got["start_whole"]
        assert got["opt_keys"] == single[case]["opt_keys"]
        for what in ("params", "grads"):
            for name, shape in want[what].items():
                rule = param_sharding_rules(name, shape)
                assert got["shapes"][what][name] == shard_shape(shape, rule), (what, name)
                split += rule is not None and what == "params"
        for name, shape in want["state"].items():
            assert got["shapes"]["state"][name] == shard_shape(shape, state_rules(name, shape)), \
                name
    assert split > 0


def test_gradients_sum_over_the_data_group_alone(runs):
    """At 1 x 2 no gradient is all-reduced; at 2 x 2 one all-reduce over the
    data group carries this rank's gradients (shards and replicated tensors,
    nothing full-size). Adafactor's update makes three flat all-reduces (the
    clip norm; the factors' partial sums, where a split tensor is factored;
    the squares of each split tensor's update and parameter), adamw's
    one."""
    _, ranks, _, _ = runs
    for key, sums, optimizer in (("1x2/collectives/base", 0, 2),
                                 ("1x2/collectives/h128", 0, 3),
                                 ("1x2/collectives/adamw", 0, 1),
                                 ("2x2/collectives/h128", 1, 3)):
        every = [r[key] for r in ranks if key in r]
        assert every, key
        for got in every:
            assert len(got["sum"]) == sums and len(got["optimizer"]) == optimizer, (key, got)
            if sums:
                assert got["sum"] == [got["local"]]
            assert got["optimizer"][0] == 1
            if optimizer > 1:
                assert got["optimizer"][-1] == 2 * got["split"]
            assert sum(got["optimizer"]) < got["local"] // 50, (key, got)


def test_resume_across_meshes(runs):
    """checkpoint-1 written at 1 x 2 holds whole tensors in one process's
    keys (the mesh recorded) and resumes at 2 x 1 and at 1 x 1 on one
    process's trajectory; checkpoint-1 written by one process resumes at
    1 x 2."""
    from open_provence_tpu_torch.utils import safetensors_io

    single, ranks, weights, out_dir = runs
    checkpoint = out_dir / "1x2_base" / "checkpoint-1"
    state = json.loads((checkpoint / "trainer_state.json").read_text())
    assert state["mesh"] == [1, 2] and state["tensor_parallel"] is True
    for name in ("model.safetensors", "optimizer.safetensors"):
        got = safetensors_io.load_file(checkpoint / name)
        want = safetensors_io.load_file(out_dir / "one_base" / "checkpoint-1" / name)
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    want = single["base"]
    start = weights["base"]
    resumed = [r["2x1/resume"] for r in ranks if "2x1/resume" in r]
    assert len(resumed) == 2
    resumed += [r["1x2/resume"] for r in ranks if "1x2/resume" in r]
    assert len(resumed) == 4
    resumed.append(resume_case(start, Mesh(), checkpoint))
    for got in resumed:
        assert got["step"] == STEPS
        np.testing.assert_allclose(got["losses"], want["losses"][1:], rtol=LOSS_REL, atol=0)
        assert_close_to_scale(
            {k: got["params"][k] - start[k] for k in start},
            {k: want["params"][k] - start[k] for k in start}, UPDATE_REL, "resumed update",
        )


@pytest.mark.parametrize("label", ["2x1", "1x2"])
def test_gather_inverts_shard(runs, label):
    _, ranks, weights, _ = runs
    for r in ranks:
        if f"{label}/gathered" in r:
            got = r[f"{label}/gathered"]
            assert got.keys() == weights["base"].keys()
            for name, t in weights["base"].items():
                assert torch.equal(got[name], t), name


@pytest.mark.parametrize("label", ["2x1", "1x2"])
def test_process_matches_one_process(runs, label):
    """process() under data (2 x 1) and tensor (1 x 2) parallelism: every
    rank returns the whole result, that of one process."""
    _, ranks, weights, _ = runs
    want = serve_case(weights["base"], None, False)
    got = [r[f"{label}/process"] for r in ranks if f"{label}/process" in r]
    assert len(got) == 2
    for served in got:
        assert served["pruned_context"] == want["pruned_context"]
        np.testing.assert_allclose(served["reranking_score"], want["reranking_score"],
                                   rtol=0, atol=1e-5)
        for a, b in zip(served["sentence_probabilities"], want["sentence_probabilities"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_mesh_loss_matches_the_jax_trainer(runs, tmp_path):
    """The 2 x 2 mesh's first loss against the JAX package's single-device
    trainer on the same batch and weights (the JAX parity tolerance of
    tests/test_torch_train.py, 1e-4 relative)."""
    import jax

    from open_provence_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from open_provence_tpu.train.trainer import OpenProvenceTrainer as JaxTrainer
    from open_provence_tpu.utils.hf_convert import hf_to_flax_params

    _, ranks, weights, _ = runs
    got, _ = mesh_results(ranks, "2x2/base")
    params = hf_to_flax_params(
        {k: v.numpy() for k, v in weights["base"].items()}, jax_config()
    )
    trainer = JaxTrainer(
        jax_config(), params, None, output_dir=tmp_path, learning_rate=1e-2, total_steps=10,
        bf16=False, mesh=jax_create_mesh(devices=jax.devices()[:1]),
    )
    want = trainer.train_one_step(make_batch(0))["loss"]
    assert abs(got["losses"][0] - want) <= 1e-4 * abs(want)


def test_tensor_parallel_update_matches_the_jax_trainer(runs, tmp_path):
    """The port's 1 x 2 run against the JAX trainer's own tensor
    parallelism (``tensor_parallel=True`` on a 1 x 2 mesh of the forced
    host devices): the same weights and batches, the update over the 3
    steps within 1e-4 of each tensor's largest, the losses 1e-4 relative."""
    import jax

    from open_provence_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from open_provence_tpu.train.trainer import OpenProvenceTrainer as JaxTrainer
    from open_provence_tpu.utils.hf_convert import hf_to_flax_params
    from open_provence_tpu_torch.utils.convert import state_dict_from_flax

    _, ranks, weights, _ = runs
    got, _ = mesh_results(ranks, "1x2/base")
    start = weights["base"]
    params = hf_to_flax_params({k: v.numpy() for k, v in start.items()}, jax_config())
    trainer = JaxTrainer(
        jax_config(), params, None, output_dir=tmp_path, learning_rate=1e-2, total_steps=10,
        warmup_ratio=0.1, bf16=False, tensor_parallel=True,
        mesh=jax_create_mesh(data=1, model=2, devices=jax.devices()[:2]),
    )
    losses = [trainer.train_one_step(make_batch(seed))["loss"] for seed in range(STEPS)]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4, atol=0)
    final = state_dict_from_flax(jax.device_get(trainer.state.params), case_config("base"))
    assert_close_to_scale({k: got["params"][k] - start[k] for k in start},
                          {k: torch.as_tensor(np.asarray(final[k])) - start[k] for k in start},
                          UPDATE_REL, "JAX tensor-parallel update")


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    loss = dryrun_multichip(4, device="cpu")
    assert np.isfinite(loss)
    assert "dryrun_multichip OK: mesh=(2 data x 2 model)" in capsys.readouterr().out


def _runner_rank(rank: int, config_path: str) -> None:
    from open_provence_tpu_torch.train import runner
    from tests.dummy_tokenizers import PairDummyTokenizer

    runner.main([config_path, "--device", "cpu"], tokenizer=PairDummyTokenizer())


def runner_assets(root) -> tuple:
    """A ModernBERT config.json (seeded random weights at init) and 24 + 6
    rows of make_toy_assets.py's schema as JSON lines."""
    import random
    import sys

    from open_provence_tpu_torch.train.data import write_jsonl_splits

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import make_toy_assets

    backbone = root / "backbone"
    backbone.mkdir()
    config = case_config("base").backbone().to_dict()
    (backbone / "config.json").write_text(json.dumps(config))
    rng = random.Random(3)
    rows = [make_toy_assets.make_row(rng, None, rng.choice(make_toy_assets.WORDS))
            for _ in range(30)]
    data = write_jsonl_splits({"train": rows[:24], "validation": rows[24:]}, root / "data")
    return backbone, data


def runner_yaml(path, backbone, data, out_dir, **training) -> str:
    settings = {
        "output_dir": str(out_dir), "optimizer": "adafactor", "learning_rate": 1.0e-2,
        "gradient_accumulation_steps": 1, "warmup_ratio": 0.1, "logging_steps": 1,
        "save_steps": 2, "eval_steps": 2, "save_total_limit": 2, "bf16": False,
        "load_best_model_at_end": False, "num_train_epochs": 1,
        "per_device_eval_batch_size": 2, "report_to": [], **training,
    }
    lines = ["model_args:", f'  model_name_or_path: "{backbone}"', "  classifier_dropout: 0.0",
             "  max_length: 64", "data_args:", f'  dataset_name: "{data}"',
             '  teacher_column: "teacher_score"', "training_args:"]
    lines += [f"  {k}: {json.dumps(v)}" for k, v in settings.items()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_runner_trains_under_mesh_data_2(tmp_path):
    """``mesh_data: 2`` from a YAML config on two ranks (2 queries a rank)
    trains as one process with 4 queries a batch: the same steps, logged
    losses and exported weights; its one ``final_model`` loads and serves
    at 1 x 1."""
    from open_provence_tpu_torch import OpenProvenceModel
    from open_provence_tpu_torch.train import runner
    from open_provence_tpu_torch.train.encoder_init import init_encoder
    from open_provence_tpu_torch.utils import safetensors_io
    from tests.dummy_tokenizers import DummyTokenizer, PairDummyTokenizer

    backbone, data = runner_assets(tmp_path)
    mesh_cfg = runner_yaml(tmp_path / "mesh.yaml", backbone, data, tmp_path / "mesh",
                           per_device_train_batch_size=2, mesh_data=2)
    one_cfg = runner_yaml(tmp_path / "one.yaml", backbone, data, tmp_path / "one",
                          per_device_train_batch_size=4, mesh_data=1)
    run_ranks(_runner_rank, 2, mesh_cfg)
    runner.main([one_cfg, "--device", "cpu"], tokenizer=PairDummyTokenizer())
    finals = {k: tmp_path / k / "final_model" for k in ("mesh", "one")}
    logs = {k: json.loads((tmp_path / k / "checkpoint-6" / "trainer_state.json").read_text())
            for k in finals}
    assert logs["mesh"]["mesh"] == [2, 1] and logs["one"]["mesh"] == [1, 1]
    assert logs["mesh"]["global_step"] == logs["one"]["global_step"] == 6
    got = [h["loss"] for h in logs["mesh"]["log_history"] if "loss" in h]
    want = [h["loss"] for h in logs["one"]["log_history"] if "loss" in h]
    np.testing.assert_allclose(got, want, rtol=LOSS_REL, atol=0)
    start = init_encoder(backbone, max_length=64, classifier_dropout=0.0, seed=42)[2]
    weights = {k: safetensors_io.load_file(v / "model.safetensors") for k, v in finals.items()}
    assert_close_to_scale({k: weights["mesh"][k] - start[k] for k in start},
                          {k: weights["one"][k] - start[k] for k in start}, UPDATE_REL,
                          "runner update")
    model = OpenProvenceModel.from_pretrained(finals["mesh"], tokenizer=DummyTokenizer(),
                                              device="cpu", bucket_step=16)
    out = model.process("q", "First sentence. Second one.", threshold=0.0, show_progress=False)
    assert out["pruned_context"] == "First sentence. Second one."


def test_runner_trains_under_mesh_model_2(tmp_path):
    """``mesh_model: 2`` from a YAML config on two ranks trains
    tensor-parallel with each rank's shards, saves whole-tensor checkpoints,
    reloads the best at the end and exports: the same steps, logged losses
    and exported weights as one process, and the checkpoint's optimizer
    state in one process's keys and shapes."""
    from open_provence_tpu_torch.train import runner
    from open_provence_tpu_torch.train.encoder_init import init_encoder
    from open_provence_tpu_torch.utils import safetensors_io
    from tests.dummy_tokenizers import PairDummyTokenizer

    backbone, data = runner_assets(tmp_path)
    paths = {}
    for name, mesh_model in (("mesh", 2), ("one", 1)):
        paths[name] = runner_yaml(tmp_path / f"{name}.yaml", backbone, data, tmp_path / name,
                                  per_device_train_batch_size=4, mesh_model=mesh_model,
                                  load_best_model_at_end=True)
    run_ranks(_runner_rank, 2, paths["mesh"])
    runner.main([paths["one"], "--device", "cpu"], tokenizer=PairDummyTokenizer())
    logs = {k: json.loads((tmp_path / k / "checkpoint-6" / "trainer_state.json").read_text())
            for k in paths}
    assert logs["mesh"]["mesh"] == [1, 2] and logs["mesh"]["tensor_parallel"] is True
    assert logs["mesh"]["global_step"] == logs["one"]["global_step"] == 6
    got = [h["loss"] for h in logs["mesh"]["log_history"] if "loss" in h]
    want = [h["loss"] for h in logs["one"]["log_history"] if "loss" in h]
    np.testing.assert_allclose(got, want, rtol=LOSS_REL, atol=0)
    state = {k: safetensors_io.load_file(tmp_path / k / "checkpoint-6" / "optimizer.safetensors")
             for k in paths}
    assert {k: v.shape for k, v in state["mesh"].items()} == \
        {k: v.shape for k, v in state["one"].items()}
    start = init_encoder(backbone, max_length=64, classifier_dropout=0.0, seed=42)[2]
    weights = {k: safetensors_io.load_file(tmp_path / k / "final_model" / "model.safetensors")
               for k in paths}
    assert_close_to_scale({k: weights["mesh"][k] - start[k] for k in start},
                          {k: weights["one"][k] - start[k] for k in start}, UPDATE_REL,
                          "runner update")
