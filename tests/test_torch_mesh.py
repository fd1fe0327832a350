"""The port's mesh, sharding rules and their pieces, in one process.

* ``create_mesh``: the JAX function's rules and errors without a process
  group (one rank: the 1 x 1 mesh).
* ``param_sharding_rules`` on the port's names, and what each rank's shard
  computes: the Wqkv shard is its heads' q, k and v (attention on it gives
  those heads' outputs), the Wi shard pairs input with gate rows (GeGLU on
  it gives those intermediate columns), and the shards of every rank,
  scattered into zeros and summed (what ``gather_state_dict`` does over the
  model group), give back the full tensors.
* A module built for one rank of a tensor-parallel mesh has the shards'
  shapes; a head count or intermediate width that ``model`` does not divide
  raises.
* Dropout under a mesh takes this rank's rows and columns of the mask one
  process draws for the whole activation.
* The trainer's rows of a batch, the engine's row padding, the optimizer's
  factored dims on a full shape and on a shard.
* The optimizer state's rules: ``v``, ``mu``, ``nu`` follow their
  parameter, the adafactor factor that keeps the split dim is split, the
  other whole; the state the optimizer makes on a rank's shards is the
  whole state's shards, key for key.

The multi-rank runs are in ``tests/test_torch_parallel.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from open_provence_tpu_torch import ModernBertBackboneConfig, OpenProvenceConfig, init_params
from open_provence_tpu_torch.models.heads import dropout
from open_provence_tpu_torch.models.model import build_module
from open_provence_tpu_torch.ops.flash_attention import attention_packed_plain
from open_provence_tpu_torch.ops.geglu import geglu_plain
from open_provence_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    init_from_env,
    param_sharding_rules,
    scatter_into_full,
    shard_state_dict,
    state_sharding_rules,
)
from open_provence_tpu_torch.train.optim import Sharding, _factored_dims, make_optimizer
from open_provence_tpu_torch.train.trainer import OpenProvenceTrainer

H, I, HEADS, D = 64, 96, 4, 16


def config(**overrides) -> OpenProvenceConfig:
    settings = dict(vocab_size=128, hidden_size=H, intermediate_size=I, num_hidden_layers=2,
                    num_attention_heads=HEADS, max_position_embeddings=64, local_attention=8,
                    pad_token_id=0, num_labels=1)
    settings.update(overrides)
    backbone = ModernBertBackboneConfig(**settings)
    return OpenProvenceConfig(base_model_config=backbone.to_dict(), max_length=32,
                              pruning_config={"hidden_size": settings["hidden_size"],
                                              "classifier_dropout": 0.0})


def rank_of(model: int, r: int, data: int = 1, d: int = 0) -> Mesh:
    return Mesh(data=data, model=model, data_rank=d, model_rank=r)


def test_create_mesh_rules_in_one_process():
    mesh = create_mesh()
    assert mesh.shape == (1, 1) and mesh.is_main and mesh.group is None
    assert create_mesh(data=None, model=1).shape == (1, 1)
    assert create_mesh(devices=[0]).devices.tolist() == [[0]]
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        create_mesh(data=2)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        create_mesh(model=2)
    with pytest.raises(ValueError, match=">= 1"):
        create_mesh(data=0)


def test_no_process_group_without_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_from_env("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_from_env(None) is False


@pytest.mark.parametrize("device,cards,backend,card", [
    (None, 2, "nccl", 1),     # a card a rank: rank LOCAL_RANK takes card LOCAL_RANK
    (None, 1, "gloo", None),  # two ranks on one card: nccl refuses that
    ("cuda:0", 2, "gloo", None),
    ("cpu", 2, "gloo", None),
])
def test_torchrun_backend_rule(monkeypatch, device, cards, backend, card):
    import torch.distributed as dist

    chosen, set_to = [], []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda name: chosen.append(name))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda index: set_to.append(index))
    for name, value in (("WORLD_SIZE", "2"), ("LOCAL_WORLD_SIZE", "2"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(name, value)
    assert init_from_env(device) is True
    assert chosen == [backend] and set_to == ([] if card is None else [card])


@pytest.mark.parametrize("name,shape,rule", [
    ("ranking_model.model.layers.1.attn.Wqkv.weight", (3 * H, H), (0, 3)),
    ("ranking_model.model.layers.1.attn.Wqkv.bias", (3 * H,), (0, 3)),
    ("ranking_model.model.layers.0.mlp.Wi.weight", (2 * I, H), (0, 2)),
    ("ranking_model.model.layers.0.mlp.Wi.bias", (2 * I,), (0, 2)),
    ("ranking_model.model.layers.1.attn.Wo.weight", (H, H), (1, 1)),
    ("ranking_model.model.layers.1.mlp.Wo.weight", (H, I), (1, 1)),
    ("ranking_model.model.layers.1.attn.Wo.bias", (H,), None),
    ("ranking_model.model.layers.1.mlp.Wo.bias", (H,), None),
    ("ranking_model.model.layers.1.attn_norm.weight", (H,), None),
    ("ranking_model.model.embeddings.tok_embeddings.weight", (128, H), None),
    ("ranking_model.head.dense.weight", (H, H), None),
    ("ranking_model.classifier.weight", (1, H), None),
    ("pruning_head.classifier.weight", (2, H), None),
])
def test_sharding_rules(name, shape, rule):
    assert param_sharding_rules(name, shape) == rule


@pytest.mark.parametrize("rank", [0, 1])
def test_wqkv_shard_is_its_heads(rank):
    """Rank r's Wqkv rows are q, k and v of heads [2r, 2r + 2), so
    attention on its packed output gives those heads' outputs."""
    gen = torch.Generator().manual_seed(0)
    wqkv = torch.randn(3 * H, H, generator=gen)
    local = shard_state_dict({"x.attn.Wqkv.weight": wqkv}, rank_of(2, rank))["x.attn.Wqkv.weight"]
    half = H // 2
    want_rows = [part * H + rank * half + j for part in range(3) for j in range(half)]
    assert torch.equal(local, wqkv[want_rows])
    x = torch.randn(2, 12, H, generator=gen)
    mask = torch.ones(2, 12, dtype=torch.int32)
    mask[1, 9:] = 0
    full = attention_packed_plain(x @ wqkv.T, num_heads=HEADS, padding_mask=mask, window=None)
    mine = attention_packed_plain(x @ local.T, num_heads=HEADS // 2, padding_mask=mask,
                                  window=None)
    torch.testing.assert_close(mine, full[..., rank * half:(rank + 1) * half])


@pytest.mark.parametrize("rank", [0, 1])
def test_wi_shard_pairs_input_with_gate(rank):
    """Rank r's Wi rows are input rows [rI/2, (r+1)I/2) followed by the
    matching gate rows, so GeGLU on them gives those intermediate columns."""
    gen = torch.Generator().manual_seed(1)
    wi = torch.randn(2 * I, H, generator=gen)
    local = shard_state_dict({"x.mlp.Wi.weight": wi}, rank_of(2, rank))["x.mlp.Wi.weight"]
    half = I // 2
    assert torch.equal(local[:half], wi[rank * half:(rank + 1) * half])
    assert torch.equal(local[half:], wi[I + rank * half:I + (rank + 1) * half])
    x = torch.randn(20, H, generator=gen)
    torch.testing.assert_close(geglu_plain(x, local, "gelu"),
                               geglu_plain(x, wi, "gelu")[:, rank * half:(rank + 1) * half])


@pytest.mark.parametrize("model", [2, 4])
def test_shards_scattered_and_summed_give_the_full_tensors(model):
    """``gather_state_dict``'s arithmetic: each rank's shard in a zero
    buffer, summed over the model group, is the full tensor; replicated
    tensors come back as they are."""
    sd = init_params(config(), torch.Generator().manual_seed(2))
    shards = [shard_state_dict(sd, rank_of(model, r)) for r in range(model)]
    for name, full in sd.items():
        rule = param_sharding_rules(name, full.shape)
        placed = [scatter_into_full(name, s[name], full.shape, rank_of(model, r))
                  for r, s in enumerate(shards)]
        if rule is None:
            assert all(p is s[name] for p, s in zip(placed, shards))
            assert torch.equal(shards[0][name], full)
        else:
            assert shards[0][name].shape[rule[0]] == full.shape[rule[0]] // model
            assert torch.equal(sum(placed), full), name


def test_module_for_one_rank_has_the_shard_shapes():
    cfg = config(mlp_bias=True, attention_bias=True)
    sd = init_params(cfg, torch.Generator().manual_seed(3))
    mesh = rank_of(2, 1)
    module = build_module(cfg, mesh, tensor_parallel=True)
    local = shard_state_dict(sd, mesh)
    assert {k: v.shape for k, v in module.state_dict().items()} == \
        {k: v.shape for k, v in local.items()}
    module.load_state_dict(local)
    attn = module.ranking_model.model.layers[1].attn
    assert attn.num_heads == HEADS // 2 and attn.Wo.bias.shape == (H,)
    assert module.ranking_model.model.layers[0].mlp.Wi.weight.shape == (I, H)


@pytest.mark.parametrize("model,overrides,match", [
    (4, {"num_attention_heads": 2}, "num_attention_heads=2"),
    (2, {"num_attention_heads": 3, "hidden_size": 96}, "num_attention_heads=3"),
    (2, {"intermediate_size": 95}, "intermediate_size=95"),
])
def test_tensor_parallel_needs_even_heads_and_columns(model, overrides, match):
    cfg = config(**overrides)
    with pytest.raises(ValueError, match=match):
        build_module(cfg, rank_of(model, 0), tensor_parallel=True)
    build_module(cfg, rank_of(model, 0), tensor_parallel=False)  # replicated: any width


@pytest.mark.parametrize("split_columns", [False, True])
def test_dropout_takes_this_ranks_part_of_the_global_mask(split_columns):
    x = torch.randn(3, 5, 8)
    whole = torch.randn(6, 5, 16 if split_columns else 8)
    want = dropout(whole, 0.3, torch.Generator().manual_seed(4))
    for d in range(2):
        for r in range(2 if split_columns else 1):
            mesh = rank_of(2, r, data=2, d=d)
            x = whole[3 * d:3 * (d + 1)]
            if split_columns:
                x = x[..., 8 * r:8 * (r + 1)]
            got = dropout(x, 0.3, torch.Generator().manual_seed(4), mesh, split_columns)
            expect = want[3 * d:3 * (d + 1)]
            if split_columns:
                expect = expect[..., 8 * r:8 * (r + 1)]
            assert torch.equal(got, expect)


def test_trainer_takes_its_data_rows(tmp_path):
    cfg = config()
    trainer = OpenProvenceTrainer(cfg, init_params(cfg, torch.Generator().manual_seed(5)), None,
                                  output_dir=tmp_path, bf16=False, device="cpu",
                                  mesh=rank_of(1, 0, data=2, d=1))
    batch = {"input_ids": np.arange(8 * 4).reshape(8, 4), "pair_mask": np.ones(8, np.float32)}
    rows = trainer._prepare_batch(batch)
    assert rows["input_ids"].tolist() == np.arange(8 * 4).reshape(8, 4)[4:].tolist()
    with pytest.raises(ValueError, match="7 pairs do not split over a data axis of 2"):
        trainer._prepare_batch({"pair_mask": np.ones(7, np.float32)})


@pytest.mark.parametrize("data,n,want", [(1, 3, 4), (2, 3, 4), (2, 1, 2), (3, 5, 9), (2, 40, 32)])
def test_engine_rows_pad_to_the_data_axis(data, n, want):
    from open_provence_tpu_torch import OpenProvenceModel
    from tests.dummy_tokenizers import DummyTokenizer

    cfg = config()
    model = OpenProvenceModel(cfg, init_params(cfg, torch.Generator().manual_seed(6)),
                              DummyTokenizer(), device="cpu", mesh=rank_of(1, 0, data=data))
    assert model._bucket_rows(n, 32) == want


def test_factored_dims_read_the_full_shape():
    """Why the optimizer must see whole tensors: at base width the tp = 2
    shards of attn.Wo [768, 384] and mlp.Wo [768, 576] swap which dim is
    the larger, and at hidden 128 a shard falls under the 128 floor."""
    assert _factored_dims((768, 768), 128) == (0, 1)
    assert _factored_dims((768, 384), 128) == (1, 0)
    assert _factored_dims((768, 1152), 128) == (0, 1)
    assert _factored_dims((768, 576), 128) == (1, 0)
    assert _factored_dims((128, 64), 128) is None


BASE = {"a.attn.Wqkv.weight": (2304, 768), "a.attn.Wo.weight": (768, 768),
        "a.mlp.Wi.weight": (2304, 768), "a.mlp.Wo.weight": (768, 1152),
        "b.mlp.Wi.weight": (128, 256), "a.attn.Wqkv.bias": (2304,), "a.norm.weight": (768,)}


@pytest.mark.parametrize("key,rule", [
    ("v/a.attn.Wqkv.bias", (0, 3)),
    ("mu/a.mlp.Wi.weight", (0, 2)),
    ("nu/a.attn.Wo.weight", (1, 1)),
    ("v/a.norm.weight", None),
    ("count", None),
    # Wqkv [2304, 768] splits dim 0, the largest: v_row averages it away.
    ("v_row/a.attn.Wqkv.weight", None),
    ("v_col/a.attn.Wqkv.weight", (0, 3)),
    # Wo [768, 768] and [768, 1152] split dim 1, which v_row averages.
    ("v_row/a.attn.Wo.weight", None),
    ("v_col/a.attn.Wo.weight", (0, 1)),
    ("v_row/a.mlp.Wo.weight", None),
    ("v_col/a.mlp.Wo.weight", (0, 1)),
    # Wi [128, 256] splits dim 0, the smaller: v_row keeps it.
    ("v_row/b.mlp.Wi.weight", (0, 2)),
    ("v_col/b.mlp.Wi.weight", None),
])
def test_state_rules_follow_the_parameter(key, rule):
    assert state_sharding_rules(BASE)(key, ()) == rule


@pytest.mark.parametrize("optim", ["adafactor", "adamw"])
@pytest.mark.parametrize("model", [2, 4])
def test_state_made_on_shards_is_the_whole_states_shards(optim, model):
    """The optimizer's state made on a rank's shards (the factored dims from
    the full shape) has the whole state's keys and the shapes of its
    shards."""
    gen = torch.Generator().manual_seed(7)
    params = {name: torch.randn(shape, generator=gen) for name, shape in BASE.items()}
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    rules = {k: param_sharding_rules(k, s) for k, s in shapes.items()}
    opt = make_optimizer(learning_rate=1e-3, total_steps=10, optim=optim)
    whole = opt.init(params)
    for r in range(model):
        mesh = rank_of(model, r)
        local = opt.init(shard_state_dict(params, mesh), Sharding(mesh, shapes, rules))
        want = shard_state_dict(whole, mesh, state_sharding_rules(shapes))
        assert {k: v.shape for k, v in local.items()} == {k: v.shape for k, v in want.items()}
