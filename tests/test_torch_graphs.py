"""The engine's CUDA-graph route (``inference/engine.py::_ForwardGraphs``).

On the CPU: a model on the CPU, and one on a gloo mesh, never capture and
count no replay; the route is taken on a card alone and without a mesh's
collectives; the two counters are in every call's trace.

On the card (marker ``cuda``, at a small width on the kernels): a replay
is bit for bit the eager forward, for a full bucket, a partial one and the
pooled route at fragment caps 16 and 32; two replays of one shape held
until a fetch stay apart; N replays count N eager forwards' launches; and
``process()`` answers as the eager engine does. This file imports no JAX,
so the card's machine can collect it.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from open_provence_tpu_torch import (
    ModernBertBackboneConfig,
    OpenProvenceConfig,
    OpenProvenceModel,
    init_params,
    kernels,
)
from open_provence_tpu_torch.inference.engine import graph_route
from open_provence_tpu_torch.parallel.mesh import Mesh
from open_provence_tpu_torch.utils.tracing import PROCESS_COUNTERS

REPO = Path(__file__).resolve().parents[1]
CONTEXTS = [f"Topic {i:02d} is sushi. More on it. And a third line {i}." for i in range(12)]


def _tokenizers():
    # By path: on the card's machine an installed package owns ``tests``.
    spec = importlib.util.spec_from_file_location(
        "dummy_tokenizers", REPO / "tests" / "dummy_tokenizers.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _config(hidden: int = 32, intermediate: int = 48, max_length: int = 64) -> OpenProvenceConfig:
    backbone = ModernBertBackboneConfig(
        vocab_size=512, hidden_size=hidden, intermediate_size=intermediate,
        num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=256,
        local_attention=16, pad_token_id=0, num_labels=1,
    )
    return OpenProvenceConfig(
        base_model_config=backbone.to_dict(), num_labels=1, max_length=max_length,
        pruning_config={"hidden_size": hidden, "classifier_dropout": 0.0},
    )


def _model(config: OpenProvenceConfig, device: str, **kwargs) -> OpenProvenceModel:
    return OpenProvenceModel(config, init_params(config, torch.Generator().manual_seed(0)),
                             _tokenizers().DummyTokenizer(), device=device, bucket_step=16,
                             **kwargs)


def _call(model: OpenProvenceModel) -> dict:
    return model.process("q", CONTEXTS, batch_size=4, preprocess_batch_size=2,
                         show_progress=False, return_sentence_metrics=True)


# --- CPU ---------------------------------------------------------------------


def test_the_route_is_a_card_without_collectives():
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert graph_route(card, None, False)
    assert graph_route(card, Mesh(), False) and graph_route(card, Mesh(), True)
    # A model axis without tensor parallelism splits nothing.
    assert graph_route(card, Mesh(model=2), False)
    assert not graph_route(card, Mesh(data=2), False)
    assert not graph_route(card, Mesh(model=2), True)
    assert not graph_route(cpu, None, False) and not graph_route(cpu, Mesh(), False)


def test_a_cpu_model_never_captures():
    model = _model(_config(), "cpu")
    timing = _call(model)["timing"]
    assert {"graph_replays", "graph_captures"} <= set(PROCESS_COUNTERS) <= set(timing)
    assert (timing["graph_replays"], timing["graph_captures"]) == (0, 0)
    assert (timing["forwards"], timing["blocks"]) == (3, 12)
    assert model.graph_counts() == {}


def _mesh_rank(rank: int) -> dict:
    from open_provence_tpu_torch.parallel import create_mesh

    mesh = create_mesh(2, 1)
    model = _model(_config(), "cpu", mesh=mesh)
    timing = _call(model)["timing"]
    return {k: timing[k] for k in ("graph_replays", "graph_captures", "forwards", "blocks")}


def test_a_model_on_a_gloo_mesh_never_captures():
    from open_provence_tpu_torch.parallel.dryrun import run_ranks

    for got in run_ranks(_mesh_rank, 2):
        assert got == {"graph_replays": 0, "graph_captures": 0, "forwards": 3, "blocks": 12}


# --- the card ----------------------------------------------------------------


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # Heads of 64 at hidden 128: the default layout's kernels at a small width.
    return _model(_config(hidden=128, intermediate=128, max_length=128), "cuda")


def _arrays(rows: int, seq: int, seed: int, cap: int = 0) -> list[np.ndarray]:
    """Ragged int32 inputs of one bucket as the dispatcher pads them: the
    last row is padding when there are several, and with ``cap`` each row's
    fragment ranges tile its valid tokens, some slots left empty."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(seq // 2, seq + 1, size=rows)
    if rows > 1:
        lengths[-1] = 0
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(3, 500, size=(rows, seq)) * mask).astype(np.int32)
    if not cap:
        return [ids, mask]
    starts = np.zeros((rows, cap), np.int32)
    ends = np.zeros((rows, cap), np.int32)
    for r, n in enumerate(lengths):
        cuts = np.unique(rng.integers(1, max(int(n), 2), size=cap // 2 - 1))
        edges = [0, *cuts.tolist(), int(n)] if n else []
        for j, (lo, hi) in enumerate(zip(edges, edges[1:])):
            starts[r, j], ends[r, j] = lo, hi
    return [ids, mask, starts, ends]


def _eager(model, arrays):
    """The forward without the graph, on the same device inputs."""
    inputs = [torch.from_numpy(a).to(model.device) for a in arrays]
    fn = model._pooled_on_device if len(arrays) == 4 else model._scores_on_device
    with torch.inference_mode():
        return fn(*inputs)


def _forward(model, arrays):
    return model._forward_pooled(*arrays) if len(arrays) == 4 else model._forward(*arrays)


def _same(got, want) -> None:
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,seq,cap", [(32, 128, 0), (4, 64, 0), (32, 128, 16), (8, 96, 32)],
                         ids=["full", "partial", "pooled-16", "pooled-32"])
def test_a_replay_is_the_eager_forward_bit_for_bit(card_model, rows, seq, cap):
    before = card_model.graph_counts()
    first = _arrays(rows, seq, 1, cap)
    _same(_forward(card_model, first), _eager(card_model, first))  # eager, then captured
    for seed in (2, 3):
        arrays = _arrays(rows, seq, seed, cap)
        _same(_forward(card_model, arrays), _eager(card_model, arrays))
    after = card_model.graph_counts()
    assert after["graph_captures"] - before["graph_captures"] == 1
    assert after["graph_replays"] - before["graph_replays"] == 2


@pytest.mark.cuda
def test_two_replays_held_until_a_fetch_stay_apart(card_model):
    _forward(card_model, _arrays(16, 64, 4, 16))  # the shape's capture
    a, b = _arrays(16, 64, 5, 16), _arrays(16, 64, 6, 16)
    held = [_forward(card_model, a), _forward(card_model, b)]
    fetched = [tuple(t.cpu() for t in res) for res in held]
    _same(fetched[0], [t.cpu() for t in _eager(card_model, a)])
    _same(fetched[1], [t.cpu() for t in _eager(card_model, b)])
    assert not torch.equal(fetched[0][1], fetched[1][1])


@pytest.mark.cuda
def test_replays_count_the_launches_of_eager_forwards(card_model):
    arrays = _arrays(2, 48, 7)
    kernels.reset_launch_counts()
    _eager(card_model, arrays)
    one = kernels.launch_counts()
    assert min(one[name] for name in kernels.DEFAULT_PATH_KERNELS[:4]) > 0, one
    kernels.reset_launch_counts()
    _forward(card_model, arrays)  # eager, then captured: the capture launches nothing
    assert kernels.launch_counts() == one
    kernels.reset_launch_counts()
    for _ in range(5):
        _forward(card_model, arrays)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {name: 5 * n for name, n in one.items()}
    assert not any(kernels.plain_counts().values())


@pytest.mark.cuda
def test_process_answers_as_the_eager_engine(card_model):
    eager = _model(_config(hidden=128, intermediate=128, max_length=128), "cuda")
    eager._graphs = None
    want = _call(eager)
    keys = ("pruned_context", "reranking_score", "sentence_probabilities")
    for _ in range(2):  # a shape's first forward is eager, then captured; the rest replay
        got = _call(card_model)
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        timing = got["timing"]
        assert timing["forwards"] == want["timing"]["forwards"] > 0
        assert timing["graph_replays"] + timing["graph_captures"] == timing["forwards"]
    assert timing["graph_captures"] == 0
