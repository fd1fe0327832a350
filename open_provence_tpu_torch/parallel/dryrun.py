"""Run a function on n ranks of one host, and ``dryrun_multichip``.

``run_ranks(fn, n, *args)`` spawns n processes joined in one ``gloo``
process group (rendezvous through a ``FileStore`` in a fresh temporary
directory, so concurrent runs never collide), calls ``fn(rank, *args)`` in
each and returns every rank's result; a rank that raises or dies fails the
call, and the others are stopped. ``fn`` must be importable by name, since
``torch.multiprocessing`` pickles it.

``dryrun_multichip(n)`` is the port's counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``: one full training step of the tiny
config over an n-rank (data × model) mesh, held to one process's step.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT = timedelta(seconds=600)


def _rank_main(rank: int, fn: Callable, world_size: int, directory: str, args: tuple) -> None:
    torch.set_num_threads(1)  # n ranks share the host's cores
    store = dist.FileStore(os.path.join(directory, "store"), world_size)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world_size,
                            timeout=RANK_TIMEOUT)
    try:
        result = fn(rank, *args)
        dist.barrier()
        torch.save(result, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args: Any) -> list[Any]:
    """``[fn(0, *args), ..., fn(world_size - 1, *args)]``, each in a process
    of its own in one gloo group, with one torch thread. Results go through
    ``torch.save``."""
    with tempfile.TemporaryDirectory(prefix="op_ranks_") as directory:
        mp.start_processes(
            _rank_main, args=(fn, world_size, directory, args),
            nprocs=world_size, join=True, start_method="spawn",
        )
        return [torch.load(Path(directory) / f"rank{r}.pt", weights_only=False)
                for r in range(world_size)]


def tiny_config():
    """``__graft_entry__.py``'s tiny config (4 layers, H 64, I 96, vocab 1024,
    max_length 64, classifier dropout 0.1), with 2 heads of 32 in place of
    its 4 of 16: the attention kernels take head dims 32 to 256."""
    from ..configs import ModernBertBackboneConfig, OpenProvenceConfig

    backbone = ModernBertBackboneConfig(
        vocab_size=1024, hidden_size=64, intermediate_size=96, num_hidden_layers=4,
        num_attention_heads=2, max_position_embeddings=128, local_attention=16,
        pad_token_id=0, num_labels=1,
    )
    return OpenProvenceConfig(
        base_model_config=backbone.to_dict(), num_labels=1,
        pruning_config={"hidden_size": 64, "classifier_dropout": 0.1}, max_length=64,
    )


def dryrun_batch(pairs: int, seq: int = 64) -> dict[str, np.ndarray]:
    """The JAX dryrun's batch, drawn from numpy's seed 0."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, size=(pairs, seq))
    labels[:, :4] = -100
    return {
        "input_ids": rng.integers(0, 1000, size=(pairs, seq)).astype(np.int32),
        "attention_mask": np.ones((pairs, seq), dtype=np.int32),
        "pruning_labels": labels.astype(np.int64),
        "ranking_targets": rng.uniform(size=(pairs,)).astype(np.float32),
        "pair_mask": np.ones((pairs,), dtype=np.float32),
        "batch_indices": np.arange(pairs, dtype=np.int32),
        "doc_indices": np.zeros((pairs,), dtype=np.int32),
    }


def _dryrun_step(config, sd, batch, device, mesh) -> float:
    from ..train.trainer import OpenProvenceTrainer

    with tempfile.TemporaryDirectory() as out:
        trainer = OpenProvenceTrainer(
            config, sd, None, output_dir=out, learning_rate=1e-4, total_steps=4, bf16=False,
            mesh=mesh, tensor_parallel=mesh.model > 1, device=device,
        )
        return trainer.train_one_step(batch)["loss"]


def _dryrun_rank(rank: int, config, sd, batch, dp: int, tp: int, device: str) -> dict:
    from .mesh import create_mesh

    loss = _dryrun_step(config, sd, batch, device, create_mesh(data=dp, model=tp))
    jax_loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "open_provence_tpu.")))
    return {"loss": loss, "jax_modules": jax_loaded}


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> float:
    """One full fp32 training step of ``tiny_config`` on ``n_devices`` ranks
    over a (dp data × tp model) mesh with the JAX dryrun's rule (tp = 2 when
    n is even and ≥ 4, dp = n // tp), each rank on ``device`` (None: the
    first CUDA card, shared by every rank). Asserts a finite loss, the same
    on every rank and within 1e-5 relative of one process's step on the same
    global batch and weights (fp32, where the JAX dryrun runs bf16, so the
    comparison can be tight), and that no rank imported jax or the JAX
    package; prints the JAX dryrun's line and returns the loss."""
    from ..kernels import first_card
    from ..utils.convert import init_params
    from .mesh import Mesh

    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    dp = n_devices // tp
    device = str(first_card() if device is None else torch.device(device))
    config = tiny_config()
    sd = init_params(config, torch.Generator().manual_seed(0))
    batch = dryrun_batch(max(8, dp * 2))
    want = _dryrun_step(config, sd, batch, device, Mesh())
    results = run_ranks(_dryrun_rank, n_devices, config, sd, batch, dp, tp, device)
    losses = [r["loss"] for r in results]
    leaked = sorted({m for r in results for m in r["jax_modules"]})
    if leaked:
        raise AssertionError(f"a rank imported {leaked[:5]}")
    if not all(math.isfinite(x) for x in losses) or len(set(losses)) != 1:
        raise AssertionError(f"rank losses {losses}")
    if abs(losses[0] - want) > 1e-5 * abs(want):
        raise AssertionError(f"mesh loss {losses[0]!r} against one process's {want!r}")
    print(f"dryrun_multichip OK: mesh=({dp} data x {tp} model), loss={losses[0]:.4f}")
    return losses[0]
