"""Training loop: bf16 compute, fp32 master parameters, checkpoints as
safetensors plus ``trainer_state.json``, on one device or over a (data,
model) mesh of ``torch.distributed`` ranks.

Counterpart of the JAX package's ``train/trainer.py`` (itself the reference
``OpenProvenceTrainer``, open_provence/trainer.py:404-588):

* each step runs the module with ``torch.func.functional_call`` on a bf16
  copy of the fp32 master parameters, as ``_loss_for_batch`` casts them;
  autograd through the cast returns fp32 gradients, as JAX's does;
* ``gradient_accumulation_steps`` averages the loss and the gradients of
  that many microbatches before one update;
* ``train/optim.py``: global-norm clipping + adafactor (or adamw) on a
  warmup-cosine, linear or constant schedule;
* loss components, ``eval_*`` metrics and the same log keys;
* ``checkpoint-N/`` holds the HF-layout export (``config.json`` +
  ``model.safetensors``), the optimizer state (``optimizer.safetensors``)
  and ``trainer_state.json`` (step, best eval loss, log history and the
  dropout generator's state), with rotation and resume resolution.

The module runs on ``device``, on the port's kernels for a CUDA device and
their plain versions on the CPU. Under a ``mesh`` (``parallel.mesh``) every
rank runs this same program on the same global batch, as the JAX program
runs over its devices:

* a rank computes on its data coordinate's rows of each batch, with loss
  normalizers over the global batch (``losses.py``);
* with ``tensor_parallel`` the module holds this rank's shards of the
  attention and MLP weights, sliced from the full master parameters at
  every step, so their gradients come back full-size and zero outside the
  shard;
* the gradients are summed over the mesh (the sharded ones over the whole
  mesh, the rest over the data group), and every rank then runs the
  optimizer on the same full tensors: the master parameters and optimizer
  state stay whole and identical on every rank, and the optimizer reads
  whole tensors (global norm, factored dims, block RMS) as on one device;
* files (checkpoints, exports) and logs are written by data rank 0 of
  model rank 0 while the others wait; a checkpoint holds whole tensors and
  resumes under any mesh.
"""

from __future__ import annotations

import json
import logging
import math
import re
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch
from torch.func import functional_call

from .. import kernels
from ..configs import OpenProvenceConfig
from ..models.model import build_module
from ..parallel.mesh import DATA_AXIS, Mesh, create_mesh, param_sharding_rules, shard_state_dict
from ..utils import safetensors_io
from .losses import joint_loss
from .optim import make_optimizer

logger = logging.getLogger(__name__)

_CHECKPOINT_DIR_PATTERN = re.compile(r"checkpoint-(\d+)$")
_INT_KEYS = ("input_ids", "attention_mask", "pruning_labels")


@dataclass
class ResolvedCheckpoint:
    checkpoint_dir: Path
    run_dir: Path
    steps: int | None = None


def resolve_resume_checkpoint_path(candidate_path: str | Path) -> ResolvedCheckpoint:
    """Accept either a checkpoint-N dir or its parent run dir
    (reference trainer.py:58-101); validity marker is trainer_state.json."""
    path = Path(candidate_path).expanduser().resolve()
    if not path.exists():
        raise FileNotFoundError(f"Checkpoint path '{path}' does not exist")
    if path.is_file():
        raise ValueError(
            f"Checkpoint path '{path}' is a file. Please point to a checkpoint directory."
        )
    if (path / "trainer_state.json").exists():
        match = _CHECKPOINT_DIR_PATTERN.search(path.name)
        steps = int(match.group(1)) if match else None
        return ResolvedCheckpoint(checkpoint_dir=path, run_dir=path.parent, steps=steps)

    checkpoint_dirs: list[tuple[int, Path]] = []
    for child in path.iterdir():
        match = _CHECKPOINT_DIR_PATTERN.match(child.name)
        if child.is_dir() and match and (child / "trainer_state.json").exists():
            checkpoint_dirs.append((int(match.group(1)), child))
    if not checkpoint_dirs:
        raise ValueError(
            f"Checkpoint path '{path}' does not contain any checkpoint-* "
            "directories with trainer_state.json"
        )
    steps, latest = max(checkpoint_dirs, key=lambda pair: pair[0])
    return ResolvedCheckpoint(checkpoint_dir=latest, run_dir=path, steps=steps)


def calculate_dynamic_steps(
    dataset_size: int,
    per_device_batch_size: int,
    gradient_accumulation_steps: int,
    num_epochs: float,
    num_devices: int = 1,
    target_eval_points: int = 20,
    target_log_points: int = 100,
) -> tuple[int, int, int]:
    """eval ≈ total/20, log ≈ total/100 (reference trainer.py:1240-1277)."""
    effective_batch_size = (
        per_device_batch_size * gradient_accumulation_steps * num_devices
    )
    steps_per_epoch = dataset_size // effective_batch_size
    total_steps = int(steps_per_epoch * num_epochs)
    eval_steps = max(1, total_steps // target_eval_points)
    logging_steps = max(1, total_steps // target_log_points)
    if logging_steps > eval_steps:
        logging_steps = max(1, eval_steps // 2)
    return eval_steps, logging_steps, total_steps


def resolve_device(
    params: Mapping[str, Any], device: str | torch.device | None
) -> torch.device:
    """The device a trainer runs on. ``None`` takes the device the
    parameters already lie on when that is not the CPU, else the first CUDA
    card, and raises where there is none (as the inference engine does): the
    CPU takes an explicit ``device="cpu"``, also for parameters on a card."""
    on = {v.device for v in params.values() if isinstance(v, torch.Tensor)}
    off_cpu = sorted({d for d in on if d.type != "cpu"}, key=str)
    if device is None:
        if len(off_cpu) > 1:
            raise ValueError(f"params lie on several devices {off_cpu}; pass device=")
        if off_cpu:
            return off_cpu[0]
        return kernels.first_card()
    return torch.device(device)


class OpenProvenceTrainer:
    """Owns the fp32 master parameters, the optimizer state, the loop,
    logging and checkpoints. ``params`` is a state dict in the port's (HF)
    names, e.g. from ``init_params`` or ``state_dict_from_flax``; the
    trainer keeps its own fp32 copy on ``device`` (by default where the
    parameters lie, or the first CUDA card for CPU or numpy parameters:
    ``resolve_device``). ``mesh`` (``parallel.create_mesh``; by default
    every rank of the process group on the data axis, or one process
    without one) and ``tensor_parallel`` as in the JAX trainer."""

    def __init__(
        self,
        config: OpenProvenceConfig,
        params: Mapping[str, torch.Tensor],
        tokenizer: Any,
        *,
        output_dir: str | Path,
        learning_rate: float = 5e-5,
        total_steps: int = 1000,
        warmup_ratio: float = 0.1,
        lr_scheduler_type: str = "cosine",
        optim: str = "adafactor",
        weight_decay: float = 0.01,
        max_grad_norm: float = 1.0,
        ranking_weight: float = 0.05,
        pruning_weight: float = 1.0,
        bf16: bool = True,
        gradient_checkpointing: bool = False,
        gradient_accumulation_steps: int = 1,
        seed: int = 42,
        mesh: Mesh | None = None,
        tensor_parallel: bool = False,
        save_total_limit: int = 5,
        device: str | torch.device | None = None,
        log_fn: Callable[[dict[str, Any]], None] | None = None,
    ):
        if gradient_accumulation_steps < 1:
            raise ValueError(
                f"gradient_accumulation_steps must be >= 1, got {gradient_accumulation_steps}"
            )
        self.config = config
        self.device = resolve_device(params, device)
        self.mesh = mesh if mesh is not None else create_mesh()
        self.tensor_parallel = bool(tensor_parallel)
        self._sharded = self.tensor_parallel and self.mesh.model > 1
        with torch.device("meta"):  # parameters come from self.params at every call
            self.module = build_module(config, self.mesh, self.tensor_parallel)
        self.module.ranking_model.model.gradient_checkpointing = gradient_checkpointing
        self.tokenizer = tokenizer
        self.output_dir = Path(output_dir)
        self.ranking_weight = ranking_weight
        self.pruning_weight = pruning_weight
        self.bf16 = bf16
        self.gradient_accumulation_steps = int(gradient_accumulation_steps)
        self.save_total_limit = save_total_limit
        self.log_fn = log_fn
        self.log_history: list[dict[str, Any]] = []
        self.optimizer = make_optimizer(
            learning_rate=learning_rate,
            total_steps=total_steps,
            warmup_ratio=warmup_ratio,
            lr_scheduler_type=lr_scheduler_type,
            optim=optim,
            weight_decay=weight_decay,
            max_grad_norm=max_grad_norm,
        )
        names = set(self.module.state_dict())
        if set(params) != names:
            raise ValueError(
                f"params do not match the module: missing {sorted(names - set(params))}, "
                f"unexpected {sorted(set(params) - names)}"
            )
        self.params = {
            k: torch.as_tensor(v)
            .detach()
            .to(device=self.device, dtype=torch.float32, copy=True)
            .requires_grad_()
            for k, v in params.items()
        }
        self.opt_state = self.optimizer.init(self._detached())
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.best_eval_loss = float("inf")
        self.best_checkpoint: Path | None = None

    # --- one step -------------------------------------------------------------

    def _detached(self) -> dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.params.items()}

    def _place_state(self, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Optimizer state on the device; the update count stays on the host."""
        return {k: v if k == "count" else v.to(self.device) for k, v in state.items()}

    def _prepare_batch(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """The batch on the device; under a data axis of n, this rank's
        n-th of its pair rows (``rows[d·P/n:(d+1)·P/n]``)."""
        out = {}
        parts, index = self.mesh.data, self.mesh.data_rank
        for key, value in batch.items():
            t = torch.as_tensor(np.asarray(value))
            if parts > 1:
                if t.shape[0] % parts:
                    raise ValueError(
                        f"{key}: {t.shape[0]} pairs do not split over a data axis of {parts}"
                    )
                share = t.shape[0] // parts
                t = t[index * share : (index + 1) * share]
            if key in _INT_KEYS:
                t = t.long()
            elif t.is_floating_point():
                t = t.float()
            out[key] = t.to(self.device)
        return out

    def _loss_for_batch(
        self,
        params: Mapping[str, torch.Tensor],
        batch: Mapping[str, torch.Tensor],
        *,
        deterministic: bool,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The joint loss of one batch under ``params``, computed with a bf16
        copy of every parameter when ``bf16``; dropout (drawn from the
        trainer's generator) unless ``deterministic``. Under a mesh, this
        rank's share of the loss of the global batch."""
        compute = shard_state_dict(params, self.mesh) if self._sharded else params
        if self.bf16:
            compute = {k: v.to(torch.bfloat16) for k, v in compute.items()}
        self.module.train(not deterministic)
        outputs = functional_call(
            self.module,
            compute,
            (batch["input_ids"], batch["attention_mask"]),
            {"generator": None if deterministic else self.generator},
        )
        return joint_loss(
            outputs, batch, ranking_weight=self.ranking_weight,
            pruning_weight=self.pruning_weight, mesh=self.mesh,
        )

    def _global_metrics(
        self, loss: torch.Tensor, components: dict[str, torch.Tensor]
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The loss and components of the global batch from this rank's
        shares (the sum over the data group, one all-reduce)."""
        if self.mesh.data == 1:
            return loss, components
        values = self.mesh.all_reduce(torch.stack([loss, *components.values()]), DATA_AXIS)
        return values[0], dict(zip(components, values[1:]))

    def _sum_gradients(self, grads: dict[str, torch.Tensor]) -> None:
        """Sum the gradients over the mesh, in place: a sharded parameter's
        (full-size, zero outside this rank's shard) over the whole mesh,
        the rest over the data group; one all-reduce of a flat buffer each."""
        sharded = {
            k for k, g in grads.items()
            if self._sharded and param_sharding_rules(k, g.shape) is not None
        }
        for names, axis in ((sorted(sharded), None), ([k for k in grads if k not in sharded],
                                                      DATA_AXIS)):
            if not names or (axis == DATA_AXIS and self.mesh.data == 1):
                continue
            flat = self.mesh.all_reduce(torch.cat([grads[k].reshape(-1) for k in names]), axis)
            for k, piece in zip(names, flat.split([grads[k].numel() for k in names])):
                grads[k].copy_(piece.view_as(grads[k]))

    def loss_and_grads(
        self, batch: Mapping[str, Any] | list[Mapping[str, Any]]
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        """(loss, components, fp32 gradients) of one optimizer step's
        microbatches, averaged over them, with dropout; under a mesh those
        of the global batch, the same on every rank."""
        accum = self.gradient_accumulation_steps
        if accum > 1:
            if not isinstance(batch, (list, tuple)) or len(batch) != accum:
                raise ValueError(
                    f"gradient_accumulation_steps={accum} requires a list of "
                    f"{accum} microbatches per step, got {type(batch).__name__} of length "
                    f"{len(batch) if isinstance(batch, (list, tuple)) else 'n/a'}"
                )
            micro = list(batch)
        elif isinstance(batch, (list, tuple)):
            if len(batch) != 1:
                raise ValueError(
                    "Multiple microbatches passed but gradient_accumulation_steps == 1"
                )
            micro = list(batch)
        else:
            micro = [batch]
        names = list(self.params)
        grads = loss = components = None
        for mb in micro:
            mb_loss, mb_comps = self._loss_for_batch(
                self.params, self._prepare_batch(mb), deterministic=False
            )
            mb_grads = torch.autograd.grad(mb_loss, [self.params[k] for k in names])
            if grads is None:
                grads, loss, components = list(mb_grads), mb_loss.detach(), {
                    k: v.detach() for k, v in mb_comps.items()
                }
            else:
                grads = [a + b for a, b in zip(grads, mb_grads)]
                loss = loss + mb_loss.detach()
                components = {k: components[k] + v.detach() for k, v in mb_comps.items()}
        if len(micro) > 1:
            inv = 1.0 / len(micro)
            grads = [g * inv for g in grads]
            loss = loss * inv
            components = {k: v * inv for k, v in components.items()}
        grads = dict(zip(names, grads))
        if self.mesh.size > 1:
            self._sum_gradients(grads)
            loss, components = self._global_metrics(loss, components)
        return loss, components, grads

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> None:
        """One optimizer update of the master parameters (in place)."""
        updates, self.opt_state = self.optimizer.update(dict(grads), self.opt_state, self._detached())
        with torch.no_grad():
            for name, update in updates.items():
                self.params[name].add_(update)
        self.step += 1

    def train_one_step(
        self,
        batch: Mapping[str, Any] | list[Mapping[str, Any]],
        *,
        sync: bool = True,
    ) -> dict[str, Any]:
        """One optimizer step. With ``gradient_accumulation_steps > 1``,
        ``batch`` must be a list of exactly that many microbatches.
        ``sync=False`` returns the metrics as device tensors, without waiting
        for the card."""
        loss, components, grads = self.loss_and_grads(batch)
        self.apply_gradients(grads)
        metrics = {"loss": loss, **components}
        if not sync:
            return metrics
        return {k: float(v) for k, v in metrics.items()}

    @torch.no_grad()
    def evaluate(self, eval_batches: Iterator[Mapping[str, Any]]) -> dict[str, float]:
        totals: dict[str, float] = {}
        count = 0
        for batch in eval_batches:
            total, components = self._global_metrics(*self._loss_for_batch(
                self.params, self._prepare_batch(batch), deterministic=True
            ))
            for k, v in {"loss": total, **components}.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            count += 1
        if count == 0:
            return {}
        return {f"eval_{k}": v / count for k, v in totals.items()}

    def log(self, logs: dict[str, Any]) -> None:
        """Every rank keeps the history; the main rank alone reports it."""
        logs = {**logs, "step": self.step}
        self.log_history.append(logs)
        if not self.mesh.is_main:
            return
        if self.log_fn is not None:
            self.log_fn(logs)
        else:
            logger.info("step %s: %s", self.step, logs)

    def train(
        self,
        train_batches: Callable[[], Iterator[Mapping[str, Any]]],
        *,
        total_steps: int,
        eval_batches: Callable[[], Iterator[Mapping[str, Any]]] | None = None,
        eval_steps: int | None = None,
        logging_steps: int = 100,
        save_steps: int | None = None,
        load_best_model_at_end: bool = True,
        resume_from: Path | None = None,
    ) -> None:
        if resume_from is not None:
            self.load_checkpoint(resume_from)
        # Metrics stay on the card between log points; one fetch per logged step.
        pending: list[dict[str, Any]] = []
        iterator = train_batches()

        def flush() -> dict[str, float]:
            totals: dict[str, float] = {}
            for entry in pending:
                for k, v in entry.items():
                    totals[k] = totals.get(k, 0.0) + float(v)
            n = len(pending)
            pending.clear()
            return {k: v / n for k, v in totals.items()}

        def next_microbatch():
            nonlocal iterator
            try:
                return next(iterator)
            except StopIteration:
                iterator = train_batches()
                return next(iterator, None)

        per_step = self.gradient_accumulation_steps
        while self.step < total_steps:
            micro = [next_microbatch() for _ in range(per_step)]
            if any(m is None for m in micro):
                break
            pending.append(self.train_one_step(micro if per_step > 1 else micro[0], sync=False))
            step = self.step
            if logging_steps and step % logging_steps == 0 and pending:
                self.log(flush())
            if eval_batches is not None and eval_steps and step % eval_steps == 0:
                eval_metrics = self.evaluate(eval_batches())
                self.log(eval_metrics)
                if eval_metrics.get("eval_loss", float("inf")) < self.best_eval_loss:
                    self.best_eval_loss = eval_metrics["eval_loss"]
                    self.best_checkpoint = self.save_checkpoint()
            if save_steps and step % save_steps == 0:
                self.save_checkpoint()
        if pending:
            self.log(flush())
        if load_best_model_at_end and self.best_checkpoint is not None and self.best_checkpoint.exists():
            self.load_checkpoint(self.best_checkpoint, restore_opt_state=False)

    # --- checkpoints ----------------------------------------------------------

    def save_checkpoint(self) -> Path:
        """checkpoint-N: the HF-layout export, the optimizer state and
        trainer_state.json (reference trainer.py:415-461), with the mesh it
        was written under. Written by the main rank; every rank returns the
        path once it is complete."""
        ckpt_dir = self.output_dir / f"checkpoint-{self.step}"
        if self.mesh.is_main:
            self._write_checkpoint(ckpt_dir)
        self.mesh.barrier()
        return ckpt_dir

    def _write_checkpoint(self, ckpt_dir: Path) -> None:
        if ckpt_dir.exists():
            shutil.rmtree(ckpt_dir)
        ckpt_dir.mkdir(parents=True)
        self._export(ckpt_dir)
        safetensors_io.save_file(self.opt_state, ckpt_dir / "optimizer.safetensors")
        (ckpt_dir / "trainer_state.json").write_text(
            json.dumps(
                {
                    "global_step": self.step,
                    "best_eval_loss": self.best_eval_loss
                    if math.isfinite(self.best_eval_loss)
                    else None,
                    "log_history": self.log_history[-200:],
                    # The dropout generator, so a resumed run replays the
                    # same masks (the reference checkpoints torch's RNG).
                    "generator_state": self.generator.get_state().tolist(),
                    "mesh": list(self.mesh.shape),
                    "tensor_parallel": self.tensor_parallel,
                }
            )
        )
        self._rotate_checkpoints()

    def _rotate_checkpoints(self) -> None:
        if not self.save_total_limit:
            return
        checkpoints = sorted(
            (int(m.group(1)), child)
            for child in self.output_dir.iterdir()
            if child.is_dir() and (m := _CHECKPOINT_DIR_PATTERN.match(child.name))
        )
        keep = {p for _, p in checkpoints[-self.save_total_limit :]}
        if self.best_checkpoint is not None:
            keep.add(self.best_checkpoint)
        for _, child in checkpoints:
            if child not in keep:
                shutil.rmtree(child, ignore_errors=True)

    def load_checkpoint(self, path: str | Path, *, restore_opt_state: bool = True) -> None:
        path = Path(path)
        weights = safetensors_io.load_file(path / "model.safetensors")
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(weights[name])
        if restore_opt_state:
            state = safetensors_io.load_file(path / "optimizer.safetensors")
            if set(state) != set(self.opt_state):
                raise ValueError(f"{path}: optimizer state does not match this optimizer")
            self.opt_state = self._place_state(state)
        state_file = path / "trainer_state.json"
        if state_file.exists():
            payload = json.loads(state_file.read_text())
            self.step = int(payload.get("global_step", self.step))
            if payload.get("best_eval_loss") is not None:
                self.best_eval_loss = float(payload["best_eval_loss"])
            if payload.get("generator_state") is not None:
                self.generator.set_state(
                    torch.tensor(payload["generator_state"], dtype=torch.uint8)
                )
            saved = (payload.get("mesh"), payload.get("tensor_parallel"))
            live = (list(self.mesh.shape), self.tensor_parallel)
            if saved[0] is not None and saved != live:
                # The tensors are whole, so any mesh resumes them (the JAX
                # trainer warns across tensor_parallel alike).
                logger.warning(
                    "Checkpoint was written under mesh=%s, tensor_parallel=%s; this trainer "
                    "runs mesh=%s, tensor_parallel=%s", *saved, *live,
                )
            if restore_opt_state and payload.get("log_history") is not None:
                # A resumed run's history goes on from the checkpoint's, as
                # HF's Trainer keeps it (the JAX trainer starts it anew).
                self.log_history = list(payload["log_history"])

    def export_model(self, directory: str | Path) -> Path:
        """The self-describing HF-layout artifact: config.json +
        model.safetensors (ranking_model.* and pruning_head.* in fp32, whole
        tensors under any mesh) + tokenizer files (reference
        encoder.py:1040-1094). Written by the main rank while the others
        wait."""
        directory = Path(directory)
        if self.mesh.is_main:
            self._export(directory)
        self.mesh.barrier()
        return directory

    def _export(self, directory: Path) -> None:
        directory.mkdir(parents=True, exist_ok=True)
        self.config.save(directory)
        safetensors_io.save_file(self._detached(), directory / "model.safetensors")
        save_fn = getattr(self.tokenizer, "save_pretrained", None)
        if callable(save_fn):
            try:
                save_fn(str(directory))
            except Exception:  # tokenizer-specific; the weights are written
                logger.warning("Failed to save tokenizer files", exc_info=True)
