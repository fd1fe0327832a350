"""train() orchestration + CLI: the port's counterpart of the JAX package's
``train/runner.py`` (reference trainer.py:1389-1737 and runner.py).

Flow: parse the YAML config → prepare datasets → dynamic step cadence →
init encoder → collator → trainer on one device → final_model export →
reload check. The step arithmetic is the JAX runner's with a data axis of
1. Differences from it:

* the device is ``training_args.device`` (``None``: the first CUDA card,
  and a RuntimeError where there is none), not a mesh; a mesh of more than
  one device raises (ROADMAP A.6);
* the reload of ``final_model`` with the port's ``from_pretrained`` on the
  run's device raises when it fails, where the JAX runner logs the failure
  and returns;
* the ``eval_datasets`` hook (``scripts/eval_datasets.py``, which loads the
  JAX model) is not ported: a config that sets it, and
  ``--eval-datasets-model``, raise (ROADMAP A.7); ``--eval_datasets none``
  clears it.

A resumed run replays its epoch from the first batch, as the JAX runner
does (ROADMAP C, faults in the reference).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Any

import torch

from .. import kernels
from .collator import OpenProvenceDataCollator
from .config import (
    DataArguments,
    ModelArguments,
    PruningTrainingArguments,
    check_single_device,
    parse_config_file,
)
from .data import batch_iterator, prepare_dataset
from .encoder_init import init_encoder
from .trainer import (
    OpenProvenceTrainer,
    calculate_dynamic_steps,
    resolve_resume_checkpoint_path,
)

logger = logging.getLogger(__name__)

EVAL_DATASETS_NOT_PORTED = (
    "the eval_datasets hook runs scripts/eval_datasets.py on the JAX model and is not "
    "ported yet (ROADMAP A.7); clear it with --eval_datasets none"
)


def _max_docs(dataset, texts_column: str = "texts", probe: int = 256) -> int:
    max_docs = 1
    for i in range(min(len(dataset), probe)):
        texts = dataset[i].get(texts_column)
        if isinstance(texts, list):
            max_docs = max(max_docs, len(texts))
    return max_docs


def train_device(training_args: PruningTrainingArguments) -> torch.device:
    """``training_args.device``, or the first CUDA card (raising without one)."""
    if training_args.device is None:
        return kernels.first_card()
    return torch.device(training_args.device)


def train(
    model_args: ModelArguments,
    data_args: DataArguments,
    training_args: PruningTrainingArguments,
    run_name: str | None = None,
    timestamp: str | None = None,
    *,
    tokenizer: Any = None,
    max_steps_override: int | None = None,
) -> str:
    """Returns the final model path (reference trainer.py:1389-1737)."""
    from ..inference.engine import OpenProvenceModel, check_attention_impl

    logging.basicConfig(level=logging.INFO)
    if training_args.eval_datasets:
        raise NotImplementedError(EVAL_DATASETS_NOT_PORTED)
    check_single_device(training_args)
    check_attention_impl(training_args.attention_impl)
    device = train_device(training_args)

    if training_args.output_dir is None:
        stamp = timestamp or time.strftime("%Y%m%d_%H%M%S")
        model_short = Path(model_args.model_name_or_path).name
        training_args.output_dir = f"./output/{model_short}_reranking-pruning_{stamp}"
    output_dir = Path(training_args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    resolved_checkpoint = None
    if training_args.resume_from_checkpoint:
        resolved_checkpoint = resolve_resume_checkpoint_path(
            training_args.resume_from_checkpoint
        )
        logger.info("Resuming from checkpoint: %s", resolved_checkpoint.checkpoint_dir)
        training_args.output_dir = str(resolved_checkpoint.run_dir)
        output_dir = resolved_checkpoint.run_dir

    train_dataset, eval_dataset = prepare_dataset(data_args=data_args, seed=training_args.seed)

    eval_steps, logging_steps, total_steps = calculate_dynamic_steps(
        dataset_size=len(train_dataset),
        per_device_batch_size=training_args.per_device_train_batch_size,
        gradient_accumulation_steps=training_args.gradient_accumulation_steps,
        num_epochs=training_args.num_train_epochs,
        num_devices=1,
    )
    if max_steps_override is not None:
        total_steps = max_steps_override
        eval_steps = max(1, total_steps // 4)
        logging_steps = max(1, total_steps // 10)
    if training_args.eval_steps:
        eval_steps = training_args.eval_steps
    if training_args.logging_steps:
        logging_steps = training_args.logging_steps
    save_steps = training_args.save_steps or eval_steps

    logger.info(
        "Dynamic steps: total=%s eval=%s logging=%s save=%s (device=%s)",
        total_steps, eval_steps, logging_steps, save_steps, device,
    )

    # wandb logging (reference trainer.py:1463-1483); gated on availability.
    log_fn = None
    if training_args.report_to and "wandb" in training_args.report_to:
        try:
            import wandb

            os.environ.setdefault("WANDB_PROJECT", "open-provence-tpu")
            wandb.init(
                project="open-provence-tpu",
                name=run_name,
                config={
                    "model_name": model_args.model_name_or_path,
                    "mode": "reranking_pruning",
                    "dataset": data_args.dataset_name,
                    "subset": data_args.subset,
                    "num_epochs": training_args.num_train_epochs,
                    "batch_size": training_args.per_device_train_batch_size,
                    "learning_rate": training_args.learning_rate,
                    "optim": training_args.optim,
                    "ranking_weight": training_args.ranking_weight,
                    "pruning_weight": training_args.pruning_weight,
                    "timestamp": timestamp,
                },
            )

            def log_fn(logs):  # noqa: F811
                wandb.log(logs, step=logs.get("step"))
        except ImportError:
            logger.info("wandb not installed; skipping wandb reporting.")

    config, _, params = init_encoder(
        model_args.model_name_or_path,
        num_labels=model_args.num_labels,
        max_length=model_args.max_length,
        classifier_dropout=model_args.classifier_dropout,
        seed=training_args.seed,
    )

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(
            model_args.tokenizer_name or model_args.model_name_or_path
        )

    # ``per_device_train_batch_size`` means queries per device (the
    # reference/HF convention, trainer.py:1509-1515); one device here, and a
    # batch is padded to a fixed number of pairs so its shape never changes.
    max_docs = _max_docs(train_dataset)
    queries_per_batch = training_args.per_device_train_batch_size
    pad_pairs_to = queries_per_batch * max_docs

    collator = OpenProvenceDataCollator(
        tokenizer=tokenizer,
        max_length=model_args.max_length,
        scores_column="teacher_score",
        chunks_pos_column="context_spans",
        relevant_chunks_column="context_spans_relevance",
        pad_pairs_to=pad_pairs_to,
    )

    trainer = OpenProvenceTrainer(
        config,
        params,
        tokenizer,
        output_dir=output_dir,
        learning_rate=training_args.learning_rate,
        total_steps=max(total_steps, 1),
        warmup_ratio=training_args.warmup_ratio,
        lr_scheduler_type=training_args.lr_scheduler_type,
        optim=training_args.optim,
        weight_decay=training_args.weight_decay,
        max_grad_norm=training_args.max_grad_norm,
        ranking_weight=training_args.ranking_weight,
        pruning_weight=training_args.pruning_weight,
        bf16=training_args.bf16,
        gradient_checkpointing=training_args.gradient_checkpointing,
        gradient_accumulation_steps=training_args.gradient_accumulation_steps,
        seed=training_args.seed,
        save_total_limit=training_args.save_total_limit,
        device=device,
        log_fn=log_fn,
    )
    del params

    epoch_counter = {"epoch": 0}

    def train_batches():
        epoch = epoch_counter["epoch"]
        epoch_counter["epoch"] += 1
        return batch_iterator(
            train_dataset,
            collator,
            queries_per_batch,
            shuffle=True,
            seed=training_args.seed,
            epoch=epoch,
        )

    eval_batches = None
    if eval_dataset is not None and training_args.do_eval:
        def eval_batches():  # noqa: F811
            return batch_iterator(
                eval_dataset,
                collator,
                training_args.per_device_eval_batch_size,
                shuffle=False,
                drop_last=False,
            )

    if training_args.do_train:
        trainer.train(
            train_batches,
            total_steps=max(total_steps, 1),
            eval_batches=eval_batches,
            eval_steps=eval_steps,
            logging_steps=logging_steps,
            save_steps=save_steps,
            load_best_model_at_end=training_args.load_best_model_at_end,
            resume_from=resolved_checkpoint.checkpoint_dir if resolved_checkpoint else None,
        )

    final_model_path = output_dir / "final_model"
    trainer.export_model(final_model_path)
    (final_model_path / "training_args.json").write_text(
        json.dumps(
            {
                "model_args": model_args.__dict__,
                "data_args": data_args.__dict__,
                "training_args": {
                    k: v for k, v in training_args.__dict__.items() if not k.startswith("_")
                },
            },
            indent=2,
            default=str,
        )
    )
    del trainer

    # Reload check (reference trainer.py:1684-1711): a failure raises.
    reloaded = OpenProvenceModel.from_pretrained(
        final_model_path, tokenizer=tokenizer, device=device
    )
    logger.info("✓ Final model reloads; max_length=%s", reloaded.max_length)
    del reloaded

    logger.info("Training completed. Model saved to %s", final_model_path)
    return str(final_model_path)


def _coerce_override(current: Any, raw: str) -> Any:
    """Coerce a CLI string to the type of the current dataclass value."""
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if raw.lower() in ("none", "null"):
        return None
    return raw


def apply_cli_overrides(argv: list[str], *arg_objects: Any) -> list[str]:
    """Apply ``--name value`` pairs onto the argument dataclasses — CLI wins
    over config values, matching the spirit of the reference's default-diff
    merge (runner.py:244-298). Names may be bare (searched across the
    dataclasses in order) or qualified (``training_args.learning_rate``).
    Returns unconsumed argv entries."""
    leftovers: list[str] = []
    i = 0
    while i < len(argv):
        token = argv[i]
        if not token.startswith("--"):
            leftovers.append(token)
            i += 1
            continue
        name = token[2:].replace("-", "_")
        if i + 1 >= len(argv):
            raise SystemExit(f"Missing value for override {token}")
        raw = argv[i + 1]
        section = None
        if "." in name:
            section, name = name.split(".", 1)
        applied = False
        section_names = ("model_args", "data_args", "training_args")
        for sec_name, obj in zip(section_names, arg_objects):
            if section is not None and sec_name != section:
                continue
            if hasattr(obj, name):
                setattr(obj, name, _coerce_override(getattr(obj, name), raw))
                applied = True
                break
        if not applied:
            raise SystemExit(f"Unknown config override: {token}")
        i += 2
    return leftovers


def main(argv: list[str] | None = None) -> None:
    """CLI: open_provence_tpu_torch_trainer <config.yaml> [--checkpoint path]
    [--<field> value ...]

    Any argument dataclass field can be overridden from the CLI, e.g.
    ``--learning_rate 1e-4 --data_args.subset freq2 --device cpu``.
    ``--eval-datasets-model`` (alias ``--only-eval-datasets-model``) is the
    JAX CLI's eval-only mode; it raises here until ROADMAP A.7."""
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in ("--eval-datasets-model", "--only-eval-datasets-model"):
        if flag in argv:
            raise NotImplementedError(f"{flag}: {EVAL_DATASETS_NOT_PORTED}")
    checkpoint = None
    if "--checkpoint" in argv:
        idx = argv.index("--checkpoint")
        if idx + 1 >= len(argv):
            raise SystemExit("--checkpoint requires a path argument")
        checkpoint = argv[idx + 1]
        del argv[idx : idx + 2]
    if not argv:
        print(
            "usage: python -m open_provence_tpu_torch.train.cli <config.yaml> "
            "[--checkpoint path] [--<field> value ...]"
        )
        raise SystemExit(2)
    config_file = argv[0]
    model_args, data_args, training_args = parse_config_file(config_file)
    leftovers = apply_cli_overrides(argv[1:], model_args, data_args, training_args)
    if leftovers:
        raise SystemExit(f"Unrecognized arguments: {leftovers}")
    if checkpoint:
        training_args.resume_from_checkpoint = checkpoint
    run_name = Path(config_file).stem
    train(model_args, data_args, training_args, run_name=run_name)
