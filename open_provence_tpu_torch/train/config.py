"""YAML training configuration → argument dataclasses.

Mirrors the reference's config system (open_provence/trainer.py:225-402,
1280-1386): ``model_args`` / ``data_args`` / ``training_args`` sections with
the same keys and defaults (adafactor, bf16, cosine, lr 5e-5, batch 32 ×
accum 2, warmup 0.1, ranking_weight 0.05 / pruning_weight 1.0).

``mesh_data`` / ``mesh_model`` are the data- and tensor-parallel axes over
the ranks of the process group (``parallel/mesh.py``), as in the JAX
package; ``training_args.device`` names each rank's device (``None``: the
first CUDA card, card ``LOCAL_RANK`` under torchrun).
``attention_impl`` is read and ignored: the port has one attention path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelArguments:
    model_name_or_path: str = "hotchpotch/japanese-reranker-xsmall-v2"
    num_labels: int | None = None
    classifier_dropout: float = 0.1
    max_length: int = 512
    config_name: str | None = None
    tokenizer_name: str | None = None
    cache_dir: str | None = None


@dataclass
class DataArguments:
    dataset_name: str = "hotchpotch/wip-msmarco-context-relevance"
    subset: str = "msmarco-ja-minimal"
    teacher_column: str | None = None
    datasets: list[dict[str, Any]] | None = None
    items: int | None = None
    max_train_samples: int | None = None
    max_eval_samples: int | None = None
    validation_split: float | None = None
    validation_split_samples: int | None = None
    validation_split_name: str = "validation"
    preprocessing_num_workers: int | None = None
    filter_zero_relevance_max_items: int | None = None
    filter_zero_relevance_max_items_reverse: bool = False
    filter_keep_first_item: bool = False
    upsample_factor: float | None = None


@dataclass
class PruningTrainingArguments:
    output_dir: str | None = None
    overwrite_output_dir: bool = True
    do_train: bool = True
    do_eval: bool = True
    ranking_weight: float = 0.05
    pruning_weight: float = 1.0
    use_teacher_scores: bool = True
    per_device_train_batch_size: int = 32
    per_device_eval_batch_size: int = 16
    gradient_accumulation_steps: int = 2
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    num_train_epochs: float = 1.0
    warmup_ratio: float = 0.1
    optim: str = "adafactor"
    lr_scheduler_type: str = "cosine"
    bf16: bool = True
    fp16: bool = False
    logging_steps: int | None = None
    save_steps: int | None = None
    eval_steps: int | None = None
    save_total_limit: int = 5
    load_best_model_at_end: bool = True
    dataloader_num_workers: int = 8
    report_to: list[str] = field(default_factory=lambda: ["wandb"])
    resume_from_checkpoint: str | None = None
    seed: int = 42
    eval_datasets: dict[str, Any] | None = None
    # TPU-native extensions (no reference counterpart):
    mesh_data: int | None = None  # data-parallel axis size (None = all devices)
    mesh_model: int = 1  # tensor-parallel axis size
    attention_impl: str = "auto"
    gradient_checkpointing: bool = False  # remat transformer layers
    # The port's device ("cuda", "cuda:1", "cpu"; None = the first CUDA card).
    device: str | None = None


def parse_config_file(
    config_file: str,
) -> tuple[ModelArguments, DataArguments, PruningTrainingArguments]:
    """(reference trainer.py:1280-1386)"""
    import yaml  # only here: importing the package needs no yaml

    with open(config_file) as f:
        config = yaml.safe_load(f) or {}

    model_config = config.get("model_args", {})
    model_args = ModelArguments(
        model_name_or_path=model_config.get(
            "model_name_or_path", "hotchpotch/japanese-reranker-xsmall-v2"
        ),
        num_labels=model_config.get("num_labels"),
        classifier_dropout=model_config.get("classifier_dropout", 0.1),
        max_length=model_config.get("max_length", 512),
        config_name=model_config.get("config_name"),
        tokenizer_name=model_config.get("tokenizer_name"),
        cache_dir=model_config.get("cache_dir"),
    )

    data_config = config.get("data_args", {})
    data_args = DataArguments(
        dataset_name=data_config.get(
            "dataset_name", "hotchpotch/wip-msmarco-context-relevance"
        ),
        subset=data_config.get("subset", "msmarco-ja-minimal"),
        teacher_column=data_config.get("teacher_column"),
        max_train_samples=data_config.get("max_train_samples"),
        max_eval_samples=data_config.get("max_eval_samples"),
        validation_split=data_config.get("validation_split"),
        validation_split_samples=data_config.get("validation_split_samples"),
        validation_split_name=data_config.get("validation_split_name", "validation"),
        preprocessing_num_workers=data_config.get("preprocessing_num_workers"),
        datasets=data_config.get("datasets"),
        items=data_config.get("items"),
        filter_zero_relevance_max_items=data_config.get("filter_zero_relevance_max_items"),
        filter_zero_relevance_max_items_reverse=data_config.get(
            "filter_zero_relevance_max_items_reverse", False
        ),
        filter_keep_first_item=data_config.get("filter_keep_first_item", False),
        upsample_factor=data_config.get("upsample_factor"),
    )

    training_config = config.get("training_args", {})
    resume_from_checkpoint = training_config.get("resume_from_checkpoint")
    checkpoint_alias = training_config.get("checkpoint")
    if checkpoint_alias and not resume_from_checkpoint:
        resume_from_checkpoint = checkpoint_alias

    training_args = PruningTrainingArguments(
        output_dir=training_config.get("output_dir"),
        overwrite_output_dir=training_config.get("overwrite_output_dir", True),
        do_train=training_config.get("do_train", True),
        do_eval=training_config.get("do_eval", True),
        ranking_weight=training_config.get("ranking_weight", 0.05),
        pruning_weight=training_config.get("pruning_weight", 1.0),
        num_train_epochs=training_config.get("num_train_epochs", 1),
        per_device_train_batch_size=training_config.get("per_device_train_batch_size", 32),
        per_device_eval_batch_size=training_config.get("per_device_eval_batch_size", 16),
        gradient_accumulation_steps=training_config.get("gradient_accumulation_steps", 2),
        learning_rate=training_config.get("learning_rate", 5e-5),
        weight_decay=training_config.get("weight_decay", 0.01),
        max_grad_norm=training_config.get("max_grad_norm", 1.0),
        lr_scheduler_type=training_config.get("lr_scheduler_type", "cosine"),
        warmup_ratio=training_config.get("warmup_ratio", 0.1),
        logging_steps=training_config.get("logging_steps"),
        save_steps=training_config.get("save_steps"),
        eval_steps=training_config.get("eval_steps"),
        save_total_limit=training_config.get("save_total_limit", 5),
        load_best_model_at_end=training_config.get("load_best_model_at_end", True),
        fp16=training_config.get("fp16", False),
        bf16=training_config.get("bf16", True),
        dataloader_num_workers=training_config.get("dataloader_num_workers", 8),
        optim=training_config.get("optimizer", training_config.get("optim", "adafactor")),
        report_to=training_config.get("report_to", ["wandb"]),
        resume_from_checkpoint=resume_from_checkpoint,
        seed=training_config.get("seed", 42),
        eval_datasets=training_config.get("eval_datasets"),
        mesh_data=training_config.get("mesh_data"),
        mesh_model=training_config.get("mesh_model", 1),
        attention_impl=training_config.get("attention_impl", "auto"),
        gradient_checkpointing=training_config.get("gradient_checkpointing", False),
        device=training_config.get("device"),
    )
    return model_args, data_args, training_args
