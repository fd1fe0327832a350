"""Training on one card: the data pipeline, collator, losses, optimizer,
trainer, and the YAML runner and CLI (``python -m
open_provence_tpu_torch.train.cli <config.yaml>``).

``encoder_init`` builds the two-head model from a checkpoint or backbone
directory. Importing this package needs neither ``yaml`` nor ``datasets``:
the config reader and the data sources that need them import them when
used.
"""

from .collator import OpenProvenceDataCollator
from .config import (
    DataArguments,
    ModelArguments,
    PruningTrainingArguments,
    parse_config_file,
)
from .data import (
    batch_iterator,
    filter_pruning_dataset,
    prepare_dataset,
    sample_items_by_label_priority,
    upsample_dataset,
)
from .encoder_init import init_encoder
from .losses import OpenProvenceLoss, joint_loss, pruning_loss, ranking_loss
from .optim import make_optimizer
from .runner import main, train
from .trainer import (
    OpenProvenceTrainer,
    calculate_dynamic_steps,
    resolve_resume_checkpoint_path,
)

__all__ = [
    "OpenProvenceDataCollator",
    "DataArguments",
    "ModelArguments",
    "PruningTrainingArguments",
    "parse_config_file",
    "batch_iterator",
    "filter_pruning_dataset",
    "prepare_dataset",
    "sample_items_by_label_priority",
    "upsample_dataset",
    "init_encoder",
    "OpenProvenceLoss",
    "joint_loss",
    "pruning_loss",
    "ranking_loss",
    "main",
    "train",
    "OpenProvenceTrainer",
    "calculate_dynamic_steps",
    "make_optimizer",
    "resolve_resume_checkpoint_path",
]
