"""Training on one card: the collator, losses, optimizer and trainer.

``encoder_init`` builds the two-head model from a checkpoint or backbone
directory. The data pipeline (``data.py``) and the YAML runner and CLI of
the JAX package's ``train/`` are not ported yet.
"""

from .collator import OpenProvenceDataCollator
from .config import (
    DataArguments,
    ModelArguments,
    PruningTrainingArguments,
    parse_config_file,
)
from .losses import OpenProvenceLoss, joint_loss, pruning_loss, ranking_loss
from .optim import make_optimizer
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
    "OpenProvenceLoss",
    "joint_loss",
    "pruning_loss",
    "ranking_loss",
    "OpenProvenceTrainer",
    "calculate_dynamic_steps",
    "make_optimizer",
    "resolve_resume_checkpoint_path",
]
