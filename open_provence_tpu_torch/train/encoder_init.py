"""Build the two-head model from a pretrained backbone or checkpoint.

Counterpart of the JAX package's ``train/encoder_init.py`` (reference
``OpenProvenceEncoder.__init__``, encoder.py:48-172): the ranking backbone
is initialized from a pretrained ModernBERT checkpoint while the pruning
head (and, when label counts differ, the classifier) starts fresh. Accepted
layouts at ``model_name_or_path`` (a local directory; nothing is
downloaded):

* an OpenProvence checkpoint (config.json with model_type=open_provence +
  merged model.safetensors) → continue training from it,
* a HF ModernBERT checkpoint (sequence-classification or bare backbone
  safetensors) → backbone weights loaded, heads initialized,
* a config-only directory → full random init (toy/offline runs).

The config is built once from the file and the arguments, never changed
after it is made.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import torch

from ..configs import ModernBertBackboneConfig, OpenProvenceConfig
from ..models.model import OpenProvenceModule, build_module
from ..utils import safetensors_io
from ..utils.convert import init_params
from ..utils.hf_convert import normalize_state_dict

logger = logging.getLogger(__name__)


def merge_state_dicts(
    fresh: dict[str, torch.Tensor], loaded: dict[str, torch.Tensor]
) -> tuple[dict[str, torch.Tensor], int]:
    """``fresh`` with every tensor ``loaded`` has under the same name and
    shape put in (cast to the fresh tensor's dtype); a tensor of another
    shape keeps its fresh init, with a warning. Returns the merged dict and
    how many tensors came from ``loaded``."""
    merged, n_loaded = dict(fresh), 0
    for name, value in loaded.items():
        if name not in merged:
            continue
        if tuple(value.shape) != tuple(merged[name].shape):
            logger.warning(
                "Shape mismatch for %s: checkpoint %s vs model %s — keeping fresh init",
                name, tuple(value.shape), tuple(merged[name].shape),
            )
            continue
        merged[name] = value.to(merged[name].dtype)
        n_loaded += 1
    return merged, n_loaded


def init_encoder(
    model_name_or_path: str | Path,
    *,
    num_labels: int | None = None,
    max_length: int = 512,
    classifier_dropout: float = 0.1,
    seed: int = 42,
    default_threadshold: float | None = None,
) -> tuple[OpenProvenceConfig, OpenProvenceModule, dict[str, torch.Tensor]]:
    """Returns (config, module with the weights loaded, on the CPU, fp32,
    its state dict). Random weights are ``init_params`` drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    path = Path(model_name_or_path)
    if not path.exists():
        raise FileNotFoundError(
            f"model_name_or_path '{path}' not found; provide a local checkpoint or config "
            "directory (nothing is downloaded)."
        )
    raw_config = json.loads((path / "config.json").read_text())

    if raw_config.get("model_type") == "open_provence":
        overrides = {"max_length": max_length}
        if num_labels is not None:
            overrides["num_labels"] = num_labels
        config = OpenProvenceConfig.from_dict({**raw_config, **overrides})
    else:
        resolved_labels = num_labels
        if resolved_labels is None:
            resolved_labels = raw_config.get("num_labels", 2) or 2
        backbone = ModernBertBackboneConfig.from_hf_dict(
            {**raw_config, "num_labels": resolved_labels}
        )
        config = OpenProvenceConfig(
            base_model_name_or_path=str(path),
            base_model_config=backbone.to_dict(),
            num_labels=resolved_labels,
            num_pruning_labels=2,
            max_length=max_length,
            pruning_config={
                "hidden_size": backbone.hidden_size,
                "classifier_dropout": classifier_dropout,
                "sentence_pooling": "mean",
                "use_weighted_pooling": False,
            },
            encoder_architecture=raw_config.get("model_type"),
            default_threadshold=default_threadshold,
        )

    state_dict = init_params(config, torch.Generator().manual_seed(seed))
    weights_path = path / "model.safetensors"
    if weights_path.exists():
        loaded = normalize_state_dict(safetensors_io.load_file(weights_path))
        state_dict, n_loaded = merge_state_dicts(state_dict, loaded)
        logger.info(
            "Loaded %d/%d parameter tensors from %s", n_loaded, len(state_dict), weights_path
        )
    else:
        logger.info("No model.safetensors at %s — random init", path)
    module = build_module(config)
    module.load_state_dict(state_dict)
    return config, module, state_dict
