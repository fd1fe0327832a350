"""Checkpoint loading: the reference's state-dict layouts into the port.

Counterpart of the JAX package's ``utils/hf_convert.py``. It understands the
three layouts the reference emits or accepts (encoder.py:1040-1094,
standalone:1452-1464, utils/model_architecture.py):

* merged checkpoints: ``ranking_model.*`` + ``pruning_head.*`` keys,
* legacy root-level keys (no ``ranking_model.`` prefix): prefixed here,
* flat ModernBERT backbones without the ``model.`` prefix: prefixed here
  (``pruning_head``/``head``/``classifier`` keys are left alone).

The port's module already carries the checkpoint's names (``nn.Linear``
stores [out, in] as torch checkpoints do), so no name mapping is needed:
the loader keeps the module's own keys and drops the rest, as the JAX
mapping picks its keys by name and ignores others. A key the module needs
and the file lacks raises ``KeyError``.
"""

from __future__ import annotations

import json
from collections.abc import Mapping
from pathlib import Path
from typing import Any

import torch

from ..configs import ModernBertBackboneConfig, OpenProvenceConfig
from . import safetensors_io
from .convert import module_shapes

ARCHITECTURE_FINGERPRINTS = {
    "modernbert": ("tok_embeddings", "attn.Wqkv", "mlp_norm"),
    "bert": ("word_embeddings", "encoder.layer", "LayerNorm"),
    "roberta": ("roberta.embeddings", "roberta.encoder"),
}


def detect_architecture(keys: list[str]) -> str:
    """Fingerprint the backbone family from state-dict keys
    (reference utils/model_architecture.py:39-73)."""
    for arch, identifiers in ARCHITECTURE_FINGERPRINTS.items():
        if all(any(ident in key for key in keys) for ident in identifiers):
            return arch
    joined = " ".join(keys)
    if "tok_embeddings" in joined and "Wqkv" in joined:
        return "modernbert"
    if any(k.startswith("bert.") for k in keys):
        return "bert"
    if any(k.startswith("roberta.") for k in keys):
        return "roberta"
    return "unknown"


def normalize_state_dict(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Normalize any accepted layout to merged ``ranking_model.*`` +
    ``pruning_head.*`` keys with the ``model.`` backbone prefix present."""
    sd = dict(state_dict)

    # Legacy: root-level keys → prefix everything but pruning_head with
    # ranking_model. (standalone:1452-1464).
    if not any(k.startswith("ranking_model.") for k in sd):
        sd = {
            (k if k.startswith("pruning_head.") else f"ranking_model.{k}"): v
            for k, v in sd.items()
        }

    # ModernBERT flat structure fix: insert "model." after "ranking_model."
    # when the backbone keys are flat (utils/model_architecture.py:75-100).
    inner = [k[len("ranking_model."):] for k in sd if k.startswith("ranking_model.")]
    has_model_prefix = any(k.startswith("model.") for k in inner)
    has_flat = any(k.startswith(("embeddings.", "layers.")) for k in inner)
    if has_flat and not has_model_prefix:
        fixed = {}
        for key, value in sd.items():
            if key.startswith("ranking_model.") and not any(
                part in key for part in ("pruning_head", ".head.", ".classifier.")
            ):
                fixed[f"ranking_model.model.{key[len('ranking_model.'):]}"] = value
            else:
                fixed[key] = value
        sd = fixed
    return sd


def module_state_dict(
    state_dict: Mapping[str, torch.Tensor], config: OpenProvenceConfig
) -> dict[str, torch.Tensor]:
    """The module's own keys out of a checkpoint of any accepted layout;
    keys the module does not have are dropped, a key it needs and the
    checkpoint lacks raises KeyError."""
    sd = normalize_state_dict(state_dict)
    out = {}
    for name in module_shapes(config):
        if name not in sd:
            raise KeyError(f"{name} missing from state dict")
        out[name] = sd[name]
    return out


def load_checkpoint(directory: str | Path) -> tuple[OpenProvenceConfig, dict[str, torch.Tensor]]:
    """Load an OpenProvence checkpoint directory (reference layout:
    config.json + model.safetensors) into (config, the module's state dict
    on the CPU, in the file's dtypes)."""
    directory = Path(directory)
    config = OpenProvenceConfig.load(directory)
    weights_path = directory / "model.safetensors"
    if not weights_path.exists():
        raise FileNotFoundError(f"model.safetensors not found in {directory}")
    return config, module_state_dict(safetensors_io.load_file(weights_path), config)


def config_from_hf_checkpoint(directory: str | Path) -> OpenProvenceConfig:
    """Build an OpenProvenceConfig from a reference checkpoint's config.json."""
    return OpenProvenceConfig.load(directory)


def backbone_config_from_hf(directory_or_dict: str | Path | dict) -> ModernBertBackboneConfig:
    if isinstance(directory_or_dict, dict):
        return ModernBertBackboneConfig.from_hf_dict(directory_or_dict)
    raw = json.loads((Path(directory_or_dict) / "config.json").read_text())
    return ModernBertBackboneConfig.from_hf_dict(raw)
