"""Configuration dataclasses for the PyTorch/CUDA OpenProvence port.

Carried over unchanged in logic from ``open_provence_tpu/configs.py``, so
both packages read and write the same ``config.json``.

Mirrors the self-describing checkpoint layout of the reference
(``modeling_open_provence_standalone.py:1246-1302``):
an outer ``OpenProvenceConfig`` that embeds the full backbone config so that
checkpoints can be rebuilt without network access, including the intentional
``default_threadshold`` legacy spelling with a back-compat shim for the
corrected spelling.

The backbone config describes a ModernBERT-class encoder (rotary embeddings
with separate local/global theta, alternating local/global attention, GeGLU
MLP, bias-free linear/norm layout) built from scratch — the reference
delegates this architecture to ``transformers`` (encoder.py:128-144).
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

DEFAULT_PROCESS_THRESHOLD = 0.1


@dataclass(unsafe_hash=True)
class ModernBertBackboneConfig:
    """Architecture hyperparameters for the ModernBERT encoder.

    Field names follow the public ModernBERT config schema so that HF
    ``config.json`` files convert losslessly (see ``from_hf_dict``).

    Hashable (all-scalar fields, treated as frozen after construction), as
    in the JAX package, which keys its jit cache on it.
    """

    vocab_size: int = 50368
    hidden_size: int = 768
    intermediate_size: int = 1152
    num_hidden_layers: int = 22
    num_attention_heads: int = 12
    hidden_activation: str = "gelu"
    max_position_embeddings: int = 8192
    norm_eps: float = 1e-5
    norm_bias: bool = False
    global_rope_theta: float = 160000.0
    attention_bias: bool = False
    attention_dropout: float = 0.0
    global_attn_every_n_layers: int = 3
    local_attention: int = 128  # total window width; half-window each side
    local_rope_theta: float | None = 10000.0
    embedding_dropout: float = 0.0
    mlp_bias: bool = False
    mlp_dropout: float = 0.0
    classifier_pooling: str = "cls"  # "cls" | "mean"
    classifier_dropout: float = 0.0
    classifier_bias: bool = False
    classifier_activation: str = "gelu"
    initializer_range: float = 0.02
    initializer_cutoff_factor: float = 2.0
    pad_token_id: int = 50283
    bos_token_id: int | None = 50281
    eos_token_id: int | None = 50282
    cls_token_id: int | None = 50281
    sep_token_id: int | None = 50282
    num_labels: int = 1
    model_type: str = "modernbert"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def is_global_layer(self, layer_id: int) -> bool:
        """Layers 0, N, 2N, ... use global attention (HF semantics)."""
        return layer_id % self.global_attn_every_n_layers == 0

    def layer_rope_theta(self, layer_id: int) -> float:
        if self.is_global_layer(layer_id):
            return self.global_rope_theta
        if self.local_rope_theta is not None:
            return self.local_rope_theta
        return self.global_rope_theta

    def layer_window(self, layer_id: int) -> int | None:
        """Half-window size for local layers, None for global layers."""
        if self.is_global_layer(layer_id):
            return None
        return self.local_attention // 2

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_hf_dict(cls, config: dict[str, Any]) -> "ModernBertBackboneConfig":
        """Build from a HF-style ``config.json`` dict, ignoring unknown keys."""
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in config.items() if k in known}
        return cls(**kwargs)


@dataclass(unsafe_hash=True)
class PruningHeadConfig:
    """Token-classification pruning head: dropout + Linear(hidden, 2).

    Mirrors reference ``OpenProvenceHeadConfig``
    (open_provence/models/open_provence_head.py:21-49).
    """

    hidden_size: int = 768
    num_labels: int = 2
    classifier_dropout: float = 0.1
    sentence_pooling: str = "mean"
    use_weighted_pooling: bool = False

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, config: dict[str, Any]) -> "PruningHeadConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        # Reference checkpoints sometimes store "dropout" instead of
        # "classifier_dropout" (trainer.py:1584-1588).
        config = dict(config)
        if "dropout" in config and "classifier_dropout" not in config:
            config["classifier_dropout"] = config.pop("dropout")
        return cls(**{k: v for k, v in config.items() if k in known})


@dataclass
class OpenProvenceConfig:
    """Outer checkpoint config embedding the backbone config.

    Parity notes vs the reference (standalone:1246-1302):
      * ``default_threadshold`` — the intentional legacy typo is preserved as
        the canonical stored key; ``default_threshold`` is accepted with a
        warning for backwards compatibility.
      * ``base_model_config`` embeds the full backbone config so checkpoints
        are self-describing.
    """

    mode: str = "reranking_pruning"
    base_model_name_or_path: str | None = None
    base_model_config: dict[str, Any] | None = None
    tokenizer_name_or_path: str | None = None
    pruning_config: dict[str, Any] = field(default_factory=dict)
    max_length: int = 512
    num_labels: int = 1
    num_pruning_labels: int = 2
    encoder_architecture: str | None = None
    default_threadshold: float | None = None
    model_type: str = "open_provence"
    auto_map: dict[str, str] | None = None
    extras: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.default_threadshold is not None:
            self.default_threadshold = float(self.default_threadshold)

    @property
    def default_threshold(self) -> float | None:
        return self.default_threadshold

    def resolve_threshold(self, threshold: float | None = None) -> float:
        if threshold is not None:
            return float(threshold)
        if self.default_threadshold is not None:
            return float(self.default_threadshold)
        return DEFAULT_PROCESS_THRESHOLD

    def backbone(self) -> ModernBertBackboneConfig:
        if not self.base_model_config:
            raise ValueError(
                "OpenProvenceConfig.base_model_config is required to rebuild the backbone."
            )
        cfg = ModernBertBackboneConfig.from_hf_dict(self.base_model_config)
        cfg.num_labels = self.num_labels
        return cfg

    def pruning_head(self) -> PruningHeadConfig:
        cfg = PruningHeadConfig.from_dict(self.pruning_config or {})
        if "hidden_size" not in (self.pruning_config or {}):
            cfg.hidden_size = self.backbone().hidden_size
        return cfg

    def to_dict(self) -> dict[str, Any]:
        payload: dict[str, Any] = {
            "model_type": self.model_type,
            "mode": self.mode,
            "base_model_name_or_path": self.base_model_name_or_path,
            "base_model_config": self.base_model_config,
            "tokenizer_name_or_path": self.tokenizer_name_or_path,
            "pruning_config": self.pruning_config,
            "max_length": self.max_length,
            "num_labels": self.num_labels,
            "num_pruning_labels": self.num_pruning_labels,
            "encoder_architecture": self.encoder_architecture,
        }
        if self.default_threadshold is not None:
            payload["default_threadshold"] = self.default_threadshold
        if self.auto_map is not None:
            payload["auto_map"] = self.auto_map
        payload.update(self.extras)
        return payload

    @classmethod
    def from_dict(cls, config: dict[str, Any]) -> "OpenProvenceConfig":
        config = dict(config)
        raw_legacy = config.pop("default_threadshold", None)
        raw_corrected = config.pop("default_threshold", None)
        threshold: float | None = None
        if raw_legacy is not None:
            try:
                threshold = float(raw_legacy)
            except (TypeError, ValueError) as exc:
                raise TypeError(
                    "Config value 'default_threadshold' must be numeric."
                ) from exc
        elif raw_corrected is not None:
            warnings.warn(
                "Config key 'default_threshold' detected. Did you intend "
                "'default_threadshold'? Using the provided value for backwards "
                "compatibility.",
                RuntimeWarning,
                stacklevel=2,
            )
            try:
                threshold = float(raw_corrected)
            except (TypeError, ValueError) as exc:
                raise TypeError(
                    "Config value 'default_threshold' must be numeric."
                ) from exc
        # Drop deprecated language hints from historical configs
        # (standalone:1266-1268).
        config.pop("splitter_default_language", None)
        config.pop("standalone_process_default_language", None)

        known = {
            "mode",
            "base_model_name_or_path",
            "base_model_config",
            "tokenizer_name_or_path",
            "pruning_config",
            "max_length",
            "num_labels",
            "num_pruning_labels",
            "encoder_architecture",
            "model_type",
            "auto_map",
        }
        kwargs = {k: v for k, v in config.items() if k in known}
        extras = {k: v for k, v in config.items() if k not in known}
        kwargs.setdefault("pruning_config", {})
        if kwargs.get("num_labels") is None:
            kwargs["num_labels"] = 1
        if kwargs.get("num_pruning_labels") is None:
            kwargs["num_pruning_labels"] = 2
        return cls(default_threadshold=threshold, extras=extras, **kwargs)

    def save(self, directory: str | Path) -> Path:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        path = directory / "config.json"
        path.write_text(json.dumps(self.to_dict(), indent=2, ensure_ascii=False))
        return path

    @classmethod
    def load(cls, directory: str | Path) -> "OpenProvenceConfig":
        path = Path(directory)
        if path.is_dir():
            path = path / "config.json"
        return cls.from_dict(json.loads(path.read_text()))
