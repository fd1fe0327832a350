"""Weights for the port: from the JAX package's parameter tree, or seeded.

``state_dict_from_flax`` turns the JAX package's flax parameter tree (numpy
leaves, as ``jax.device_get(params)`` gives them) into the port's state
dict, whose keys are the reference / HF checkpoint names. It imports no
jax: the tree is plain nested mappings.

``init_params`` draws a state dict from the distributions the flax module's
``init`` uses, so a run can use seeded random weights at full width.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from ..configs import OpenProvenceConfig


def state_dict_from_flax(
    params: Mapping[str, Any], config: OpenProvenceConfig
) -> dict[str, torch.Tensor]:
    """Dense ``kernel [in, out]`` → ``weight [out, in]``; ``embedding`` →
    ``weight``; norm ``scale`` → ``weight``; biases kept."""
    backbone = config.backbone()
    sd: dict[str, torch.Tensor] = {}

    def node(path: tuple[str, ...]) -> Mapping[str, Any]:
        out: Any = params
        for part in path:
            out = out[part]
        return out

    def tensor(arr: Any) -> torch.Tensor:
        return torch.tensor(np.asarray(arr))

    def linear(dst: str, src: tuple[str, ...]) -> None:
        leaf = node(src)
        sd[f"{dst}.weight"] = tensor(np.asarray(leaf["kernel"]).T)
        if "bias" in leaf:
            sd[f"{dst}.bias"] = tensor(leaf["bias"])

    def norm(dst: str, src: tuple[str, ...]) -> None:
        leaf = node(src)
        sd[f"{dst}.weight"] = tensor(leaf["scale"])
        if "bias" in leaf:
            sd[f"{dst}.bias"] = tensor(leaf["bias"])

    rb, rm = "ranking_model.model", ("ranking_model", "model")
    sd[f"{rb}.embeddings.tok_embeddings.weight"] = tensor(
        node(rm + ("embeddings", "tok_embeddings"))["embedding"]
    )
    norm(f"{rb}.embeddings.norm", rm + ("embeddings", "norm"))
    for i in range(backbone.num_hidden_layers):
        dst, src = f"{rb}.layers.{i}", rm + (f"layers_{i}",)
        if i != 0:
            norm(f"{dst}.attn_norm", src + ("attn_norm",))
        linear(f"{dst}.attn.Wqkv", src + ("attn", "Wqkv"))
        linear(f"{dst}.attn.Wo", src + ("attn", "Wo"))
        norm(f"{dst}.mlp_norm", src + ("mlp_norm",))
        linear(f"{dst}.mlp.Wi", src + ("mlp", "Wi"))
        linear(f"{dst}.mlp.Wo", src + ("mlp", "Wo"))
    norm(f"{rb}.final_norm", rm + ("final_norm",))
    linear("ranking_model.head.dense", ("ranking_model", "head", "dense"))
    norm("ranking_model.head.norm", ("ranking_model", "head", "norm"))
    linear("ranking_model.classifier", ("ranking_model", "classifier"))
    linear("pruning_head.classifier", ("pruning_head", "classifier"))
    return sd


def module_shapes(config: OpenProvenceConfig) -> dict[str, torch.Size]:
    """The port's module's state-dict names and shapes for ``config``
    (built on the meta device: nothing is allocated)."""
    from ..models.model import build_module

    with torch.device("meta"):
        return {k: v.shape for k, v in build_module(config).state_dict().items()}


# flax's lecun_normal: a normal truncated at ±2 standard units, rescaled so
# the truncated distribution has variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def init_params(
    config: OpenProvenceConfig, generator: torch.Generator
) -> dict[str, torch.Tensor]:
    """fp32 CPU state dict drawn as flax's ``init`` draws the module:
    embeddings N(0, 1/hidden); Linear weights lecun-normal (fan_in = in
    features); biases 0; norm scales 1. The numbers differ from flax's for
    the same seed (another generator); the distributions are the same."""
    sd: dict[str, torch.Tensor] = {}
    for name, shape in module_shapes(config).items():
        if name.endswith("tok_embeddings.weight"):
            t = torch.empty(shape).normal_(0.0, shape[1] ** -0.5, generator=generator)
        elif name.endswith(".bias"):
            t = torch.zeros(shape)
        elif len(shape) == 1:  # norm scale
            t = torch.ones(shape)
        else:  # Linear [out, in]
            std = math.sqrt(1.0 / shape[1]) / _TRUNC_STD
            t = torch.nn.init.trunc_normal_(
                torch.empty(shape), 0.0, std, -2.0 * std, 2.0 * std, generator=generator
            )
        sd[name] = t
    return sd
