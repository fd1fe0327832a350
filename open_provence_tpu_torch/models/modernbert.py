"""ModernBERT encoder in PyTorch, on the port's kernels.

The counterpart of the JAX package's ``models/modernbert.py`` on its fused
path. The default, bias-free layout:

* token embeddings, then LayerNorm (kernel 1); no positional embeddings;
* pre-norm layers; layer 0's attn_norm is the identity (the embeddings are
  already normalized), later layers fold attn_norm into the Wqkv GEMM
  (kernel 2); layer 0's Wqkv is a plain ``nn.Linear``;
* attention on the packed Wqkv output (kernel 3) with rotary in-kernel,
  theta and window per layer: every ``global_attn_every_n_layers``-th layer
  is global (160k theta), the others see keys within ±local_attention//2
  (10k theta); head dims 32, 64, 128 and 256 and any head count go through
  the same call, which reads the buffer through strides;
* mlp_norm deferred past the residual add and folded into the Wi GEMM with
  the GeGLU epilogue (kernel 4); Wo stays a plain ``nn.Linear``. With the
  gate ``OPEN_PROVENCE_TPU_FUSED_MLP_TAIL`` (the JAX package's own name and
  values, read when the module is built) at ``1`` the whole MLP, Wo
  included, is one kernel forward (kernel 8) and backward (kernel 13); at
  ``bwd`` the forward stays split and only the backward is fused; at ``0``
  neither. The default is what the H100 measured fastest (``PERF.md``);
* both the last hidden state before ``final_norm`` (read by the pruning
  head) and after it (read by the ranking head).

Checkpoints that carry biases route as the JAX module routes them:

* ``norm_bias``: every norm is the plain LayerNorm with a bias (tensor ops,
  as it is XLA ops in JAX); no norm folds into a GEMM, so Wqkv is a plain
  linear and the MLP gets normalized rows and runs Wi → act·gate as the
  GeGLU GEMM without a norm (kernel 6), unless ``mlp_bias``;
* ``attention_bias`` (norms bias-free): attn_norm runs alone (kernel 1) and
  Wqkv and Wo are plain linears with biases; the MLP side is unchanged;
* ``mlp_bias`` (norms bias-free): the attention side is unchanged; the
  residual add fuses into mlp_norm (kernel 7, which returns the sum and its
  norm), and Wi with its bias, act·gate and Wo are plain tensor ops.

Attribute names follow the HF / reference state-dict names
(``embeddings.tok_embeddings``, ``layers.{i}.attn.Wqkv``, ``…mlp.Wi``,
``…mlp_norm``, ``final_norm``, ``head.dense``, ``classifier``; a bias is
``….bias`` beside ``….weight``), so a reference-layout state dict loads with
``load_state_dict`` as is.

Training: in ``train()`` mode the classifier dropout applies before the
ranking classifier, with masks drawn from a ``torch.Generator`` the caller
passes in (never the global RNG); a nonzero backbone dropout
(``attention_dropout``, ``embedding_dropout``, ``mlp_dropout``; 0.0 in
ModernBERT-base) raises ``NotImplementedError``. ``gradient_checkpointing``
recomputes each layer in the backward (``torch.utils.checkpoint``), as
``remat`` does in the JAX package.
"""

from __future__ import annotations

import os

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..configs import ModernBertBackboneConfig
from ..ops.flash_attention import flash_attention_packed
from ..ops.geglu import (
    geglu,
    geglu_wo_supported,
    ln_geglu,
    ln_geglu_wo,
    ln_matmul,
    lookup_activation,
)
from ..ops.layer_norm import add_layer_norm, layer_norm, layer_norm_plain
from ..ops.rotary import rope_tables
from .heads import dropout


class LayerNorm(nn.Module):
    """LayerNorm holding ``weight`` (the HF name for the scale) and, for
    norm_bias checkpoints, ``bias``. Bias-free it runs on the kernels; with
    a bias it is the plain LayerNorm on either device."""

    def __init__(self, hidden: int, eps: float, bias: bool = False):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return layer_norm(x, self.weight, self.eps)
        return layer_norm_plain(x, self.weight, self.eps, self.bias)

    def add(self, residual: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(residual + x, LN(residual + x)): one kernel when bias-free."""
        if self.bias is None:
            return add_layer_norm(residual, x, self.weight, self.eps)
        h = residual + x
        return h, layer_norm_plain(h, self.weight, self.eps, self.bias)


class ModernBertEmbeddings(nn.Module):
    def __init__(self, cfg: ModernBertBackboneConfig):
        super().__init__()
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.norm = LayerNorm(cfg.hidden_size, cfg.norm_eps, cfg.norm_bias)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.norm(self.tok_embeddings(input_ids))


class ModernBertAttention(nn.Module):
    """Fused-QKV attention with per-layer rotary theta and window."""

    def __init__(self, cfg: ModernBertBackboneConfig, layer_id: int):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.head_dim
        self.theta = cfg.layer_rope_theta(layer_id)
        self.window = cfg.layer_window(layer_id)
        self.Wqkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size, bias=cfg.attention_bias)
        self.Wo = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=cfg.attention_bias)

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: torch.Tensor | None,
        ln_scale: torch.Tensor | None = None,
        ln_eps: float = 1e-5,
    ) -> torch.Tensor:
        """``ln_scale`` (a deferred, bias-free attn_norm) folds the norm into a
        bias-free Wqkv; without it x goes through Wqkv as a plain linear."""
        batch, seq_len, hidden = x.shape
        if ln_scale is None:
            qkv = self.Wqkv(x)
        else:
            qkv = ln_matmul(
                x.reshape(batch * seq_len, hidden), ln_scale, self.Wqkv.weight, ln_eps
            ).reshape(batch, seq_len, 3 * hidden)
        rope = rope_tables(seq_len, self.head_dim, self.theta, qkv.dtype, qkv.device)
        out = flash_attention_packed(
            qkv, num_heads=self.num_heads, padding_mask=padding_mask,
            window=self.window, rope=rope,
        )
        return self.Wo(out)


MLP_TAIL_GATE = "OPEN_PROVENCE_TPU_FUSED_MLP_TAIL"
MLP_TAIL_DEFAULT = "0"


def mlp_tail_gate() -> str:
    """The whole-MLP fusion's gate: ``"1"`` (forward and backward fused),
    ``"bwd"`` (only the backward) or ``"0"`` (split: kernel 4 or 11 and a
    plain Wo)."""
    value = os.environ.get(MLP_TAIL_GATE, MLP_TAIL_DEFAULT)
    if value not in ("0", "1", "bwd"):
        raise ValueError(f"{MLP_TAIL_GATE} must be 0, 1 or bwd, not {value!r}")
    return value


class ModernBertMLP(nn.Module):
    """GeGLU MLP: Wi → act(input)·gate, then Wo. Bias-free, Wi and the gate
    run in one kernel, with mlp_norm folded in when its scale is passed; the
    gate (read here, when the module is built) folds Wo in too."""

    def __init__(self, cfg: ModernBertBackboneConfig):
        super().__init__()
        self.fused_tail = mlp_tail_gate() if cfg.mlp_dropout == 0.0 else "0"
        self.activation = cfg.hidden_activation
        self.act = lookup_activation(cfg.hidden_activation)[1]
        self.Wi = nn.Linear(cfg.hidden_size, 2 * cfg.intermediate_size, bias=cfg.mlp_bias)
        self.Wo = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=cfg.mlp_bias)

    def forward(
        self, x: torch.Tensor, ln_scale: torch.Tensor | None = None, ln_eps: float = 1e-5
    ) -> torch.Tensor:
        """``ln_scale`` (a deferred, bias-free mlp_norm) folds the norm into
        the Wi GEMM; without it x is normalized already."""
        if self.Wi.bias is not None:
            inp, gate = self.Wi(x).chunk(2, dim=-1)
            return self.Wo(self.act(inp) * gate)
        x2d = x.reshape(-1, x.shape[-1])
        if (
            ln_scale is not None
            and self.fused_tail != "0"
            and geglu_wo_supported(x2d.shape[1], self.Wo.in_features, x.dtype, self.activation)
        ):
            return ln_geglu_wo(
                x2d, ln_scale, self.Wi.weight, self.Wo.weight, self.activation, ln_eps,
                fuse_forward=self.fused_tail == "1",
            ).reshape(x.shape)
        if ln_scale is None:
            hidden = geglu(x2d, self.Wi.weight, self.activation)
        else:
            hidden = ln_geglu(x2d, ln_scale, self.Wi.weight, self.activation, ln_eps)
        return self.Wo(hidden).reshape(x.shape)


class ModernBertEncoderLayer(nn.Module):
    def __init__(self, cfg: ModernBertBackboneConfig, layer_id: int):
        super().__init__()
        self.eps = cfg.norm_eps
        # A norm folds into the GEMM it feeds only when neither carries a
        # bias (the JAX package's attn_ln_fusable / fuse_mlp_ln).
        self.fold_attn_norm = not (cfg.attention_bias or cfg.norm_bias)
        self.fold_mlp_norm = not (cfg.mlp_bias or cfg.norm_bias)
        # Layer 0 has no attn_norm parameter: its input is the normalized
        # embedding output (HF uses nn.Identity there).
        self.attn_norm = (
            None if layer_id == 0 else LayerNorm(cfg.hidden_size, cfg.norm_eps, cfg.norm_bias)
        )
        self.attn = ModernBertAttention(cfg, layer_id)
        self.mlp_norm = LayerNorm(cfg.hidden_size, cfg.norm_eps, cfg.norm_bias)
        self.mlp = ModernBertMLP(cfg)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor | None) -> torch.Tensor:
        if self.attn_norm is None:
            attn_in, attn_scale = x, None
        elif self.fold_attn_norm:
            attn_in, attn_scale = x, self.attn_norm.weight
        else:
            attn_in, attn_scale = self.attn_norm(x), None
        attn_out = self.attn(attn_in, padding_mask, attn_scale, self.eps)
        if self.fold_mlp_norm:
            x = x + attn_out
            return x + self.mlp(x, self.mlp_norm.weight, self.eps)
        x, mlp_in = self.mlp_norm.add(x, attn_out)
        return x + self.mlp(mlp_in)


def _layer_call(layer, names, x, padding_mask, *tensors):
    return functional_call(layer, dict(zip(names, tensors)), (x, padding_mask))


class ModernBertModel(nn.Module):
    """Backbone returning the last hidden state before and after final_norm."""

    def __init__(self, cfg: ModernBertBackboneConfig):
        super().__init__()
        self.backbone_dropouts = {
            n: getattr(cfg, n)
            for n in ("attention_dropout", "embedding_dropout", "mlp_dropout")
            if getattr(cfg, n)
        }
        self.gradient_checkpointing = False
        self.embeddings = ModernBertEmbeddings(cfg)
        self.layers = nn.ModuleList(
            ModernBertEncoderLayer(cfg, i) for i in range(cfg.num_hidden_layers)
        )
        self.final_norm = LayerNorm(cfg.hidden_size, cfg.norm_eps, cfg.norm_bias)

    def forward(
        self, input_ids: torch.Tensor, padding_mask: torch.Tensor | None = None
    ) -> dict[str, torch.Tensor]:
        if self.training and self.backbone_dropouts:
            raise NotImplementedError(
                f"backbone dropout {self.backbone_dropouts} is not ported yet; "
                "ModernBERT-base trains with 0.0"
            )
        remat = self.gradient_checkpointing and self.training and torch.is_grad_enabled()
        x = self.embeddings(input_ids)
        for layer in self.layers:
            if remat:
                # The layer's parameters go in as inputs, so the recompute in
                # the backward sees the tensors this forward saw, also when
                # they were swapped in by torch.func.functional_call.
                names, tensors = zip(*layer.named_parameters())
                x = checkpoint(_layer_call, layer, names, x, padding_mask, *tensors,
                               use_reentrant=False)
            else:
                x = layer(x, padding_mask)
        return {"last_hidden_pre_norm": x, "last_hidden_state": self.final_norm(x)}


class ModernBertPredictionHead(nn.Module):
    """dense → act → norm (HF ModernBertPredictionHead)."""

    def __init__(self, cfg: ModernBertBackboneConfig):
        super().__init__()
        self.act = lookup_activation(cfg.classifier_activation)[1]
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=cfg.classifier_bias)
        self.norm = LayerNorm(cfg.hidden_size, cfg.norm_eps, cfg.norm_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.act(self.dense(x)))


class ModernBertForSequenceClassification(nn.Module):
    """Backbone + pooled classification head (ranking logits): pool (cls or
    masked mean) → prediction head → dropout (training) → classifier."""

    def __init__(self, cfg: ModernBertBackboneConfig):
        super().__init__()
        if cfg.classifier_pooling not in ("cls", "mean"):
            raise ValueError(f"Unknown classifier_pooling: {cfg.classifier_pooling!r}")
        self.pooling = cfg.classifier_pooling
        self.classifier_dropout = cfg.classifier_dropout
        self.model = ModernBertModel(cfg)
        self.head = ModernBertPredictionHead(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(
        self,
        input_ids: torch.Tensor,
        padding_mask: torch.Tensor | None = None,
        *,
        generator: torch.Generator | None = None,
    ) -> dict[str, torch.Tensor]:
        """``generator`` draws the classifier dropout mask in training mode."""
        outputs = self.model(input_ids, padding_mask)
        hidden = outputs["last_hidden_state"]
        if self.pooling == "cls":
            pooled = hidden[:, 0]
        elif padding_mask is None:
            pooled = hidden.mean(dim=1)
        else:
            mask = padding_mask[..., None].to(hidden.dtype)
            pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1)
        pooled = self.head(pooled)
        if self.training:
            pooled = dropout(pooled, self.classifier_dropout, generator)
        return {"logits": self.classifier(pooled), **outputs}
