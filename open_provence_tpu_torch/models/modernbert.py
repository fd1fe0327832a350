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

Training: in ``train()`` mode every dropout of the JAX module applies,
with masks drawn from a ``torch.Generator`` the caller passes in (never the
global RNG): the classifier dropout before the ranking classifier, and the
backbone's (0.0 in ModernBERT-base) at the JAX module's sites:
``embedding_dropout`` after the embedding norm, ``attention_dropout`` after
attention's Wo, ``mlp_dropout`` between act·gate and Wo (the MLP then
leaves the whole-MLP kernels: kernel 4, the mask, a plain Wo).
``gradient_checkpointing`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as ``remat`` does in the JAX package; the
recompute draws the forward's masks again from the generator state the
layer began with.

Over a mesh (``parallel/mesh.py``) a module holds one rank's part: its rows
of each batch (dropout takes those rows of the mask drawn for the whole
batch) and, with ``tensor_parallel``, its heads and intermediate columns.
Wqkv and Wi are column-parallel (their input enters through
``copy_to_model``, as does a norm scale folded into them, so the kernels'
backward partial dx and dscale are summed over the model group), attention
runs on the rank's heads, and Wo (or the whole-MLP kernel) is row-parallel:
its partial output is summed by ``reduce_from_model`` before the bias.
Embeddings, norms, heads and classifiers stay whole on every rank.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
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
from ..parallel.mesh import Mesh, check_tensor_parallel, copy_to_model, reduce_from_model
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
    def __init__(self, cfg: ModernBertBackboneConfig, mesh: Mesh | None = None):
        super().__init__()
        self.dropout = cfg.embedding_dropout
        self.mesh = mesh
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.norm = LayerNorm(cfg.hidden_size, cfg.norm_eps, cfg.norm_bias)

    def forward(
        self, input_ids: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        x = self.norm(self.tok_embeddings(input_ids))
        return dropout(x, self.dropout, generator, self.mesh) if self.training else x


def row_parallel(linear: nn.Linear, x: torch.Tensor, tp: Mesh | None) -> torch.Tensor:
    """``linear(x)`` for a row-parallel ``linear`` (its input columns split
    over ``tp``'s model group): the partial products summed over the group,
    then the bias, once."""
    if tp is None:
        return linear(x)
    out = reduce_from_model(F.linear(x, linear.weight), tp)
    return out if linear.bias is None else out + linear.bias


class ModernBertAttention(nn.Module):
    """Fused-QKV attention with per-layer rotary theta and window. Under
    tensor parallelism (``tp``, a mesh whose model axis splits the heads)
    the layer holds this rank's heads: Wqkv their q, k, v rows, Wo their
    input columns."""

    def __init__(
        self,
        cfg: ModernBertBackboneConfig,
        layer_id: int,
        mesh: Mesh | None = None,
        tp: Mesh | None = None,
    ):
        super().__init__()
        parts = tp.model if tp is not None else 1
        self.mesh, self.tp = mesh, tp
        self.num_heads = cfg.num_attention_heads // parts
        self.head_dim = cfg.head_dim
        self.theta = cfg.layer_rope_theta(layer_id)
        self.window = cfg.layer_window(layer_id)
        self.dropout = cfg.attention_dropout
        width = self.num_heads * self.head_dim
        self.Wqkv = nn.Linear(cfg.hidden_size, 3 * width, bias=cfg.attention_bias)
        self.Wo = nn.Linear(width, cfg.hidden_size, bias=cfg.attention_bias)

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: torch.Tensor | None,
        ln_scale: torch.Tensor | None = None,
        ln_eps: float = 1e-5,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``ln_scale`` (a deferred, bias-free attn_norm) folds the norm into a
        bias-free Wqkv; without it x goes through Wqkv as a plain linear."""
        batch, seq_len, hidden = x.shape
        x, ln_scale = copy_to_model(x, self.tp), copy_to_model(ln_scale, self.tp)
        if ln_scale is None:
            qkv = self.Wqkv(x)
        else:
            qkv = ln_matmul(
                x.reshape(batch * seq_len, hidden), ln_scale, self.Wqkv.weight, ln_eps
            ).reshape(batch, seq_len, self.Wqkv.out_features)
        rope = rope_tables(seq_len, self.head_dim, self.theta, qkv.dtype, qkv.device)
        out = flash_attention_packed(
            qkv, num_heads=self.num_heads, padding_mask=padding_mask,
            window=self.window, rope=rope,
        )
        out = row_parallel(self.Wo, out, self.tp)
        return dropout(out, self.dropout, generator, self.mesh) if self.training else out


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
    gate (read here, when the module is built) folds Wo in too. Under
    tensor parallelism (``tp``) the layer holds this rank's intermediate
    columns: Wi their input rows followed by their gate rows, Wo their
    input columns."""

    def __init__(
        self, cfg: ModernBertBackboneConfig, mesh: Mesh | None = None, tp: Mesh | None = None
    ):
        super().__init__()
        self.mesh, self.tp = mesh, tp
        self.dropout = cfg.mlp_dropout
        self.fused_tail = mlp_tail_gate() if cfg.mlp_dropout == 0.0 else "0"
        self.activation = cfg.hidden_activation
        self.act = lookup_activation(cfg.hidden_activation)[1]
        width = cfg.intermediate_size // (tp.model if tp is not None else 1)
        self.Wi = nn.Linear(cfg.hidden_size, 2 * width, bias=cfg.mlp_bias)
        self.Wo = nn.Linear(width, cfg.hidden_size, bias=cfg.mlp_bias)

    def forward(
        self,
        x: torch.Tensor,
        ln_scale: torch.Tensor | None = None,
        ln_eps: float = 1e-5,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``ln_scale`` (a deferred, bias-free mlp_norm) folds the norm into
        the Wi GEMM; without it x is normalized already."""
        x, ln_scale = copy_to_model(x, self.tp), copy_to_model(ln_scale, self.tp)
        if self.Wi.bias is not None:
            inp, gate = self.Wi(x).chunk(2, dim=-1)
            return row_parallel(self.Wo, self._drop(self.act(inp) * gate, generator), self.tp)
        x2d = x.reshape(-1, x.shape[-1])
        if (
            ln_scale is not None
            and self.fused_tail != "0"
            and geglu_wo_supported(x2d.shape[1], self.Wo.in_features, x.dtype, self.activation)
        ):
            # Under tensor parallelism kernel 8's output is a partial sum.
            return reduce_from_model(ln_geglu_wo(
                x2d, ln_scale, self.Wi.weight, self.Wo.weight, self.activation, ln_eps,
                fuse_forward=self.fused_tail == "1",
            ), self.tp).reshape(x.shape)
        if ln_scale is None:
            hidden = geglu(x2d, self.Wi.weight, self.activation)
        else:
            hidden = ln_geglu(x2d, ln_scale, self.Wi.weight, self.activation, ln_eps)
        return row_parallel(self.Wo, self._drop(hidden, generator), self.tp).reshape(x.shape)

    def _drop(self, hidden: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if not self.training:
            return hidden
        return dropout(hidden, self.dropout, generator, self.mesh, split_columns=self.tp is not None)


class ModernBertEncoderLayer(nn.Module):
    """Under tensor parallelism the norms stay whole on every rank; a norm
    folded into a column-parallel GEMM (kernels 2, 4, 8) enters it through
    ``copy_to_model``, so its scale's gradient, which that GEMM's backward
    gives from this rank's columns alone, is summed over the group."""

    def __init__(
        self,
        cfg: ModernBertBackboneConfig,
        layer_id: int,
        mesh: Mesh | None = None,
        tp: Mesh | None = None,
    ):
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
        self.attn = ModernBertAttention(cfg, layer_id, mesh, tp)
        self.mlp_norm = LayerNorm(cfg.hidden_size, cfg.norm_eps, cfg.norm_bias)
        self.mlp = ModernBertMLP(cfg, mesh, tp)

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: torch.Tensor | None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        if self.attn_norm is None:
            attn_in, attn_scale = x, None
        elif self.fold_attn_norm:
            attn_in, attn_scale = x, self.attn_norm.weight
        else:
            attn_in, attn_scale = self.attn_norm(x), None
        attn_out = self.attn(attn_in, padding_mask, attn_scale, self.eps, generator)
        if self.fold_mlp_norm:
            x = x + attn_out
            return x + self.mlp(x, self.mlp_norm.weight, self.eps, generator)
        x, mlp_in = self.mlp_norm.add(x, attn_out)
        return x + self.mlp(mlp_in, generator=generator)


def _layer_call(layer, names, x, padding_mask, generator, start, ends, *tensors):
    """One layer under ``functional_call``, for ``torch.utils.checkpoint``,
    which restores the global RNG but not an explicit generator. With a
    dropout ``generator`` the layer draws its masks from ``start`` (the
    generator's state when the forward reached the layer) and leaves the
    generator as it found it, so the recompute in the backward draws the
    forward's masks and disturbs nothing; the state the forward's draws end
    in is appended to ``ends``."""
    params = dict(zip(names, tensors))
    if generator is None:
        return functional_call(layer, params, (x, padding_mask))
    resume = generator.get_state()
    generator.set_state(start)
    try:
        out = functional_call(layer, params, (x, padding_mask), {"generator": generator})
        ends.append(generator.get_state())
    finally:
        generator.set_state(resume)
    return out


class ModernBertModel(nn.Module):
    """Backbone returning the last hidden state before and after final_norm.
    ``mesh`` (a ``parallel.Mesh``) says which rows of a batch this rank
    holds, for dropout; with ``tensor_parallel`` its model axis splits the
    heads and the MLP's intermediate columns."""

    def __init__(
        self,
        cfg: ModernBertBackboneConfig,
        mesh: Mesh | None = None,
        tensor_parallel: bool = False,
    ):
        super().__init__()
        tp = mesh if tensor_parallel and mesh is not None and mesh.model > 1 else None
        if tp is not None:
            check_tensor_parallel(cfg.num_attention_heads, cfg.intermediate_size, tp.model)
        self.layer_dropout = bool(cfg.attention_dropout or cfg.mlp_dropout)
        self.gradient_checkpointing = False
        self.embeddings = ModernBertEmbeddings(cfg, mesh)
        self.layers = nn.ModuleList(
            ModernBertEncoderLayer(cfg, i, mesh, tp) for i in range(cfg.num_hidden_layers)
        )
        self.final_norm = LayerNorm(cfg.hidden_size, cfg.norm_eps, cfg.norm_bias)

    def forward(
        self,
        input_ids: torch.Tensor,
        padding_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> dict[str, torch.Tensor]:
        """``generator`` draws the backbone's dropout masks in training mode."""
        remat = self.gradient_checkpointing and self.training and torch.is_grad_enabled()
        layer_generator = generator if self.training and self.layer_dropout else None
        x = self.embeddings(input_ids, generator)
        for layer in self.layers:
            if remat:
                # The layer's parameters go in as inputs, so the recompute in
                # the backward sees the tensors this forward saw, also when
                # they were swapped in by torch.func.functional_call.
                names, tensors = zip(*layer.named_parameters())
                start, ends = None, []
                if layer_generator is not None:
                    start = layer_generator.get_state()
                x = checkpoint(_layer_call, layer, names, x, padding_mask, layer_generator,
                               start, ends, *tensors, use_reentrant=False)
                if layer_generator is not None:
                    layer_generator.set_state(ends[0])
            else:
                x = layer(x, padding_mask, generator)
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

    def __init__(
        self,
        cfg: ModernBertBackboneConfig,
        mesh: Mesh | None = None,
        tensor_parallel: bool = False,
    ):
        super().__init__()
        if cfg.classifier_pooling not in ("cls", "mean"):
            raise ValueError(f"Unknown classifier_pooling: {cfg.classifier_pooling!r}")
        self.pooling = cfg.classifier_pooling
        self.classifier_dropout = cfg.classifier_dropout
        self.mesh = mesh
        self.model = ModernBertModel(cfg, mesh, tensor_parallel)
        self.head = ModernBertPredictionHead(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(
        self,
        input_ids: torch.Tensor,
        padding_mask: torch.Tensor | None = None,
        *,
        generator: torch.Generator | None = None,
    ) -> dict[str, torch.Tensor]:
        """``generator`` draws the dropout masks in training mode (the
        backbone's, then the classifier's)."""
        outputs = self.model(input_ids, padding_mask, generator)
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
            pooled = dropout(pooled, self.classifier_dropout, generator, self.mesh)
        return {"logits": self.classifier(pooled), **outputs}
