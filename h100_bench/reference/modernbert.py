"""Plain PyTorch ModernBERT with OpenProvence's two heads, in fp32.

Written from the published architecture (HF ``modeling_modernbert.py``'s
equations and OpenProvence's heads), independent of the program: token
embeddings and LayerNorm; pre-norm layers whose first has no attention
norm; fused Wqkv, rotate-half rotary embeddings with theta per layer,
softmax attention over the keys that are not padding and, on local layers,
within ``local_attention // 2`` positions (``|i - j| <= w``); a GeGLU MLP
(``act(x Wi_in) * (x Wi_gate)``, then Wo); a final norm. Every
``global_attn_every_n_layers``-th layer, starting at layer 0, is global.
The ranking head pools the final hidden states (the first token, or the
mean over real tokens), applies dense, the activation and a norm, then the
classifier; the pruning head is a linear map of the hidden states *before*
the final norm. LayerNorms carry no bias where the config says so.

Parameters are a dict in the HF checkpoint's names (``param_shapes``). The
matrix products go through ``Precision.linear``: exact fp32 by default; the
control computes them through float8 (``reference/precision.py``). Call
``torch.backends.cuda.matmul.allow_tf32 = False`` first (``fp32_mode``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import Precision

RB = "ranking_model.model"


def fp32_mode() -> None:
    """Full fp32 products on the card: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Names and shapes of every parameter, in the HF checkpoint's names."""
    h, i, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    heads_w = cfg["num_attention_heads"] * (h // cfg["num_attention_heads"])
    out = {f"{RB}.embeddings.tok_embeddings.weight": (v, h), f"{RB}.embeddings.norm.weight": (h,)}
    for n in range(cfg["num_hidden_layers"]):
        p = f"{RB}.layers.{n}"
        if n:
            out[f"{p}.attn_norm.weight"] = (h,)
        out[f"{p}.attn.Wqkv.weight"] = (3 * heads_w, h)
        out[f"{p}.attn.Wo.weight"] = (h, heads_w)
        out[f"{p}.mlp_norm.weight"] = (h,)
        out[f"{p}.mlp.Wi.weight"] = (2 * i, h)
        out[f"{p}.mlp.Wo.weight"] = (h, i)
    out[f"{RB}.final_norm.weight"] = (h,)
    out["ranking_model.head.dense.weight"] = (h, h)
    out["ranking_model.head.norm.weight"] = (h,)
    out["ranking_model.classifier.weight"] = (cfg.get("num_labels", 1), h)
    out["ranking_model.classifier.bias"] = (cfg.get("num_labels", 1),)
    out["pruning_head.classifier.weight"] = (2, h)
    out["pruning_head.classifier.bias"] = (2,)
    return out


def _act(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unsupported activation {name!r}")


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w


def _rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, heads, S, D]: rotate-half rotary embedding at positions 0..S-1."""
    s, d = x.shape[-2], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d)
    ang = torch.arange(s, device=x.device, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _attention(q, k, v, keys: torch.Tensor, window: int | None) -> torch.Tensor:
    """q, k, v [B, heads, S, D]; keys [B, S] bool (real tokens)."""
    s = q.shape[-2]
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    allowed = keys[:, None, None, :]
    if window is not None:
        pos = torch.arange(s, device=q.device)
        allowed = allowed & ((pos[:, None] - pos[None, :]).abs() <= window)[None, None]
    scores = scores.masked_fill(~allowed, float("-inf"))
    probs = torch.softmax(scores, dim=-1).nan_to_num(0.0)
    return probs @ v


def forward(params: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
            prec: Precision | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(ranking logits [B, num_labels], pruning logits [B, S, 2]) in fp32
    for token ids [B, S] and the attention mask [B, S] (1 = real)."""
    prec = prec or Precision()
    eps = cfg["norm_eps"]
    heads = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // heads
    act = _act(cfg["hidden_activation"])
    keys = mask.bool()
    b, s = ids.shape
    x = _norm(params[f"{RB}.embeddings.tok_embeddings.weight"][ids],
              params[f"{RB}.embeddings.norm.weight"], eps)
    every = cfg["global_attn_every_n_layers"]
    for n in range(cfg["num_hidden_layers"]):
        p = f"{RB}.layers.{n}"
        glob = n % every == 0
        theta = cfg["global_rope_theta"] if glob or cfg.get("local_rope_theta") is None \
            else cfg["local_rope_theta"]
        window = None if glob else cfg["local_attention"] // 2
        h = x if n == 0 else _norm(x, params[f"{p}.attn_norm.weight"], eps)
        qkv = prec.linear(h, params[f"{p}.attn.Wqkv.weight"]).view(b, s, 3, heads, d)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        o = _attention(_rotary(q, theta), _rotary(k, theta), v, keys, window)
        x = x + prec.linear(o.transpose(1, 2).reshape(b, s, heads * d), params[f"{p}.attn.Wo.weight"])
        h = _norm(x, params[f"{p}.mlp_norm.weight"], eps)
        inp, gate = prec.linear(h, params[f"{p}.mlp.Wi.weight"]).chunk(2, dim=-1)
        x = x + prec.linear(act(inp) * gate, params[f"{p}.mlp.Wo.weight"])
    pre = x
    last = _norm(pre, params[f"{RB}.final_norm.weight"], eps)
    if cfg["classifier_pooling"] == "mean":
        m = mask[..., None].float()
        pooled = (last * m).sum(1) / m.sum(1)
    else:
        pooled = last[:, 0]
    cact = _act(cfg["classifier_activation"])
    pooled = _norm(cact(prec.linear(pooled, params["ranking_model.head.dense.weight"])),
                   params["ranking_model.head.norm.weight"], eps)
    ranking = prec.linear(pooled, params["ranking_model.classifier.weight"]) \
        + params["ranking_model.classifier.bias"]
    pruning = prec.linear(pre, params["pruning_head.classifier.weight"]) \
        + params["pruning_head.classifier.bias"]
    return ranking, pruning


def rows_per_chunk(seq_len: int, budget: int = 1 << 28) -> int:
    """Rows a chunk of the reference takes at ``seq_len`` so that one
    layer's attention scores stay near ``budget`` elements."""
    return max(1, budget // (seq_len * seq_len * 12))
