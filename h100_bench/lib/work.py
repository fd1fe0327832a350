"""The work a cell's inputs need, counted from the inputs, and the card's peaks.

Counts follow the model's equations at each sequence's *valid* length (the
tokens of a block or a collated row), whatever the program pads, buckets or
fuses, so a later change meets the same yardstick. Matrix products count
2 * m * n * k operations; attention counts ``4 * head_dim * heads`` per
(query, key) pair it attends to (QK^T and PV), global layers all L^2 pairs,
local layers the pairs with |i - j| <= window. Bytes count each operand
once in bf16: for a product its activations in and out, and its weights
once per forward batch of ``batch_rows`` sequences; for attention q, k, v
read and the output written. A backward counts twice the forward's
operations (no recompute).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# NVIDIA H100 SXM, dense bf16 tensor-core rate and HBM3 bandwidth (data sheet).
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2


@dataclass
class Work:
    """Operations and bytes by kind of work."""

    flops: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)

    def add(self, kind: str, flops: float, nbytes: float) -> None:
        self.flops[kind] = self.flops.get(kind, 0.0) + flops
        self.bytes[kind] = self.bytes.get(kind, 0.0) + nbytes

    def merge(self, other: "Work", times: float = 1.0) -> None:
        for k in other.flops:
            self.add(k, other.flops[k] * times, other.bytes[k] * times)

    def total_flops(self) -> float:
        return sum(self.flops.values())

    def bound_s(self, kinds) -> float:
        """Least time of the work of ``kinds`` on one card: the larger of
        operations over the peak rate and bytes over the bandwidth."""
        f = sum(self.flops.get(k, 0.0) for k in kinds)
        b = sum(self.bytes.get(k, 0.0) for k in kinds)
        return max(f / PEAK_FLOPS, b / PEAK_BYTES)


def attended_pairs(length: int, window: int | None) -> int:
    """(query, key) pairs of a sequence of ``length`` real tokens."""
    if window is None or window >= length - 1:
        return length * length
    w = window
    # Each query sees 2w + 1 keys, minus those beyond either end.
    return length * (2 * w + 1) - w * (w + 1)


def products(cfg: dict) -> dict[str, tuple[int, int]]:
    """(k, n) of each per-token projection of one layer."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    heads_w = cfg["num_attention_heads"] * (h // cfg["num_attention_heads"])
    return {"wqkv": (h, 3 * heads_w), "attn_wo": (heads_w, h), "wi": (h, 2 * i),
            "mlp_wo": (i, h)}


def forward_work(cfg: dict, lengths, batch_rows: int) -> Work:
    """The work of one forward over sequences of the given valid lengths."""
    work = Work()
    tokens = float(sum(lengths))
    n_seq = len(lengths)
    batches = -(-n_seq // max(1, batch_rows))
    layers = cfg["num_hidden_layers"]
    h = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    d = h // heads
    for k, n in products(cfg).values():
        work.add("gemm", layers * 2.0 * tokens * k * n,
                 layers * BF16 * (tokens * (k + n) + batches * k * n))
    # Heads: the ranking head's dense and classifier on one pooled row a
    # sequence, the pruning classifier on every token.
    work.add("gemm", 2.0 * n_seq * (h * h + h) + 2.0 * tokens * h * 2,
             BF16 * (n_seq * 2 * h + tokens * (h + 2) + batches * (h * h + 3 * h)))
    every = cfg["global_attn_every_n_layers"]
    for layer in range(layers):
        window = None if layer % every == 0 else cfg["local_attention"] // 2
        kind = "attention_global" if window is None else "attention_local"
        pairs = float(sum(attended_pairs(int(l), window) for l in lengths))
        work.add(kind, 4.0 * d * heads * pairs, BF16 * 4 * tokens * h)
    return work


def training_work(cfg: dict, lengths, batch_rows: int) -> Work:
    """Forward and backward (twice the forward's operations) of one step."""
    fwd = forward_work(cfg, lengths, batch_rows)
    out = Work()
    out.merge(fwd, 3.0)
    return out

