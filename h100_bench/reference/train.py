"""What an OpenProvence training step must do, worked out in plain PyTorch.

The upstream recipe (OpenProvence's data collator, loss and trainer; the
optimizer is optax's ``clip_by_global_norm`` then ``adafactor`` as the
shipped configs set it):

* a row (query, text, the text's sentence spans and their relevance, a
  teacher score) becomes ``[CLS] query [SEP] text [SEP]``, cut at
  ``max_length``; span k covers the tokens from the end of span k-1 (the
  separating space included) to its own end, all offset by the query and
  its two specials, and is labelled 1 when relevant and 0 otherwise; every
  other position is ignored (``-100``);
* the loss of a micro-batch is ``0.05 * mean((ranking_logit - teacher)^2)
  + mean token cross-entropy of the pruning logits`` over its labelled
  tokens; a step averages its micro-batches' losses and gradients;
* the gradients are scaled to a global norm of at most ``max_grad_norm``;
  adafactor (factored second moments of the two largest dims when the
  smaller is >= 128, decay ``1 - t^-0.8``, eps 1e-30, update clipped to a
  block RMS of 1, scaled by the learning rate and by the parameter's RMS
  floored at 1e-3, no weight decay) on linear warmup from 0 over
  ``int(total * warmup_ratio)`` steps, then cosine to 0.

Gradients are computed in fp32 in chunks of rows, summed with each chunk's
share of its micro-batch's normalizers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import modernbert
from .precision import Precision


def collate(rows: list[dict], max_length: int) -> dict[str, torch.Tensor]:
    """ids, mask, labels, teacher targets of one text per row."""
    n = len(rows)
    ids = torch.zeros((n, max_length), dtype=torch.long)
    mask = torch.zeros((n, max_length), dtype=torch.long)
    labels = torch.full((n, max_length), -100, dtype=torch.long)
    targets = torch.zeros(n)
    for r, row in enumerate(rows):
        q = [ord(c) + 10 for c in row["query"]]
        text = row["texts"][0]
        seq = ([1, *q, 2, *(ord(c) + 10 for c in text), 2])[:max_length]
        ids[r, : len(seq)] = torch.tensor(seq)
        mask[r, : len(seq)] = 1
        base, prev = len(q) + 2, 0
        for (lo, hi), rel in zip(row["context_spans"][0], row["context_spans_relevance"][0]):
            a, b = min(base + prev, len(seq)), min(base + hi, len(seq))
            labels[r, a:b] = int(rel)
            prev = hi
        targets[r] = float(row["teacher_score"][0])
    return {"ids": ids, "mask": mask, "labels": labels, "targets": targets}


def step_loss_and_grads(params: dict, cfg: dict, micro: list[dict], device,
                        prec: Precision | None = None, chunk: int = 16,
                        only_rows: int | None = None):
    """(loss, ranking loss, {name: grad}) of one optimizer step over its
    micro-batches (each a ``collate`` dict), in fp32, ``chunk`` rows at a
    time; both losses averaged over the micro-batches. ``only_rows`` sums
    only each micro-batch's first rows under the whole micro-batch's
    normalizers: one data rank's share with the exchange left out."""
    names = list(params)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    total = ranking_total = 0.0
    for mb in micro:
        rows = mb["ids"].shape[0]
        count = int((mb["labels"] != -100).sum())
        loss_mb = 0.0
        for lo in range(0, rows if only_rows is None else only_rows, chunk):
            sl = slice(lo, min(lo + chunk, rows if only_rows is None else only_rows))
            ids, mask = mb["ids"][sl].to(device), mb["mask"][sl].to(device)
            labels, targets = mb["labels"][sl].to(device), mb["targets"][sl].to(device)
            ranking, pruning = modernbert.forward(params, cfg, ids, mask, prec)
            r_loss = ((ranking[:, 0] - targets) ** 2).sum() / rows
            valid = labels != -100
            logp = F.log_softmax(pruning, dim=-1)
            picked = logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
            p_loss = -(picked * valid).sum() / max(count, 1)
            loss = (0.05 * r_loss + p_loss) / len(micro)
            part = torch.autograd.grad(loss, [params[k] for k in names])
            for k, g in zip(names, part):
                grads[k] += g
            loss_mb += float(loss.detach())
            ranking_total += float(r_loss.detach()) / len(micro)
        total += loss_mb
    return total, ranking_total, grads


def schedule(count: int, lr: float, total: int, warmup_ratio: float) -> float:
    warm = max(1, int(total * warmup_ratio))
    if count < warm:
        return lr * count / warm
    span = max(total, warm + 1) - warm
    return lr * 0.5 * (1 + math.cos(math.pi * min(count - warm, span) / span))


def factored_dims(shape) -> tuple[int, int] | None:
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """Global-norm clipping, then adafactor as above; ``state`` per name."""

    def __init__(self, lr: float, total: int, warmup_ratio: float, max_grad_norm: float):
        self.lr, self.total, self.warmup_ratio = lr, total, warmup_ratio
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.state: dict[str, tuple] = {}

    def clipped(self, grads: dict) -> dict:
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        if float(norm) < self.max_grad_norm:
            return grads
        return {k: g / norm * self.max_grad_norm for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        grads = self.clipped(grads)
        t = self.count + 1
        decay = 1.0 - t ** -0.8
        lr = schedule(self.count, self.lr, self.total, self.warmup_ratio)
        for k, g in grads.items():
            p = params[k]
            g2 = g * g + 1e-30
            dims = factored_dims(tuple(g.shape))
            if dims is None:
                v = self.state.get(k, (torch.zeros_like(g),))[0]
                v = decay * v + (1 - decay) * g2
                self.state[k] = (v,)
                u = g * v.rsqrt()
            else:
                d1, d0 = dims
                vr, vc = self.state.get(k, (torch.zeros_like(g2.mean(d0)),
                                            torch.zeros_like(g2.mean(d1))))
                vr = decay * vr + (1 - decay) * g2.mean(d0)
                vc = decay * vc + (1 - decay) * g2.mean(d1)
                self.state[k] = (vr, vc)
                r = d1 - 1 if d1 > d0 else d1
                rf = (vr / vr.mean(dim=r, keepdim=True)) ** -0.5
                u = g * rf.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
            u = u / torch.clamp(torch.sqrt(u.square().mean()), min=1.0)
            rms_p = torch.sqrt(p.square().mean())
            u = u * lr * torch.clamp(rms_p, min=1e-3)
            p.sub_(u)
        self.count += 1


def leaf_norms(tensors: dict) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}
