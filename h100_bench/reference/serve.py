"""What ``process()`` must answer, worked out in plain PyTorch.

OpenProvence's ``process()`` contract (the upstream standalone model's
``process``): each (query, context) pair's sentences are tokenized without
special tokens; a sentence longer than the fragment budget (half of
``max_length``, at least 16) is cut into fragments of that stride;
fragments are packed greedily, in order, into blocks ``[CLS] query [SEP]
fragments [SEP]`` whose query and separator take ``len(query) + len(sep
text)`` of the ``max_length - 2`` positions (the separator's text, "[SEP]",
tokenized as text: the upstream rule); a fragment that does not fit starts
a new block, cut to the room a block has. One forward per block gives a
keep probability per token (the softmax's second column of the pruning
logits) and a ranking score (sigmoid of the first ranking logit). A
fragment's score is the mean keep probability of its tokens; a sentence's
is the mean of its fragments' scores; a sentence is kept when its score is
above the threshold. A pair's score is the best of its blocks' scores, and
0 when nothing is kept.

The sentences come from the traffic generator, which built each passage
from them (``lib/textgen.py``); the program must find the same ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import modernbert
from .precision import Precision

SEP_TEXT = "[SEP]"


def encode(text: str) -> list[int]:
    """The benchmark tokenizer's ids (lib/tokenizer.py): ord + 10."""
    return [ord(c) + 10 for c in text]


@dataclass
class Block:
    pair: int  # index of the (query, context) pair within the call
    ids: list[int]
    ranges: list[tuple[int, int]]  # token range of each fragment
    sentence_of: list[int]  # the sentence each fragment belongs to


def pack_pair(pair: int, query: str, sentences: list[str], max_length: int) -> list[Block]:
    """The blocks of one pair under the contract above."""
    q = encode(query)
    budget = max(16, max_length // 2)
    frags: list[tuple[list[int], int]] = []
    for s_idx, sentence in enumerate(sentences):
        ids = encode(sentence)
        frags += [(ids[lo : lo + budget], s_idx) for lo in range(0, len(ids), budget)]
    room = max_length - 2
    fixed = len(q) + len(encode(SEP_TEXT))
    capacity = max(1, room - fixed)
    groups: list[list[tuple[list[int], int]]] = []
    used = None
    for ids, s_idx in frags:
        if used is not None and used + len(ids) <= room:
            groups[-1].append((ids, s_idx))
            used += len(ids)
            continue
        ids = ids[:capacity]
        groups.append([(ids, s_idx)])
        used = fixed + len(ids)
    blocks = []
    for group in groups:
        ids = [1, *q, 2]
        ranges, owners = [], []
        for frag, s_idx in group:
            ranges.append((len(ids), len(ids) + len(frag)))
            owners.append(s_idx)
            ids += frag
        ids.append(2)
        blocks.append(Block(pair, ids, ranges, owners))
    return blocks


def pack_call(queries: list[str], passages: list[list[list[str]]], max_length: int) -> list[Block]:
    """Every block of a call, pairs numbered query-major."""
    blocks, pair = [], 0
    for query, group in zip(queries, passages):
        for sentences in group:
            blocks += pack_pair(pair, query, sentences, max_length)
            pair += 1
    return blocks


@torch.no_grad()
def block_outputs(params: dict, cfg: dict, blocks: list[Block], device,
                  prec: Precision | None = None) -> list[tuple[float, np.ndarray]]:
    """(ranking score, per-token keep probabilities) of each block, run in
    chunks of blocks of equal padded length."""
    order = sorted(range(len(blocks)), key=lambda i: len(blocks[i].ids))
    out: list = [None] * len(blocks)
    lo = 0
    while lo < len(order):
        # Sorted by length: size the chunk by the longest block it would
        # take at the shortest one's size, which bounds its longest.
        n = modernbert.rows_per_chunk(len(blocks[order[lo]].ids))
        n = modernbert.rows_per_chunk(len(blocks[order[min(len(order), lo + n) - 1]].ids))
        chunk = order[lo : lo + n]
        seq = max(len(blocks[i].ids) for i in chunk)
        ids = torch.zeros((len(chunk), seq), dtype=torch.long)
        mask = torch.zeros((len(chunk), seq), dtype=torch.long)
        for r, i in enumerate(chunk):
            ids[r, : len(blocks[i].ids)] = torch.tensor(blocks[i].ids)
            mask[r, : len(blocks[i].ids)] = 1
        ranking, pruning = modernbert.forward(params, cfg, ids.to(device), mask.to(device), prec)
        score = torch.sigmoid(ranking[:, 0]).double().cpu().numpy()
        keep = torch.softmax(pruning.double(), dim=-1)[..., 1].cpu().numpy()
        for r, i in enumerate(chunk):
            out[i] = (float(score[r]), keep[r])
        lo += n
    return out


def pair_answers(blocks: list[Block], outputs, n_pairs: int, n_sentences: list[int],
                 threshold: float) -> tuple[list[float], list[list[float]], list[list[bool]]]:
    """(score, sentence probabilities, kept flags) of every pair."""
    sums = [np.zeros(n) for n in n_sentences]
    hits = [np.zeros(n) for n in n_sentences]
    best = [None] * n_pairs
    for block, (score, keep) in zip(blocks, outputs):
        p = block.pair
        best[p] = score if best[p] is None else max(best[p], score)
        for (lo, hi), s_idx in zip(block.ranges, block.sentence_of):
            sums[p][s_idx] += keep[lo:hi].mean() if hi > lo else 1.0
            hits[p][s_idx] += 1
    scores, probs, kept = [], [], []
    for p in range(n_pairs):
        means = np.clip(np.where(hits[p] > 0, sums[p] / np.maximum(hits[p], 1), 0.0), 0.0, 1.0)
        flags = means > threshold
        probs.append(means.tolist())
        kept.append(flags.tolist())
        scores.append(0.0 if not flags.any() else float(best[p]))
    return scores, probs, kept
