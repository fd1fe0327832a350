"""The one traffic generator: synthetic English-like text from a seed.

Every traffic mix is a JSON file under ``traffic/`` whose numbers this
module reads; nothing here belongs to one mix. Text is drawn from a
synthetic vocabulary (``vocab_words`` lowercase words of 2-10 letters, made
from ``vocab_seed``) with Zipf frequencies (exponent ``zipf_s``), and cut
into sentences of exact token lengths (one token a character, see
``tokenizer.py``).

Sizes do not depend on the run's seed: a length distribution is read at
evenly spaced quantiles (``quantile_lengths``), and the seed only orders
those lengths and draws the words, so every seed brings the same amount of
work in another arrangement.

A sentence is "Capitalized words ... lastword." followed by one space when
another sentence of its passage follows; its last five characters before
the period are letters, so no sentence splitter reads the period as an abbreviation's or an
initial's. The sentences of a passage are therefore exactly what a sentence
splitter must return, and the reference takes them from here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))
# Letter frequencies of English text, so words look like words to a reader
# and to a splitter's heuristics alike.
_LETTER_FREQ = np.array([8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.2, 0.8, 4.0, 2.4,
                         6.7, 7.5, 1.9, 0.1, 6.0, 6.3, 9.1, 2.8, 1.0, 2.4, 0.2, 2.0, 0.1])


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any integer, also past 32 bits) and a
    stream of sub-keys, so separate parts of a run draw independently."""
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the evenly spaced quantiles (i + 0.5) / n of the
    distribution ``dist``: {"dist": "lognormal", "median", "sigma", "min",
    "max"} or {"dist": "uniform", "min", "max"}; clipped to [min, max]."""
    q = (np.arange(n) + 0.5) / n
    if dist["dist"] == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
        values = float(dist["median"]) * np.exp(float(dist["sigma"]) * z)
    elif dist["dist"] == "uniform":
        values = float(dist["min"]) + q * (float(dist["max"]) - float(dist["min"]))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(values), dist["min"], dist["max"]).astype(np.int64)


class Vocabulary:
    """``size`` synthetic words and their Zipf probabilities."""

    def __init__(self, size: int, zipf_s: float, seed: int):
        rng = rng_for(seed, 0)
        lengths = rng.integers(2, 11, size=size)
        p = _LETTER_FREQ / _LETTER_FREQ.sum()
        letters = rng.choice(_LETTERS, size=int(lengths.sum()), p=p)
        bounds = np.concatenate([[0], np.cumsum(lengths)])
        self.words = np.array(["".join(letters[a:b]) for a, b in zip(bounds[:-1], bounds[1:])])
        # Shorter words are the commoner ones, as in English.
        self.words = self.words[np.argsort(lengths, kind="stable")]
        ranks = np.arange(1, size + 1, dtype=np.float64)
        weights = ranks ** -float(zipf_s)
        self.p = weights / weights.sum()
        self.mean_len = float((self.p * np.char.str_len(self.words)).sum()) + 1.0


class TextStream:
    """Cuts sentences of exact lengths out of a stream of Zipf words."""

    def __init__(self, vocab: Vocabulary, rng: np.random.Generator):
        self.vocab, self.rng = vocab, rng
        self.buf, self.pos = "", 0

    def _take(self, n: int) -> str:
        if self.pos + n > len(self.buf):
            count = int(max(n, 65536) / self.vocab.mean_len * 1.2) + 16
            words = self.rng.choice(self.vocab.words, size=count, p=self.vocab.p)
            self.buf, self.pos = " ".join(words.tolist()), 0
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def groups(self, lengths: list[list[int]], end: str = ".") -> list[list[str]]:
        """Groups of sentences (a passage each) of the given lengths: each
        sentence "Capital words ... word<end>" followed by one space when
        another sentence of its group follows. Built in bulk: one slice of
        the word stream for all groups, the periods, spaces and capitals
        written over it."""
        flat = [n for group in lengths for n in group]
        lens = np.asarray(flat, dtype=np.int64)
        ends = np.cumsum(lens)
        starts = ends - lens
        last = np.zeros(len(flat), dtype=bool)
        last[np.cumsum([len(g) for g in lengths]) - 1] = True
        arr = np.frombuffer(self._take(int(ends[-1])).encode("ascii"), dtype=np.uint8).copy()
        arr[ends[~last] - 1] = ord(" ")
        period = np.where(last, ends - 1, ends - 2)
        arr[period] = ord(end)
        for k in range(1, 6):
            idx = period - k
            arr[idx[arr[idx] == ord(" ")]] = ord("e")
        first = arr[starts]
        arr[starts] = np.where(first == ord(" "), ord("T"), first - 32)
        text = arr.tobytes().decode("ascii")
        out, at = [], 0
        for group in lengths:
            out.append([text[a:b] for a, b in zip(starts[at : at + len(group)].tolist(),
                                                  ends[at : at + len(group)].tolist())])
            at += len(group)
        return out


class Draws:
    """Uniform integers in [lo, hi], drawn in bulk and handed out one by one."""

    def __init__(self, rng: np.random.Generator, lo: int, hi: int, count: int):
        self.values = rng.integers(lo, hi + 1, size=count).tolist()
        self.at = 0

    def __call__(self) -> int:
        self.at += 1
        return self.values[self.at - 1]


def sentence_lengths(total: int, lo: int, hi: int, draw) -> list[int]:
    """Split ``total`` tokens into sentence lengths in [lo, hi] (uniform
    draws from ``draw()``; the last one or two adjusted so they sum to
    ``total``)."""
    out, left = [], int(total)
    while left > hi:
        n = draw()
        if left - n < lo:
            n = left - lo
        out.append(n)
        left -= n
    out.append(left)
    return out


def span_lengths(total: int, count: int, lo: int, rng: np.random.Generator) -> list[int]:
    """Split ``total`` tokens into ``count`` spans of at least ``lo`` (cut
    points uniform over what is left)."""
    spare = total - count * lo
    cuts = np.sort(rng.integers(0, spare + 1, size=count - 1))
    parts = np.diff(np.concatenate([[0], cuts, [spare]]))
    return [int(p) + lo for p in parts]


@dataclass
class ProcessCall:
    """One ``process()`` call: queries[i] with passages[i][j], each a list of
    sentences (the passage's text is their concatenation)."""

    queries: list[str]
    passages: list[list[list[str]]]

    @property
    def pairs(self) -> int:
        return sum(len(group) for group in self.passages)

    def contexts(self) -> list[list[str]]:
        return [["".join(p) for p in group] for group in self.passages]


class Traffic:
    """The generator for one traffic mix (the JSON of ``traffic/<mix>.json``)
    and one run seed."""

    def __init__(self, mix: dict, seed: int):
        self.mix, self.seed = mix, int(seed)
        text = mix["text"]
        self.vocab = Vocabulary(int(text["vocab_words"]), float(text["zipf_s"]),
                                int(text["vocab_seed"]))
        self.sentence_range = tuple(text["sentence_tokens"])

    def _stream(self, *key: int) -> tuple[TextStream, np.random.Generator]:
        rng = rng_for(self.seed, *key)
        return TextStream(self.vocab, rng), rng

    @staticmethod
    def _queries(stream: TextStream, lengths) -> list[str]:
        return [g[0] for g in stream.groups([[int(n)] for n in lengths], end="?")]

    # --- process() traffic ---------------------------------------------------

    def process_call(self, index: int) -> ProcessCall:
        """Call ``index`` of the run: the same query and passage lengths in
        every call and for every seed, in an order and with words drawn from
        (seed, index)."""
        mix = self.mix
        nq, npq = int(mix["queries_per_call"]), int(mix["passages_per_query"])
        stream, rng = self._stream(1, index)
        q_lens = rng.permutation(quantile_lengths(mix["query_tokens"], nq))
        p_lens = rng.permutation(quantile_lengths(mix["passage_tokens"], nq * npq))
        lo, hi = self.sentence_range
        draw = Draws(rng, lo, hi, int(p_lens.sum()) // lo + 1)
        queries = self._queries(stream, q_lens)
        flat = stream.groups([sentence_lengths(int(n), lo, hi, draw) for n in p_lens])
        passages = [flat[i * npq : (i + 1) * npq] for i in range(nq)]
        return ProcessCall(queries, passages)

    # --- training traffic ----------------------------------------------------

    def train_rows(self, step: int) -> list[dict]:
        """The rows of optimizer step ``step`` (``pairs_per_step`` rows, one
        text a row, as the collator reads them); lengths as in
        ``process_call``."""
        mix = self.mix
        n = int(mix["pairs_per_step"])
        stream, rng = self._stream(2, step)
        q_lens = rng.permutation(quantile_lengths(mix["query_tokens"], n))
        t_lens = rng.permutation(quantile_lengths(mix["text_tokens"], n))
        lo_spans, hi_spans = mix["spans_per_text"]
        span_min = int(mix["span_min_tokens"])
        lengths = []
        for total in t_lens.tolist():
            count = int(np.clip(round(total / mix["tokens_per_span"]), lo_spans, hi_spans))
            lengths.append(span_lengths(total, min(count, total // span_min), span_min, rng))
        texts = stream.groups(lengths)
        queries = self._queries(stream, q_lens)
        rows = []
        for i, sentences in enumerate(texts):
            count = len(sentences)
            spans, at = [], 0
            for s in sentences:
                body = len(s.rstrip(" "))
                spans.append([at, at + body])
                at += len(s)
            relevance = (rng.random(count) < float(mix["relevant_share"])).astype(int).tolist()
            rows.append({
                "query": queries[i],
                "texts": ["".join(sentences)],
                "context_spans": [spans],
                "context_spans_relevance": [relevance],
                "labels": [int(any(relevance))],
                "teacher_score": [float(rng.random())],
            })
        return rows

