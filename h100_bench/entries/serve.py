"""Serving cells: a closed loop of ``OpenProvenceModel.process()`` calls.

Set-up makes the weights from the seed on the card, builds the model (bf16),
generates a pool of distinct calls, runs the program's ``warmup()`` (every
bucket shape) and one call of the mix, and freezes what it made out of the
garbage collector's reach (``gc.freeze``). The window then issues the pool's
calls back to back, one caller, until ``--seconds`` have passed; the last
call started finishes inside the window. A traced run profiles the few
calls that follow the window. Once the window has closed, the
calls ``check_calls`` drawn from the seed are worked out again by the plain
reference (``reference/serve.py``) and every answer of theirs is compared:
each sentence's keep probability (as a logit, so that a gap means the same
at 0.05 as at 0.5), each pair's score, each keep decision: the root mean
square of the gaps over every answer, and the largest.
"""

from __future__ import annotations

import gc
from time import perf_counter

import numpy as np

from ..lib.harness import (BENCH, HostLoad, Profiled, Run, card, check_kernels, eprint, p95,
                           peak_bytes, sync)
from ..lib.textgen import ProcessCall, Traffic, rng_for
from ..lib.tokenizer import CharTokenizer
from ..lib.weights import make_weights
from ..lib.work import Work, forward_work
from ..reference import modernbert as ref_model
from ..reference import serve as ref_serve
from ..reference.precision import CONTROL, Precision

# Call index of the set-up's warm-up call, outside any window's range.
WARM_CALL = 1 << 30
# Logits from the threshold within which a keep decision, and the zero
# score of a pair with nothing kept, may tip either way under rounding.
MARGIN = 0.5


def port_config(cfg: dict, max_length: int):
    from open_provence_tpu_torch import OpenProvenceConfig

    # The backbone reads the HF keys of the configuration file and ignores
    # the rest (source, reduced, assumed, training).
    return OpenProvenceConfig(base_model_config=dict(cfg), max_length=max_length,
                              pruning_config=dict(cfg["pruning_config"]), num_labels=1)


def build_model(cfg: dict, mix: dict, seed: int, device):
    from open_provence_tpu_torch import OpenProvenceModel

    weights = make_weights(cfg, seed, device)
    model = OpenProvenceModel(port_config(cfg, int(mix["max_length"])), weights, CharTokenizer(),
                              device=device)
    del weights
    return model


def call_kwargs(mix: dict) -> dict:
    return {"batch_size": mix.get("batch_size"), "threshold": mix.get("threshold"),
            "show_progress": False, "return_sentence_metrics": True}


def call_args(call: ProcessCall, contexts: list[list[str]]) -> tuple:
    """``process()``'s question and context for a call: one query and its
    list of contexts, or the lists of queries and of their context lists."""
    if len(call.queries) == 1:
        return call.queries[0], contexts[0]
    return call.queries, contexts


class Answers:
    """What the program returned for one call: scores and sentence
    probabilities, [query][context] (a one-query call's flat lists are
    nested back)."""

    def __init__(self, out: dict, n_queries: int):
        self.scores = out["reranking_score"]
        self.probs = out["sentence_probabilities"]
        if n_queries == 1:
            self.scores, self.probs = [self.scores], [self.probs]


# Keep probabilities are compared as logits within [0.001, 0.999]: past
# that band a probability is no nearer to any decision, and its logit would
# magnify the rounding of a tiny number.
PROB_BAND = 1e-3


def _logit(p) -> np.ndarray:
    p = np.clip(np.asarray(p, dtype=np.float64), PROB_BAND, 1 - PROB_BAND)
    return np.log(p) - np.log1p(-p)


def compare(call: ProcessCall, answers: Answers, ref, threshold: float,
            margin: float) -> dict:
    """Every answer of one call against the reference's (scores, probs,
    kept): the sums of squared and the largest gaps of the sentences' keep
    logits and of the pairs' scores, and the decisions flipped. A decision
    counts, and a pair's score (0 when nothing is kept) is compared, only
    where the reference's sentence probability (its best sentence's, for
    the score) lies more than ``margin`` logits from the threshold: nearer,
    a rounding may tip it either way."""
    ref_scores, ref_probs, _ = ref
    out = {"logit_sq": 0.0, "logit_max": 0.0, "sentences": 0, "score_sq": 0.0,
           "score_max": 0.0, "scored": 0, "flips": 0, "pairs": 0}
    thr = float(_logit(threshold))
    p = 0
    for qi, group in enumerate(call.passages):
        for ci, _ in enumerate(group):
            got, want = answers.probs[qi][ci], ref_probs[p]
            s = answers.scores[qi][ci]
            if got is None or len(got) != len(want) or s is None:
                out["logit_max"] = out["score_max"] = out["logit_sq"] = float("inf")
                return out
            g, w = _logit(got), _logit(want)
            d = np.abs(g - w)
            out["logit_sq"] += float((d * d).sum())
            out["logit_max"] = max(out["logit_max"], float(d.max()))
            out["sentences"] += len(d)
            far = np.abs(w - thr) > margin
            out["flips"] += int(((g > thr) != (w > thr))[far].sum())
            if abs(float(w.max()) - thr) > margin:
                e = abs(float(s) - ref_scores[p])
                out["score_sq"] += e * e
                out["score_max"] = max(out["score_max"], e)
                out["scored"] += 1
            out["pairs"] += 1
            p += 1
    return out


def summed(parts: list[dict]) -> dict:
    """The compared numbers over several calls' ``compare`` outputs: the
    root mean square and the largest gap of the keep logits and of the
    scores, and the decisions flipped."""
    total = {k: sum(p[k] for p in parts) for k in parts[0]}
    for k in ("logit_max", "score_max"):
        total[k] = max(p[k] for p in parts)
    return {"keep_logit_rms": (total["logit_sq"] / max(total["sentences"], 1)) ** 0.5,
            "keep_logit_gap": total["logit_max"],
            "score_rms": (total["score_sq"] / max(total["scored"], 1)) ** 0.5,
            "score_gap": total["score_max"],
            "decision_flips": total["flips"], "pairs": total["pairs"]}


def reference_answers(params, cfg, call: ProcessCall, max_length: int, threshold: float, device,
                      prec: Precision | None = None):
    blocks = ref_serve.pack_call(call.queries, call.passages, max_length)
    outputs = ref_serve.block_outputs(params, cfg, blocks, device, prec)
    n_sent = [len(s) for group in call.passages for s in group]
    return ref_serve.pair_answers(blocks, outputs, len(n_sent), n_sent, threshold)


def call_work(cfg: dict, call: ProcessCall, max_length: int, batch_rows: int) -> Work:
    blocks = ref_serve.pack_call(call.queries, call.passages, max_length)
    return forward_work(cfg, [len(b.ids) for b in blocks], batch_rows)


def threshold_of(mix: dict) -> float:
    from open_provence_tpu_torch.configs import DEFAULT_PROCESS_THRESHOLD

    return DEFAULT_PROCESS_THRESHOLD if mix.get("threshold") is None else float(mix["threshold"])


def run(run: Run) -> dict:
    import torch
    from open_provence_tpu_torch import kernels

    cell, mix, cfg = run.cell, run.cell.mix, run.cell.config
    device = card(run)
    model = build_model(cfg, mix, run.seed, device)
    traffic = Traffic(mix, run.seed)
    pool = [traffic.process_call(i) for i in range(int(mix["calls_in_pool"]))]
    texts = [c.contexts() for c in pool]
    kwargs = call_kwargs(mix)
    model.warmup(batch_size=mix.get("batch_size"))
    warm = traffic.process_call(WARM_CALL)
    model.process(*call_args(warm, warm.contexts()), **kwargs)
    sync(device)
    kernels.reset_launch_counts()
    # What set-up made lives on: no collection in the window walks it.
    gc.collect()
    gc.freeze()
    run.setup_s = perf_counter() - run.t0

    walls, answers, traces = [], [], []
    load = HostLoad()
    load.start()
    start = perf_counter()
    i = 0
    while True:
        call = pool[i % len(pool)]
        t = perf_counter()
        out = model.process(*call_args(call, texts[i % len(pool)]), **kwargs)
        walls.append(perf_counter() - t)
        answers.append(Answers(out, len(call.queries)))
        traces.append(out["performance_trace"].as_dict())
        i += 1
        if perf_counter() - start >= run.seconds:
            break
    run.window_s = perf_counter() - start
    eprint(load.report())
    gc.unfreeze()
    n_calls = i
    count = int(mix["profile"]["calls"])
    if run.trace:
        # The profiled slice: the calls that would have come next, after
        # the window, so the window itself runs as it does untraced.
        profiler = Profiled(BENCH / "_out" / "traces" / f"{cell.name}.json")
        profiler.start()
        for k in range(n_calls, n_calls + count):
            model.process(*call_args(pool[k % len(pool)], texts[k % len(pool)]), **kwargs)
        profiler.stop()
    pairs = sum(pool[k % len(pool)].pairs for k in range(n_calls))
    run.attempted = n_calls
    run.e2e = {"pairs_per_s": pairs / run.window_s, "query_p95_ms": p95(walls) * 1e3}
    spread = [min(walls), *np.quantile(walls, [0.25, 0.5, 0.75]).tolist(), max(walls)]
    eprint(f"calls in the window: {n_calls}, pairs {pairs}, window {run.window_s:.3f} s, "
           f"pool {len(pool)} distinct calls; call walls (ms) min, quartiles, max "
           f"{[round(1e3 * w, 1) for w in spread]}")
    memory_peak = peak_bytes(device)
    check_kernels(run, device, [k for k in kernels.DEFAULT_PATH_KERNELS if "bwd" not in k])

    if run.trace:
        run.summary = profiler.summary()
        per_call = {}
        batch_rows = int(mix.get("batch_size") or 32)
        for k in range(n_calls + count):
            key = k % len(pool)
            if key not in per_call:
                per_call[key] = call_work(cfg, pool[key], int(mix["max_length"]), batch_rows)
        run.window_work, run.slice_work = Work(), Work()
        for k in range(n_calls):
            run.window_work.merge(per_call[k % len(pool)])
        for k in range(n_calls, n_calls + count):
            run.slice_work.merge(per_call[k % len(pool)])
        run.slice_units = count
        run.host_traces = traces

    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check(run, pool, answers, n_calls, device)
    return {"memory_peak_bytes": int(memory_peak)}


def check(run: Run, pool, answers, n_calls: int, device) -> None:
    """The reference over the calls drawn from the seed; every answer of
    theirs held to the cell's limits."""
    import torch

    mix, cfg, limits = run.cell.mix, run.cell.config, run.cell.workload["limits"]
    distinct = sorted({k % len(pool) for k in range(n_calls)})
    rng = rng_for(run.seed, 9)
    want = min(int(mix["check_calls"]), len(distinct))
    picked = sorted(rng.choice(distinct, size=want, replace=False).tolist())
    ref_model.fp32_mode()
    params = make_weights(cfg, run.seed, device)
    thr = threshold_of(mix)
    t = perf_counter()
    parts = []
    for key in picked:
        ref = reference_answers(params, cfg, pool[key], int(mix["max_length"]), thr, device)
        parts.append(compare(pool[key], answers[key], ref, thr, MARGIN))
    got = summed(parts)
    eprint(f"reference over calls {picked}: {got['pairs']} pairs, {perf_counter() - t:.1f} s")
    for name in ("keep_logit_rms", "keep_logit_gap", "score_rms", "score_gap"):
        if name in limits:
            run.check(name, got[name], limits[name])
        else:  # read, not compared (PERF.md says why)
            eprint(f"reading {name}: {got[name]!r}")
    run.check("decision_flips", got["decision_flips"], 0)
    del params


def calibrate(run: Run, seeds: list[int]) -> list[dict]:
    """For each seed: the program's gaps on the calls a run would check,
    and the control's (the reference in ``CONTROL`` precision in the
    program's place), in one process. Calls are the first ``check_calls``
    of the pool, run through ``process()`` at the cell's own load."""
    import torch

    mix, cfg = run.cell.mix, run.cell.config
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    thr = threshold_of(mix)
    out = []
    for seed in seeds:
        model = build_model(cfg, mix, seed, device)
        traffic = Traffic(mix, seed)
        calls = [traffic.process_call(i) for i in range(int(mix["check_calls"]))]
        got = [Answers(model.process(*call_args(c, c.contexts()), **call_kwargs(mix)),
                       len(c.queries)) for c in calls]
        del model
        gc.collect()
        torch.cuda.empty_cache()
        ref_model.fp32_mode()
        params = make_weights(cfg, seed, device)
        row = {"seed": seed}
        for who in ("program", "control"):
            parts = []
            for c, a in zip(calls, got):
                ref = reference_answers(params, cfg, c, int(mix["max_length"]), thr, device)
                if who != "program":
                    low = reference_answers(params, cfg, c, int(mix["max_length"]), thr, device,
                                            Precision(CONTROL))
                    a = _AnswersFrom(low, c)
                parts.append(compare(c, a, ref, thr, MARGIN))
            row[who] = summed(parts)
        eprint(row)
        out.append(row)
        del params
        torch.cuda.empty_cache()
    return out


class _AnswersFrom(Answers):
    """The reference's (scores, probs) laid out as ``process()`` returns them."""

    def __init__(self, ref, call: ProcessCall):
        scores, probs, _ = ref
        self.scores, self.probs, p = [], [], 0
        for group in call.passages:
            self.scores.append(scores[p : p + len(group)])
            self.probs.append(probs[p : p + len(group)])
            p += len(group)
