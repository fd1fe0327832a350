"""MLDR long-document evaluation: prune stage + LLM-judge stage.

The port's copy of the JAX package's ``eval/mldr_eval.py``: stage 1 runs the
port's ``OpenProvenceModel.process`` (or any callable with its signature);
the records, reports, judge prompt and judge transport are the JAX
package's, byte for byte. ``yaml`` is imported where the ignore list is
read, so that importing the module needs none.

Counterpart of the reference's scripts/eval_mldr.py (1651 LoC): stage 1 runs
``process()`` over Shitao/MLDR positive+negative passages and records pruned
text / scores / compression per passage; stage 2 asks an LLM judge whether
each pruned positive passage still answers the query ("Has Answer"). Output
artifacts (records schema, summary.json fields, ignore-list semantics,
60k-char clamp) match the reference so Has Answer numbers are comparable.

The judge prompt and JSON contract are reproduced verbatim from the
reference (eval_mldr.py:970-1020) — judge comparability requires byte-equal
prompts (SURVEY §7 hard parts). The transport is a native httpx client
against any OpenAI-compatible chat-completions endpoint (litellm is not
available here); tests inject a fake judge callable.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from collections import Counter
from collections.abc import Callable, Sequence
from dataclasses import dataclass
from pathlib import Path
from statistics import fmean, median
from time import perf_counter
from typing import Any

LOGGER = logging.getLogger("open_provence_tpu_torch.eval.mldr")


# --- stage 1: prune ---------------------------------------------------------


def normalize_title(value: Any) -> str | None:
    """(reference eval_mldr.py:255-272)"""
    if value is None:
        return None
    if isinstance(value, str):
        stripped = value.strip()
        return stripped if stripped else None
    if isinstance(value, Sequence):
        parts = [str(item).strip() for item in value if item is not None and str(item).strip()]
        return " ".join(parts) if parts else None
    stripped = str(value).strip()
    return stripped if stripped else None


def build_records(
    process_fn: Callable[..., dict[str, Any]],
    dataset: Any,
    *,
    threshold: float,
    batch_size: int,
    use_best_reranker_score: bool = True,
    show_progress: bool = False,
) -> tuple[list[dict[str, Any]], dict[str, list[float]], int]:
    """Per-passage records {query_id, query, docid, label, title,
    original_text, pruned_text, reranking_score, compression_rate,
    kept/removed_sentences} + pos/neg stats (reference :238-515)."""
    stats: dict[str, list[float]] = {
        "pos_scores": [],
        "neg_scores": [],
        "pos_compression": [],
        "neg_compression": [],
    }

    queries: list[str] = []
    query_ids: list[str] = []
    contexts_per_query: list[list[str]] = []
    titles_per_query: list[list[str | None]] = []
    docids_per_query: list[list[str]] = []
    labels_per_query: list[list[int]] = []

    for row in dataset:
        positives = row.get("positive_passages") or []
        negatives = row.get("negative_passages") or []
        context_texts, title_texts, docids, labels = [], [], [], []
        for passage, label in [(p, 1) for p in positives] + [(n, 0) for n in negatives]:
            context_texts.append(passage["text"])
            title_texts.append(
                normalize_title(passage.get("title") if isinstance(passage, dict) else None)
            )
            docids.append(passage["docid"])
            labels.append(label)
        if not context_texts:
            continue
        query_ids.append(str(row["query_id"]))
        queries.append(str(row["query"]))
        contexts_per_query.append(context_texts)
        titles_per_query.append(title_texts)
        docids_per_query.append(docids)
        labels_per_query.append(labels)

    if not queries:
        return [], stats, 0

    result = process_fn(
        question=queries,
        context=contexts_per_query,
        title=titles_per_query,
        threshold=threshold,
        batch_size=batch_size,
        use_best_reranker_score=use_best_reranker_score,
        show_progress=show_progress,
        return_sentence_texts=True,
    )

    pruned_all = result["pruned_context"]
    scores_all = result.get("reranking_score")
    compression_all = result.get("compression_rate")
    kept_all = result.get("kept_sentences")
    removed_all = result.get("removed_sentences")
    title_all = result.get("title")

    records: list[dict[str, Any]] = []
    for q_idx, query_text in enumerate(queries):
        docids = docids_per_query[q_idx]
        labels = labels_per_query[q_idx]
        originals = contexts_per_query[q_idx]
        titles_in = titles_per_query[q_idx]
        model_titles = (
            title_all[q_idx] if isinstance(title_all, list) and q_idx < len(title_all) else None
        )
        for d_idx in range(len(docids)):
            def _pick(nested, default):
                if not isinstance(nested, list) or q_idx >= len(nested):
                    return default
                row_vals = nested[q_idx]
                if not isinstance(row_vals, list) or d_idx >= len(row_vals):
                    return default
                return row_vals[d_idx]

            effective_title = normalize_title(titles_in[d_idx])
            if effective_title is None and isinstance(model_titles, list) and d_idx < len(model_titles):
                effective_title = normalize_title(model_titles[d_idx])

            score = _pick(scores_all, None)
            compression = _pick(compression_all, 0.0)
            record = {
                "query_id": query_ids[q_idx],
                "query": query_text,
                "docid": docids[d_idx],
                "label": labels[d_idx],
                "title": effective_title,
                "original_text": originals[d_idx],
                "pruned_text": _pick(pruned_all, ""),
                "reranking_score": score,
                "compression_rate": compression,
                "kept_sentences": _pick(kept_all, []),
                "removed_sentences": _pick(removed_all, []),
            }
            records.append(record)
            bucket = "pos" if labels[d_idx] == 1 else "neg"
            stats[f"{bucket}_scores"].append(
                score if score is not None else float("nan")
            )
            stats[f"{bucket}_compression"].append(float(compression))

    return records, stats, len(query_ids)


def build_original_records(dataset: Any) -> tuple[list[dict[str, Any]], dict[str, list[float]], int]:
    """No-prune baseline: compression 0, pruned = original
    (reference :734-925)."""
    stats: dict[str, list[float]] = {
        "pos_scores": [],
        "neg_scores": [],
        "pos_compression": [],
        "neg_compression": [],
    }
    records: list[dict[str, Any]] = []
    query_count = 0
    for row in dataset:
        positives = row.get("positive_passages") or []
        negatives = row.get("negative_passages") or []

        def _append(passage: dict[str, Any], label: int, row=row) -> None:
            records.append(
                {
                    "query_id": str(row["query_id"]),
                    "query": str(row["query"]),
                    "docid": passage["docid"],
                    "label": label,
                    "title": normalize_title(passage.get("title")),
                    "original_text": passage["text"],
                    "pruned_text": passage["text"],
                    "reranking_score": None,
                    "compression_rate": 0.0,
                    "kept_sentences": [],
                    "removed_sentences": [],
                }
            )
            bucket = "pos" if label == 1 else "neg"
            stats[f"{bucket}_compression"].append(0.0)

        for passage in positives:
            _append(passage, 1)
        for passage in negatives:
            _append(passage, 0)
        if positives or negatives:
            query_count += 1
    return records, stats, query_count


def process_summary(
    records: list[dict[str, Any]],
    stats: dict[str, list[float]],
    num_queries: int,
    *,
    args_payload: dict[str, Any],
    elapsed: float,
) -> dict[str, Any]:
    """summary.json with pos/neg score & compression means
    (reference :686-713)."""

    def _mean(values: list[float]) -> float | None:
        finite = [v for v in values if v == v]
        return fmean(finite) if finite else None

    return {
        **args_payload,
        "num_records": len(records),
        "num_queries": num_queries,
        "avg_pos_score": _mean(stats["pos_scores"]),
        "avg_neg_score": _mean(stats["neg_scores"]),
        "avg_pos_compression": _mean(stats["pos_compression"]),
        "avg_neg_compression": _mean(stats["neg_compression"]),
        "process_time_seconds": elapsed,
    }


def write_markdown_report(
    records: list[dict[str, Any]],
    output_path: Path,
    *,
    threshold: float,
    max_queries: int = 5,
) -> None:
    """Human-readable sample of pruning results (counterpart of the
    reference's result.md, :527-609)."""
    by_query: dict[str, list[dict[str, Any]]] = {}
    for record in records:
        by_query.setdefault(record["query_id"], []).append(record)
    lines = [f"# MLDR pruning samples (threshold={threshold})", ""]
    for qid in list(by_query)[:max_queries]:
        rows = by_query[qid]
        lines.append(f"## {qid}: {rows[0]['query']}")
        for record in rows[:3]:
            score = record.get("reranking_score")
            lines += [
                "",
                f"* docid={record['docid']} label={record['label']} "
                f"score={score if score is None else round(score, 4)} "
                f"compression={round(float(record.get('compression_rate') or 0.0), 2)}%",
                "",
                "**Pruned text:**",
                f"> {record.get('pruned_text') or '(empty)'}",
            ]
        lines += ["", "---", ""]
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text("\n".join(lines), encoding="utf-8")


# --- stage 2: LLM judge ------------------------------------------------------

# Reproduced verbatim from the reference (eval_mldr.py:970-975) — judge
# comparability requires identical prompts.
SYSTEM_PROMPT = (
    "You are an impartial verifier who checks whether a passage answers a question. "
    "Evaluate based on the actual content in <text>, considering <title> as supplementary context.\n"
    'Return strict JSON: {"has_answer": 0 or 1, "answer_score": float between 0 and 1, "reasoning": "brief English explanation (≤3 sentences)"}'
)

_JUDGE_INSTRUCTION = """
Determine whether the passage provides sufficient information to answer the question.

Evaluation criteria:
- has_answer=1: The passage explicitly contains facts/statements that directly answer the question OR strongly support a correct answer through clear logical inference.
- has_answer=0: The answer is missing, contradicted, requires external knowledge, or the question is malformed/empty.
- answer_score: A float between 0 and 1 indicating the likelihood/strength that the passage contains the answer (1.0 = definitely contains answer, 0.8 = probably contains answer, 0.5 = ambiguous, 0.2 = probably lacks answer, 0.0 = definitely lacks answer).
- For "why/how" questions: accept answers that explain mechanisms or reasons, even if not exhaustive.
- For factual questions: require explicit mention of the key entity/fact.
- For lengthy passages: scan systematically through the entire text for relevant information before concluding.
- For short passages: be precise about what is explicitly stated.

Examples:
1. Q: "Where were the 2020 Olympics held?" | Text: "The 2020 Summer Olympics took place in Tokyo, Japan."
   ⇒ {"has_answer": 1, "answer_score": 1.0, "reasoning": "Tokyo, Japan is explicitly stated as the location."}

2. Q: "Which temple is the most famous in Kyoto?" | Text: "Kyoto has a humid climate with four distinct seasons."
   ⇒ {"has_answer": 0, "answer_score": 0.0, "reasoning": "The passage discusses climate only; no temple is mentioned."}

3. Q: "asdfkj lkjwer?" | Text: "Paris is the capital of France."
   ⇒ {"has_answer": 0, "answer_score": 0.0, "reasoning": "The question is incoherent gibberish."}

4. Q: "Why did the company's revenue decline?" | Text: "The company faced supply chain disruptions and decreased consumer demand in Q3."
   ⇒ {"has_answer": 1, "answer_score": 0.95, "reasoning": "The passage identifies two clear causes for the decline."}

5. Q: "What is the population of Tokyo?" | Text: "Tokyo is a major metropolitan area. It has significant economic importance."
   ⇒ {"has_answer": 0, "answer_score": 0.05, "reasoning": "Population figure is not provided, only general characteristics."}

6. Q: "Does the report mention climate change?" | Text: "The environmental section discusses rising temperatures and changing weather patterns over the past decade."
   ⇒ {"has_answer": 1, "answer_score": 0.8, "reasoning": "While 'climate change' is not explicitly stated, rising temperatures and changing weather patterns strongly imply it."}
""".strip()


def build_user_prompt(question: str, pruned_text: str, title: str | None) -> str:
    """(reference eval_mldr.py:977-1020)"""
    question_block = question.strip() or "(empty question)"
    text_block = pruned_text.strip() or "(empty text)"
    title_block = (title or "").strip() or "(none)"
    return "\n".join(
        [
            f"<instruction>{_JUDGE_INSTRUCTION}</instruction>",
            f"<question>{question_block}</question>",
            f"<title>{title_block}</title>",
            f"<text>{text_block}</text>",
        ]
    )


def parse_judge_payload(content: str) -> dict[str, Any]:
    """Parse + validate the judge's JSON (reference :1052-1079, incl. the
    reason/contains_answer aliases)."""
    parsed = json.loads(content)
    if not isinstance(parsed, dict):
        raise ValueError(f"Judge payload is not an object: {content!r}")
    if "reason" in parsed and "reasoning" not in parsed:
        parsed["reasoning"] = parsed.pop("reason")
    if "has_answer" not in parsed and "contains_answer" in parsed:
        parsed["has_answer"] = parsed.pop("contains_answer")
    has_answer = parsed.get("has_answer")
    if has_answer not in (0, 1):
        raise ValueError(f"Invalid has_answer in payload: {parsed}")
    answer_score = parsed.get("answer_score")
    if answer_score is not None:
        answer_score = float(answer_score)
        if not (0.0 <= answer_score <= 1.0):
            raise ValueError(f"answer_score out of range: {parsed}")
    reasoning = parsed.get("reasoning")
    if not isinstance(reasoning, str) or len(reasoning) > 16000:
        raise ValueError(f"Invalid reasoning in payload: {parsed}")
    return {
        "has_answer": int(has_answer),
        "answer_score": answer_score,
        "reasoning": reasoning,
    }


@dataclass
class JudgeConfig:
    model: str = "gpt-5-nano"
    reasoning_effort: str | None = "minimal"
    temperature: float = 0.0
    max_completion_tokens: int = 20000
    retries: int = 3
    retry_delay: float = 2.0
    concurrency: int = 8
    request_timeout: float = 120.0
    base_url: str | None = None  # defaults to OPENAI_BASE_URL / api.openai.com


async def call_openai_judge(prompt: str, config: JudgeConfig) -> dict[str, Any]:
    """Native chat-completions call (OpenAI-compatible endpoint) with JSON
    mode + the reference's gpt-5 token/temperature quirks (:1023-1049)."""
    import httpx

    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        raise OSError("OPENAI_API_KEY is not set. Please export it before running evaluation.")
    base_url = (
        config.base_url
        or os.environ.get("OPENAI_BASE_URL")
        or "https://api.openai.com/v1"
    ).rstrip("/")

    is_gpt5 = "gpt-5" in config.model.lower()
    body: dict[str, Any] = {
        "model": config.model,
        "messages": [
            {"role": "system", "content": SYSTEM_PROMPT},
            {"role": "user", "content": prompt},
        ],
        "temperature": 1.0 if is_gpt5 else config.temperature,
        "response_format": {"type": "json_object"},
    }
    token_budget = config.max_completion_tokens
    if config.reasoning_effort:
        token_budget = max(token_budget, 20000)
        body["reasoning_effort"] = config.reasoning_effort
    if is_gpt5:
        body["max_completion_tokens"] = token_budget
    else:
        body["max_tokens"] = token_budget

    async with httpx.AsyncClient(timeout=config.request_timeout) as client:
        response = await client.post(
            f"{base_url}/chat/completions",
            headers={"Authorization": f"Bearer {api_key}"},
            json=body,
        )
        response.raise_for_status()
        payload = response.json()
    content = payload["choices"][0]["message"]["content"]
    if content is None:
        raise ValueError("LLM returned empty content.")
    return parse_judge_payload(content)


async def evaluate_example(
    record: dict[str, Any],
    config: JudgeConfig,
    judge_fn: Callable[..., Any],
) -> dict[str, Any]:
    """Retry/backoff/hard-timeout wrapper returning an error record instead
    of raising (reference :1082-1131)."""
    attempts = 0
    start = perf_counter()
    hard_timeout = max(1.0, config.request_timeout or 0.0) + 5.0
    prompt = build_user_prompt(
        str(record.get("query", "")),
        str(record.get("pruned_text") or ""),
        record.get("title"),
    )
    while attempts <= config.retries:
        try:
            payload = await asyncio.wait_for(judge_fn(prompt, config), timeout=hard_timeout)
            return {
                "has_answer": payload["has_answer"],
                "answer_score": payload.get("answer_score"),
                "reasoning": payload.get("reasoning"),
                "attempts": attempts + 1,
                "error": None,
                "latency": perf_counter() - start,
            }
        except Exception as exc:
            attempts += 1
            if attempts > config.retries:
                return {
                    "has_answer": None,
                    "answer_score": None,
                    "reasoning": None,
                    "attempts": attempts,
                    "error": str(exc) or type(exc).__name__,
                    "latency": perf_counter() - start,
                }
            await asyncio.sleep(config.retry_delay)
    raise RuntimeError("Exceeded maximum retries without producing a result.")


async def evaluate_batch(
    records: list[dict[str, Any]],
    config: JudgeConfig,
    judge_fn: Callable[..., Any] | None = None,
) -> list[dict[str, Any]]:
    judge_fn = judge_fn or call_openai_judge
    semaphore = asyncio.Semaphore(max(1, config.concurrency))

    async def _run(record: dict[str, Any]) -> dict[str, Any]:
        async with semaphore:
            return await evaluate_example(record, config, judge_fn)

    return await asyncio.gather(*(_run(r) for r in records))


# The reference's ignore-list YAML keys languages "en"/"jp" (its --lang CLI
# choices, reference scripts/eval_mldr.py:1459-1463) while the MLDR dataset
# itself uses "ja". Our CLI takes a single MLDR-style --lang, so accept both
# spellings when looking up the Japanese section.
_IGNORE_LANG_ALIASES = {"ja": "jp", "jp": "ja"}


def load_ignore_list(path: Path, lang: str) -> dict[str, str]:
    """qid → reason mapping per language (reference :835-846)."""
    import yaml

    data = yaml.safe_load(path.read_text(encoding="utf-8")) or {}
    entries = (
        data.get(lang) or data.get(_IGNORE_LANG_ALIASES.get(lang, "")) or []
    )
    mapping: dict[str, str] = {}
    for entry in entries:
        qid = entry.get("qid")
        if qid is None:
            continue
        mapping[str(qid)] = str(entry.get("reason", "")).strip()
    return mapping


def filter_records_for_judging(
    records: list[dict[str, Any]],
    *,
    ignore_map: dict[str, str],
    include_negatives: bool = False,
    max_text_chars: int = 60000,
) -> tuple[list[dict[str, Any]], list[dict[str, str]]]:
    """Ignore-list filter + positives-only + 60k-char clamp
    (reference :1200-1223)."""
    filtered: list[dict[str, Any]] = []
    skipped: list[dict[str, str]] = []
    max_chars = max(0, max_text_chars)
    for record in records:
        qid = str(record["query_id"])
        if qid in ignore_map:
            skipped.append({"query_id": qid, "reason": ignore_map[qid]})
            continue
        if not include_negatives and record.get("label") != 1:
            continue
        truncated = dict(record)
        text_value = str(truncated.get("pruned_text") or "")
        if max_chars > 0 and len(text_value) > max_chars:
            text_value = text_value[:max_chars]
        truncated["pruned_text"] = text_value
        filtered.append(truncated)
    return filtered, skipped


def judge_records(
    records: list[dict[str, Any]],
    config: JudgeConfig,
    *,
    judge_fn: Callable[..., Any] | None = None,
) -> tuple[list[dict[str, Any]], dict[str, Any]]:
    """Run the judge over filtered records; return enriched records +
    summary (reference :1255-1362)."""
    start = perf_counter()
    results = asyncio.run(evaluate_batch(records, config, judge_fn))

    enriched_records = []
    counters: Counter = Counter()
    failures = 0
    answer_scores: list[float] = []
    for record, result in zip(records, results):
        enriched = dict(record)
        enriched["llm_attempts"] = result["attempts"]
        enriched["llm_latency"] = result["latency"]
        enriched["llm_error"] = result["error"]
        enriched["llm_answer_score"] = result["answer_score"]
        if result["answer_score"] is not None:
            answer_scores.append(result["answer_score"])
        if result["has_answer"] is None:
            failures += 1
            enriched["llm_has_answer"] = None
            enriched["llm_reasoning"] = result["error"] or ""
        else:
            enriched["llm_has_answer"] = result["has_answer"]
            enriched["llm_reasoning"] = result["reasoning"]
            counters[result["has_answer"]] += 1
        enriched_records.append(enriched)

    summary = {
        "llm_model": config.model,
        "reasoning_effort": config.reasoning_effort,
        "records_evaluated": len(enriched_records),
        "counts": {
            "has_answer_1": counters.get(1, 0),
            "has_answer_0": counters.get(0, 0),
            "failed": failures,
        },
        "answer_score_stats": (
            {
                "mean": fmean(answer_scores),
                "median": median(answer_scores),
                "min": min(answer_scores),
                "max": max(answer_scores),
            }
            if answer_scores
            else None
        ),
        "evaluation_time_seconds": perf_counter() - start,
    }
    return enriched_records, summary


def write_eval_summary_md(summary: dict[str, Any], path: Path, *, extra: dict[str, Any]) -> None:
    lines = [
        "# LLM Evaluation Summary",
        "",
        *[f"- {k}: {v}" for k, v in extra.items()],
        f"- LLM model: {summary['llm_model']}",
        f"- Reasoning effort: {summary['reasoning_effort']}",
        f"- Records evaluated: {summary['records_evaluated']}",
        f"- Has answer (1): {summary['counts']['has_answer_1']}",
        f"- Has answer (0): {summary['counts']['has_answer_0']}",
        f"- Failed: {summary['counts']['failed']}",
        f"- LLM eval time (s): {summary['evaluation_time_seconds']:.2f}",
    ]
    score_stats = summary.get("answer_score_stats")
    if score_stats:
        lines += [
            "",
            "## Answer Score Statistics",
            f"- mean: {score_stats['mean']:.4f}",
            f"- median: {score_stats['median']:.4f}",
            f"- min: {score_stats['min']:.4f}",
            f"- max: {score_stats['max']:.4f}",
        ]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
