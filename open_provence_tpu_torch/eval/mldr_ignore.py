"""``python -m open_provence_tpu_torch.eval.mldr_ignore``: generate the MLDR
ignore list with the port (the body of
``scripts/eval_mldr/generate_ignore_qid_torch.py``).

The counterpart of the JAX package's ``scripts/eval_mldr/generate_ignore_qid.py``,
with its flags and prompt, its ``JudgeConfig`` taken from the port's
``eval/mldr_eval.py``, and one more flag, ``--dataset`` (default the hub's
``Shitao/MLDR``; a local directory is read as ``eval.mldr_cli`` reads it).
An LLM flags malformed or unusable queries and the list is written to a
YAML file per language. Two sources of ignores:

* automatic: positive passages longer than ``--max-chars`` (the 60k-char
  clamp of the judge stage);
* LLM-flagged: malformed, incoherent or empty questions, judged through the
  OpenAI-compatible endpoint of the judge stage (``OPENAI_API_KEY``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
from pathlib import Path

from .mldr_cli import IGNORES_PATH_DEFAULT

_EXAMPLES = """
Example 1:
Question: "京都の有名な寺院は？"
Positive passages:
1. "京都には清水寺や金閣寺などの歴史的な寺院があり..."
Assistant: {"ignore": 0, "reason": "question is well-formed and positives contain the expected information"}

Example 2:
Question: "Who wrote 'Frankenstein'?"
Positive passages:
1. "This paragraph discusses the population of Berlin."
Assistant: {"ignore": 0, "reason": "question is well-formed even if the passage is unrelated"}

Example 3:
Question: "What is the best strategy to solve this [EMPTY]?"
Positive passages:
(none)
Assistant: {"ignore": 1, "reason": "question is malformed/empty"}
""".strip()


def build_prompt(question: str, positives: list[str]) -> str:
    positives_text = "\n".join(f"{i + 1}. {t}" for i, t in enumerate(positives)) or "(none)"
    return (
        "You are an evaluator that flags only malformed MLDR questions. "
        "Return JSON with fields 'ignore' (0 or 1) and 'reason'. "
        "Set ignore=1 only when the question itself is malformed, incoherent, "
        "empty, or clearly unusable. If the question is well-formed—even when "
        "the positives seem irrelevant—set ignore=0. "
        "Respond in English even if the question is in another language.\n\n"
        f"{_EXAMPLES}\n\n"
        f"Question: {question}\n"
        f"Positive passages:\n{positives_text}\n"
        "Assistant:"
    )


async def judge_question(question: str, positives: list[str], config) -> dict:
    """The judge stage's transport with this prompt."""
    import httpx

    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        raise OSError("OPENAI_API_KEY is not set.")
    base_url = (os.environ.get("OPENAI_BASE_URL") or "https://api.openai.com/v1").rstrip("/")
    body = {
        "model": config.model,
        "messages": [{"role": "user", "content": build_prompt(question, positives)}],
        "temperature": 1.0 if "gpt-5" in config.model.lower() else 0.0,
        "response_format": {"type": "json_object"},
    }
    async with httpx.AsyncClient(timeout=config.request_timeout) as client:
        response = await client.post(
            f"{base_url}/chat/completions",
            headers={"Authorization": f"Bearer {api_key}"},
            json=body,
        )
        response.raise_for_status()
        content = response.json()["choices"][0]["message"]["content"]
    parsed = json.loads(content)
    if parsed.get("ignore") not in (0, 1):
        raise ValueError(f"Invalid payload: {parsed}")
    return parsed


async def run(args: argparse.Namespace) -> list[dict]:
    from .mldr_cli import _load_mldr_split
    from .mldr_eval import JudgeConfig

    dataset, _ = _load_mldr_split(args)
    config = JudgeConfig(model=args.llm_model, request_timeout=args.request_timeout)
    semaphore = asyncio.Semaphore(args.concurrency)
    entries: list[dict] = []

    async def handle(row) -> None:
        qid = str(row["query_id"])
        question = str(row["query"])
        positives = [p["text"] for p in (row.get("positive_passages") or [])]
        oversize = [p for p in positives if len(p) > args.max_chars]
        if oversize:
            entries.append(
                {
                    "qid": qid,
                    "question": question,
                    "reason": (
                        f"Positive passage length exceeds limit "
                        f"({len(oversize[0])} characters > {args.max_chars}). "
                        "Automatically flagged."
                    ),
                }
            )
            return
        async with semaphore:
            try:
                verdict = await judge_question(question, positives[:3], config)
            except Exception as exc:
                print(f"[warn] qid={qid}: judge failed: {exc}", file=sys.stderr)
                return
        if verdict.get("ignore") == 1:
            entries.append(
                {"qid": qid, "question": question, "reason": str(verdict.get("reason", ""))}
            )

    await asyncio.gather(*(handle(row) for row in dataset))
    return entries


def main(argv: list[str] | None = None) -> int:
    import yaml

    parser = argparse.ArgumentParser()
    parser.add_argument("--lang", default="en")
    parser.add_argument("--split", default="test")
    parser.add_argument("--limit", type=int, default=200)
    parser.add_argument("--max-chars", type=int, default=60000)
    parser.add_argument("--llm-model", default="gpt-5-nano")
    parser.add_argument("--concurrency", type=int, default=8)
    parser.add_argument("--request-timeout", type=float, default=120.0)
    parser.add_argument("--dataset", default="Shitao/MLDR",
                        help="Hub ID, local save_to_disk path or directory of <split>.jsonl "
                        "files of the MLDR-format dataset.")
    parser.add_argument("--output", type=Path, default=IGNORES_PATH_DEFAULT)
    args = parser.parse_args(argv)

    entries = asyncio.run(run(args))
    existing = {}
    if args.output.exists():
        existing = yaml.safe_load(args.output.read_text()) or {}
    existing[args.lang] = entries
    args.output.parent.mkdir(parents=True, exist_ok=True)
    args.output.write_text(yaml.safe_dump(existing, allow_unicode=True, sort_keys=False))
    print(f"Wrote {len(entries)} ignore entries for lang={args.lang} to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
