"""``python -m open_provence_tpu_torch.eval.mldr_cli --model ... --output-dir ...``:
MLDR processing and LLM evaluation with the port.

The counterpart of the JAX package's ``scripts/eval_mldr.py``, with its flags
and one more, ``--device`` (default: the first CUDA card; ``cpu`` for the
plain PyTorch versions). Stage 1 (process) prunes the MLDR passages with the
port's ``OpenProvenceModel`` (or the naver-provence baseline) into
``<output-dir>/process{,_original}/``: the per-passage records,
``summary.json`` and ``result.md``. Stage 2 (eval) asks an LLM judge
whether each pruned positive still answers its query (an OpenAI-compatible
endpoint through ``OPENAI_API_KEY`` / ``OPENAI_BASE_URL``) into
``<output-dir>/eval_llm/``. A stage whose output exists is skipped unless
``--force-process`` / ``--force-eval``.

``--dataset`` is a local directory or a hub name. A directory of
``<split>.jsonl`` files is read without HF ``datasets``, and the records are
then written as JSON lines; a ``save_to_disk`` directory or a hub name
imports it, and the records are written with ``save_to_disk``.
``main(argv, tokenizer=...)`` takes a tokenizer object in place of the
checkpoint's tokenizer files.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from time import perf_counter
from typing import Any

from ..train.data import RowTable, _from_hf, _import_datasets, open_splits, save_splits

LOGGER = logging.getLogger("open_provence_tpu_torch.eval.mldr_cli")

IGNORES_PATH_DEFAULT = (
    Path(__file__).resolve().parents[2] / "scripts" / "eval_mldr" / "ignored_questions.yaml"
)
# The one split of a records directory written as JSON lines.
RECORDS_SPLIT = "records"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Process Shitao/MLDR samples and run LLM evaluation (PyTorch/CUDA port)."
    )
    parser.add_argument("--model", type=str, help="Local checkpoint path.")
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--limit", type=int, default=200)
    parser.add_argument("--threshold", type=float, default=0.1)
    parser.add_argument(
        "--text-source", choices=["pruned", "original"], default="pruned",
        help="Evaluate pruned passages (default) or the no-prune baseline.",
    )
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--split", default="test")
    parser.add_argument("--lang", default="en", help="MLDR language subset.")
    parser.add_argument("--max-length", type=int, default=None)
    parser.add_argument("--dataset", type=str, default="Shitao/MLDR",
                        help="Hub ID, local save_to_disk path or directory of <split>.jsonl "
                        "files of the MLDR-format dataset.")
    parser.add_argument("--tokenizer", help="Tokenizer path override (offline use).")
    parser.add_argument("--reranker-first-score", action="store_true",
                        help="Use the first block's reranker score instead of the max.")
    parser.add_argument("--no-progress", action="store_true")
    parser.add_argument("--force-process", action="store_true")
    parser.add_argument("--force-eval", action="store_true")
    parser.add_argument("--no-eval", action="store_true", help="Skip the LLM judge stage.")
    parser.add_argument("--include-negatives", action="store_true")
    parser.add_argument("--max-text-chars", type=int, default=60000)
    parser.add_argument("--ignore-file", type=Path, default=IGNORES_PATH_DEFAULT)
    parser.add_argument("--force-no-ignore", action="store_true")
    parser.add_argument("--llm-model", default="gpt-5-nano")
    parser.add_argument("--reasoning-effort", default="minimal")
    parser.add_argument("--concurrency", type=int, default=8)
    parser.add_argument("--retries", type=int, default=3)
    parser.add_argument("--retry-delay", type=float, default=2.0)
    parser.add_argument("--request-timeout", type=float, default=120.0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card; 'cpu' for the CPU).")
    return parser.parse_args(argv)


def _load_mldr_split(args: argparse.Namespace) -> tuple[RowTable, bool]:
    """The split's rows (the first ``--limit``) and whether they came from
    JSON lines."""
    local = Path(args.dataset).expanduser()
    if local.exists():
        source, jsonl = open_splits(args.dataset)
        dataset = source[None] if list(source) == [None] else source[args.split]
        if args.limit:
            dataset = dataset.select(range(min(len(dataset), args.limit)))
        return dataset, jsonl
    split_expr = args.split
    if args.limit and "[" not in split_expr:
        split_expr = f"{split_expr}[:{args.limit}]"
    datasets = _import_datasets(f"the hub dataset {args.dataset!r}")
    loaded = datasets.load_dataset(args.dataset, args.lang, split=split_expr,
                                   trust_remote_code=True)
    return _from_hf(loaded), False


def write_records(records: list[dict[str, Any]], path: Path, *, jsonl: bool) -> None:
    """``records`` as ``path/records.jsonl`` or, with ``jsonl`` False, as a
    ``save_to_disk`` ``Dataset``."""
    if jsonl:
        save_splits({RECORDS_SPLIT: RowTable.from_list(records)}, path, jsonl=True)
        return
    datasets = _import_datasets("writing a save_to_disk directory")
    datasets.Dataset.from_list(records).save_to_disk(str(path))


def read_records(path: Path) -> tuple[list[dict[str, Any]], bool]:
    """The records ``write_records`` wrote, and whether as JSON lines."""
    source, jsonl = open_splits(str(path))
    (table,) = source.values()
    return [dict(row) for row in table], jsonl


def _process_fn(args: argparse.Namespace, tokenizer: Any):
    from .external_baselines import is_naver_provence_model

    if is_naver_provence_model(args.model):
        # Published torch baseline (reference eval_mldr.py:75-125) for
        # apples-to-apples comparison rows; needs the network.
        from .external_baselines import load_naver_process_fn

        process_fn, _model = load_naver_process_fn(
            args.model,
            max_length=args.max_length,
            device=args.device,
            disable_progress=args.no_progress,
        )
        return process_fn
    from ..inference import OpenProvenceModel

    if tokenizer is None and args.tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    model_dir = Path(args.model)
    if (model_dir / "final_model").exists():
        model_dir = model_dir / "final_model"
    model = OpenProvenceModel.from_pretrained(
        model_dir, tokenizer=tokenizer, max_length=args.max_length, device=args.device
    )
    return model.process


def run_process(args: argparse.Namespace, tokenizer: Any = None) -> Path:
    from .mldr_eval import (
        build_original_records,
        build_records,
        process_summary,
        write_markdown_report,
    )

    suffix = "process_original" if args.text_source == "original" else "process"
    process_dir = args.output_dir / suffix
    dataset_path = process_dir / "dataset"
    if dataset_path.exists() and not args.force_process:
        LOGGER.info("Process dataset already exists at %s – skipping (use --force-process).",
                    dataset_path)
        return dataset_path
    process_dir.mkdir(parents=True, exist_ok=True)

    start = perf_counter()
    dataset, jsonl = _load_mldr_split(args)

    if args.text_source == "original":
        records, stats, num_queries = build_original_records(dataset)
    else:
        if not args.model:
            raise SystemExit("--model is required unless --text-source original")
        records, stats, num_queries = build_records(
            _process_fn(args, tokenizer),
            dataset,
            threshold=args.threshold,
            batch_size=args.batch_size,
            use_best_reranker_score=not args.reranker_first_score,
            show_progress=not args.no_progress,
        )

    write_records(records, dataset_path, jsonl=jsonl)
    elapsed = perf_counter() - start
    summary = process_summary(
        records, stats, num_queries,
        args_payload={
            "limit": args.limit,
            "threshold": args.threshold,
            "dataset_language": args.lang,
            "max_length": args.max_length,
            "model": args.model,
            "source_text": args.text_source,
        },
        elapsed=elapsed,
    )
    (process_dir / "summary.json").write_text(
        json.dumps(summary, ensure_ascii=False, indent=2)
    )
    write_markdown_report(records, process_dir / "result.md", threshold=args.threshold)
    LOGGER.info("[process] Saved %d records (%d queries) to %s in %.1fs",
                len(records), num_queries, dataset_path, elapsed)
    return dataset_path


def run_evaluation(args: argparse.Namespace, dataset_path: Path) -> None:
    from .mldr_eval import (
        JudgeConfig,
        filter_records_for_judging,
        judge_records,
        load_ignore_list,
        write_eval_summary_md,
    )

    eval_dir = args.output_dir / "eval_llm"
    dataset_out = eval_dir / "dataset"
    if dataset_out.exists() and not args.force_eval:
        LOGGER.info("LLM evaluation artifacts already exist at %s – skipping.", eval_dir)
        return

    records, jsonl = read_records(dataset_path)

    if not args.ignore_file.exists():
        if args.force_no_ignore:
            LOGGER.warning("Ignore list %s not found; proceeding without it.", args.ignore_file)
            ignore_map: dict[str, str] = {}
        else:
            raise FileNotFoundError(
                f"Ignore list file '{args.ignore_file}' not found. Create it or "
                "rerun with --force-no-ignore."
            )
    else:
        ignore_map = load_ignore_list(args.ignore_file, args.lang)

    filtered, skipped = filter_records_for_judging(
        records,
        ignore_map=ignore_map,
        include_negatives=args.include_negatives,
        max_text_chars=args.max_text_chars,
    )
    if not filtered:
        LOGGER.warning("No records eligible for evaluation after filtering. Exiting.")
        return

    config = JudgeConfig(
        model=args.llm_model,
        reasoning_effort=args.reasoning_effort,
        concurrency=max(1, args.concurrency),
        retries=max(0, args.retries),
        retry_delay=max(0.0, args.retry_delay),
        request_timeout=max(1.0, args.request_timeout),
    )
    enriched, summary = judge_records(filtered, config)
    summary = {
        "input_dataset": str(dataset_path),
        "language": args.lang,
        "ignored_count": len(skipped),
        **summary,
    }
    eval_dir.mkdir(parents=True, exist_ok=True)
    write_records(enriched, dataset_out, jsonl=jsonl)
    (eval_dir / "summary.json").write_text(json.dumps(summary, ensure_ascii=False, indent=2))
    write_eval_summary_md(
        summary,
        eval_dir / "summary.md",
        extra={"Dataset": dataset_path, "Language": args.lang,
               "Ignored queries": len(skipped)},
    )
    print(json.dumps(summary, ensure_ascii=False, indent=2))


def main(argv: list[str] | None = None, *, tokenizer: Any = None) -> int:
    """Run both stages. ``tokenizer`` (an object) takes the place of
    ``--tokenizer`` and of the checkpoint's own tokenizer files."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    dataset_path = run_process(args, tokenizer)
    if not args.no_eval:
        run_evaluation(args, dataset_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
