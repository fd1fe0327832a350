"""``python -m open_provence_tpu_torch.eval.cli --config ... --model ...``:
evaluate a checkpoint on context-relevance datasets with the port.

The counterpart of the JAX package's ``scripts/eval_datasets.py``, with its
flags and one more, ``--device`` (default: the first CUDA card; ``cpu`` for
the plain PyTorch versions). It lives in the package so that an installed
package, and the trainer's ``eval_datasets`` hook, can reach it.
``--attention-impl`` must name one of the JAX engine's attention routes and
is then ignored, as everywhere in the port; ``--timing-details`` is
accepted, as the JAX CLI accepts it.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any

from ..inference.engine import ATTENTION_IMPLS


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Evaluate OpenProvence checkpoints on context relevance datasets "
        "(PyTorch/CUDA port).",
    )
    parser.add_argument("--config", required=True, help="YAML file describing datasets to load.")
    parser.add_argument("--model", required=True, help="Local checkpoint directory.")
    parser.add_argument("--threshold", type=float, default=0.1)
    parser.add_argument(
        "--thresholds", "--th", action="append", dest="threshold_list",
        help="Comma separated thresholds; repeatable (e.g. --th 0.05,0.1 --th 0.2).",
    )
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--split", help="Override split for every dataset in the config.")
    parser.add_argument("--limit", type=int, help="Evaluate only the first N examples.")
    parser.add_argument(
        "--target", action="append",
        help="Limit evaluation to 'dataset_name:subset' keys. Repeatable.",
    )
    parser.add_argument("--output-file", type=Path, help="Markdown report path.")
    parser.add_argument("--output-json", type=Path, help="JSON metrics path.")
    parser.add_argument("--tokenizer", help="Tokenizer path override (offline use).")
    parser.add_argument("--attention-impl", default="auto", choices=list(ATTENTION_IMPLS))
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card; 'cpu' for the CPU).")
    parser.add_argument("--no-progress", action="store_false", dest="show_progress")
    parser.add_argument("--silent", action="store_true")
    parser.add_argument("--timing-details", action="store_true")
    parser.set_defaults(show_progress=True)
    return parser.parse_args(argv)


def thresholds_of(args: argparse.Namespace) -> list[float]:
    """``--th`` entries split at commas, else ``--threshold``; de-duplicated
    in order."""
    thresholds: list[float] = []
    for entry in args.threshold_list or []:
        for chunk in str(entry).split(","):
            if chunk.strip():
                thresholds.append(float(chunk.strip()))
    if not thresholds:
        thresholds = [args.threshold]
    seen: set[float] = set()
    return [t for t in thresholds if not (t in seen or seen.add(t))]


def main(argv: list[str] | None = None, *, tokenizer: Any = None) -> int:
    """Run the evaluation. ``tokenizer`` (an object) takes the place of
    ``--tokenizer`` and of the checkpoint's own tokenizer files."""
    args = parse_args(argv)
    from ..inference import OpenProvenceModel
    from .datasets_eval import EvalConfig, run_evaluation

    thresholds = thresholds_of(args)
    if tokenizer is None and args.tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)

    model = OpenProvenceModel.from_pretrained(
        args.model, tokenizer=tokenizer, attention_impl=args.attention_impl, device=args.device
    )
    eval_config = EvalConfig.load(args.config)
    result = run_evaluation(
        model,
        eval_config,
        model_name=args.model,
        config_path=str(args.config),
        thresholds=thresholds,
        batch_size=args.batch_size,
        split_override=args.split,
        limit=args.limit,
        targets={t.strip() for t in (args.target or []) if t} or None,
        show_progress=args.show_progress and not args.silent,
        output_file=args.output_file,
        output_json=args.output_json,
    )
    if not args.output_file:
        print(result["markdown"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
