#!/usr/bin/env python3
"""Release smoke test with the PyTorch/CUDA port: run process() through the
five input-shape contract cases (str, list, aligned, nested, titles) of
scripts/hf_utils/hf_model_process_check.py::build_cases against a
checkpoint directory.

Usage:
  python scripts/hf_utils/hf_model_process_check_torch.py --model <dir>
      [--tokenizer <dir>] [--threshold 0.1] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO_ROOT = HERE.parent.parent
for path in (REPO_ROOT, HERE):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from hf_model_process_check import build_cases  # noqa: E402  (imports no model code)


def main(argv=None, *, tokenizer=None) -> int:
    """``tokenizer`` (an object) takes the place of ``--tokenizer`` and of
    the checkpoint's own tokenizer files."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True, help="Checkpoint directory.")
    parser.add_argument("--tokenizer", help="Tokenizer path override.")
    parser.add_argument("--threshold", type=float, default=0.1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card; 'cpu' for the CPU).")
    args = parser.parse_args(argv)

    from open_provence_tpu_torch.inference import OpenProvenceModel

    if tokenizer is None and args.tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    model = OpenProvenceModel.from_pretrained(args.model, tokenizer=tokenizer, device=args.device)

    cases = build_cases()
    failures = 0
    for case in cases:
        kwargs = dict(case.get("kwargs") or {})
        try:
            result = model.process(
                case["question"],
                case["context"],
                threshold=args.threshold,
                show_progress=False,
                **kwargs,
            )
            if "pruned_context" not in result or "reranking_score" not in result:
                raise KeyError("the payload lacks pruned_context or reranking_score")
            print(f"✓ {case['name']}")
        except Exception as exc:  # report every case, then the count
            failures += 1
            print(f"✗ {case['name']}: {exc!r}")
    print(f"{len(cases) - failures}/{len(cases)} cases passed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
