#!/usr/bin/env python3
"""MLDR processing and LLM evaluation with the PyTorch/CUDA port: a thin
wrapper over ``open_provence_tpu_torch.eval.mldr_cli`` (the counterpart of
scripts/eval_mldr.py, with one more flag, ``--device``; ``--device cpu``
runs on the CPU).

Usage:
  python scripts/eval_mldr_torch.py --model <checkpoint> --output-dir <dir> \\
      [--dataset <dir>] [--threshold 0.1] [--no-eval] [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def main(argv=None) -> int:
    from open_provence_tpu_torch.eval.mldr_cli import main as mldr_main

    return mldr_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
