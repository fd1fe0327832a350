#!/usr/bin/env python3
"""Evaluate OpenProvence checkpoints on context relevance datasets with the
PyTorch/CUDA port: a thin wrapper over ``open_provence_tpu_torch.eval.cli``
(the counterpart of scripts/eval_datasets.py, with one more flag,
``--device``; ``--device cpu`` runs on the CPU).

Usage:
  python scripts/eval_datasets_torch.py --config configs/eval_datasets/ja.yaml \\
      --model <checkpoint> [--th 0.05,0.1] [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def main(argv=None) -> int:
    from open_provence_tpu_torch.eval.cli import main as eval_main

    return eval_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
