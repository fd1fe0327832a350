#!/usr/bin/env python3
"""Add ``teacher_scores.<model>`` columns by scoring every (query, text) pair
with the PyTorch/CUDA port: a thin wrapper over
``open_provence_tpu_torch.datasets_factory.cli add_reranker_teacher_scores`` (the counterpart of
add_reranker_teacher_scores.py, with one more flag, ``--device``).

Usage:
  python scripts/context_relevance_datasets/add_reranker_teacher_scores_torch.py --dataset <dir> \\
      --output-dir <dir> [...] [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def main(argv=None) -> int:
    from open_provence_tpu_torch.datasets_factory.cli import main as factory_main

    return factory_main(["add_reranker_teacher_scores", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
