#!/usr/bin/env python3
"""Convert sentence-transformer-style triplet datasets to OpenProvence format
with the PyTorch/CUDA port: a thin wrapper over
``open_provence_tpu_torch.datasets_factory.cli generate`` (the counterpart of
generate_ds_from_sentence_transformer.py).

Usage:
  python scripts/context_relevance_datasets/generate_ds_from_sentence_transformer_torch.py --dataset <dir> \\
      --output-dir <dir> [...]
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def main(argv=None) -> int:
    from open_provence_tpu_torch.datasets_factory.cli import main as factory_main

    return factory_main(["generate", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
