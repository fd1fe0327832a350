#!/usr/bin/env python3
"""Limit duplicate texts per dataset via MD5 fingerprints (the "freqN" subsets)
with the PyTorch/CUDA port: a thin wrapper over
``open_provence_tpu_torch.datasets_factory.cli frequency_filter`` (the counterpart of
frequency_filter_ds.py).

Usage:
  python scripts/context_relevance_datasets/frequency_filter_ds_torch.py --dataset <dir> \\
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

    return factory_main(["frequency_filter", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
