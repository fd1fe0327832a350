#!/usr/bin/env python3
"""Push a context-relevance dataset to the Hugging Face Hub (needs the network and HF_TOKEN)
with the PyTorch/CUDA port: a thin wrapper over
``open_provence_tpu_torch.datasets_factory.cli upload`` (the counterpart of
upload_context_relevance_to_hf.py).

Usage:
  python scripts/context_relevance_datasets/upload_context_relevance_to_hf_torch.py --dataset <dir> \\
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

    return factory_main(["upload", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
