#!/usr/bin/env python3
"""Generate the MLDR ignore list with the PyTorch/CUDA port: a thin wrapper
over ``open_provence_tpu_torch.eval.mldr_ignore`` (the counterpart of
generate_ignore_qid.py, with the port's ``JudgeConfig``; needs the network
and OPENAI_API_KEY).

Usage:
  python scripts/eval_mldr/generate_ignore_qid_torch.py --lang en [--limit 200]
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def main(argv=None) -> int:
    from open_provence_tpu_torch.eval.mldr_ignore import main as ignore_main

    return ignore_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
