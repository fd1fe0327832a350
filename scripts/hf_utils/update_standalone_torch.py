#!/usr/bin/env python3
"""Refresh the PyTorch/CUDA port's standalone inference bundle inside
checkpoint directories or published HF model repos (the counterpart of
scripts/hf_utils/update_standalone.py). A local directory works offline;
a hub repo id needs network, ``huggingface_hub`` and HF_TOKEN, and uploads
the bundle alone.

Usage:
  python scripts/hf_utils/update_standalone_torch.py <checkpoint dir | repo id> ...
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

DEFAULT_MODELS = [
    "open-provence-tpu-reranker-xsmall-v1",
    "open-provence-tpu-reranker-v1",
    "open-provence-tpu-reranker-large-v1",
    "open-provence-tpu-reranker-v1-gte-modernbert-base",
]


def update_local(checkpoint_dir: Path) -> None:
    from open_provence_tpu_torch.utils.modeling_export import write_standalone_bundle

    shim = write_standalone_bundle(checkpoint_dir)
    print(f"refreshed bundle: {shim}")


def update_hub(repo_id: str, commit_message: str) -> None:
    from huggingface_hub import HfApi

    from open_provence_tpu_torch.utils.modeling_export import write_standalone_bundle

    api = HfApi()
    with tempfile.TemporaryDirectory() as tmp:
        tmp_path = Path(tmp)
        write_standalone_bundle(tmp_path)
        api.upload_folder(
            repo_id=repo_id,
            folder_path=str(tmp_path),
            commit_message=commit_message,
        )
    print(f"pushed bundle to {repo_id}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("targets", nargs="*", default=None,
                        help="Local checkpoint dirs or hub repo ids.")
    parser.add_argument("--commit-message",
                        default="Refresh standalone inference bundle (PyTorch/CUDA)")
    args = parser.parse_args(argv)

    for target in args.targets or DEFAULT_MODELS:
        path = Path(target)
        if path.exists():
            update_local(path)
        else:
            update_hub(target, args.commit_message)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
