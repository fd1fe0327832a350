#!/usr/bin/env python3
"""Refresh the PyTorch/CUDA port's standalone bundle and strip deprecated
config keys in every OpenProvence checkpoint under output/** (the
counterpart of scripts/utils/sync_output_modeling.py).

Usage:
  python scripts/utils/sync_output_modeling_torch.py [--root output] [--no-bundle]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

# Deprecated config keys dropped on sync (reference sync_output_modeling.py:13-17).
DEPRECATED_CONFIG_KEYS = (
    "splitter_default_language",
    "standalone_process_default_language",
)


def sync_checkpoint(checkpoint_dir: Path, *, write_bundle: bool = True) -> bool:
    """Strip the deprecated keys and refresh the bundle of one OpenProvence
    checkpoint; False (and nothing written) for any other directory."""
    config_path = checkpoint_dir / "config.json"
    if not config_path.exists() or not (checkpoint_dir / "model.safetensors").exists():
        return False
    payload = json.loads(config_path.read_text())
    if payload.get("model_type") != "open_provence":
        return False
    stale = [key for key in DEPRECATED_CONFIG_KEYS if key in payload]
    if stale:
        for key in stale:
            payload.pop(key)
        config_path.write_text(json.dumps(payload, indent=2, ensure_ascii=False))
    if write_bundle:
        from open_provence_tpu_torch.utils.modeling_export import write_standalone_bundle

        write_standalone_bundle(checkpoint_dir)
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path, default=REPO_ROOT / "output")
    parser.add_argument("--no-bundle", action="store_true",
                        help="Only strip deprecated keys, skip bundle refresh.")
    args = parser.parse_args(argv)

    if not args.root.exists():
        print(f"No output directory at {args.root}")
        return 0
    synced = 0
    for config_path in sorted(args.root.rglob("config.json")):
        if sync_checkpoint(config_path.parent, write_bundle=not args.no_bundle):
            synced += 1
            print(f"synced {config_path.parent}")
    print(f"{synced} checkpoints synced")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
