#!/usr/bin/env python3
"""Convert/initialize checkpoints with the PyTorch/CUDA port (the
counterpart of scripts/convert_checkpoint.py).

* An OpenProvence checkpoint (merged ranking_model.* + pruning_head.*
  safetensors, or the legacy layouts ``utils/hf_convert.py`` reads) is
  validated and re-exported (refreshing config keys, attaching tokenizer
  files).
* A plain HF ModernBERT checkpoint (sequence-classification or bare
  backbone) becomes a two-head OpenProvence checkpoint with a fresh pruning
  head (``train/encoder_init.py``).

The weights stay in fp32 on the way through. ``--bundle`` also vendors the
port's standalone inference bundle (``utils/modeling_export.py``).

Usage:
  python scripts/convert_checkpoint_torch.py --input <dir> --output <dir>
      [--num-labels 1] [--max-length 512] [--tokenizer <dir>] [--bundle]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="Source checkpoint directory.")
    parser.add_argument("--output", required=True, help="Destination directory.")
    parser.add_argument("--num-labels", type=int, default=None)
    parser.add_argument("--max-length", type=int, default=512)
    parser.add_argument("--classifier-dropout", type=float, default=0.1)
    parser.add_argument("--tokenizer", help="Tokenizer dir override (offline).")
    parser.add_argument("--default-threshold", type=float, default=None,
                        help="Stored as the canonical 'default_threadshold' key.")
    parser.add_argument("--bundle", action="store_true",
                        help="Also vendor the standalone inference bundle.")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card; 'cpu' for the CPU).")
    args = parser.parse_args(argv)

    import torch

    from open_provence_tpu_torch.encoder import OpenProvenceEncoder

    tokenizer = None
    if args.tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    encoder = OpenProvenceEncoder(
        args.input,
        tokenizer=tokenizer,
        num_labels=args.num_labels,
        max_length=args.max_length,
        pruning_config={"classifier_dropout": args.classifier_dropout},
        device=args.device,
        dtype=torch.float32,
    )
    if args.default_threshold is not None:
        encoder.config.default_threadshold = float(args.default_threshold)
    out = encoder.save_pretrained(args.output)
    if args.bundle:
        from open_provence_tpu_torch.utils.modeling_export import write_standalone_bundle

        write_standalone_bundle(out)
    print(f"converted checkpoint written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
