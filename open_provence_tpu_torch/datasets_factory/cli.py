"""``python -m open_provence_tpu_torch.datasets_factory.cli <command> ...``:
the data factory's commands on the port.

One subcommand for each script of the JAX package's
``scripts/context_relevance_datasets/``, with its flags, and ``--device`` on
the two that load a teacher (default: the first CUDA card; ``cpu`` for the
plain PyTorch versions):

* ``generate`` — sentence-transformers triplets to the context-relevance
  format, with validation and test carved out of train when absent
  (``generate_ds_from_sentence_transformer.py``);
* ``frequency_filter`` — rows that repeat too many already-seen texts
  dropped from train, with ``frequency_filter_stats.json``
  (``frequency_filter_ds.py``);
* ``add_context_spans_relevance`` — a ``context_spans_relevance`` mask from
  an encoder checkpoint or an OpenAI-compatible LLM, resumable from a shard
  cache, rewritten through a ``.tmp`` directory
  (``add_context_spans_relevance.py``);
* ``add_reranker_teacher_scores`` — a ``teacher_scores.<name>`` column from
  an encoder checkpoint (``add_reranker_teacher_scores.py``);
* ``upload`` — push to the hub, with a size estimate and ``--dry-run``
  (``upload_context_relevance_to_hf.py``).

``--dataset`` is a local directory or a hub name. A directory of
``<split>.jsonl`` files is read and written without HF ``datasets``; a
``save_to_disk`` directory or a hub name imports it, and the output is then
a ``save_to_disk`` directory. ``main(argv, tokenizer=...)`` takes a
tokenizer object in place of the checkpoint's tokenizer files.
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
from pathlib import Path
from typing import Any

from ..train.data import RowTable, _import_datasets, open_splits, save_splits, to_hf


def _as_splits(source: dict[str | None, RowTable]) -> dict[str, RowTable]:
    """A lone ``save_to_disk`` ``Dataset`` becomes the split ``train``."""
    return {"train" if name is None else name: table for name, table in source.items()}


def _load_encoder(args: argparse.Namespace, tokenizer: Any):
    from ..encoder import OpenProvenceEncoder

    if tokenizer is None and args.tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    return OpenProvenceEncoder.from_pretrained(
        args.teacher_model, tokenizer=tokenizer, device=args.device
    )


def generate(args: argparse.Namespace, tokenizer: Any) -> int:
    from .converter import convert_dataset_dict, slugify_dataset_name

    source, jsonl = open_splits(args.dataset, args.subset)
    converted = convert_dataset_dict(
        _as_splits(source),
        language=args.lang,
        dataset_slug=slugify_dataset_name(args.dataset, args.subset),
        sample_size=args.sample_size,
        seed=args.seed,
    )
    save_splits(converted, args.output_dir, jsonl=jsonl)
    for name, ds in converted.items():
        print(f"{name}: {len(ds)} rows")
    return 0


def frequency_filter(args: argparse.Namespace, tokenizer: Any) -> int:
    from .frequency_filter import frequency_filter_train

    source, jsonl = open_splits(args.dataset)
    out = {}
    stats_payload = {}
    for name, ds in _as_splits(source).items():
        if args.debug_limit:
            ds = ds.select(range(min(args.debug_limit, len(ds))))
        if name == "train":
            filtered, stats, _ = frequency_filter_train(
                ds, args.threshold,
                id_column=args.id_column, texts_column=args.texts_column,
            )
            out[name] = filtered
            stats_payload[name] = stats.to_dict()
            print(f"{name}: kept {stats.rows_kept}/{stats.rows_total} rows "
                  f"(dup ratio {stats.texts_dup_ratio:.3f})")
        else:
            out[name] = ds

    args.output_dir.mkdir(parents=True, exist_ok=True)
    save_splits(out, args.output_dir, jsonl=jsonl)
    (args.output_dir / "frequency_filter_stats.json").write_text(
        json.dumps(stats_payload, indent=2)
    )
    return 0


def add_context_spans_relevance(args: argparse.Namespace, tokenizer: Any) -> int:
    from .labeling import (
        ShardCache,
        annotate_span_relevance,
        make_encoder_annotator,
        make_openai_annotator,
    )

    source, jsonl = open_splits(args.dataset)
    if args.annotator == "encoder":
        annotator = make_encoder_annotator(
            _load_encoder(args, tokenizer),
            token_threshold=args.token_threshold,
            chunk_threshold=args.chunk_threshold,
        )
    else:
        annotator = make_openai_annotator(args.teacher_model)

    cache = ShardCache(args.cache_dir) if args.cache_dir else None
    out = {}
    for name, ds in _as_splits(source).items():
        if args.split and name != args.split:
            out[name] = ds
            continue
        out[name] = annotate_span_relevance(ds, annotator, cache=cache)
        print(f"{name}: annotated {len(out[name])} rows")

    # Atomic dataset rewrite (reference :112-134): write to tmp, then swap.
    # A tmp directory an interrupted run left is cleared first, so that no
    # split file of it reaches the output.
    output_dir = args.output_dir
    tmp_dir = output_dir.with_name(output_dir.name + ".tmp")
    if tmp_dir.exists():
        shutil.rmtree(tmp_dir)
    save_splits(out, tmp_dir, jsonl=jsonl)
    if output_dir.exists():
        shutil.rmtree(output_dir)
    tmp_dir.rename(output_dir)
    return 0


def add_reranker_teacher_scores(args: argparse.Namespace, tokenizer: Any) -> int:
    from .labeling import add_teacher_scores

    source, jsonl = open_splits(args.dataset)
    encoder = _load_encoder(args, tokenizer)
    teacher_name = args.teacher_name or Path(args.teacher_model).name

    out = {}
    for name, ds in _as_splits(source).items():
        out[name] = add_teacher_scores(
            ds,
            lambda pairs: encoder.predict(pairs, batch_size=args.batch_size),
            teacher_name=teacher_name,
            batch_size=args.batch_size,
        )
        print(f"{name}: scored {len(out[name])} rows → teacher_scores.{teacher_name}")
    save_splits(out, args.output_dir, jsonl=jsonl)
    return 0


def estimate_size_bytes(dataset_dict: dict[str, Any]) -> int:
    """Bytes to upload: an HF dataset's ``info.size_in_bytes`` where it has
    one, else the text of its first 100 rows scaled to its length."""
    total = 0
    for ds in dataset_dict.values():
        info_size = getattr(ds, "info", None)
        if info_size is not None and getattr(info_size, "size_in_bytes", None):
            total += int(info_size.size_in_bytes)
        else:
            total += sum(
                len(str(row).encode("utf-8")) for row in ds.select(range(min(len(ds), 100)))
            ) * max(1, len(ds) // max(1, min(len(ds), 100)))
    return total


def upload(args: argparse.Namespace, tokenizer: Any) -> int:
    source = _as_splits(open_splits(args.dataset)[0])
    size = estimate_size_bytes(source)
    print(f"Estimated upload size: {size / 1e6:.1f} MB "
          f"({', '.join(f'{k}={len(v)}' for k, v in source.items())})")
    if args.dry_run:
        print("[dry-run] Skipping push_to_hub.")
        return 0

    datasets = _import_datasets("push_to_hub")
    kwargs = {"private": args.private}
    if args.subset:
        kwargs["config_name"] = args.subset
    datasets.DatasetDict({k: to_hf(v) for k, v in source.items()}).push_to_hub(
        args.repo_id, **kwargs)
    print(f"Pushed to https://huggingface.co/datasets/{args.repo_id}")
    return 0


COMMANDS = {
    "generate": generate,
    "frequency_filter": frequency_filter,
    "add_context_spans_relevance": add_context_spans_relevance,
    "add_reranker_teacher_scores": add_reranker_teacher_scores,
    "upload": upload,
}


def _device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card; 'cpu' for the CPU).")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Build context-relevance training data (PyTorch/CUDA port).")
    commands = parser.add_subparsers(dest="command", required=True)

    p = commands.add_parser("generate", help="Convert sentence-transformer triplets.")
    p.add_argument("--dataset", required=True,
                   help="Hub ID, local save_to_disk path or directory of <split>.jsonl files.")
    p.add_argument("--subset", default=None)
    p.add_argument("--lang", default="en")
    p.add_argument("--sample-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output-dir", type=Path, required=True)

    p = commands.add_parser("frequency_filter", help="Limit duplicate texts (freqN subsets).")
    p.add_argument("--dataset", required=True)
    p.add_argument("--threshold", type=int, default=2,
                   help="Max already-seen duplicate texts per kept row.")
    p.add_argument("--id-column", default="id")
    p.add_argument("--texts-column", default="texts")
    p.add_argument("--debug-limit", type=int, default=None)
    p.add_argument("--output-dir", type=Path, required=True)

    p = commands.add_parser("add_context_spans_relevance",
                            help="Annotate relevant spans with a teacher.")
    p.add_argument("--dataset", required=True,
                   help="Local save_to_disk path, directory of <split>.jsonl files or Hub ID.")
    p.add_argument("--split", default=None, help="Annotate one split (default: all).")
    p.add_argument("--annotator", choices=["encoder", "openai"], default="encoder")
    p.add_argument("--teacher-model", required=True)
    p.add_argument("--tokenizer", help="Tokenizer path override for encoder annotator.")
    p.add_argument("--token-threshold", type=float, default=0.5)
    p.add_argument("--chunk-threshold", type=float, default=0.5)
    p.add_argument("--cache-dir", type=Path, default=None)
    p.add_argument("--output-dir", type=Path, required=True)
    _device_flag(p)

    p = commands.add_parser("add_reranker_teacher_scores",
                            help="Score every (query, text) pair with a teacher.")
    p.add_argument("--dataset", required=True)
    p.add_argument("--teacher-model", required=True, help="Checkpoint directory.")
    p.add_argument("--teacher-name", default=None,
                   help="Column suffix (default: checkpoint dir name).")
    p.add_argument("--tokenizer", help="Tokenizer path override.")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--output-dir", type=Path, required=True)
    _device_flag(p)

    p = commands.add_parser("upload", help="Push a dataset to the Hugging Face Hub.")
    p.add_argument("--dataset", required=True,
                   help="Local save_to_disk directory or directory of <split>.jsonl files.")
    p.add_argument("--repo-id", required=True, help="Target hub repo, e.g. user/name.")
    p.add_argument("--subset", default=None, help="Config name on the hub.")
    p.add_argument("--private", action="store_true")
    p.add_argument("--dry-run", action="store_true")
    return parser


def main(argv: list[str] | None = None, *, tokenizer: Any = None) -> int:
    """Run one command. ``tokenizer`` (an object) takes the place of
    ``--tokenizer`` and of the teacher checkpoint's tokenizer files."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    return COMMANDS[args.command](args, tokenizer)


if __name__ == "__main__":
    raise SystemExit(main())
