"""Host-side dataset preparation for the training pipeline.

Counterpart of the JAX package's ``train/data.py`` (itself the reference's
data path, open_provence/trainer.py:591-1237), with the same public names
and bit-compatible sampling: the same rows, in the same order, with the
same values, from the same sources and arguments. Zero-relevance row
filtering, positives-first item capping with a ``seed + row_idx`` rng,
upsampling, multi-source concatenation on shared columns, and validation
carving.

HF ``datasets`` is not needed to prepare data. Rows live in a
:class:`RowTable` (a list of row dicts and their column names) with the few
operations the pipeline uses, including HF's two permutations
(``Dataset.shuffle`` and ``Dataset.train_test_split``, both
``np.random.default_rng(seed).permutation(n)``). Sources:

* a local directory of ``<split>.jsonl`` files (one JSON object a row), read
  with ``json``;
* a local ``save_to_disk`` directory (``dataset_dict.json``), read with
  ``datasets.load_from_disk``;
* a hub name, read with ``datasets.load_dataset``.

The last two import ``datasets`` when they are used and raise
``ImportError`` where it is missing. ``open_splits`` and ``save_splits``
read and write whole datasets for the commands of the data factory and the
MLDR evaluation, in the form they were read.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "RowTable",
    "batch_iterator",
    "concatenate_tables",
    "filter_pruning_dataset",
    "open_splits",
    "prepare_dataset",
    "sample_items_by_label_priority",
    "save_splits",
    "to_hf",
    "upsample_dataset",
    "write_jsonl_splits",
]


# --------------------------------------------------------------------------
# the row table


class RowTable:
    """Rows as dicts, with the operations of HF ``Dataset`` that the
    pipeline and the data factory use and their semantics (column order,
    permutations, the ``train_test_split`` sizes, ``from_list``'s columns).
    Operations return new tables; ``map`` works on copies and
    ``__getitem__`` returns one, so a row shared by two tables (an upsampled
    copy) is never edited through either."""

    def __init__(self, rows: list[dict[str, Any]], column_names: Iterable[str] | None = None):
        self._rows = rows
        if column_names is None:
            names: dict[str, None] = {}
            for row in rows:
                names.update(dict.fromkeys(row))
            column_names = names
        self.column_names = list(column_names)

    @classmethod
    def from_list(cls, rows: list[dict[str, Any]]) -> RowTable:
        """HF ``Dataset.from_list``: the columns are the first row's keys, in
        its order; a row gets None for a column it lacks, and loses a key the
        first row lacks."""
        columns = list(rows[0]) if rows else []
        return cls([{c: row.get(c) for c in columns} for row in rows], columns)

    @classmethod
    def from_dict(cls, mapping: dict[str, list[Any]]) -> RowTable:
        """HF ``Dataset.from_dict``: one list a column, all of one length; no
        rows keeps the column names."""
        columns = list(mapping)
        lengths = {len(values) for values in mapping.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of different lengths: {sorted(lengths)}")
        count = lengths.pop() if lengths else 0
        return cls([{c: mapping[c][i] for c in columns} for i in range(count)], columns)

    def __len__(self) -> int:
        return len(self._rows)

    def __getitem__(self, index: int) -> dict[str, Any]:
        return copy.deepcopy(self._rows[index])

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return (self[i] for i in range(len(self)))

    def to_list(self) -> list[dict[str, Any]]:
        return list(self)

    def map(
        self,
        fn: Callable[..., dict[str, Any]],
        *,
        with_indices: bool = False,
        num_proc: int | None = None,
    ) -> RowTable:
        """``fn(row[, idx])`` on a copy of each row; the dict it returns
        updates that copy (HF ``Dataset.map``). ``num_proc`` is accepted and
        ignored: one process."""
        rows = []
        for idx in range(len(self)):
            row = self[idx]
            row.update(fn(row, idx) if with_indices else fn(row))
            rows.append(row)
        names = dict.fromkeys(self.column_names)
        for row in rows:
            names.update(dict.fromkeys(row))
        return RowTable(rows, names)

    def filter(
        self,
        fn: Callable[..., bool],
        *,
        with_indices: bool = False,
        num_proc: int | None = None,
    ) -> RowTable:
        """The rows for which ``fn(row[, idx])`` holds, each given as a copy
        (HF ``Dataset.filter``)."""
        return RowTable(
            [r for i, r in enumerate(self._rows)
             if (fn(copy.deepcopy(r), i) if with_indices else fn(copy.deepcopy(r)))],
            self.column_names,
        )

    def select(self, indices: Iterable[int]) -> RowTable:
        return RowTable([self._rows[int(i)] for i in indices], self.column_names)

    def add_column(self, name: str, column: list[Any]) -> RowTable:
        """HF ``Dataset.add_column``: ``column`` becomes the last column."""
        if name in self.column_names:
            raise ValueError(f"column {name!r} is already in {self.column_names}")
        if len(column) != len(self):
            raise ValueError(f"column {name!r} has {len(column)} values for {len(self)} rows")
        rows = [{**row, name: value} for row, value in zip(self._rows, column)]
        return RowTable(rows, [*self.column_names, name])

    def remove_columns(self, column_names: str | list[str]) -> RowTable:
        """HF ``Dataset.remove_columns`` of one name or a list of them."""
        names = [column_names] if isinstance(column_names, str) else list(column_names)
        missing = [c for c in names if c not in self.column_names]
        if missing:
            raise ValueError(f"columns {missing} not in {self.column_names}")
        rows = [{k: v for k, v in row.items() if k not in names} for row in self._rows]
        return RowTable(rows, [c for c in self.column_names if c not in names])

    def select_columns(self, columns: list[str]) -> RowTable:
        missing = [c for c in columns if c not in self.column_names]
        if missing:
            raise ValueError(f"columns {missing} not in {self.column_names}")
        return RowTable([{c: r[c] for c in columns} for r in self._rows], columns)

    def rename_column(self, old: str, new: str) -> RowTable:
        if old not in self.column_names or new in self.column_names:
            raise ValueError(f"cannot rename {old!r} to {new!r} in {self.column_names}")
        rows = [{(new if k == old else k): v for k, v in r.items()} for r in self._rows]
        return RowTable(rows, [new if c == old else c for c in self.column_names])

    def shuffle(self, seed: int) -> RowTable:
        """HF ``Dataset.shuffle(seed=seed)``'s order."""
        return self.select(np.random.default_rng(seed).permutation(len(self)))

    def train_test_split(self, test_size: float | int, seed: int) -> dict[str, RowTable]:
        """HF ``Dataset.train_test_split(test_size=..., seed=...)``: a float
        takes ``ceil(test_size * n)`` test rows, an int that many; the test
        rows are the permutation's head, the train rows the rest."""
        n = len(self)
        if isinstance(test_size, float):
            if not 0.0 < test_size < 1.0:
                raise ValueError(f"test_size={test_size} should be in (0, 1)")
            n_test = math.ceil(test_size * n)
        else:
            n_test = int(test_size)
        if not 0 < n_test < n:
            raise ValueError(f"test_size={test_size} leaves no train or no test rows of {n}")
        permutation = np.random.default_rng(seed).permutation(n)
        return {"train": self.select(permutation[n_test:]),
                "test": self.select(permutation[:n_test])}


def concatenate_tables(parts: list[RowTable]) -> RowTable:
    """HF ``concatenate_datasets`` of tables with the same columns."""
    columns = parts[0].column_names
    for part in parts[1:]:
        if set(part.column_names) != set(columns):
            raise ValueError(f"cannot concatenate columns {part.column_names} onto {columns}")
    return RowTable([r for part in parts for r in part._rows], columns)


def _from_hf(dataset: Any) -> RowTable:
    return RowTable(dataset.to_list(), dataset.column_names)


def _read_jsonl(path: Path) -> RowTable:
    with path.open(encoding="utf-8") as f:
        return RowTable([json.loads(line) for line in f if line.strip()])


def write_jsonl_splits(splits: dict[str, Iterable[dict[str, Any]]], directory: str | Path) -> Path:
    """Write each split as ``<split>.jsonl`` under ``directory``: a source
    ``prepare_dataset`` reads without ``datasets``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for name, rows in splits.items():
        with (directory / f"{name}.jsonl").open("w", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row, ensure_ascii=False) + "\n")
    return directory


def _import_datasets(what: str):
    try:
        import datasets
    except ImportError as error:
        raise ImportError(
            f"{what} needs the HF `datasets` package, which is not installed; "
            "a directory of <split>.jsonl files needs none"
        ) from error
    return datasets


# --------------------------------------------------------------------------
# row-level primitives


def _take_parallel(row: dict[str, Any], width: int, kept: list[int]) -> dict[str, Any]:
    """Project every list-valued column of length ``width`` onto ``kept``.

    Parallel columns (texts / labels / relevance / spans ...) are recognised
    purely by length, mirroring the reference's duck-typed field filtering.
    Indices beyond a column's actual length are skipped defensively.
    """
    for name in [k for k, v in row.items() if isinstance(v, list) and len(v) == width]:
        column = row[name]
        row[name] = [column[i] for i in kept if i < len(column)]
    return row


def _relevance_rank(
    relevance: list[Any], cap: int, *, ascending: bool, pin_first: bool
) -> list[int]:
    """Kept indices for one row of ``context_spans_relevance``.

    Items whose relevance is entirely zero are discarded; the survivors are
    ranked by mean relevance (descending unless ``ascending``) with the
    original position breaking ties, and the top ``cap`` kept.  ``pin_first``
    reserves slot 0 for the row's first item regardless of its relevance.
    """
    kept: list[int] = []
    budget = cap
    first = 0
    if pin_first and relevance:
        kept.append(0)
        budget -= 1
        first = 1

    sign = 1.0 if ascending else -1.0
    ranked: list[tuple[float, int]] = []
    for pos in range(first, len(relevance)):
        cell = relevance[pos]
        if isinstance(cell, list):
            if not any(v != 0 for v in cell):
                continue
            mean = sum(cell) / len(cell) if cell else 0
        else:
            if cell == 0:
                continue
            mean = cell
        ranked.append((sign * mean, pos))

    if budget > 0:
        ranked.sort()
        kept.extend(pos for _, pos in ranked[:budget])
    kept.sort()
    return kept


def _priority_pick(labels: list[Any] | None, width: int, cap: int, rng_seed: int) -> list[int]:
    """Kept indices for one row under positives-first capped sampling.

    With labels: every index labelled 1 (in order) up to ``cap``, then the
    remainder filled from shuffled negatives — or from ALL indices when the
    row has no positives at all.  Without labels: a plain shuffled draw.
    The rng is ``random.Random(rng_seed)`` (callers pass ``seed + row_idx``),
    matching the reference scheme exactly for reproducibility.
    """
    if labels is not None:
        hits = [i for i, v in enumerate(labels) if v == 1]
        rest = [i for i, v in enumerate(labels) if v != 1]
        chosen = hits[:cap]
        gap = cap - len(chosen)
        if gap > 0:
            pool = rest if hits else list(range(width))
            random.Random(rng_seed).shuffle(pool)
            chosen = chosen + pool[:gap]
    else:
        pool = list(range(width))
        random.Random(rng_seed).shuffle(pool)
        chosen = pool[:cap]
    return sorted({i for i in chosen if i < width})


# --------------------------------------------------------------------------
# dataset-level ops


def filter_pruning_dataset(
    dataset: RowTable,
    max_items: int,
    num_proc: int | None = None,
    reverse_sort: bool = False,
    keep_first: bool = False,
) -> RowTable:
    """Drop all-zero-relevance items per row, cap each row at ``max_items``
    by mean relevance, then drop rows left with fewer than ``max_items``
    items (reference trainer.py:591-703)."""
    before = len(dataset)

    def _cap_row(row: dict[str, Any]) -> dict[str, Any]:
        relevance = row.get("context_spans_relevance", [])
        if not relevance:
            return row
        kept = _relevance_rank(
            relevance, max_items, ascending=reverse_sort, pin_first=keep_first
        )
        return _take_parallel(row, len(relevance), kept)

    def _row_is_full(row: dict[str, Any]) -> bool:
        return len(row.get("context_spans_relevance", [])) >= max_items

    dataset = dataset.map(_cap_row, num_proc=num_proc).filter(_row_is_full, num_proc=num_proc)
    logger.info(
        "filter_pruning_dataset: kept %d of %d rows (%.1f%%)",
        len(dataset), before, 100.0 * len(dataset) / max(before, 1),
    )
    return dataset


_FALLBACK_LIST_COLUMNS = ("texts", "context_spans", "context", "passages")


def sample_items_by_label_priority(
    dataset: RowTable,
    max_items: int,
    seed: int,
    *,
    label_column: str = "labels",
    num_proc: int | None = None,
) -> RowTable:
    """Cap every row at ``max_items`` items, preferring positive labels and
    filling the rest with a deterministic ``seed + row_idx`` shuffle
    (reference trainer.py:706-867)."""
    if max_items <= 0:
        raise ValueError("items must be a positive integer")

    has_labels = label_column in dataset.column_names
    anchor: str | None = None
    if not has_labels:
        anchor = next(
            (c for c in _FALLBACK_LIST_COLUMNS if c in dataset.column_names), None
        )
        if anchor is None and len(dataset):
            anchor = next(
                (k for k, v in dataset[0].items() if isinstance(v, list)), None
            )
        if anchor is None:
            logger.warning(
                "sample_items_by_label_priority: no '%s' column and no list "
                "column to anchor sampling on; dataset left untouched.",
                label_column,
            )
            return dataset

    def _sample_row(row: dict[str, Any], idx: int) -> dict[str, Any]:
        labels = row.get(label_column) if has_labels else None
        if has_labels and isinstance(labels, list):
            width = len(labels)
        else:
            anchored = row.get(anchor) if anchor else None
            if not isinstance(anchored, list):
                return row
            labels, width = None, len(anchored)
        if width == 0:
            return row
        kept = _priority_pick(labels, width, max_items, seed + idx)
        return _take_parallel(row, width, kept)

    def _row_is_full(row: dict[str, Any]) -> bool:
        witness = row.get(label_column if has_labels else anchor, [])
        return isinstance(witness, list) and len(witness) >= max_items

    dataset = dataset.map(_sample_row, with_indices=True, num_proc=num_proc)
    return dataset.filter(_row_is_full, num_proc=num_proc)


def upsample_dataset(
    dataset: RowTable,
    multiplier: float,
    *,
    seed: int,
    dataset_label: str | None = None,
) -> RowTable:
    """Repeat the dataset ``multiplier`` times: floor(multiplier) whole
    copies plus a seeded-shuffle prefix for the fractional part
    (reference trainer.py:870-935)."""
    if multiplier < 1.0:
        raise ValueError("upsample_factor must be >= 1.0")
    size = len(dataset)
    if size == 0 or multiplier <= 1.0:
        return dataset

    copies, remainder = int(multiplier), multiplier - int(multiplier)
    parts = [dataset] * copies
    if remainder > 1e-6:
        tail_len = min(max(int(round(remainder * size)), 1), size)
        parts.append(dataset.shuffle(seed=seed).select(range(tail_len)))
    result = concatenate_tables(parts)
    logger.info(
        "upsample %s: %d -> %d rows (x%.3f)",
        dataset_label or "dataset", size, len(result), multiplier,
    )
    return result


# --------------------------------------------------------------------------
# end-to-end preparation


@dataclass
class _SourceSpec:
    """One entry of ``data_args.datasets`` (or the single implicit source)."""

    name: str | None
    subset: str | None
    teacher_column: str
    items: int | None
    upsample: float | None
    n_samples: float | None

    @property
    def label(self) -> str:
        return f"{self.name}:{self.subset}" if self.name else self.subset or "train"


def _source_specs(data_args: Any) -> list[_SourceSpec]:
    raw_entries: list[dict[str, Any]]
    if data_args.datasets:
        raw_entries = data_args.datasets
    else:
        entry: dict[str, Any] = {
            "dataset_name": data_args.dataset_name,
            "subset": data_args.subset,
            "teacher_column": data_args.teacher_column or "teacher_score",
        }
        if data_args.items is not None:
            entry["items"] = data_args.items
        if data_args.upsample_factor is not None:
            entry["upsample_factor"] = data_args.upsample_factor
        raw_entries = [entry]
    return [
        _SourceSpec(
            name=e.get("dataset_name"),
            subset=e.get("subset"),
            teacher_column=e.get("teacher_column", "teacher_score"),
            items=e.get("items", data_args.items),
            upsample=e.get("upsample_factor", data_args.upsample_factor),
            n_samples=e.get("n_samples"),
        )
        for e in raw_entries
    ]


def _open_source(spec: _SourceSpec) -> dict[str | None, RowTable]:
    """Resolve a spec to its splits. A local directory takes priority over a
    hub identifier (reference trainer.py:104-121): a ``save_to_disk``
    directory, else its ``<split>.jsonl`` files. A ``save_to_disk``
    directory of one ``Dataset`` (no splits) comes back under the key
    None."""
    if spec.name and Path(spec.name).expanduser().exists():
        path = Path(spec.name).expanduser()
        if _is_jsonl_dir(path):
            logger.info("Loading local JSON-lines dataset from %s", path)
            return {f.stem: _read_jsonl(f) for f in sorted(path.glob("*.jsonl"))}
        datasets = _import_datasets(f"the save_to_disk directory {path}")
        logger.info("Loading local dataset from %s", path)
        loaded = datasets.load_from_disk(str(path))
        if isinstance(loaded, datasets.Dataset):
            return {None: _from_hf(loaded)}
        return {name: _from_hf(split) for name, split in loaded.items()}
    datasets = _import_datasets(f"the hub dataset {spec.name!r}")
    loaded = datasets.load_dataset(spec.name or "", spec.subset or None)
    return {name: _from_hf(split) for name, split in loaded.items()}


def _is_jsonl_dir(path: Path) -> bool:
    """A directory of ``<split>.jsonl`` files that is no ``save_to_disk``
    directory."""
    return any(path.glob("*.jsonl")) and not (path / "dataset_dict.json").exists()


def open_splits(name: str, subset: str | None = None) -> tuple[dict[str | None, RowTable], bool]:
    """The splits of a local directory or a hub dataset, by the training
    data's rules (``_open_source``: a lone ``save_to_disk`` ``Dataset``
    under the key None), and whether they came from ``<split>.jsonl``
    files, so that a command writes its output in the form it read."""
    path = Path(name).expanduser()
    spec = _SourceSpec(name=name, subset=subset, teacher_column="teacher_score", items=None,
                       upsample=None, n_samples=None)
    return _open_source(spec), path.is_dir() and _is_jsonl_dir(path)


def to_hf(table: RowTable) -> Any:
    """The table as an HF ``Dataset`` with its columns (none of its rows
    lacking one), for ``save_to_disk`` and ``push_to_hub``."""
    datasets = _import_datasets("writing a save_to_disk directory")
    rows = table.to_list()
    return datasets.Dataset.from_dict(
        {c: [row.get(c) for row in rows] for c in table.column_names})


def save_splits(splits: dict[str, RowTable], directory: str | Path, *, jsonl: bool) -> Path:
    """Write ``splits`` as ``<split>.jsonl`` files (``write_jsonl_splits``)
    or, with ``jsonl`` False, as an HF ``DatasetDict`` ``save_to_disk``
    directory."""
    if jsonl:
        return write_jsonl_splits(splits, directory)
    datasets = _import_datasets("writing a save_to_disk directory")
    datasets.DatasetDict({k: to_hf(v) for k, v in splits.items()}).save_to_disk(str(directory))
    return Path(directory)


def _refine_split(
    split: RowTable, spec: _SourceSpec, data_args: Any, seed: int
) -> RowTable:
    """The op chain shared verbatim by train and eval splits: zero-relevance
    filtering, per-row item capping, teacher-column normalisation."""
    workers = data_args.preprocessing_num_workers
    cap = data_args.filter_zero_relevance_max_items
    if cap is not None:
        split = filter_pruning_dataset(
            split,
            cap,
            num_proc=workers,
            reverse_sort=data_args.filter_zero_relevance_max_items_reverse,
            keep_first=data_args.filter_keep_first_item,
        )
    if spec.items is not None:
        split = sample_items_by_label_priority(
            split, spec.items, seed=seed, num_proc=workers
        )
    if spec.teacher_column != "teacher_score" and spec.teacher_column in split.column_names:
        split = split.rename_column(spec.teacher_column, "teacher_score")
    return split


def _draw_rows(dataset: RowTable, count: int, rnd: random.Random, label: str) -> RowTable:
    """Uniform row subsample without replacement, order-preserving
    (reference trainer.py:124-152)."""
    if count <= 0:
        raise ValueError("sample_size must be greater than 0")
    if len(dataset) <= count:
        return dataset
    picks = sorted(rnd.sample(range(len(dataset)), count))
    logger.info("Sampled %d/%d rows from %s", count, len(dataset), label)
    return dataset.select(picks)


def _eval_split_name(dataset: dict[str, RowTable], preferred: str) -> str | None:
    for candidate in (preferred, "validation", "test"):
        if candidate in dataset:
            return candidate
    return None


def _shared_column_order(parts: list[RowTable]) -> list[str]:
    """Column set common to all parts, ordered: ranking essentials first,
    then span columns, then the rest alphabetically."""
    common = set(parts[0].column_names)
    for ds in parts[1:]:
        common &= set(ds.column_names)
    leading = [
        c
        for c in ("query", "positive", "negative", "teacher_score",
                  "context_spans", "context_spans_relevance")
        if c in common
    ]
    return leading + [c for c in sorted(common) if c not in leading]


def _carve_validation(
    train_dataset: RowTable, data_args: Any, seed: int
) -> tuple[RowTable, RowTable]:
    """Split a validation set off the training data when no source provided
    one (reference trainer.py:1180-1214). ``validation_split_samples`` goes
    in as the fraction ``wanted / len``, as in the JAX package, so the
    split's ``ceil`` can carve one row more than asked (7 of 25 rows carve
    8: ROADMAP C, faults in the reference)."""
    if data_args.validation_split_samples is not None:
        wanted = data_args.validation_split_samples
        if wanted <= 0 or wanted >= len(train_dataset):
            raise ValueError(
                f"validation_split_samples must be between 1 and {len(train_dataset) - 1}"
            )
        fraction = wanted / len(train_dataset)
    else:
        fraction = data_args.validation_split
        if fraction is None or not (0 < fraction < 1):
            raise ValueError("validation_split must be between 0 and 1")
    halves = train_dataset.train_test_split(test_size=fraction, seed=seed)
    return halves["train"], halves["test"]


def prepare_dataset(data_args: Any, seed: int = 42) -> tuple[RowTable, RowTable | None]:
    """Load every configured source, refine its splits, concatenate on the
    shared columns, and return ``(train, eval_or_None)``
    (reference trainer.py:938-1237)."""
    specs = _source_specs(data_args)
    rnd = random.Random(seed)
    train_parts: list[RowTable] = []
    eval_parts: list[RowTable] = []

    for spec in specs:
        source = _open_source(spec)
        if "train" not in source:
            raise KeyError(f"Source {spec.label!r} has no 'train' split")
        train_ds = _refine_split(source["train"], spec, data_args, seed)
        if spec.upsample is not None:
            train_ds = upsample_dataset(
                train_ds, float(spec.upsample), seed=seed,
                dataset_label=f"{spec.label} train",
            )

        drawn_fraction: float | None = None
        if spec.n_samples is not None:
            requested = float(spec.n_samples)
            if requested <= 0:
                raise ValueError("n_samples must be greater than 0")
            pool = len(train_ds)
            target = (
                max(1, math.ceil(pool * requested)) if requested <= 1 else int(requested)
            )
            train_ds = _draw_rows(
                train_ds, min(pool, target), rnd, f"{spec.label} train"
            )
            drawn_fraction = len(train_ds) / pool if pool > 0 else 1.0
        train_parts.append(train_ds)

        held_out = _eval_split_name(source, data_args.validation_split_name)
        if held_out:
            eval_ds = _refine_split(source[held_out], spec, data_args, seed)
            if drawn_fraction is not None and len(eval_ds) > 0:
                eval_ds = _draw_rows(
                    eval_ds,
                    min(len(eval_ds), max(1, math.ceil(len(eval_ds) * drawn_fraction))),
                    rnd,
                    f"{spec.label} {held_out}",
                )
            eval_parts.append(eval_ds)

    if len(train_parts) > 1:
        columns = _shared_column_order(train_parts)
        train_dataset = concatenate_tables([ds.select_columns(columns) for ds in train_parts])
        usable_eval = [
            ds.select_columns(columns)
            for ds in eval_parts
            if all(c in ds.column_names for c in columns)
        ]
        eval_dataset = concatenate_tables(usable_eval) if usable_eval else None
    else:
        train_dataset = train_parts[0]
        eval_dataset = eval_parts[0] if eval_parts else None

    wants_carved = (
        data_args.validation_split is not None
        or data_args.validation_split_samples is not None
    )
    if eval_dataset is None and wants_carved:
        train_dataset, eval_dataset = _carve_validation(train_dataset, data_args, seed)

    if data_args.max_train_samples and len(train_dataset) > data_args.max_train_samples:
        train_dataset = train_dataset.select(range(data_args.max_train_samples))
    if (
        eval_dataset is not None
        and data_args.max_eval_samples
        and len(eval_dataset) > data_args.max_eval_samples
    ):
        eval_dataset = eval_dataset.select(range(data_args.max_eval_samples))

    logger.info(
        "Final dataset sizes: train=%d validation=%d",
        len(train_dataset),
        len(eval_dataset) if eval_dataset is not None else 0,
    )
    return train_dataset, eval_dataset


# --------------------------------------------------------------------------
# batching


def batch_iterator(
    dataset: RowTable,
    collator: Callable[[list[dict[str, Any]]], Any],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 42,
    epoch: int = 0,
    drop_last: bool = True,
) -> Iterator[Any]:
    """Yield collated fixed-shape batches; epoch-keyed deterministic order."""
    order = list(range(len(dataset)))
    if shuffle:
        random.Random(seed + epoch).shuffle(order)
    for lo in range(0, len(order), batch_size):
        window = order[lo : lo + batch_size]
        if drop_last and len(window) < batch_size:
            return
        yield collator([dataset[int(i)] for i in window])
