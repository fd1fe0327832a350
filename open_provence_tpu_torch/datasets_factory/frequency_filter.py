"""Duplicate-text frequency filtering — the source of the "freq2" subsets.

The port's copy of the JAX package's ``datasets_factory/frequency_filter.py``
(the same fingerprints, counters and statistics) on ``train/data.py``'s
``RowTable``.
Counterpart of scripts/context-relevance-datasets/frequency_filter_ds.py:
rows whose texts repeat already-seen MD5 fingerprints more than
``threshold`` times are dropped; duplicate-bucket statistics are reported.
"""

from __future__ import annotations

import hashlib
from collections import Counter
from dataclasses import dataclass
from typing import Any

from ..train.data import RowTable


@dataclass
class DuplicateStats:
    rows_total: int
    rows_kept: int
    rows_removed: int
    texts_total: int
    texts_unique: int
    texts_duplicates: int
    texts_dup_ratio: float
    duplicate_buckets_total: dict[int, int]
    duplicate_buckets_kept: dict[int, int]
    duplicate_buckets_removed: dict[int, int]

    def to_dict(self) -> dict[str, Any]:
        return dict(self.__dict__)


def frequency_filter_train(
    dataset: RowTable,
    threshold: int,
    *,
    id_column: str = "id",
    texts_column: str = "texts",
) -> tuple[RowTable, DuplicateStats, set[str]]:
    """Keep a row only when at most ``threshold`` of its texts were already
    seen in kept rows (reference frequency_filter_ds.py:114-199)."""
    if threshold < 0:
        raise ValueError(f"threshold must be >= 0, got {threshold}")

    all_fingerprints: Counter[str] = Counter()
    kept_fingerprints: Counter[str] = Counter()
    bucket_total: Counter[int] = Counter()
    bucket_kept: Counter[int] = Counter()
    bucket_removed: Counter[int] = Counter()
    dropped: set[str] = set()

    for row_idx, row in enumerate(dataset):
        fingerprints = [
            hashlib.md5(str(text).encode("utf-8")).hexdigest()
            for text in row[texts_column]
        ]
        all_fingerprints.update(fingerprints)
        n_repeats = sum(kept_fingerprints[fp] > 0 for fp in fingerprints)
        bucket_total[n_repeats] += 1
        if n_repeats > threshold:
            dropped.add(str(row.get(id_column, row_idx)))
            bucket_removed[n_repeats] += 1
        else:
            bucket_kept[n_repeats] += 1
            kept_fingerprints.update(fingerprints)

    filtered = dataset.filter(
        lambda row, idx: str(row.get(id_column, idx)) not in dropped,
        with_indices=True,
    )

    texts_total = sum(all_fingerprints.values())
    texts_unique = len(all_fingerprints)
    stats = DuplicateStats(
        rows_total=len(dataset),
        rows_kept=len(filtered),
        rows_removed=len(dataset) - len(filtered),
        texts_total=texts_total,
        texts_unique=texts_unique,
        texts_duplicates=texts_total - texts_unique,
        texts_dup_ratio=(texts_total - texts_unique) / texts_total if texts_total else 0.0,
        duplicate_buckets_total=dict(bucket_total),
        duplicate_buckets_kept=dict(bucket_kept),
        duplicate_buckets_removed=dict(bucket_removed),
    )
    return filtered, stats, dropped
