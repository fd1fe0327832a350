"""Preprocess loader auto-tuning.

Counterpart of the reference's `_auto_tune_preprocess_loader`
(reference modeling_open_provence_standalone.py:2567-2623) and its worker /
device-memory resolution helpers (:2521-2534, :2536-2564, :82-97). The
heuristics (thresholds, caps, env overrides) match the reference so tuning
behavior is drop-in; the execution substrate differs — fragmentation here is
thread-parallel (HF fast tokenizers release the GIL), not DataLoader worker
processes, so ``prefetch_factor`` maps to the thread-pool map chunk size.

Env overrides (reference names):
* ``OPEN_PROVENCE_PREPROCESS_WORKERS`` — positive int forces the worker count.
* ``OPEN_PROVENCE_DEVICE_MEMORY_GB``  — overrides device-memory detection.
"""

from __future__ import annotations

import functools
import math
import os


def default_preprocess_workers() -> int:
    """CPU count − 1 (reference :82-97; psutil physical-core preference
    degraded to os.cpu_count, psutil not being a dependency here)."""
    cpu_total = os.cpu_count()
    if cpu_total is None:
        return 0
    return max(0, int(cpu_total) - 1)


def resolve_preprocess_workers(override: int | None) -> int | None:
    """Explicit override → env var → None (meaning: auto-tune).

    Mirrors reference ``_resolve_preprocess_workers`` (:2521-2534) except the
    no-signal case returns None so the auto-tuner can apply its job-count
    heuristics rather than always defaulting to cpu−1.
    """
    if override is not None:
        return max(0, int(override))
    env_value = os.getenv("OPEN_PROVENCE_PREPROCESS_WORKERS")
    if env_value:
        try:
            parsed = int(env_value)
        except ValueError:
            parsed = 0
        if parsed > 0:
            return parsed
    return None


def estimate_device_memory_bytes(device=None) -> int | None:
    """Device memory size: env override, then ``torch.cuda.mem_get_info``
    for a CUDA ``device`` (reference :2536-2564 queries torch.cuda too),
    asked once a card. None for a CPU device."""
    override_gb = os.getenv("OPEN_PROVENCE_DEVICE_MEMORY_GB")
    if override_gb:
        try:
            parsed = float(override_gb)
        except ValueError:
            parsed = None
        else:
            if parsed > 0:
                return int(parsed * (1024**3))

    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    return _cuda_total_bytes(index)


@functools.cache
def _cuda_total_bytes(index: int) -> int:
    """A card's memory size, which does not change. The query is a driver
    call whose time has a tail of tens of milliseconds; ``process()`` plans
    with it on every call."""
    import torch

    _free, total = torch.cuda.mem_get_info(index)
    return int(total)


def auto_tune_preprocess_loader(
    *,
    total_jobs: int,
    inference_batch_size: int,
    current_workers: int | None,
    current_preprocess_batch: int | None,
    current_prefetch: int | None = None,
    device_memory_bytes: int | None = None,
) -> tuple[int, int, int | None]:
    """(workers, preprocess_batch, prefetch_factor) — reference :2567-2623.

    ``current_*=None`` means "not explicitly set" (auto-tune that knob);
    a value pins it. Heuristics kept behavior-identical:
    * small runs (<2000 jobs) stay single-threaded,
    * preprocess batch capped by device memory tier (64/128/192 for
      <12/<20/≥20 GB) else min(96, max(32, inference_batch_size)),
    * prefetch = clamp(ceil(batch/workers), 2, 8) when workers > 0.
    """
    jobs_count = max(0, int(total_jobs))
    workers_explicit = current_workers is not None
    batch_explicit = current_preprocess_batch is not None
    prefetch_explicit = current_prefetch is not None

    workers = max(0, int(current_workers)) if workers_explicit else 0
    preprocess_batch = (
        max(1, int(current_preprocess_batch)) if batch_explicit else 1 << 30
    )
    prefetch_factor = current_prefetch if prefetch_explicit else None

    if not workers_explicit:
        cpu_limit = max(0, default_preprocess_workers())
        workers = min(workers or cpu_limit, cpu_limit)
        if jobs_count < 2_000:
            workers = 0
        elif workers == 0 and cpu_limit > 0:
            workers = min(cpu_limit, 4)
        if jobs_count:
            workers = min(workers, jobs_count)

    if not batch_explicit:
        cap_from_device: int | None = None
        if device_memory_bytes:
            device_gb = device_memory_bytes / float(1024**3)
            if device_gb < 12:
                cap_from_device = 64
            elif device_gb < 20:
                cap_from_device = 128
            else:
                cap_from_device = 192
        fallback_cap = min(96, max(32, inference_batch_size))
        target_cap = cap_from_device or fallback_cap
        preprocess_batch = min(preprocess_batch, target_cap)
        preprocess_batch = min(preprocess_batch, max(1, inference_batch_size))
        if jobs_count:
            preprocess_batch = min(preprocess_batch, jobs_count)
        preprocess_batch = max(1, preprocess_batch)

    if workers <= 0:
        workers = 0
    if workers == 0 and not prefetch_explicit:
        prefetch_factor = None
    elif workers > 0 and not prefetch_explicit:
        prefetch_factor = max(2, min(8, math.ceil(preprocess_batch / workers)))

    return workers, preprocess_batch, prefetch_factor
