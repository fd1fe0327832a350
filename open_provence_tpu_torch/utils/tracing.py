"""Runtime telemetry for process() calls + optional torch.profiler capture.

``ProcessPerformanceTrace`` mirrors the reference's frozen dataclass
(modeling_open_provence_standalone.py:378-404) so eval harnesses can consume
timing columns unchanged. ``profiler_trace`` wraps a region in a
torch.profiler trace (host and, when a card is present, CUDA activity) and
writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ProcessPerformanceTrace:
    preprocess_seconds: float = 0.0
    assembly_seconds: float = 0.0
    inference_seconds: float = 0.0
    postprocess_seconds: float = 0.0
    total_seconds: float = 0.0
    sentence_collect_seconds: float = 0.0
    sentence_normalize_seconds: float = 0.0
    tokenize_seconds: float = 0.0
    fragment_split_seconds: float = 0.0
    fragment_decode_seconds: float = 0.0

    def as_dict(self) -> dict[str, float]:
        return {
            "preprocess_seconds": float(self.preprocess_seconds),
            "assembly_seconds": float(self.assembly_seconds),
            "inference_seconds": float(self.inference_seconds),
            "postprocess_seconds": float(self.postprocess_seconds),
            "total_seconds": float(self.total_seconds),
            "sentence_collect_seconds": float(self.sentence_collect_seconds),
            "sentence_normalize_seconds": float(self.sentence_normalize_seconds),
            "tokenize_seconds": float(self.tokenize_seconds),
            "fragment_split_seconds": float(self.fragment_split_seconds),
            "fragment_decode_seconds": float(self.fragment_decode_seconds),
        }

    def timing_line(self) -> str:
        return (
            "Timing: "
            f"preprocess={self.preprocess_seconds:.2f}s "
            f"[collect={self.sentence_collect_seconds:.2f}s "
            f"normalize={self.sentence_normalize_seconds:.2f}s "
            f"tokenize={self.tokenize_seconds:.2f}s "
            f"fragment_split={self.fragment_split_seconds:.2f}s "
            f"fragment_decode={self.fragment_decode_seconds:.2f}s] "
            f"assembly={self.assembly_seconds:.2f}s "
            f"inference={self.inference_seconds:.2f}s "
            f"postprocess={self.postprocess_seconds:.2f}s "
            f"total={self.total_seconds:.2f}s"
        )


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Capture a torch.profiler trace into ``log_dir/trace.json`` when
    log_dir is given; yields the profiler (None when disabled) so callers
    can also read ``key_averages()``."""
    if not log_dir:
        yield None
        return
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
