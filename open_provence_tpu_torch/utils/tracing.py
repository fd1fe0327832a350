"""Runtime telemetry: named spans and counters, and the ``process()`` trace.

``Spans`` times named phases of a call or a step on its calling thread and
counts named quantities; while a ``torch.profiler`` capture records, each
span also opens a user range of its name (what ``record_function`` opens),
so the phases land in the capture's trace on the device activity's clock.

``ProcessPerformanceTrace`` mirrors the reference's frozen dataclass
(modeling_open_provence_standalone.py:378-404) so eval harnesses can consume
timing columns unchanged, and adds the seconds of every span and the
counters of ``process()`` (``PROCESS_SPANS``, ``PROCESS_COUNTERS``).
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field
from time import perf_counter
from typing import Any

import torch

# The spans of one process() call, root first (inference/engine.py).
PROCESS_SPANS = (
    "engine.process",  # the whole call
    "engine.plan",  # inputs normalized, jobs planned, the loader tuned
    "engine.fragments",  # the next fragmentized entry produced or waited for
    "engine.assembly",  # blocks packed and their inputs prepared
    "engine.pad",  # a forward's rows padded, its fragment ranges laid out
    "engine.dispatch",  # the inputs' copies to the device, the forward launched
    "engine.fetch",  # the results copied back: the host blocked on the device
    "engine.attach",  # the results attached to their cells
    "engine.post",  # contexts summarized and reordered
    "engine.payload",  # the output payload built
)
# Its counters: blocks packed, forwards run, the token positions of the
# forwards' padded [rows, length] against those holding a real token, and the
# forwards served by a CUDA graph's replay and the graphs captured.
PROCESS_COUNTERS = (
    "blocks", "forwards", "token_slots", "valid_tokens", "graph_replays", "graph_captures",
)
# The fragmentation stages whose seconds the workers report per entry; the
# engine adds them to its spans under these names (``Spans.add``).
FRAGMENT_STAGES = (
    "sentence_collect", "sentence_normalize", "tokenize", "fragment_split", "fragment_decode",
)


class Spans:
    """Wall seconds and counts by name, for one thread.

    ``with spans("engine.dispatch"): ...`` adds the block's ``perf_counter``
    seconds to that name, ``spans.add(name, seconds)`` adds seconds timed
    elsewhere (another thread's), and ``spans.count("forwards", n)`` adds
    ``n`` to a counter. A span opened with none open is a root: it reads
    once whether a ``torch.profiler`` capture is recording, and while one
    is, it and the spans opened inside it each open a user range of their
    name, the ``user_annotation`` that ``torch.profiler.record_function``
    opens. Otherwise a span makes no torch call.

    The range is opened through the binding beneath ``record_function``,
    which keeps the GIL: ``record_function`` calls a dispatcher op that
    releases it, and with the fragmentation threads busy the calling thread
    then waits for it again, up to several switch intervals, after the
    range has closed, so the wait shows as the parent's time.
    """

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._stack: list[tuple[str, Any, float]] = []
        self._recording = False

    def __call__(self, name: str) -> "Spans":
        if not self._stack:
            self._recording = torch.autograd._profiler_enabled()
        opened = None
        if self._recording:
            opened = torch._C._autograd._record_function_with_args_enter(name)
        self._stack.append((name, opened, perf_counter()))
        return self

    def __enter__(self) -> "Spans":
        return self

    def __exit__(self, *exc: Any) -> None:
        name, opened, began = self._stack.pop()
        self.add(name, perf_counter() - began)
        if opened is not None:
            torch._C._autograd._record_function_with_args_exit(opened)

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)


@dataclass(frozen=True)
class ProcessPerformanceTrace:
    preprocess_seconds: float = 0.0
    assembly_seconds: float = 0.0
    # Host seconds launching the forwards and blocked on the device for
    # their results (engine.dispatch + engine.fetch): not device time.
    inference_seconds: float = 0.0
    postprocess_seconds: float = 0.0
    total_seconds: float = 0.0
    sentence_collect_seconds: float = 0.0
    sentence_normalize_seconds: float = 0.0
    tokenize_seconds: float = 0.0
    fragment_split_seconds: float = 0.0
    fragment_decode_seconds: float = 0.0
    # Seconds of each of PROCESS_SPANS and the value of each of
    # PROCESS_COUNTERS.
    span_seconds: Mapping[str, float] = field(default_factory=dict)
    counts: Mapping[str, int] = field(default_factory=dict)

    @classmethod
    def from_spans(cls, spans: Spans) -> "ProcessPerformanceTrace":
        """The trace of one ``process()`` call from its spans, the
        fragmentation workers' stage seconds among them. The reference's keys:
        preprocess is planning, fragments and padding; assembly, inference
        (``inference_seconds``), postprocess and total as their spans say."""
        s = {name: spans.seconds.get(name, 0.0) for name in PROCESS_SPANS}
        return cls(
            preprocess_seconds=s["engine.plan"] + s["engine.fragments"] + s["engine.pad"],
            assembly_seconds=s["engine.assembly"],
            inference_seconds=s["engine.dispatch"] + s["engine.fetch"],
            postprocess_seconds=s["engine.post"],
            total_seconds=s["engine.process"],
            **{f"{stage}_seconds": spans.seconds.get(stage, 0.0) for stage in FRAGMENT_STAGES},
            span_seconds=s,
            counts={name: spans.counts.get(name, 0) for name in PROCESS_COUNTERS},
        )

    def as_dict(self) -> dict[str, float]:
        """The reference's ten keys, then ``<span>_seconds`` for each span
        and each counter by its name."""
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
            **{f"{name}_seconds": float(v) for name, v in self.span_seconds.items()},
            **{name: int(v) for name, v in self.counts.items()},
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
