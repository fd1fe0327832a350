"""OpenProvenceModel — the inference runtime on PyTorch.

Counterpart of the JAX package's ``inference/engine.py`` (and of the
reference's flagship artifact, modeling_open_provence_standalone.py:
1467-3805): ``process()`` with the same input-shape contract and output
payload, over the port's module:

* one forward per (batch, length) bucket (inference/batching.py); on a
  CUDA device the forward runs the port's hand-written kernels, on the CPU
  their plain versions; on one card without a mesh each bucket's forward is
  captured once as a CUDA graph and replayed (``_ForwardGraphs``), so a
  forward costs the host one graph launch, not one launch a kernel;
* fp32 sigmoid/softmax of the logits on the device (standalone:2900-2924);
* fragment mean pooling on the device when no title prefix applies, so only
  [B] scores and [B, F] fragment means come back to the host.

Everything around the forward is host text processing, carried over from
the JAX package: sentence split → fragmentation → greedy block packing →
postprocess (SURVEY §3.2). ``from_pretrained`` loads a checkpoint directory
(config.json + model.safetensors, utils/hf_convert.py); the raw-prediction
APIs (``get_raw_predictions*``, ``predict_with_thresholds``) are host code
around the same bucketed forward.

Over a ``mesh`` of ``torch.distributed`` ranks (``parallel/mesh.py``) every
rank runs ``process()`` on the same inputs, as the JAX engine's one program
runs over its devices: a forward's rows pad to a multiple of the data axis,
each data rank runs its share of them (with ``tensor_parallel``, on its
shard of the attention and MLP weights) and the outputs are gathered, so
every rank returns the whole result.
"""

from __future__ import annotations

import logging
import os
from collections.abc import Callable, Mapping, Sequence
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import kernels
from ..configs import OpenProvenceConfig
from ..models.model import (
    OpenProvenceModule,
    keep_probs_from_logits,
    ranking_score_from_logits,
)
from ..models.modernbert import ModernBertAttention
from ..ops.rotary import rope_tables
from ..ops.segment import fragment_mean_pool_ranges
from ..parallel.mesh import DATA_AXIS, Mesh, shard_state_dict
from ..text.fragmentation import (
    FragmentRecord,
    assemble_blocks,
    fragmentize_jobs,
    fragments_from_payload,
    max_fragment_tokens_for,
    tokenize_sentences,
)
from ..text.splitters import SentenceSplitter, resolve_sentence_splitter
from ..text.tokenizer import TokenizerAdapter
from ..utils.tracing import FRAGMENT_STAGES, ProcessPerformanceTrace, Spans
from .batching import bucket_batch, bucket_length, length_buckets, pad_block_batch
from .inputs import normalize_inputs, resolve_prefix_sentences, resolve_titles
from .postprocess import (
    BlockScores,
    build_payload,
    reorder_outcomes,
    summarize_contexts,
)

_LOG = logging.getLogger(__name__)

DEFAULT_BATCH_SIZE = 32
# The JAX engine's attention routes; the port has one attention kernel for
# every shape, so it accepts these names and ignores them.
ATTENTION_IMPLS = ("auto", "xla", "pallas")
# The length-bucket step that ``bucket_step=None`` means: the JAX engine's
# choice off the TPU. The kernels take any S, so 64 wastes at most 63 padded
# positions a row.
DEFAULT_BUCKET_STEP = 64


def check_attention_impl(attention_impl: str) -> None:
    """Raise unless ``attention_impl`` names one of the JAX engine's
    attention routes."""
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"attention_impl must be one of {', '.join(ATTENTION_IMPLS)}, not {attention_impl!r}"
        )


def place_module(
    config: OpenProvenceConfig,
    state_dict: Mapping[str, torch.Tensor],
    device: torch.device | str | None,
    dtype: torch.dtype | None,
    mesh: Mesh | None = None,
    tensor_parallel: bool = False,
) -> tuple[torch.device, OpenProvenceModule]:
    """The module of ``config`` holding ``state_dict``, in eval mode, on
    ``device`` (None: the first CUDA card, raising where there is none) in
    ``dtype`` (None: bf16 on a card, the weights' own dtype on the CPU).
    With ``tensor_parallel`` over ``mesh`` it holds this rank's shards of
    the full ``state_dict``."""
    device = kernels.first_card() if device is None else torch.device(device)
    if dtype is None and device.type == "cuda":
        dtype = torch.bfloat16
    module = OpenProvenceModule(config.backbone(), config.pruning_head(), mesh, tensor_parallel)
    if tensor_parallel and mesh is not None:
        state_dict = shard_state_dict(state_dict, mesh)
    module.load_state_dict(dict(state_dict))
    module.to(device=device, dtype=dtype).eval()
    return device, module


@torch.inference_mode()
def forward_logits(
    module: OpenProvenceModule,
    device: torch.device,
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One bucketed forward: (fp32 ranking logits [B, num_labels], fp32 keep
    probabilities [B, S], the softmax's keep column), left on the device."""
    ids, mask = (
        torch.from_numpy(a).to(device, non_blocking=True) for a in (input_ids, attention_mask)
    )
    return device_logits(module, ids, mask)


def device_logits(
    module: OpenProvenceModule, ids: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``forward_logits`` on inputs that already lie on the device."""
    out = module(ids.long(), mask)
    return out["ranking_logits"].float(), keep_probs_from_logits(out["pruning_logits"])


def fragment_means(
    keep: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor
) -> torch.Tensor:
    """[B, F] fragment means of the [B, S] keep probabilities; empty slots
    (start == end) read 1.0, the keep-everything sentinel the postprocess
    expects."""
    means, counts = fragment_mean_pool_ranges(keep, starts, ends)
    return torch.where(counts > 0, means, 1.0)


def graph_route(device: torch.device, mesh: Mesh | None, tensor_parallel: bool) -> bool:
    """Whether the engine replays its forwards as CUDA graphs: on a CUDA
    card where a forward is this process's alone. A mesh's row gather and
    its tensor-parallel sums are collectives that a graph cannot hold, and
    the CPU has no graphs."""
    if device.type != "cuda":
        return False
    return mesh is None or (mesh.data == 1 and not (tensor_parallel and mesh.model > 1))


def _rope_tables_read(module: OpenProvenceModule, seq_len: int) -> list[torch.Tensor]:
    """The cached rope tables a forward of ``module`` at ``seq_len`` reads."""
    return [
        t
        for m in module.modules()
        if isinstance(m, ModernBertAttention)
        for t in rope_tables(seq_len, m.head_dim, m.theta, m.Wqkv.weight.dtype,
                             m.Wqkv.weight.device)
    ]


class _Graph(NamedTuple):
    """One captured forward: the graph, its static inputs and outputs, the
    kernel launches it replays, and the rope tables it reads (held here, so
    the tables' cache cannot free memory a replay reads)."""

    graph: torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]
    outputs: tuple[torch.Tensor, ...]
    launches: dict[str, int]
    tables: list[torch.Tensor]


class _ForwardGraphs:
    """The bucketed forward as one CUDA graph per input shape, on one card
    without a mesh: (rows, length), or (rows, length, fragment cap) pooled.

    A shape's first forward runs eagerly and its result is returned: that
    builds the kernels, sets their attributes and caches the rope tables.
    Its inputs then become the graph's static inputs, and the forward is
    captured on a side stream. Every later forward of the shape copies its
    host arrays into those inputs, replays the graph on the current stream
    and returns clones of the graph's outputs, so that results held until a
    fetch stay apart. All the graphs share one memory pool: replays run one
    after another on one stream, and nothing of a replay outlives it but the
    clones. The capture calls ``CUDAGraph.capture_begin`` / ``capture_end``
    itself, because ``torch.cuda.graph`` synchronises the device and empties
    the allocator's caches on every capture, which would stall a call's
    pipeline. ``counts`` holds the replays and the captures so far; each
    replay adds the kernel launches its capture recorded
    (``kernels.add_launches``).
    """

    def __init__(self, module: OpenProvenceModule, device: torch.device):
        self.module = module
        self.device = device
        self.counts = {"graph_replays": 0, "graph_captures": 0}
        self._graphs: dict[tuple, _Graph] = {}
        self._pool = None
        self._stream: torch.cuda.Stream | None = None

    def run(
        self, fn: Callable[..., tuple[torch.Tensor, ...]], *arrays: np.ndarray
    ) -> tuple[torch.Tensor, ...]:
        """``fn`` of the device copies of ``arrays`` (int32, [rows, ...]):
        eagerly for a shape's first forward, then as the graph's replay."""
        key = (fn.__name__, *(a.shape for a in arrays))
        graph = self._graphs.get(key)
        with torch.cuda.device(self.device):
            if graph is None:
                inputs = [torch.from_numpy(a).to(self.device, non_blocking=True) for a in arrays]
                out = fn(*inputs)
                self._graphs[key] = self._capture(fn, inputs, arrays[0].shape[1])
                return out
            for buf, a in zip(graph.inputs, arrays):
                buf.copy_(torch.from_numpy(a), non_blocking=True)
            graph.graph.replay()
        kernels.add_launches(graph.launches)
        self.counts["graph_replays"] += 1
        return tuple(t.clone() for t in graph.outputs)

    def _capture(self, fn, inputs: list[torch.Tensor], seq_len: int) -> _Graph:
        if self._stream is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        with kernels.recorded_launches() as launches, torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                outputs = fn(*inputs)
            finally:
                graph.capture_end()
        self.counts["graph_captures"] += 1
        return _Graph(graph, inputs, outputs, launches, _rope_tables_read(self.module, seq_len))


def _debug_emitter(
    debug_messages: bool | Callable[[str], None],
) -> Callable[[str], None] | None:
    """Map the ``debug_messages`` argument to an emitter: True → logger,
    False → None, callable → itself."""
    if debug_messages is True:
        return _LOG.info
    if debug_messages is False:
        return None
    if callable(debug_messages):
        return debug_messages
    raise TypeError("debug_messages must be a bool or a callable that accepts a string")


class _BlockDispatcher:
    """Buckets prepared block inputs by padded length and runs forwards AS
    BUCKETS FILL, so host fragmentation of later cells overlaps device
    compute of earlier ones (CUDA launches are asynchronous). Results stay on
    the device until a window of ``FETCH_WINDOW`` batches is fetched, so the
    host waits for the device once per window, not once per batch.

    The first batch flushes at half size to put the device to work early.
    With ``pipeline=False`` (one preprocessing slice, so nothing to overlap)
    buckets are dispatched only at ``finish()``. Its phases are spans of the
    call's ``spans`` (``engine.pad``, ``engine.dispatch``, ``engine.fetch``,
    ``engine.attach``), and it counts ``blocks``, ``forwards``,
    ``token_slots``, ``valid_tokens``, and the model's ``graph_replays`` and
    ``graph_captures`` in the call, there.
    """

    FETCH_WINDOW = 256

    def __init__(
        self,
        model: "OpenProvenceModel",
        batch_size: int,
        *,
        use_device_pooling: bool,
        cell_table: dict[tuple[int, int], dict[str, Any]],
        spans: Spans,
        progress: Any = None,
        pipeline: bool = True,
    ):
        self.model = model
        self.batch_size = batch_size
        self.pooling = use_device_pooling
        self.cell_table = cell_table
        self.spans = spans
        self.progress = progress
        self.pipeline = pipeline
        self._buckets = length_buckets(model.max_length, model.bucket_step)
        self._buffers: dict[int, list[dict[str, Any]]] = {}
        self._pending: list[tuple[list[dict[str, Any]], Any]] = []
        self._dispatched = 0
        self._graph_counts = model.graph_counts()

    def add(self, entry: dict[str, Any]) -> None:
        blen = bucket_length(
            min(len(entry["input_ids"]), self.model.max_length), self._buckets
        )
        buf = self._buffers.setdefault(blen, [])
        buf.append(entry)
        self.spans.count("blocks")
        if not self.pipeline:
            return
        # Half-size first flush, never above batch_size — a chunk larger
        # than the padded batch would be truncated by pad_block_batch.
        threshold = (
            min(self.batch_size, max(8, self.batch_size // 2))
            if self._dispatched == 0
            else self.batch_size
        )
        if len(buf) >= threshold:
            self._dispatch(blen, buf[:])
            buf.clear()

    def finish(self) -> None:
        """Dispatch every partial bucket, then fetch and attach everything."""
        for blen in sorted(self._buffers):
            buf = self._buffers[blen]
            for lo in range(0, len(buf), self.batch_size):
                self._dispatch(blen, buf[lo : lo + self.batch_size])
            buf.clear()
        self._drain()
        for name, n in self.model.graph_counts().items():
            self.spans.count(name, n - self._graph_counts[name])

    def _dispatch(self, seq_len: int, chunk: list[dict[str, Any]]) -> None:
        model, spans = self.model, self.spans
        with spans("engine.pad"):
            n_rows = model._bucket_rows(len(chunk), self.batch_size)
            batch_arrays = pad_block_batch(
                chunk, seq_len, n_rows, model.tokenizer.pad_token_id
            )
            spans.count("forwards")
            spans.count("token_slots", n_rows * seq_len)
            spans.count("valid_tokens", batch_arrays["attention_mask"].sum())
            if self.pooling:
                f_cap = model._frag_cap(max(len(e["ranges"]) for e in chunk))
                frag_starts = np.zeros((n_rows, f_cap), dtype=np.int32)
                frag_ends = np.zeros((n_rows, f_cap), dtype=np.int32)
                for row, entry in enumerate(chunk):
                    for j, (frag_lo, frag_hi) in enumerate(entry["ranges"]):
                        frag_starts[row, j] = frag_lo
                        frag_ends[row, j] = frag_hi
        with spans("engine.dispatch"):
            if self.pooling:
                res = model._forward_pooled(
                    batch_arrays["input_ids"], batch_arrays["attention_mask"],
                    frag_starts, frag_ends,
                )
            else:
                res = model._forward(
                    batch_arrays["input_ids"], batch_arrays["attention_mask"]
                )
        self._pending.append((chunk, res))
        self._dispatched += 1
        if self.progress is not None:
            self.progress.update(1)
        if len(self._pending) >= self.FETCH_WINDOW:
            self._drain()

    def _drain(self) -> None:
        if not self._pending:
            return
        with self.spans("engine.fetch"):
            # The first copy waits for the device; the rest are already done.
            fetched = [
                tuple(t.cpu().numpy() for t in res) for _, res in self._pending
            ]
        with self.spans("engine.attach"):
            for (chunk, _), (rank, values) in zip(self._pending, fetched):
                for row, entry in enumerate(chunk):
                    work = entry["job"]
                    ranges = np.asarray(entry["ranges"], dtype=np.int64).reshape(-1, 2)
                    if self.pooling:
                        scores = BlockScores(
                            order=work["block_idx"],
                            rank=float(rank[row]),
                            fragment_gids=entry["gids"],
                            fragment_spans=ranges,
                            fragment_means=values[row][: len(entry["ranges"])],
                        )
                    else:
                        scores = BlockScores(
                            order=work["block_idx"],
                            rank=float(rank[row]),
                            fragment_gids=entry["gids"],
                            fragment_spans=ranges,
                            token_probs=values[row][: len(entry["input_ids"])],
                        )
                    self.cell_table[(work["query_idx"], work["context_idx"])][
                        "raw_blocks"
                    ].append(scores)
        self._pending.clear()


class OpenProvenceRawPrediction:
    """Raw pruning outputs for a (query, contexts) pair
    (standalone:451-459)."""

    def __init__(
        self,
        query: str,
        contexts: list[str],
        ranking_score: float | None,
        pruning_probs: np.ndarray,
        context_ranges: list[tuple[int, int]],
    ):
        self.query = query
        self.contexts = contexts
        self.ranking_score = ranking_score
        self.pruning_probs = pruning_probs
        self.context_ranges = context_ranges


class OpenProvenceModel:
    """Inference runtime: config + module + tokenizer on one device, or on
    each rank of a mesh."""

    def __init__(
        self,
        config: OpenProvenceConfig,
        state_dict: Mapping[str, torch.Tensor],
        tokenizer: Any,
        *,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        attention_impl: str = "auto",
        bucket_step: int | None = None,
        mesh: Mesh | None = None,
        tensor_parallel: bool = False,
        device_pooling: bool = True,
    ):
        """``state_dict`` has the reference checkpoint names (see
        ``utils/convert.py``). ``device`` defaults to the first CUDA card and
        raises where there is none: the CPU is taken only when asked for with
        ``device="cpu"``. ``dtype`` defaults to bf16 on CUDA and to the
        weights' own dtype on the CPU. ``attention_impl`` must be one of
        ``auto``, ``xla``, ``pallas`` and is then ignored: the port runs one
        attention kernel for every shape. ``bucket_step`` is the length
        bucket granularity (None: ``DEFAULT_BUCKET_STEP``). ``mesh``
        (``parallel.create_mesh``) splits each forward's rows over its data
        axis and, with
        ``tensor_parallel``, the weights over its model axis; every rank
        calls ``process()`` alike and gets the whole result."""
        check_attention_impl(attention_impl)
        self.config = config
        self.mesh = mesh
        self._data_axis = mesh.data if mesh is not None else 1
        self.device, self.module = place_module(
            config, state_dict, device, dtype, mesh, tensor_parallel
        )
        self._graphs = (
            _ForwardGraphs(self.module, self.device)
            if graph_route(self.device, mesh, tensor_parallel)
            else None
        )
        self.tokenizer = (
            tokenizer
            if isinstance(tokenizer, TokenizerAdapter)
            else TokenizerAdapter(tokenizer, max_length=config.max_length)
        )
        self.max_length = int(config.max_length)
        self.default_threshold = config.default_threshold
        self.attention_impl = attention_impl
        self.bucket_step = int(DEFAULT_BUCKET_STEP if bucket_step is None else bucket_step)
        # Device-side fragment mean pooling (ops/segment.py): exact only when
        # no title-prefix offset correction applies; the engine falls back to
        # token-prob transfer otherwise.
        self.device_pooling = bool(device_pooling)

    # --- loading -------------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls,
        path: str | Path,
        *,
        dtype: torch.dtype | None = None,
        attention_impl: str = "auto",
        max_length: int | None = None,
        tokenizer: Any = None,
        device: torch.device | str | None = None,
        **kwargs: Any,
    ) -> "OpenProvenceModel":
        """Load a reference-layout checkpoint directory (config.json +
        model.safetensors in any layout ``utils/hf_convert.py`` accepts, and
        tokenizer files when ``tokenizer`` is None, read with transformers'
        ``AutoTokenizer``). ``device`` and ``dtype`` as in the constructor:
        the first CUDA card and bf16 there by default. ``attention_impl`` is
        the JAX engine's choice of attention route, checked (before the
        weights are read) and ignored as in the constructor. ``kwargs`` go
        to the constructor (``bucket_step``, ``mesh``, ``tensor_parallel``,
        ``device_pooling``)."""
        from ..utils.hf_convert import load_checkpoint

        check_attention_impl(attention_impl)
        config, state_dict = load_checkpoint(path)
        if max_length is not None:
            config.max_length = int(max_length)
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(str(path))
        return cls(config, state_dict, tokenizer, dtype=dtype, device=device,
                   attention_impl=attention_impl, **kwargs)

    # --- device forward -------------------------------------------------------

    def _inputs(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        return [torch.from_numpy(a).to(self.device, non_blocking=True) for a in arrays]

    def _bucket_rows(self, n: int, batch_size: int) -> int:
        """Pad the row count to a power of two (capped at batch_size) and,
        under a mesh, to a multiple of the data axis."""
        rows = bucket_batch(n, batch_size)
        d = self._data_axis
        return -(-rows // d) * d

    def _my_rows(self, *arrays: np.ndarray) -> list[np.ndarray]:
        """This data rank's share of each array's rows."""
        if self._data_axis == 1:
            return list(arrays)
        share = arrays[0].shape[0] // self._data_axis
        lo = self.mesh.data_rank * share
        return [a[lo : lo + share] for a in arrays]

    def _gather_rows(self, *local: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Every data rank's rows of each output, in order, on every rank:
        each rank writes its rows into a zero buffer and the buffers are
        summed (an all-reduce, which gloo also takes on CUDA tensors where
        ranks share a card; its all_gather takes only CPU tensors)."""
        if self._data_axis == 1:
            return local
        out = []
        for t in local:
            full = t.new_zeros((t.shape[0] * self._data_axis, *t.shape[1:]))
            full[self.mesh.data_rank * t.shape[0] : (self.mesh.data_rank + 1) * t.shape[0]] = t
            out.append(self.mesh.all_reduce(full, DATA_AXIS))
        return tuple(out)

    def graph_counts(self) -> dict[str, int]:
        """The forwards served by a CUDA graph's replay and the graphs
        captured so far (none off the graph route)."""
        return dict(self._graphs.counts) if self._graphs is not None else {}

    @torch.inference_mode()
    def _forward(
        self, input_ids: np.ndarray, attention_mask: np.ndarray
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One bucketed forward: ([B] ranking scores, [B, S] keep probs),
        fp32, left on the device (under a mesh, every data rank's rows)."""
        if self._graphs is not None:
            return self._graphs.run(self._scores_on_device, input_ids, attention_mask)
        ranking, keep = forward_logits(
            self.module, self.device, *self._my_rows(input_ids, attention_mask)
        )
        return self._gather_rows(ranking_score_from_logits(ranking), keep)

    def _scores_on_device(
        self, ids: torch.Tensor, mask: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        ranking, keep = device_logits(self.module, ids, mask)
        return ranking_score_from_logits(ranking), keep

    def _pooled_on_device(
        self, ids: torch.Tensor, mask: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        rank, keep = self._scores_on_device(ids, mask)
        return rank, fragment_means(keep, starts, ends)

    @staticmethod
    def _frag_cap(n_frags: int) -> int:
        """Bucket the per-row fragment capacity (power of two, min 16) so
        [B, F] transfers stay F-sized instead of seq_len-sized."""
        cap = 16
        while cap < n_frags:
            cap *= 2
        return cap

    @torch.inference_mode()
    def _forward_pooled(
        self,
        input_ids: np.ndarray,
        attention_mask: np.ndarray,
        frag_starts: np.ndarray,
        frag_ends: np.ndarray,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Forward + on-device fragment mean pooling: ([B] scores, [B, F]
        fragment means). Empty slots (start == end) come back as 1.0 — the
        keep-everything sentinel the postprocess expects."""
        if self._graphs is not None:
            return self._graphs.run(
                self._pooled_on_device, input_ids, attention_mask, frag_starts, frag_ends
            )
        rank, keep = self._forward(input_ids, attention_mask)
        return rank, fragment_means(keep, *self._inputs(frag_starts, frag_ends))

    def warmup(
        self,
        batch_size: int | None = None,
        lengths: Sequence[int] | None = None,
        *,
        include_pooled: bool = True,
        fragment_caps: Sequence[int] = (16,),
    ) -> list[tuple[int, ...]]:
        """Run the forwards ``process()`` will dispatch, so the first request
        does not pay for building the kernels or for first-use allocations:
        one full batch per bucket length (every length of the bucket table by
        default), its rows padded by the dispatcher's rule, and, when
        ``include_pooled`` and device pooling is on, the pooled forward at
        each of ``fragment_caps`` rounded as the dispatcher rounds a row's
        fragment count. ``batch_size=None`` is ``process()``'s default. On
        the graph route each shape's forward is also captured as its CUDA
        graph. Returns the (rows, length) and (rows, length, fragment cap)
        shapes run, as the JAX engine's ``warmup`` returns its compiled
        keys."""
        if batch_size is None:
            batch_size = DEFAULT_BATCH_SIZE
        if lengths is None:
            lengths = length_buckets(self.max_length, self.bucket_step)
        rows = self._bucket_rows(batch_size, batch_size)
        warmed: list[tuple[int, ...]] = []
        for seq_len in lengths:
            ids = np.zeros((rows, seq_len), dtype=np.int32)
            mask = np.ones((rows, seq_len), dtype=np.int32)
            for t in self._forward(ids, mask):
                t.cpu()
            warmed.append((rows, seq_len))
            if include_pooled and self.device_pooling:
                for cap in fragment_caps:
                    f_cap = self._frag_cap(int(cap))
                    starts = np.zeros((rows, f_cap), dtype=np.int32)
                    for t in self._forward_pooled(ids, mask, starts, starts):
                        t.cpu()
                    warmed.append((rows, seq_len, f_cap))
        return warmed

    # --- raw prediction APIs ---------------------------------------------------

    def get_raw_predictions(
        self, query: str, contexts: Sequence[str]
    ) -> OpenProvenceRawPrediction:
        return self.get_raw_predictions_batch(query, [list(contexts)])[0]

    def _queries_for_batch(
        self, query: str | Sequence[str], n_rows: int
    ) -> list[str]:
        """Broadcast a scalar query / validate a per-row query list."""
        if isinstance(query, str) or not isinstance(query, Sequence):
            return [str(query)] * n_rows
        rows = [str(entry) for entry in query]
        if len(rows) != n_rows:
            raise ValueError(
                "When providing multiple queries, their count must match contexts_batch."
            )
        return rows

    def get_raw_predictions_batch(
        self,
        query: str | Sequence[str],
        contexts_batch: Sequence[Sequence[str]],
        batch_size: int | None = None,
    ) -> list[OpenProvenceRawPrediction]:
        """Joint forward over ``query [SEP] ctx0 ctx1 …`` rows, returning
        per-token keep probabilities (fp32 numpy) plus each context's token
        range (behavior of standalone:1752-1841)."""
        if not contexts_batch:
            return []
        step = batch_size if batch_size and batch_size > 0 else len(contexts_batch)
        queries = self._queries_for_batch(query, len(contexts_batch))
        sep = self.tokenizer.sep_token or ""
        buckets = length_buckets(self.max_length, self.bucket_step)

        out: list[OpenProvenceRawPrediction] = []
        for lo in range(0, len(contexts_batch), step):
            rows = [
                (queries[i], [str(c) for c in contexts_batch[i]])
                for i in range(lo, min(lo + step, len(contexts_batch)))
            ]
            id_rows = self.tokenizer.tokenizer(
                [q + sep + "".join(ctxs) for q, ctxs in rows],
                padding=False,
                truncation=True,
                max_length=self.max_length,
            )["input_ids"]
            longest = max((len(ids) for ids in id_rows), default=1)
            padded = pad_block_batch(
                [{"input_ids": ids, "attention_mask": [1] * len(ids)} for ids in id_rows],
                bucket_length(longest, buckets),
                self._bucket_rows(len(id_rows), max(len(id_rows), 1)),
                self.tokenizer.pad_token_id,
            )
            rank, keep = (
                t.cpu().numpy()
                for t in self._forward(padded["input_ids"], padded["attention_mask"])
            )
            for row_idx, (q, ctxs) in enumerate(rows):
                if not ctxs:
                    continue
                out.append(
                    OpenProvenceRawPrediction(
                        query=q,
                        contexts=ctxs,
                        ranking_score=float(rank[row_idx]),
                        pruning_probs=keep[row_idx][: len(id_rows[row_idx])],
                        context_ranges=self._token_windows_per_context(q, ctxs),
                    )
                )
        return out

    def _token_windows_per_context(
        self, query: str, contexts: Sequence[str]
    ) -> list[tuple[int, int]]:
        """Token range of each context inside the joint encoding, found by
        encoding the cumulative prefixes in one batched tokenizer call
        (behavior of standalone:1926-1969)."""
        if not contexts:
            return []
        head = query + (self.tokenizer.sep_token or "")
        growing: list[str] = []
        acc = head
        for ctx in contexts:
            acc += ctx
            growing.append(acc)
        encoded = self.tokenizer.tokenizer(
            growing, padding=False, truncation=True, max_length=self.max_length
        )
        edges = [len(ids) for ids in encoded["input_ids"]]
        head_len = len(
            self.tokenizer.tokenizer([head], padding=False, truncation=False)["input_ids"][0]
        )
        return list(zip([head_len, *edges[:-1]], edges))

    def predict_with_thresholds(
        self,
        query: str,
        contexts: Sequence[str],
        thresholds: Sequence[float],
        *,
        use_majority: bool = False,
    ) -> dict[str, Any]:
        """Per-context keep decisions swept over thresholds (behavior of
        standalone:1843-1881): mean-probability rule by default, majority of
        per-token votes with ``use_majority``. Empty token ranges always
        predict keep. The forward runs once."""
        raw_pred = self.get_raw_predictions(query, contexts)
        probs = np.asarray(raw_pred.pruning_probs, dtype=np.float32)
        spans = np.asarray(raw_pred.context_ranges, dtype=np.int64).reshape(-1, 2)
        sizes = np.maximum(spans[:, 1] - spans[:, 0], 0)
        running = np.concatenate([[0.0], np.cumsum(probs, dtype=np.float64)])
        sums = running[np.minimum(spans[:, 1], len(probs))] - running[
            np.minimum(spans[:, 0], len(probs))
        ]
        means = np.divide(sums, np.maximum(sizes, 1))

        by_threshold: dict[float, list[int]] = {}
        for th in thresholds:
            if use_majority:
                votes = np.array(
                    [
                        np.count_nonzero(probs[lo:hi] > th)
                        for lo, hi in raw_pred.context_ranges
                    ]
                )
                decided = votes >= sizes / 2
            else:
                decided = means > th
            by_threshold[th] = np.where(sizes == 0, 1, decided.astype(int)).tolist()
        return {
            "query": raw_pred.query,
            "contexts": raw_pred.contexts,
            "ranking_score": raw_pred.ranking_score,
            "predictions": by_threshold,
            "context_ranges": raw_pred.context_ranges,
            "pruning_probs": raw_pred.pruning_probs,
        }

    # --- process() --------------------------------------------------------------

    def _prep_cell(
        self,
        query_idx: int,
        context_idx: int,
        context_entry: Any,
        title_spec: Any,
    ) -> dict[str, Any]:
        """Preprocessing unit for one (query, context) cell: title prefixes
        resolved, sentence splitting deferred to the fragmentize stage."""
        manual: list[str] | None = None
        if isinstance(context_entry, list):
            manual = [str(s) for s in context_entry if str(s).strip()]
            text = "".join(manual)
        else:
            text = context_entry
        prefixes, title_is_first = resolve_prefix_sentences(title_spec, context_idx)
        return {
            "query_idx": query_idx,
            "context_idx": context_idx,
            "context_text": text,
            "prefix_sentences": prefixes,
            "title_is_first_sentence": title_is_first,
            "manual_sentences": manual,
        }

    def _plan_preprocessing(
        self,
        queries: list[str],
        contexts: list[list[Any]],
        titles: list[Any],
    ) -> tuple[list[dict[str, Any]], list[list[int]]]:
        """Flatten the (query, context) grid into preprocessing jobs and
        encode each query once (behavior of standalone:2436-2519)."""
        encoded_queries = [
            list(ids) for ids in tokenize_sentences(self.tokenizer, [str(q) for q in queries])
        ]
        jobs = [
            self._prep_cell(q_idx, c_idx, entry, titles[q_idx])
            for q_idx, group in enumerate(contexts)
            for c_idx, entry in enumerate(group)
        ]
        return jobs, encoded_queries

    def _cell_blocks(
        self,
        job: dict[str, Any],
        entry: dict[str, Any],
        encoded_queries: list[list[int]],
        sep_ids: list[int],
    ) -> tuple[tuple[int, int], dict[str, Any], list[dict[str, Any]]]:
        """One job's fragments → blocks + inference jobs
        (standalone:2649-2759)."""
        fragments = fragments_from_payload(entry)
        query_idx, context_idx = job["query_idx"], job["context_idx"]
        blocks = assemble_blocks(
            self.tokenizer,
            self.max_length,
            len(encoded_queries[query_idx]),
            len(sep_ids),
            fragments,
        )
        info = {
            "sentences": entry.get("sentences", []),
            "fragments": fragments,
            "blocks": blocks,
            "prefix_length": len(job.get("prefix_sentences", [])),
            "prefix_sentences": job.get("prefix_sentences", []),
            "prefix_token_counts": entry.get("prefix_token_counts", []),
            "title_is_first_sentence": job.get("title_is_first_sentence", False),
            "original_text": job["context_text"],
            "raw_blocks": [],
        }
        block_work = [
            {"query_idx": query_idx, "context_idx": context_idx, "block_idx": block_idx}
            for block_idx in range(len(blocks))
        ]
        return (query_idx, context_idx), info, block_work

    def _prepare_block(
        self,
        work: dict[str, Any],
        query_ids: list[int],
        block_fragments: list[FragmentRecord],
        start_cache: dict[int, int] | None = None,
    ) -> dict[str, Any]:
        """Host-side inputs for one block: token ids, mask, fragment token
        ranges and fragment global ids. ``start_cache`` memoizes the
        context-start offset per query token length."""
        hint = None if start_cache is None else start_cache.get(len(query_ids))
        input_ids, attention_mask, _token_type_ids, ranges = (
            self.tokenizer.prepare_block_inputs(
                query_ids,
                block_fragments,
                want_token_type_ids=False,
                context_start_hint=hint,
            )
        )
        if start_cache is not None and hint is None and ranges:
            start_cache[len(query_ids)] = int(ranges[0][0])
        return {
            "job": work,
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "ranges": ranges,
            "gids": np.array([f.global_index for f in block_fragments], dtype=np.int64),
        }

    def process(
        self,
        question: str | Sequence[str],
        context: Any,
        title: Any = "first_sentence",
        first_line_as_title: bool = False,
        *,
        batch_size: int | None = None,
        threshold: float | None = None,
        always_select_title: bool = False,
        reorder: bool = False,
        top_k: int | None = None,
        sentence_splitter: SentenceSplitter | Mapping[str, SentenceSplitter] | None = None,
        language: str | None = None,
        use_best_reranker_score: bool = True,
        zero_score_when_empty: bool = True,
        show_progress: bool = True,
        debug_messages: bool | Callable[[str], None] = False,
        enable_warnings: bool = True,
        strip_sentences: bool = False,
        respect_sentence_boundaries: bool = False,
        return_sentence_metrics: bool = False,
        return_sentence_texts: bool = False,
        show_inference_progress: bool | None = None,
        preprocess_workers: int | None = None,
        preprocess_batch_size: int | None = None,
        torch_dataloader_kwargs: Mapping[str, Any] | None = None,
    ) -> dict[str, Any]:
        """Prune long contexts while preserving sentence boundaries.

        Argument semantics match the reference's ``process()``
        (standalone:3314-3406) and the JAX package's. ``batch_size=None``
        takes 32 rows a forward and 0 takes one, as in the JAX engine; row
        counts pad to powers of two capped at the batch size.
        ``preprocess_workers`` selects thread-parallel
        fragmentation, auto-tuned from the job count and device memory when
        unset (preprocess_tuning.py). ``torch_dataloader_kwargs`` is
        accepted for drop-in compatibility but unused (a warning says so
        unless ``enable_warnings=False``).
        """
        spans = Spans()
        with spans("engine.process"):
            with spans("engine.plan"):
                warn: Callable[[str], None] = (
                    _LOG.warning if enable_warnings else (lambda _msg: None)
                )
                if torch_dataloader_kwargs:
                    warn(
                        "torch_dataloader_kwargs is accepted for reference "
                        "compatibility but has no effect (no torch DataLoader here)."
                    )
                batch_size = DEFAULT_BATCH_SIZE if batch_size is None else max(batch_size, 1)
                threshold = self.config.resolve_threshold(threshold)
                splitter = resolve_sentence_splitter(sentence_splitter, language)
                emit_debug = _debug_emitter(debug_messages)
                if show_inference_progress is None:
                    show_inference_progress = bool(show_progress)

                queries, contexts, structure = normalize_inputs(question, context)
                contexts, titles = resolve_titles(
                    queries, contexts, title, first_line_as_title=first_line_as_title
                )
                max_fragment_tokens = max_fragment_tokens_for(
                    self.max_length, respect_sentence_boundaries
                )
                sep_ids = self.tokenizer.sep_token_ids()
                prep_jobs, encoded_queries = self._plan_preprocessing(queries, contexts, titles)

                def _fragmentize_chunk(jobs: list[dict[str, Any]]) -> list[dict[str, Any]]:
                    return fragmentize_jobs(
                        self.tokenizer,
                        jobs,
                        max_fragment_tokens=max_fragment_tokens,
                        splitter=splitter,
                        strip_sentences=strip_sentences,
                        respect_sentence_boundaries=respect_sentence_boundaries,
                        # Applies the empty-decode filter the keep decisions
                        # depend on while decoding only undecidable fragments.
                        decode_fragments="filter_only",
                    )

                from .preprocess_tuning import (
                    auto_tune_preprocess_loader,
                    estimate_device_memory_bytes,
                    resolve_preprocess_workers,
                )

                workers, chunk_size, _prefetch = auto_tune_preprocess_loader(
                    total_jobs=len(prep_jobs),
                    inference_batch_size=batch_size,
                    current_workers=resolve_preprocess_workers(preprocess_workers),
                    current_preprocess_batch=preprocess_batch_size,
                    device_memory_bytes=estimate_device_memory_bytes(self.device),
                )
                span = max(1, int(chunk_size or 1))
                slices = [prep_jobs[i : i + span] for i in range(0, len(prep_jobs), span)]

                def _entries():
                    """Fragmentized entries in job order, yielded lazily so
                    the dispatcher can put the device to work while later
                    cells are still being tokenized."""
                    if workers > 0 and len(slices) > 1:
                        from concurrent.futures import ThreadPoolExecutor

                        with ThreadPoolExecutor(max_workers=workers) as pool:
                            for batch in pool.map(_fragmentize_chunk, slices):
                                yield from batch
                    else:
                        for jobs in slices:
                            yield from _fragmentize_chunk(jobs)

                # Device pooling is exact only when the title-prefix offset
                # correction never applies (standalone:3075-3081).
                use_device_pooling = self.device_pooling and all(
                    not job["prefix_sentences"] for job in prep_jobs
                )
                progress = None
                if show_inference_progress:
                    try:
                        from tqdm import tqdm

                        progress = tqdm(desc="Model inference", unit="batch", leave=False)
                    except ImportError:
                        progress = None

                # The half-size early flush only pays when later chunks are
                # still fragmentizing while the device works;
                # OPEN_PROVENCE_TPU_PIPELINE=0 turns it off, as in the JAX
                # engine.
                dispatcher = _BlockDispatcher(
                    self,
                    batch_size,
                    use_device_pooling=use_device_pooling,
                    cell_table=(cell_table := {}),
                    spans=spans,
                    progress=progress,
                    pipeline=(
                        os.environ.get("OPEN_PROVENCE_TPU_PIPELINE", "1") != "0"
                        and len(slices) > 1
                    ),
                )
                context_start_cache: dict[int, int] = {}
                entries = _entries()

            for job in prep_jobs:
                with spans("engine.fragments"):
                    entry = next(entries)
                    for stage in FRAGMENT_STAGES:
                        spans.add(stage, entry.pop(f"timing_{stage}", 0.0))
                with spans("engine.assembly"):
                    key, info, works = self._cell_blocks(job, entry, encoded_queries, sep_ids)
                    cell_table[key] = info
                    prepared = [
                        self._prepare_block(
                            work,
                            encoded_queries[key[0]],
                            info["blocks"][work["block_idx"]],
                            start_cache=context_start_cache,
                        )
                        for work in works
                    ]
                for block_entry in prepared:
                    dispatcher.add(block_entry)
            with spans("engine.fragments"):
                entries.close()  # shuts the worker pool down

            dispatcher.finish()
            if progress is not None:
                progress.close()
            blocks = spans.counts.get("blocks", 0)
            if show_progress and blocks:
                host_seconds = spans.seconds["engine.dispatch"] + spans.seconds["engine.fetch"]
                note = (
                    "[OpenProvenceModel] Host time launching the forwards and waiting "
                    f"for the device (not device time): {host_seconds:.2f}s ({blocks} blocks)"
                )
                (emit_debug or (lambda m: print(m, flush=True)))(note)

            with spans("engine.post"):
                outcomes = summarize_contexts(
                    queries,
                    contexts,
                    cell_table,
                    threshold=threshold,
                    always_select_title=always_select_title,
                    use_best_reranker_score=use_best_reranker_score,
                    first_line_as_title=first_line_as_title,
                    zero_score_when_empty=zero_score_when_empty,
                )
                if reorder:
                    outcomes = reorder_outcomes(outcomes, top_k=top_k)

            with spans("engine.payload"):
                payload = build_payload(
                    structure,
                    outcomes,
                    include_sentence_texts=return_sentence_texts,
                    include_sentence_probs=return_sentence_metrics,
                )

        trace = ProcessPerformanceTrace.from_spans(spans)
        if emit_debug is not None:
            emit_debug(f"[OpenProvenceModel] {trace.timing_line()}")
        payload["timing"] = trace.as_dict()
        payload["performance_trace"] = trace
        return payload
