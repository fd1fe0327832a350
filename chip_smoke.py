#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (open_provence_tpu_torch) once on one NVIDIA
card and check it, in phases:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the fourteen hand-written kernels from kernels/csrc with nvcc, and
   the host library of native/;
3. each forward kernel against its plain PyTorch version on the card, at
   the ModernBERT-base shapes the engine dispatches (M = B·S for B in 1/8/32
   and S in 64/192/512, ragged padding, global and ±64 windows), fp32 and
   bf16; the kernels of the bias-carrying layouts (GeGLU without a norm,
   add + LayerNorm) at M = 16384 and a ragged M; the GEMM engine's edge
   cases (M = 64, 16384 - 37, 16384; an output width of one tile and a
   ragged one; K = 768 and a K that is no multiple of 64; every GeGLU
   activation; two bf16 launches bit-equal), and the bare products on
   torch.matmul timed beside kernels 2, 4, 6, 11 and 12;
3b. each backward kernel against its plain version at the training shapes
   (B=32, S=512), fp32 and bf16, with kernel and plain times; the LayerNorm
   adjoint with the residual cotangent gh, at K = 768, 1024 and a strided
   width (264), each twice bit-equal; the edge cases of kernels 11 and
   12 (M = 64, 77, 16384 - 37, 16384; dW row counts 256 and ragged 456 /
   464; K = 768 and 200; every GeGLU activation; fp32 and bf16; two bf16
   launches bit-equal);
3c. the attention kernels, forward and backward, at S = 1024, 2048, 4096
   and a ragged 1100 (window ±64 and global, ragged masks, a padding row),
   fp32 and bf16; then, for every head layout, what tiles, an asynchronous
   ring and skipped key tiles make fragile: S = 65, 513, 1100, B = 1,
   windows 0, 16, 128 and one past S, masks with holes and a wholly padded
   stretch inside a valid row, batches whose rows are all short, the
   backward twice, bit-equal; times at B=8, S=2048; the one-call PyTorch
   counterparts (F.layer_norm, scaled_dot_product_attention and their
   backwards) timed beside the kernels, and each kernel's bound;
3d. attention on separate q, k, v (kernels 9 and 16) against its plain
   version for every head layout of width 768 (24 x 32, 12 x 64, 6 x 128,
   3 x 256) at B=32, S=512 and, for D = 32 and 256, at B=8, S=2048: fp32 and
   bf16, global and +-64, ragged masks with a padding row, on contiguous
   tensors, on strided views of a packed buffer and through the packed
   wrapper on that buffer; times, bounds and the library call per shape;
3e. the whole MLP in one kernel (kernels 8 and 13) against its plain version
   at M = 16384 and a ragged M, fp32 and bf16, every activation, with times
   beside the split path's (kernel 4 or 11 and the library's Wo products)
   and the bf16 design (kernels.built_mlp_tail_design);
4. the whole model at base width on seeded random weights: fp32 on the card
   against fp32 on the CPU (plain versions), and bf16 on the card against
   the same CPU result;
5. ``process()`` in bf16 on the card — the serving path — with every
   forward kernel's launch count read around it; threshold 0 reproduces the
   input, threshold 1 prunes everything; then fp32 card against fp32 CPU on
   8 pairs;
6. timings: per-kernel time beside its plain version's, the forward in
   pairs/s at B=32, S=512, and process() on 256 pairs in pairs/s;
7. two fp32 training steps of the 22-layer model at B=2, S=512 (one
   padding pair), card against CPU: the loss and every gradient tensor,
   and the card's adafactor update against the CPU optimizer's on the
   card's own inputs;
8. the training path: 20 bf16 steps at B=32, S=512 on seeded collated
   pairs — the eval loss on them falls, all eight kernels launch and no
   plain version runs — then train pairs/s on the kernels and on the plain versions, a
   profile of a step, a checkpoint resume that reproduces the next step,
   and ``process()`` served from the trained weights;
9. long context: ``process()`` at max_length 2048 in bf16 on pairs that
   fill the 2048 bucket (launch counts, threshold 0 and 1, pairs/s and
   tokens/s), fp32 card against CPU on a few pairs; then a trainer at B=8,
   S=2048: one fp32 step card against CPU at 3 layers, and bf16 steps at
   22 layers with train pairs/s and tokens/s;
10. the bias-carrying checkpoint layouts (norm_bias; mlp_bias with
   attention_bias) at base width: fp32 card against CPU, ``process()`` and
   20 training steps each, with the launch counts of their kernels;
11. head layouts the packed TPU kernel refuses (24 heads of 32; 3 heads of
   256) at base width: fp32 card against CPU (the model; keep/drop flips
   and one training step on the first 3 layers), ``process()`` on 256 pairs
   and 20 bf16 training steps,
   with kernels 9 and 16 launched and no plain version;
12. the whole-MLP fusion (gate OPEN_PROVENCE_TPU_FUSED_MLP_TAIL): the
   forward with the gate at 0, 1 and bwd in turns, the training step's
   wall and device time at each once; with 1: ``process()``, fp32 card
   against CPU (as in 11), training steps and the bit-exact resume; with
   bwd: the training steps again;
13. the checkpoint and encoder entry points at base width, bf16,
   max_length 512: phase 4's weights written by the trainer's export_model,
   by the encoder's save_pretrained and in the legacy root-level and
   flat-backbone layouts; ``OpenProvenceModel.from_pretrained`` on each
   serves phase 5's 256 pairs with the state-dict model's bits; the encoder
   from_pretrained (predict, predict_with_pruning at thresholds 0 and 1,
   prune_texts, predict_context) and the engine's get_raw_predictions_batch
   and predict_with_thresholds on 64 pairs; both paths launch kernels 1-4
   and no plain version; the bf16 encoder against the fp32 CPU encoder on
   16 of the pairs; fp32 card against CPU on 8 pairs; encoder.predict
   pairs/s at B=32, S=512;
14. the training entry point at base width: parse_config_file,
   apply_cli_overrides and runner.train on a ModernBERT backbone directory
   of phase 4's weights and two JSON-lines sources (20 bf16 steps of 32
   pairs of 512), its eval_datasets hook evaluating the final model on the
   card after the trainer is released; a resume from checkpoint-10; fp32
   card against CPU through the runner on the backbone's first 3 layers
   (P14_FP32_LAYERS); every backbone dropout at 0.1; each step timed;
15. the release surface at base width, bf16: both HF-style wrappers from
   phase 13's trainer export at B=32 S=512, B=1 S=77 and B=3 S=300, their
   logits bit-equal to the engine's forward_logits, and their fp32 losses
   card against CPU on 8 pairs; the standalone bundle written into a copy of
   that checkpoint and served on phase 5's 256 pairs in a process of its
   own without the repository on sys.path, its kernels built from its own
   sources into an empty build directory, bit-equal to the in-repo
   package; the eval-only mode of the trainer's CLI on phase 14's final
   model (both reports, contexts/s) and fp32 card against CPU span
   decisions on 8 queries;
16. the mesh (data and tensor parallelism over torch.distributed): kernels
   2, 3, 4, 11, 12 and 14 at the widths a rank of a tp = 2 mesh gives them
   (Wqkv's 1152 rows, 6 heads of 64, 576 intermediate columns) against
   their plain versions, with bf16 times; then four ranks spawned on the
   one card over gloo: phase 8's batch trained in fp32 for 3 steps at base
   width on the first 3 layers (P16_FP32_LAYERS) under meshes 2 x 1 and
   1 x 2 (side by side on ranks {0, 1} and {2, 3}) and 2 x 2, each held to
   one process on the same batch
   and weights (losses 1e-4 relative, the update over the run 1e-3 of each
   tensor's largest); 2 bf16 steps under 2 x 2 (every default kernel
   launched on every rank, no plain version); phase 5's 256 pairs served
   under 2 x 1 in bf16 and, on the first 3 layers (CPU_CHECK_LAYERS: gloo
   carries every activation sum through the host), 1 x 2 in fp32, against
   one process; no rank imports jax; dryrun_multichip(4) on the card;
17. the data factory and the MLDR evaluation at base width, bf16, from
   phase 14's final model with the char-level tokenizers, on JSON-lines
   data: datasets_factory/cli.py's generate, frequency_filter,
   add_context_spans_relevance (the encoder teacher) and
   add_reranker_teacher_scores on 64 sentence-transformers rows with 8
   planted duplicates (``factory_512``: the carved splits, the dropped rows,
   one flag a span, a teacher score a text); eval/mldr_cli.py on 16 MLDR
   queries of 1 positive and 3 negatives of 4000-8000 characters, half
   titled, with a stand-in judge, its stage-skip rerun, --text-source
   original and --threshold 0 (``mldr_512``: 64 records, 16 positives
   judged, passages/s); each path launches kernels 1-4 and no plain
   version; fp32 card against CPU at 3 layers (span flags and teacher
   scores on 8 rows; process() scores and keep flips on 2 queries).

The library's attention (``scaled_dot_product_attention``) is timed beside
the kernels at every shape of phases 3c and 3d, global and +-64 (a boolean
band-and-padding mask: one dense call for the same function).

``python3 chip_smoke.py --rates [TREE]`` measures only the serving and
training rates at B=32, S=512 of the package under TREE (default: this
checkout), so that two trees can be compared inside one call.
``python3 chip_smoke.py --attention [TREE]`` builds TREE's kernels, prints
the attention units' ptxas report, a digest of each kernel's machine code
and the designs, runs the edge cases of phase 3c and times the attention
forward and backward in bf16 at the shapes of the table of TPU kernels
(packed and unpacked wrappers, each launch from torch.profiler, the host's
time to issue a call, the library call beside them). ``python3 chip_smoke.py
--layouts [TREE]`` profiles the forward and the training step of phase 11's
head layouts. ``python3 chip_smoke.py --same-buffers TREE`` imports TREE's
package beside this checkout's into one process and times both trees'
attention kernels in turns on the same tensors at the shapes of
``--attention``, then their LayerNorm adjoint (kernel 10; kernels 12, 11
and 13 whole and launch by launch), forward LayerNorm kernels (1, 7) and
whole-MLP kernels (8, 13; launch by launch, beside this tree's split
paths).
``python3 chip_smoke.py --ln-adjoint [TREE]`` checks the LayerNorm adjoint
at its widths and row counts, prints its ptxas report and design, and
times it at every width in both types beside its bound, and kernels 12, 11
and 13 launch by launch.
``python3 chip_smoke.py --gemm [TREE]``
does the same for the GEMM engine: its units' ptxas report, the design of
every layout, phase 3's GEMM edge cases, kernels 2, 4 and 6 in bf16 at
M = 16384 beside torch.matmul on the same product, then kernels 12, 11 and
13: each whole call, each of its launches on its own (normalize, the recomputed
projection, the GeGLU chain, dW, dW's chunk sum, dy, the LN adjoint; from
torch.profiler) beside torch.matmul on each bare product, kernel 12 with
dW cut into 1 to 14 chunks, and phase 3b's backward edge cases.

``python3 -m torch.distributed.run --nproc-per-node 4 chip_smoke.py
--mesh-cards`` runs the mesh across four cards, one rank a card, under the
process group the trainer's CLI starts (nccl): phase 16's fp32 training and
fp32 serving under 2 x 2 against one process on rank 0's card.

Every phase prints a line; any failure raises and the script exits
non-zero without printing a result. The line before the last is the JSON
kernel table; the last is {"ok": true, "device": {...}}.

Usage (from the repository root, on a machine with one CUDA card):
    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
HIDDEN, HEADS, HEAD_DIM, INTER = 768, 12, 64, 1152
# Kernel -> (source, the TPU kernels it replaces as file:line, their rows in
# the table of TPU kernels), the default layout's eight in the order a
# training step first reaches them, then the two of the bias layouts.
_JAX_OPS = "open_provence_tpu/ops"
KERNEL_INFO = {
    "layer_norm": ("layer_norm.cu", [f"{_JAX_OPS}/layer_norm.py:36"], [1]),
    "ln_matmul": ("ln_gemm.cu", [f"{_JAX_OPS}/geglu.py:790"], [2]),
    "flash_attention_packed": (
        "flash_attention.cu",
        [f"{_JAX_OPS}/flash_attention.py:856", f"{_JAX_OPS}/flash_attention.py:1007"], [3, 5]),
    "ln_geglu": ("ln_gemm.cu", [f"{_JAX_OPS}/geglu.py:152"], [4]),
    "layer_norm_bwd": ("layer_norm.cu", [f"{_JAX_OPS}/layer_norm.py:91"], [10]),
    "ln_geglu_bwd": ("ln_gemm_bwd.cu", [f"{_JAX_OPS}/geglu.py:353"], [11]),
    "flash_attention_packed_bwd": (
        "flash_attention_bwd.cu",
        [f"{_JAX_OPS}/flash_attention.py:1579", f"{_JAX_OPS}/flash_attention.py:1346",
         f"{_JAX_OPS}/flash_attention.py:1453"], [14, 15]),
    "ln_matmul_bwd": ("ln_gemm_bwd.cu", [f"{_JAX_OPS}/geglu.py:886"], [12]),
    "add_layer_norm": ("layer_norm.cu", [f"{_JAX_OPS}/layer_norm.py:233"], [7]),
    "geglu": ("ln_gemm.cu", [f"{_JAX_OPS}/geglu.py:148"], [6]),
    "flash_attention": ("flash_attention.cu", [f"{_JAX_OPS}/flash_attention.py:185"], [9]),
    "flash_attention_bwd": (
        "flash_attention_bwd.cu",
        [f"{_JAX_OPS}/flash_attention.py:474", f"{_JAX_OPS}/flash_attention.py:570"], [16]),
    "ln_geglu_wo": ("mlp_tail.cu", [f"{_JAX_OPS}/geglu.py:518"], [8]),
    "ln_geglu_wo_bwd": ("mlp_tail_bwd.cu", [f"{_JAX_OPS}/geglu.py:631"], [13]),
}
# Every head layout of width 768 the attention kernels are instantiated for;
# the JAX package's packed kernel takes the second and third.
HEAD_LAYOUTS = ((24, 32), (12, 64), (6, 128), (3, 256))
MLP_TAIL_GATE = "OPEN_PROVENCE_TPU_FUSED_MLP_TAIL"
FORWARD = ("layer_norm", "ln_matmul", "flash_attention_packed", "ln_geglu")
BACKWARD = ("layer_norm_bwd", "ln_geglu_bwd", "flash_attention_packed_bwd", "ln_matmul_bwd")
DEFAULT_EIGHT = FORWARD + BACKWARD
# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the full
# 700 W limit): a kernel's bound is the larger of its operations over the
# bf16 tensor-core rate and its bytes over the memory rate.
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
# |kernel - plain| <= atol + rtol·|plain|. fp32: both sides compute in true
# fp32 and differ only in summation order (K = 768 sums, online softmax).
# bf16: both round at the same points, but a sum that lands beside a bf16
# rounding boundary can round one ulp apart (2^-7 relative), and GeGLU's
# chain of three roundings can compound that.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# Backward outputs: |kernel - plain| <= a·max|plain| + r·|plain|. The atol is
# a share of the output's own scale, since dW and dscale sum over all
# 16384 rows and grow with them. fp32: summation order only. bf16: the
# cotangents P, dS and (GeGLU) gi, gg are rounded to bf16 on both sides,
# from fp32 sums taken in another order, so an element beside a rounding
# boundary can land one ulp apart before the next product.
BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 2e-2)}


def phase(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call on the card (CUDA events), after warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call on the card (CUDA events) of ``reps``
    calls captured into one CUDA graph and replayed, after warm-up: the
    device's time for the calls' launches with no host time between them
    (where a call's Python and launch cost nears its device time, cuda_ms
    measures the host)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel_fn, plain_fn, timer=cuda_ms) -> tuple[float, float]:
    """Time kernel and plain in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = timer(plain_fn), timer(kernel_fn), timer(kernel_fn), timer(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: each input byte read once and
    each output byte written once over the memory rate, or the operations
    over the bf16 peak, whichever is larger."""
    by_ops, by_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def scored_pairs(mask: torch.Tensor, window: int | None) -> int:
    """(query, key) pairs this batch's data needs scored: valid queries
    against valid keys (rows are valid from position 0 to their length; a
    padding row has none), all of them or those with |i - j| <= window."""
    total = 0
    for length in mask.sum(dim=1).tolist():
        if window is None or window >= length - 1:
            total += length * length
        else:
            total += length * (2 * window + 1) - window * (window + 1)
    return total


def attention_bound(mask: torch.Tensor, window: int | None, backward: bool,
                    heads: int = HEADS, head_dim: int = HEAD_DIM) -> dict:
    """bf16 attention on ``heads`` heads of ``head_dim`` under the [B, S] key
    mask of this run. Forward: Q.K^T and P.V, 4·D operations a scored pair
    and head; backward: the five products (S, dP, dV, dK, dQ), 10·D. Bytes:
    q, k, v and out (and for the backward g, lse and dq, dk, dv), the int32
    mask and the rope tables: the function's own operands, not the scratch a
    design may rotate them into."""
    batch, seq = mask.shape
    tokens, hidden = batch * seq, heads * head_dim
    nbytes = tokens * 4 * hidden * 2 + tokens * 4 + 2 * seq * head_dim * 2
    if backward:
        nbytes += tokens * (hidden + 3 * hidden) * 2 + batch * heads * seq * 4
    return bound((10 if backward else 4) * head_dim * heads * scored_pairs(mask, window), nbytes)


def gemm_bounds(rows: int, n: int = 3 * HIDDEN, i: int = INTER) -> dict[str, dict]:
    """Bounds of the row-wise and GEMM kernels at M = rows, base width, bf16
    (Wqkv's ``n`` rows and the MLP's ``i`` intermediate columns: a
    tensor-parallel rank's shard gives less of each)."""
    m, k, e = rows, HIDDEN, 2
    return {
        "layer_norm": bound(8 * m * k, (2 * m * k + k) * e),
        "add_layer_norm": bound(9 * m * k, (4 * m * k + k) * e),
        "layer_norm_bwd": ln_adjoint_bound(m, k, torch.bfloat16, torch.bfloat16),
        "ln_matmul": bound(2 * m * k * n, (m * k + k + n * k + m * n) * e),
        "ln_geglu": bound(4 * m * k * i, (m * k + k + 2 * i * k + m * i) * e),
        "geglu": bound(4 * m * k * i, (m * k + 2 * i * k + m * i) * e),
        # dW and dy (and for GeGLU the recomputed projection): 2·M·K·N each.
        "ln_matmul_bwd": bound(4 * m * k * n, (2 * m * k + 2 * k + 2 * n * k + m * n) * e),
        "ln_geglu_bwd": bound(12 * m * k * i, (2 * m * k + 2 * k + 4 * i * k + m * i) * e),
        # The whole MLP: x, the scale, Wi and Wo in, [M, K] out; the backward
        # also reads g and writes dx, dscale, dWi, dWo.
        "ln_geglu_wo": bound(6 * m * k * i, (2 * m * k + k + 3 * i * k) * e),
        "ln_geglu_wo_bwd": bound(16 * m * k * i, (3 * m * k + 2 * k + 6 * i * k) * e),
    }


def ln_adjoint_bound(rows: int, hidden: int, dtype, dy_dtype, with_gh: bool = False) -> dict:
    """The LN adjoint over rows x hidden: x, dy (g, or the fp32 dy of
    kernels 11-13) and gh read once, dx written once, the scale read and
    dscale written; 16 operations an element."""
    e, nbytes = dtype.itemsize, rows * hidden * dy_dtype.itemsize
    nbytes += rows * hidden * e * (3 if with_gh else 2) + 2 * hidden * e
    return bound(16 * rows * hidden, nbytes)


def bits_equal(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


# The LN adjoint (ln_adjoint.cuh; kernel 10 and the tail of kernels 11-13):
# the configs' widths, which run its register instance, then a multiple of 8
# that is no multiple of 256 and a width that is no multiple of 8, which run
# the strided one; the rows of the training path (B=32, S=512), a ragged
# count, the head norm's B and a single row.
LN_ADJOINT_WIDTHS = (768, 1024, 264, 36)
LN_ADJOINT_ROW_COUNTS = (32 * 512, 32 * 512 - 37, 32, 1)


def ln_adjoint_cases(dev, widths, row_counts, check) -> int:
    """Kernel 10 against its plain version at each width and row count, fp32
    and bf16, without gh and with it (``check(dtype, case, got, want)``
    holds each pair to BWD_TOL); a null gh gives the form without gh's bits
    and two launches give the same bits. Returns the pairs checked."""
    from open_provence_tpu_torch import ops

    gen = torch.Generator().manual_seed(91)
    pairs = 0
    for dtype in (torch.float32, torch.bfloat16):
        for width in widths:
            def randn(*shape, s=1.0):
                return (torch.randn(*shape, generator=gen) * s).to(device=dev, dtype=dtype)

            x, scale = randn(max(row_counts), width, s=2.0), randn(width, s=0.1) + 1
            for m in row_counts:
                g, gh = randn(m, width), randn(m, width)
                case = f"K={width} M={m}"
                without = ops.layer_norm_bwd(x[:m], scale, g)
                check(dtype, case, without, ops.layer_norm_bwd_plain(x[:m], scale, g))
                with_gh = ops.layer_norm_bwd(x[:m], scale, g, 1e-5, gh)
                check(dtype, f"{case} with gh", with_gh,
                      ops.layer_norm_bwd_plain(x[:m], scale, g, 1e-5, gh))
                if not bits_equal(ops.layer_norm_bwd(x[:m], scale, g, 1e-5, None), without):
                    raise AssertionError(f"layer_norm_bwd {case}: a null gh changed its bits")
                if not bits_equal(ops.layer_norm_bwd(x[:m], scale, g, 1e-5, gh), with_gh):
                    raise AssertionError(f"layer_norm_bwd {case}: two launches differ")
                pairs += 2
    return pairs


def library_note(name: str, ms: float | None) -> str:
    """How a timing line names the one-call PyTorch counterpart."""
    if ms is not None:
        return f"{ms:.4f} ms"
    return "timed in phase 3c" if name.startswith("flash_attention") else "none"


def design_note(head_dim: int, backward: bool) -> str:
    """Which design the bf16 attention kernel of a head dim runs, the ring's
    stages, the tile shape, the consumer warpgroups a CTA and where the rope
    tables come from, as the library was compiled (an older tree reports
    the first four)."""
    from open_provence_tpu_torch import kernels

    d = kernels.attention_design(head_dim, backward)
    note = f"{d['products']}, {d['fill']}, {d['stages']} stage(s), tile {d['tile']}"
    if "consumers" in d:
        note += f", consumer warpgroups {d['consumers']}, rotation {d['rotation']}"
        if d["scratch"]:
            note += f" ({d['scratch']} operand(s))"
    if "dq_stages" in d:
        note += f"; dQ {d['dq_stages']} stage(s)"
    return note


def attention_designs(backward: bool) -> dict:
    """The design of every head dim's bf16 kernel, for the kernel table."""
    from open_provence_tpu_torch import kernels

    return {f"d{dim}": kernels.attention_design(dim, backward)
            for dim in kernels.ATTENTION_HEAD_DIMS}


def gemm_designs() -> dict:
    """The GEMM engine's design of every bf16 layout, as the library was
    built: the forward's K-major x K-major product (kernels 2, 4, 6 and
    kernel 11's recomputed projection) and the backward's transposed ones."""
    from open_provence_tpu_torch import kernels

    layouts = {"xn.W^T": (False, False), "G^T.xn": (True, True), "G.W": (False, True)}
    return {name: kernels.gemm_design(ta, tb, torch.bfloat16) for name, (ta, tb) in layouts.items()}


def gemm_design_note(design: dict) -> str:
    return (f"{design['products']}, {design['fill']}, {design['stages']} stage(s), "
            f"tile {design['tile']}")


def lowest_ms(fn, tries: int = 3) -> float:
    """The lowest of ``tries`` means of 20 calls."""
    return min(cuda_ms(fn) for _ in range(tries))


def ptxas_entries(log: str, wanted):
    """(entry, its "Used ..." line, its spill line) from a ptxas report, for
    the entry functions whose mangled name contains one of ``wanted``, and
    the report's warnings as (entry, warning, "")."""
    entry, spills = "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry, spills = line.split("'")[1], ""
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and any(w in entry for w in wanted):
            yield entry, line.split(":", 1)[1].strip(), spills
        elif "warning" in line:
            yield entry, line.strip(), ""


def print_ptxas(log: str, wanted) -> None:
    """The ptxas report (registers, and the spill line) of the entry
    functions whose mangled name contains one of ``wanted``."""
    for entry, used, spills in ptxas_entries(log, wanted):
        phase(f"ptxas {entry}: {used}; {spills}" if spills else f"ptxas {entry}: {used}")


# The four activation codes of the GeGLU epilogue (ops/geglu.py::ACTIVATIONS).
GEGLU_ACTIVATIONS = ("gelu", "gelu_new", "relu", "silu")


def gemm_edge_cases(dev, stats: dict[str, dict]) -> None:
    """Kernels 2, 4 and 6 against their plain versions where the GEMM
    engine's tiles make them fragile: M = 64 (B=1, S=64), 16384 - 37 and
    16384; output widths of one whole tile (256 columns; 128 under GeGLU)
    and ragged ones (452 and 100: no multiple of the tile, nor of 8, so the
    epilogue stores element by element); K = 768 and K = 200 (three 64-deep
    steps and 8 more, zero-filled); every GeGLU activation; fp32 and bf16.
    In bf16 each kernel runs twice and must give the same bits. Kernel 4
    must give the bits of kernel 6 on kernel 1's rows: its normalized rows
    are kernel 1's to the bit, and the products are the same."""
    from open_provence_tpu_torch import ops

    gen = torch.Generator().manual_seed(6)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(device=dev, dtype=dtype)

    for name in ("ln_matmul", "ln_geglu", "geglu"):
        stats.setdefault(name, {"max_abs_err": {}, "cases": 0})
    worst, cases = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        for k in (HIDDEN, 200):
            scale = randn(k, scale=0.1, dtype=dtype) + 1
            w = {n: randn(n, k, scale=k**-0.5, dtype=dtype) for n in (256, 452)}
            wi = {i: randn(2 * i, k, scale=k**-0.5, dtype=dtype) for i in (128, 100)}
            for m in (64, 16384 - 37, 16384):
                x = randn(m, k, scale=2.0, dtype=dtype)
                xn = ops.layer_norm_plain(x, scale)
                xn_kernel = ops.layer_norm(x, scale)
                # (label, name, kernel, plain, the bits it must equal or None)
                runs = [(f"ln_matmul N={n}", "ln_matmul",
                         lambda w_=w_: ops.ln_matmul(x, scale, w_),
                         lambda w_=w_: ops.ln_matmul_plain(x, scale, w_), None)
                        for n, w_ in w.items()]
                for j, (i, w_) in enumerate(wi.items()):
                    runs += [(f"ln_geglu I={i} {act}", "ln_geglu",
                              lambda w_=w_, act=act: ops.ln_geglu(x, scale, w_, act),
                              lambda w_=w_, act=act: ops.ln_geglu_plain(x, scale, w_, act),
                              lambda w_=w_, act=act: ops.geglu(xn_kernel, w_, act))
                             for act in GEGLU_ACTIVATIONS]
                    act = GEGLU_ACTIVATIONS[(j + m) % len(GEGLU_ACTIVATIONS)]
                    runs.append((f"geglu I={i} {act}", "geglu",
                                 lambda w_=w_, act=act: ops.geglu(xn, w_, act),
                                 lambda w_=w_, act=act: ops.geglu_plain(xn, w_, act), None))
                for label, name, kernel, plain, same_bits in runs:
                    got = kernel()
                    err = check_close(f"{label} M={m} K={k} {dtype}", got, plain(), dtype)
                    if dtype == torch.bfloat16 and not torch.equal(got, kernel()):
                        raise AssertionError(f"{label} M={m} K={k}: two launches differ")
                    if same_bits is not None and not torch.equal(got, same_bits()):
                        raise AssertionError(f"{label} M={m} K={k} {dtype}: not kernel 6 on "
                                             "kernel 1's rows, bit for bit")
                    by_dtype = stats[name]["max_abs_err"]
                    by_dtype[dtype] = max(by_dtype.get(dtype, 0.0), err)
                    stats[name]["cases"] += 1
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
                    cases += 1
                torch.cuda.synchronize()
    phase(f"phase 3 GEMM edge cases: {cases} cases, max_abs_err fp32 {worst[torch.float32]:.3e}, "
          f"bf16 {worst[torch.bfloat16]:.3e} (tol {TOL[torch.float32]}, {TOL[torch.bfloat16]}); "
          "bf16 launches twice, bit-equal")


def gemm_bwd_edge_cases(dev, stats: dict[str, dict]) -> None:
    """Kernels 12 and 11 against their plain versions where the transposed
    products' tiles and the dW split over rows make them fragile: a
    contraction depth M (the rows) of 64 (less than one chunk), 77 (a ragged
    k-step), 16384 - 37 (a ragged last chunk) and 16384; dW row counts of
    one whole tile (256) and ragged ones (456 for kernel 12; 2I = 464 for
    kernel 11, whose cotangent rows must stay 16-byte multiples); K = 768
    and K = 200 (dy's and dW's columns: no multiple of the 256-wide tile);
    every GeGLU activation (relu's cotangent zeroed where the card and the
    plain version put inp on either side of the step: off_relu_step); fp32 and
    bf16. In bf16 each kernel runs twice and must give the same bits."""
    from open_provence_tpu_torch import ops

    gen = torch.Generator().manual_seed(7)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(device=dev, dtype=dtype)

    for name in ("ln_matmul_bwd", "ln_geglu_bwd"):
        stats.setdefault(name, {"max_abs_err": {}})
        stats[name].setdefault("cases", 0)
    worst, cases, flipped = {}, 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for k in (HIDDEN, 200):
            scale = randn(k, scale=0.1, dtype=dtype) + 1
            w = {n: randn(n, k, scale=k**-0.5, dtype=dtype) for n in (256, 456)}
            wi = {i: randn(2 * i, k, scale=k**-0.5, dtype=dtype) for i in (128, 232)}
            for m in (64, 77, 16384 - 37, 16384):
                x = randn(m, k, scale=2.0, dtype=dtype)
                runs = []
                for n, w_ in w.items():
                    g = randn(m, n, scale=0.1, dtype=dtype)
                    runs.append((f"ln_matmul_bwd N={n}", "ln_matmul_bwd",
                                 lambda w_=w_, g=g: ops.ln_matmul_bwd(x, scale, w_, g),
                                 lambda w_=w_, g=g: ops.ln_matmul_bwd_plain(x, scale, w_, g)))
                zeroed = 0
                for i, w_ in wi.items():
                    g = randn(m, i, scale=0.1, dtype=dtype)
                    for act in GEGLU_ACTIVATIONS:
                        g_act, flips = off_relu_step(x, scale, w_, g) if act == "relu" else (g, 0)
                        zeroed += flips
                        runs.append((f"ln_geglu_bwd 2I={2 * i} {act}", "ln_geglu_bwd",
                                     lambda w_=w_, g=g_act, act=act: ops.ln_geglu_bwd(
                                         x, scale, w_, g, act),
                                     lambda w_=w_, g=g_act, act=act: ops.ln_geglu_bwd_plain(
                                         x, scale, w_, g, act)))
                for label, name, kernel, plain in runs:
                    got = kernel()
                    err = max(check_grad(f"{label} {out} M={m} K={k} {dtype}", a, b, dtype)
                              for out, a, b in zip(("dx", "dscale", "dw"), got, plain()))
                    if dtype == torch.bfloat16 and not all(
                            torch.equal(a, b) for a, b in zip(got, kernel())):
                        raise AssertionError(f"{label} M={m} K={k}: two launches differ")
                    by_dtype = stats[name]["max_abs_err"]
                    by_dtype[dtype] = max(by_dtype.get(dtype, 0.0), err)
                    stats[name]["cases"] += 1
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
                    cases += 1
                torch.cuda.synchronize()
                flipped[dtype] = flipped.get(dtype, 0) + zeroed
    a32, a16 = BWD_TOL[torch.float32], BWD_TOL[torch.bfloat16]
    phase(f"phase 3b GEMM backward edge cases: {cases} cases, max_abs_err fp32 "
          f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e} (tol "
          f"{a32[0]}·max|plain| + {a32[1]}·|plain|, {a16[0]}·max|plain| + {a16[1]}·|plain|); "
          "bf16 launches twice, bit-equal; relu's cotangent zeroed at "
          f"{flipped[torch.float32]} (fp32) and {flipped[torch.bfloat16]} (bf16) elements whose "
          "inp the card and the plain version put on either side of the step")


def off_relu_step(x, scale, w_i, g) -> tuple[torch.Tensor, int]:
    """(g with 0 wherever the card's inp and the plain version's fall on
    either side of relu's step, how many). There relu' is 1 on one side and 0
    on the other, and two right summation orders (or normalized rows one ulp
    apart) can give either; with g 0 there neither gi nor gg depends on the
    side, so kernel 11 and its plain version can be held to the tolerance in
    every output. The card's inp is kernel 2's product on the whole Wi, whose
    bits are kernel 11's recomputed projection (the same normalize pass and
    tiles); the plain one is ln_geglu_bwd_plain's."""
    from open_provence_tpu_torch import ops

    inter = g.shape[1]
    acc = torch.promote_types(g.dtype, torch.float32)
    inp_plain = (ops.layer_norm_plain(x, scale).to(acc) @ w_i.to(acc).t()).to(g.dtype)
    inp_card = ops.ln_matmul(x, scale, w_i)
    flip = (inp_card[:, :inter] > 0) != (inp_plain[:, :inter] > 0)
    return g.masked_fill(flip, 0), int(flip.sum())


# The launches of kernels 11, 12 and 13 by the profiler's kernel names (all
# the words of an entry in a name). The GEMM kernels of the transposed
# layouts carry them in their template arguments (<true, true: dW = G^T.xn;
# <false, true: dy = G.W); the first match names a launch.
BWD_LAUNCHES = (
    (("normalize_kernel",), "normalize"),
    (("geglu_grad_kernel",), "GeGLU chain"),
    (("ln_adjoint", "reduce_kernel"), "LN adjoint dscale"),
    (("ln_adjoint",), "LN adjoint rows"),
    (("tail_bwd_rows",), "whole-MLP rows pass"),
    (("tail_fwd",), "whole-MLP forward"),
    (("dw_sum_kernel",), "dW chunk sum"),
    (("<true, true",), "dW = G^T.xn"),
    (("<false, true",), "dy = G.W"),
    (("gemm_wgmma_kernel",), "projection xn.Wi^T"),
)


def launch_split(fn, reps: int = 20, flush: torch.Tensor | None = None) -> dict[str, dict]:
    """Device milliseconds a call of ``fn`` spends in each of its launches,
    and the launches a call, from torch.profiler's kernel records. With
    ``flush`` (a buffer larger than the 50 MB L2), it is zeroed before each
    call (that launch not counted), so no launch finds in L2 what the call
    before it left there."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    split: dict[str, dict] = {}
    for evt in prof.key_averages():
        if getattr(evt.device_type, "name", "") != "CUDA":
            continue
        if flush is not None and "FillFunctor" in evt.key:
            continue
        us = getattr(evt, "self_device_time_total", 0.0) or getattr(evt, "device_time_total", 0.0)
        label = next((lab for words, lab in BWD_LAUNCHES if all(w in evt.key for w in words)),
                     evt.key[:60])
        entry = split.setdefault(label, {"ms": 0.0, "launches": 0.0})
        entry["ms"] += us / 1e3 / reps
        entry["launches"] += evt.count / reps
    return split


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values off, max abs err "
            f"{err.max().item():.3e} (atol {atol}, rtol {rtol})"
        )
    return err.max().item()


def grad_errors(name: str, got: torch.Tensor, want: torch.Tensor, dtype):
    """(|kernel - plain|, the mask of values outside BWD_TOL)."""
    a, r = BWD_TOL[dtype]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    return err, err > a * want.abs().max() + r * want.abs()


def check_grad(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    err, bad = grad_errors(name, got, want, dtype)
    if bad.any():
        a, r = BWD_TOL[dtype]
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values off, max abs err "
            f"{err.max().item():.3e} (max |plain| {want.float().abs().max().item():.3e}; "
            f"atol {a}·max|plain|, rtol {r})"
        )
    return err.max().item()


def ragged_mask(batch: int, seq: int, gen: torch.Generator, device) -> torch.Tensor:
    """Row 0 full, the others valid for a random length in [seq/2, seq]."""
    lengths = torch.randint(seq // 2, seq + 1, (batch,), generator=gen)
    lengths[0] = seq
    return (torch.arange(seq)[None, :] < lengths[:, None]).to(device=device, dtype=torch.int32)


def phase3_kernels(dev) -> dict[str, dict]:
    from open_provence_tpu_torch import ops

    gen = torch.Generator().manual_seed(3)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(device=dev, dtype=dtype)

    stats = {name: {"max_abs_err": {}, "cases": 0}
             for name in (*FORWARD, "add_layer_norm", "geglu")}

    def record(name, dtype, got, want):
        err = check_close(f"{name} {dtype}", got, want, dtype)
        by_dtype = stats[name]["max_abs_err"]
        by_dtype[dtype] = max(by_dtype.get(dtype, 0.0), err)
        stats[name]["cases"] += 1

    for dtype in (torch.float32, torch.bfloat16):
        scale = randn(HIDDEN, scale=0.1, dtype=dtype) + 1
        w_qkv = randn(3 * HIDDEN, HIDDEN, scale=HIDDEN**-0.5, dtype=dtype)
        w_i = randn(2 * INTER, HIDDEN, scale=HIDDEN**-0.5, dtype=dtype)
        for batch in (1, 8, 32):
            head_x = randn(batch, HIDDEN, dtype=dtype)  # the prediction head's norm
            record("layer_norm", dtype, ops.layer_norm(head_x, scale), ops.layer_norm_plain(head_x, scale))
            for seq in (64, 192, 512):
                x = randn(batch * seq, HIDDEN, scale=2.0, dtype=dtype)
                record("layer_norm", dtype, ops.layer_norm(x, scale), ops.layer_norm_plain(x, scale))
                record("ln_matmul", dtype, ops.ln_matmul(x, scale, w_qkv), ops.ln_matmul_plain(x, scale, w_qkv))
                record("ln_geglu", dtype, ops.ln_geglu(x, scale, w_i, "gelu"),
                       ops.ln_geglu_plain(x, scale, w_i, "gelu"))
                qkv = randn(batch, seq, 3 * HIDDEN, dtype=dtype)
                mask = ragged_mask(batch, seq, gen, dev)
                valid = mask.bool()
                for window, theta in ((None, 160000.0), (64, 10000.0)):
                    rope = ops.rope_tables(seq, HEAD_DIM, theta, dtype, dev)
                    kw = dict(num_heads=HEADS, padding_mask=mask, window=window, rope=rope)
                    record("flash_attention_packed", dtype,
                           ops.flash_attention_packed(qkv, **kw)[valid],
                           ops.attention_packed_plain(qkv, **kw)[valid])
                torch.cuda.synchronize()
        # The bias layouts' kernels at the training and serving row count and
        # at a ragged one. add + LN must equal an add followed by kernel 1.
        for m in (16384, 16384 - 37):
            x, y = randn(m, HIDDEN, scale=2.0, dtype=dtype), randn(m, HIDDEN, dtype=dtype)
            record("geglu", dtype, ops.geglu(x, w_i, "gelu"), ops.geglu_plain(x, w_i, "gelu"))
            h, normed = ops.add_layer_norm(x, y, scale)
            h_plain, normed_plain = ops.add_layer_norm_plain(x, y, scale)
            record("add_layer_norm", dtype, normed, normed_plain)
            if not (torch.equal(h, h_plain) and torch.equal(normed, ops.layer_norm(x + y, scale))):
                raise AssertionError(f"add_layer_norm {dtype} M={m}: h or LN(h) differs from "
                                     "an add followed by the LayerNorm kernel")
            torch.cuda.synchronize()
        for name, st in stats.items():
            atol, rtol = TOL[dtype]
            phase(f"phase 3 {name} {str(dtype)[6:]}: max_abs_err {st['max_abs_err'][dtype]:.3e} "
                  f"(tol atol {atol} + rtol {rtol}) over {st['cases']} cases so far")
    gemm_edge_cases(dev, stats)

    # Times at the main path's largest bucket: B=32, S=512, bf16.
    dtype, batch, seq = torch.bfloat16, 32, 512
    x = randn(batch * seq, HIDDEN, scale=2.0, dtype=dtype)
    y = randn(batch * seq, HIDDEN, dtype=dtype)
    scale = randn(HIDDEN, scale=0.1, dtype=dtype) + 1
    w_qkv = randn(3 * HIDDEN, HIDDEN, scale=HIDDEN**-0.5, dtype=dtype)
    w_i = randn(2 * INTER, HIDDEN, scale=HIDDEN**-0.5, dtype=dtype)
    qkv = randn(batch, seq, 3 * HIDDEN, dtype=dtype)
    mask = ragged_mask(batch, seq, gen, dev)
    rope_g = ops.rope_tables(seq, HEAD_DIM, 160000.0, dtype, dev)
    rope_l = ops.rope_tables(seq, HEAD_DIM, 10000.0, dtype, dev)
    attn_g = dict(num_heads=HEADS, padding_mask=mask, window=None, rope=rope_g)
    attn_l = dict(num_heads=HEADS, padding_mask=mask, window=64, rope=rope_l)
    timings = {
        "layer_norm": paired_ms(lambda: ops.layer_norm(x, scale), lambda: ops.layer_norm_plain(x, scale)),
        "ln_matmul": paired_ms(lambda: ops.ln_matmul(x, scale, w_qkv),
                               lambda: ops.ln_matmul_plain(x, scale, w_qkv)),
        "flash_attention_packed": paired_ms(lambda: ops.flash_attention_packed(qkv, **attn_g),
                                            lambda: ops.attention_packed_plain(qkv, **attn_g)),
        "ln_geglu": paired_ms(lambda: ops.ln_geglu(x, scale, w_i, "gelu"),
                              lambda: ops.ln_geglu_plain(x, scale, w_i, "gelu")),
        "add_layer_norm": paired_ms(lambda: ops.add_layer_norm(x, y, scale),
                                    lambda: ops.add_layer_norm_plain(x, y, scale)),
        "geglu": paired_ms(lambda: ops.geglu(x, w_i, "gelu"),
                           lambda: ops.geglu_plain(x, w_i, "gelu")),
    }
    local = paired_ms(lambda: ops.flash_attention_packed(qkv, **attn_l),
                      lambda: ops.attention_packed_plain(qkv, **attn_l))
    bounds = gemm_bounds(batch * seq)
    bounds["flash_attention_packed"] = attention_bound(mask, None, False)
    # The one PyTorch call that computes the same function, where there is
    # one: timed here, used nowhere in the port.
    library = dict.fromkeys(timings)
    library["layer_norm"] = cuda_ms(lambda: F.layer_norm(x, (HIDDEN,), scale, None, 1e-5))
    for name, (ms, plain_ms) in timings.items():
        stats[name].update(ms=ms, plain_ms=plain_ms, library_ms=library[name], **bounds[name])
        phase(f"phase 3 time {name} B=32 S=512 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bounds[name]['bound_ms']:.4f} ms by {bounds[name]['bound_by']}, one "
              f"PyTorch call {library_note(name, library[name])}")
    # The bare product of kernels 2, 4 and 6 on torch.matmul, on the rows
    # they normalize: the library's time for the GEMM alone (no single call
    # computes LN -> GEMM or the GeGLU epilogue).
    xn = ops.layer_norm(x, scale)
    design = gemm_designs()
    for name, w in (("ln_matmul", w_qkv), ("ln_geglu", w_i), ("geglu", w_i)):
        stats[name].update(matmul_ms=lowest_ms(lambda w=w: torch.matmul(xn, w.t())),
                           design=design["xn.W^T"])
        phase(f"phase 3 time {name}: the bare product on torch.matmul "
              f"{stats[name]['matmul_ms']:.4f} ms; {gemm_design_note(design['xn.W^T'])}")
    local_bound = attention_bound(mask, 64, False)
    stats["flash_attention_packed"].update(ms_window64=local[0], plain_ms_window64=local[1],
                                           bound_ms_window64=local_bound["bound_ms"])
    phase(f"phase 3 time flash_attention_packed window=64: kernel {local[0]:.4f} ms, "
          f"plain {local[1]:.4f} ms, bound {local_bound['bound_ms']:.4f} ms by "
          f"{local_bound['bound_by']}; D={HEAD_DIM}: {design_note(HEAD_DIM, False)}")
    stats["flash_attention_packed"]["design"] = attention_designs(False)
    add_then_ln = cuda_ms(lambda: ops.layer_norm(x + y, scale))
    stats["add_layer_norm"]["add_then_layer_norm_ms"] = add_then_ln
    phase(f"phase 3 time add_layer_norm against an add followed by kernel 1: "
          f"{timings['add_layer_norm'][0]:.4f} ms vs {add_then_ln:.4f} ms")
    return stats


def phase3b_backward(dev) -> dict[str, dict]:
    """Each backward kernel against its plain version on the same inputs,
    at the training shapes B=32, S=512 (M = 16384 rows), fp32 and bf16."""
    from open_provence_tpu_torch import kernels, ops

    gen = torch.Generator().manual_seed(33)
    batch, seq, rows = 32, 512, 32 * 512

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(device=dev, dtype=dtype)

    stats = {name: {"max_abs_err": {}} for name in BACKWARD}

    def record(name, dtype, labels, got, want):
        errs = [check_grad(f"{name} {label} {dtype}", a, b, dtype)
                for label, a, b in zip(labels, got, want)]
        by_dtype = stats[name]["max_abs_err"]
        by_dtype[dtype] = max(by_dtype.get(dtype, 0.0), *errs)
        return ", ".join(f"{label} {e:.3e}" for label, e in zip(labels, errs))

    def report(name, dtype, case, errs):
        a, r = BWD_TOL[dtype]
        phase(f"phase 3b {name} {str(dtype)[6:]} {case}: max_abs_err {errs} "
              f"(tol {a}·max|plain| + {r}·|plain|)")

    for dtype in (torch.float32, torch.bfloat16):
        x = randn(rows, HIDDEN, scale=2.0, dtype=dtype)
        scale = randn(HIDDEN, scale=0.1, dtype=dtype) + 1
        w_qkv = randn(3 * HIDDEN, HIDDEN, scale=HIDDEN**-0.5, dtype=dtype)
        w_i = randn(2 * INTER, HIDDEN, scale=HIDDEN**-0.5, dtype=dtype)
        for m in (rows, rows - 37, batch):  # the embedding / final norms, ragged, the head norm
            g, gh = randn(m, HIDDEN, dtype=dtype), randn(m, HIDDEN, dtype=dtype)
            without = ops.layer_norm_bwd(x[:m], scale, g)
            errs = record("layer_norm_bwd", dtype, ("dx", "dscale"), without,
                          ops.layer_norm_bwd_plain(x[:m], scale, g))
            report("layer_norm_bwd", dtype, f"M={m}", errs)
            # The add + LN form: the residual cotangent gh goes into dx.
            errs = record("layer_norm_bwd", dtype, ("dx", "dscale"),
                          ops.layer_norm_bwd(x[:m], scale, g, 1e-5, gh),
                          ops.layer_norm_bwd_plain(x[:m], scale, g, 1e-5, gh))
            report("layer_norm_bwd", dtype, f"M={m} with gh", errs)
            null_gh = ops.layer_norm_bwd(x[:m], scale, g, 1e-5, None)
            if not all(torch.equal(a, b) for a, b in zip(null_gh, without)):
                raise AssertionError("layer_norm_bwd with a null gh changed its bits")
            if not bits_equal(ops.layer_norm_bwd(x[:m], scale, g, 1e-5, gh),
                              ops.layer_norm_bwd(x[:m], scale, g, 1e-5, gh)):
                raise AssertionError(f"layer_norm_bwd: two launches differ at M={m}")
        g_qkv = randn(rows, 3 * HIDDEN, scale=0.1, dtype=dtype)
        errs = record("ln_matmul_bwd", dtype, ("dx", "dscale", "dw"),
                      ops.ln_matmul_bwd(x, scale, w_qkv, g_qkv),
                      ops.ln_matmul_bwd_plain(x, scale, w_qkv, g_qkv))
        report("ln_matmul_bwd", dtype, f"M={rows}", errs)
        g_mlp = randn(rows, INTER, scale=0.1, dtype=dtype)
        errs = record("ln_geglu_bwd", dtype, ("dx", "dscale", "dwi"),
                      ops.ln_geglu_bwd(x, scale, w_i, g_mlp, "gelu"),
                      ops.ln_geglu_bwd_plain(x, scale, w_i, g_mlp, "gelu"))
        report("ln_geglu_bwd", dtype, f"M={rows}", errs)
        if dtype == torch.bfloat16:
            gemm_bwd_edge_cases(dev, stats)
            # The LN adjoint's other instances: ModernBERT-large's width and a
            # strided one, fp32 and bf16.
            ln_adjoint_cases(dev, (1024, 264), (rows, rows - 37, batch), lambda *case: report(
                "layer_norm_bwd", case[0], case[1],
                record("layer_norm_bwd", case[0], ("dx", "dscale"), case[2], case[3])))

        qkv = randn(batch, seq, 3 * HIDDEN, dtype=dtype)
        mask = ragged_mask(batch, seq, gen, dev)
        mask[-1] = 0  # a padding pair, as the collator adds
        valid = mask.bool()
        g = randn(batch, seq, HIDDEN, dtype=dtype) * mask[..., None].to(dtype)
        for window, theta in ((None, 160000.0), (64, 10000.0)):
            rope = ops.rope_tables(seq, HEAD_DIM, theta, dtype, dev)
            kw = dict(num_heads=HEADS, padding_mask=mask, window=window, rope=rope)
            out, lse = ops.flash_attention_packed_lse(qkv, **kw)
            out_p, lse_p = ops.attention_packed_plain(qkv, **kw, return_lse=True)
            lse_err = check_close(f"lse {dtype}", lse.transpose(1, 2)[valid],
                                  lse_p.transpose(1, 2)[valid], torch.float32)
            if not torch.isfinite(lse).all():
                raise AssertionError("lse is not finite")
            errs = record("flash_attention_packed_bwd", dtype, ("dqkv",),
                          (ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw),),
                          (ops.attention_packed_bwd_plain(qkv, g, out, lse, **kw),))
            report("flash_attention_packed_bwd", dtype, f"window={window}",
                   f"{errs}; forward lse on valid rows {lse_err:.3e}")
        torch.cuda.synchronize()

    # Times at B=32, S=512, bf16 (the last dtype of the loop above); kernel
    # 10's cotangents are tensors of their own, as on the training path.
    g_ln, gh_ln = randn(rows, HIDDEN, dtype=dtype), randn(rows, HIDDEN, dtype=dtype)
    timings = {
        "layer_norm_bwd": paired_ms(lambda: ops.layer_norm_bwd(x, scale, g_ln),
                                    lambda: ops.layer_norm_bwd_plain(x, scale, g_ln), graph_ms),
        "ln_geglu_bwd": paired_ms(lambda: ops.ln_geglu_bwd(x, scale, w_i, g_mlp, "gelu"),
                                  lambda: ops.ln_geglu_bwd_plain(x, scale, w_i, g_mlp, "gelu")),
        "ln_matmul_bwd": paired_ms(lambda: ops.ln_matmul_bwd(x, scale, w_qkv, g_qkv),
                                   lambda: ops.ln_matmul_bwd_plain(x, scale, w_qkv, g_qkv)),
    }
    for window, theta in ((64, 10000.0), (None, 160000.0)):  # the global one is recorded
        rope = ops.rope_tables(seq, HEAD_DIM, theta, dtype, dev)
        kw = dict(num_heads=HEADS, padding_mask=mask, window=window, rope=rope)
        out, lse = ops.flash_attention_packed_lse(qkv, **kw)
        timings["flash_attention_packed_bwd"] = paired_ms(
            lambda: ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw),
            lambda: ops.attention_packed_bwd_plain(qkv, g, out, lse, **kw))
        if window is not None:
            window_ms = timings["flash_attention_packed_bwd"]
    stats["flash_attention_packed_bwd"].update(
        ms_window64=window_ms[0], plain_ms_window64=window_ms[1],
        bound_ms_window64=attention_bound(mask, 64, True)["bound_ms"])
    phase(f"phase 3b time flash_attention_packed_bwd window=64: kernel {window_ms[0]:.4f} ms, "
          f"plain {window_ms[1]:.4f} ms, bound "
          f"{stats['flash_attention_packed_bwd']['bound_ms_window64']:.4f} ms; D={HEAD_DIM}: "
          f"{design_note(HEAD_DIM, True)}")
    stats["flash_attention_packed_bwd"]["design"] = attention_designs(True)
    bounds = gemm_bounds(rows)
    bounds["flash_attention_packed_bwd"] = attention_bound(mask, None, True)
    library = dict.fromkeys(timings)
    library["layer_norm_bwd"] = library_ln_bwd_ms(x, scale, g_ln)
    for name, (ms, plain_ms) in timings.items():
        stats[name].update(ms=ms, plain_ms=plain_ms, library_ms=library[name], **bounds[name])
        phase(f"phase 3b time {name} B=32 S=512 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bounds[name]['bound_ms']:.4f} ms by {bounds[name]['bound_by']}, one "
              f"PyTorch call {library_note(name, library[name])}")
    # Their products on torch.matmul, summed: dW = G^T.xn and dy = G.W, and
    # for kernel 11 the recomputed projection xn.Wi^T (G = [gi | gg]).
    xn = ops.layer_norm(x, scale)
    design = gemm_designs()
    for name, grad, w in (("ln_matmul_bwd", g_qkv, w_qkv),
                          ("ln_geglu_bwd", torch.cat([g_mlp, g_mlp], dim=1), w_i)):
        ms = [lowest_ms(lambda: torch.matmul(grad.t(), xn)),
              lowest_ms(lambda: torch.matmul(grad, w))]
        if name == "ln_geglu_bwd":
            ms.append(lowest_ms(lambda: torch.matmul(xn, w.t())))
        stats[name].update(matmul_ms=sum(ms), design=design)
        phase(f"phase 3b time {name}: its products on torch.matmul {sum(ms):.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in ms)}); "
              + "; ".join(f"{k}: {gemm_design_note(d)}" for k, d in design.items()))
    with_gh = paired_ms(lambda: ops.layer_norm_bwd(x, scale, g_ln, 1e-5, gh_ln),
                        lambda: ops.layer_norm_bwd_plain(x, scale, g_ln, 1e-5, gh_ln), graph_ms)
    gh_bound = ln_adjoint_bound(rows, HIDDEN, dtype, dtype, True)["bound_ms"]
    stats["layer_norm_bwd"].update(ms_with_gh=with_gh[0], plain_ms_with_gh=with_gh[1],
                                   bound_ms_with_gh=gh_bound,
                                   design=kernels.built_ln_adjoint_design(rows, HIDDEN))
    phase(f"phase 3b time layer_norm_bwd with gh: kernel {with_gh[0]:.4f} ms, plain "
          f"{with_gh[1]:.4f} ms, bound {gh_bound:.4f} ms; design "
          f"{stats['layer_norm_bwd']['design']}")
    return stats


def library_ln_bwd_ms(x, scale, g) -> float:
    """Milliseconds of the library's LayerNorm backward on kernel 10's
    inputs: the one call autograd makes for F.layer_norm
    (aten.native_layer_norm_backward, which reads the mean and rstd its
    forward saved instead of recomputing them), timed as kernel 10 is, by
    replays of a CUDA graph. A yardstick only; the port never calls it."""
    hidden = (x.shape[1],)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, hidden, scale, None, 1e-5)
    return graph_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        g, x, hidden, mean, rstd, scale, None, [True, True, False]))


def library_attention_ms(qkv, rope, mask, g, heads: int = HEADS, head_dim: int = HEAD_DIM,
                         window: int | None = None) -> tuple[float, float]:
    """Milliseconds of ``F.scaled_dot_product_attention`` and of its autograd
    backward on the same problem as a layer of ``window`` (None: global):
    q and k rotated beforehand (the library call has no rope, so it does
    less than the kernels), [B, H, S, D] contiguous, the key padding and,
    for a window, the band |i - j| <= window as one boolean mask (dense: the
    library call scores every pair). Timed as a yardstick only; the port
    never calls it."""
    from open_provence_tpu_torch import ops

    batch, seq, _ = qkv.shape
    q, k, v = qkv.reshape(batch, seq, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    q, k = ops.apply_rotary(q, k, *rope)
    q, k, v = (t.contiguous().requires_grad_() for t in (q, k, v))
    keys = mask.bool()[:, None, None, :]
    if window is not None:
        pos = torch.arange(seq, device=qkv.device)
        keys = keys & ((pos[:, None] - pos[None, :]).abs() <= window)
    # A query with no key to see (a padding row, a padded stretch out of the
    # band) sees every key instead: the library would give it NaNs.
    keys = keys | ~keys.any(dim=-1, keepdim=True)
    g_heads = g.reshape(batch, seq, heads, head_dim).transpose(1, 2).contiguous()
    with torch.no_grad():
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keys))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=keys)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g_heads, retain_graph=True))
    return fwd, bwd


def phase3c_long_context(dev, stats: dict[str, dict]) -> None:
    """The attention kernels where the JAX package routes to its banded
    forward (window layers, 1024 <= S <= 4096) and to its split backward
    (S > 1024): S = 1024, 2048 and 4096, and 1100 for a ragged last tile;
    the batch is what the plain version's fp32 [B, H, S, S] scores allow.
    Every batch ends in a padding row (all keys masked). Errors go into the
    two attention kernels' stats under the tolerances of phases 3 and 3b;
    times at B=8, S=2048, bf16, beside those at B=32, S=512."""
    from open_provence_tpu_torch import ops

    gen = torch.Generator().manual_seed(35)
    fwd, bwd = stats["flash_attention_packed"], stats["flash_attention_packed_bwd"]

    def case(batch, seq, dtype):
        qkv = torch.randn(batch, seq, 3 * HIDDEN, generator=gen).to(device=dev, dtype=dtype)
        mask = ragged_mask(batch, seq, gen, dev)
        mask[-1] = 0
        g = (torch.randn(batch, seq, HIDDEN, generator=gen).to(device=dev, dtype=dtype)
             * mask[..., None].to(dtype))
        return qkv, mask, g

    for dtype in (torch.float32, torch.bfloat16):
        for seq, batch in ((1024, 8), (1100, 4), (2048, 8), (4096, 2)):
            qkv, mask, g = case(batch, seq, dtype)
            valid = mask.bool()
            for window, theta in ((None, 160000.0), (64, 10000.0)):
                rope = ops.rope_tables(seq, HEAD_DIM, theta, dtype, dev)
                if rope[0].shape != (seq, HEAD_DIM):
                    raise AssertionError(f"rope table for S={seq} has shape {tuple(rope[0].shape)}")
                kw = dict(num_heads=HEADS, padding_mask=mask, window=window, rope=rope)
                out, lse = ops.flash_attention_packed_lse(qkv, **kw)
                out_p, lse_p = ops.attention_packed_plain(qkv, **kw, return_lse=True)
                if not (torch.isfinite(lse).all() and torch.isfinite(out).all()):
                    raise AssertionError(f"attention S={seq} {dtype}: out or lse is not finite")
                out_err = check_close(f"attention out S={seq} window={window} {dtype}",
                                      out[valid], out_p[valid], dtype)
                lse_err = check_close(f"attention lse S={seq} window={window} {dtype}",
                                      lse.transpose(1, 2)[valid], lse_p.transpose(1, 2)[valid],
                                      torch.float32)
                grad_err = check_grad(f"attention dqkv S={seq} window={window} {dtype}",
                                      ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw),
                                      ops.attention_packed_bwd_plain(qkv, g, out, lse, **kw), dtype)
                for st, err in ((fwd, out_err), (bwd, grad_err)):
                    st["max_abs_err"][dtype] = max(st["max_abs_err"].get(dtype, 0.0), err)
                phase(f"phase 3c attention {str(dtype)[6:]} B={batch} S={seq} window={window}: "
                      f"max_abs_err out {out_err:.3e}, lse {lse_err:.3e}, dqkv {grad_err:.3e}")
                del out_p, lse_p
            torch.cuda.synchronize()

    attention_edge_cases(dev, stats)

    # Times at the long-context training and serving shape, and the library
    # call beside the kernels at both shapes, global and +-64.
    dtype = torch.bfloat16
    for label, batch, seq in (("", 32, 512), ("_b8_s2048", 8, 2048)):
        qkv, mask, g = case(batch, seq, dtype)
        for window, theta in ((64, 10000.0), (None, 160000.0)):
            rope = ops.rope_tables(seq, HEAD_DIM, theta, dtype, dev)
            kw = dict(num_heads=HEADS, padding_mask=mask, window=window, rope=rope)
            out, lse = ops.flash_attention_packed_lse(qkv, **kw)
            suffix = label + ("" if window is None else "_window64")
            if window is not None:
                lib_f, lib_b = library_attention_ms(qkv, rope, mask, g, window=window)
                fwd[f"library_ms{suffix}"], bwd[f"library_ms{suffix}"] = lib_f, lib_b
                phase(f"phase 3c time scaled_dot_product_attention (no rope) B={batch} S={seq} "
                      f"window={window} (a band-and-padding mask) bf16: forward {lib_f:.4f} ms, "
                      f"autograd backward {lib_b:.4f} ms")
            if label:
                f_ms = paired_ms(lambda: ops.flash_attention_packed(qkv, **kw),
                                 lambda: ops.attention_packed_plain(qkv, **kw))
                b_ms = paired_ms(lambda: ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw),
                                 lambda: ops.attention_packed_bwd_plain(qkv, g, out, lse, **kw))
                for st, (ms, plain_ms), backward in ((fwd, f_ms, False), (bwd, b_ms, True)):
                    b = attention_bound(mask, window, backward)
                    st.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                               f"bound_ms{suffix}": b["bound_ms"]})
                    phase(f"phase 3c time attention {'backward' if backward else 'forward'} "
                          f"B={batch} S={seq} window={window} bf16: kernel {ms:.4f} ms, plain "
                          f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}; "
                          f"D={HEAD_DIM}: {design_note(HEAD_DIM, backward)}")
        lib_f, lib_b = library_attention_ms(qkv, rope, mask, g)
        fwd[f"library_ms{label}"], bwd[f"library_ms{label}"] = lib_f, lib_b
        phase(f"phase 3c time scaled_dot_product_attention (no rope) B={batch} S={seq} global "
              f"bf16: forward {lib_f:.4f} ms, autograd backward {lib_b:.4f} ms")


def edge_mask(batch: int, seq: int, gen: torch.Generator, device, short: bool = False):
    """Key masks that are no prefix: each row valid up to a random length (in
    [seq/2, seq], row 0 full; with ``short`` every row under seq/2), with
    single padded keys scattered through it and, where it fits, one wholly
    padded stretch of 130 keys (so at least one aligned 64-key tile holds no
    valid key) in the middle of the valid run."""
    lo, hi = (max(seq // 8, 1), max(seq // 2 - 1, 2)) if short else (seq // 2, seq + 1)
    lengths = torch.randint(lo, hi, (batch,), generator=gen)
    if not short:
        lengths[0] = seq
    mask = (torch.arange(seq)[None, :] < lengths[:, None]).to(torch.int32)
    holes = torch.rand(batch, seq, generator=gen) < 0.05
    mask[holes] = 0
    for row, length in enumerate(lengths.tolist()):
        if length >= 130 + 32:
            start = int(torch.randint(8, length - 130 - 8, (1,), generator=gen))
            mask[row, start:start + 130] = 0
        mask[row, 0] = 1  # never an empty row here
    return mask.to(device)


def attention_case(qkv, mask, g, heads: int, window, dtype, what: str):
    """The packed attention kernels, forward and backward, against their plain
    versions on one input: (out, lse, dqkv) max errors under TOL / BWD_TOL,
    out and lse on the valid rows (g is zero on the others). The backward
    runs twice and must give the same bits."""
    from open_provence_tpu_torch import ops

    batch, seq, width = qkv.shape
    head_dim = width // (3 * heads)
    theta = 160000.0 if window is None else 10000.0
    kw = dict(num_heads=heads, padding_mask=mask, window=window,
              rope=ops.rope_tables(seq, head_dim, theta, dtype, qkv.device))
    valid = mask.bool()
    out, lse = ops.flash_attention_packed_lse(qkv, **kw)
    out_p, lse_p = ops.attention_packed_plain(qkv, **kw, return_lse=True)
    if not (torch.isfinite(lse).all() and torch.isfinite(out).all()):
        raise AssertionError(f"attention {what}: out or lse is not finite")
    out_err = check_close(f"attention out {what}", out[valid], out_p[valid], dtype)
    lse_err = check_close(f"attention lse {what}", lse.transpose(1, 2)[valid],
                          lse_p.transpose(1, 2)[valid], torch.float32)
    dqkv = ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw)
    grad_err = check_grad(f"attention dqkv {what}", dqkv,
                          ops.attention_packed_bwd_plain(qkv, g, out, lse, **kw), dtype)
    again = ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw)
    if not (torch.equal(again, dqkv)
            and torch.equal(ops.flash_attention_packed_lse(qkv, **kw)[0], out)):
        raise AssertionError(f"attention {what}: two runs on one input gave different bits")
    return out_err, lse_err, grad_err


def attention_edge_cases(dev, stats: dict[str, dict], layouts=HEAD_LAYOUTS) -> None:
    """What an asynchronously filled ring, wgmma tiles and skipped key tiles
    make fragile, every head layout, fp32 and bf16: S that is no multiple of
    the tile (65, 513, 1100), B = 1, windows 0, 16, 64, 128 and one past S
    beside global, masks with holes and a wholly padded stretch inside a valid
    row, a batch whose rows are all under S/2."""
    gen = torch.Generator().manual_seed(39)
    names = ("flash_attention_packed", "flash_attention", "flash_attention_packed_bwd",
             "flash_attention_bwd")
    for name in names:
        stats.setdefault(name, {"max_abs_err": {}})
    count = 0
    for dtype in (torch.float32, torch.bfloat16):
        worst = [0.0, 0.0, 0.0]
        for heads, head_dim in layouts:
            main = (heads, head_dim) == (HEADS, HEAD_DIM)
            shapes = [(1, 65, False), (3, 513, False), (2, 1100, False), (4, 512, True)]
            if main:
                shapes += [(1, 513, False), (1, 1100, False), (2, 2048, True)]
            for batch, seq, short in shapes:
                qkv = torch.randn(batch, seq, 3 * HIDDEN, generator=gen).to(device=dev, dtype=dtype)
                mask = edge_mask(batch, seq, gen, dev, short)
                g = (torch.randn(batch, seq, HIDDEN, generator=gen).to(device=dev, dtype=dtype)
                     * mask[..., None].to(dtype))
                windows = (None, 0, 16, 64, 128, seq + 7) if main else (None, 16, 128)
                for window in windows:
                    what = f"{heads}x{head_dim} B={batch} S={seq} window={window} {dtype}"
                    errs = attention_case(qkv, mask, g, heads, window, dtype, what)
                    worst = [max(a, b) for a, b in zip(worst, errs)]
                    count += 1
            torch.cuda.synchronize()
        for name, err in zip(names, (worst[0], worst[0], worst[2], worst[2])):
            by_dtype = stats[name]["max_abs_err"]
            by_dtype[dtype] = max(by_dtype.get(dtype, 0.0), err)
        phase(f"phase 3c edge cases {str(dtype)[6:]}: max_abs_err out {worst[0]:.3e}, lse "
              f"{worst[1]:.3e}, dqkv {worst[2]:.3e} over {count} cases so far (ragged S, B=1, "
              f"windows 0..S+7, masks with holes and padded stretches, short rows; the backward "
              f"twice, bit-equal)")


def phase3d_head_layouts(dev, stats: dict[str, dict]) -> None:
    """Attention on separate q, k, v (kernels 9 and 16) against its plain
    version for every head layout of width 768, at B=32, S=512 and (D = 32,
    128, 256) at B=8, S=2048; fp32 and bf16, global and +-64, ragged masks whose
    last row is padding. The same data as strided views of the packed buffer
    and through the packed wrapper must give the same bits. Errors go
    into the stats of all four attention kernels under the tolerances of
    phases 3 and 3b; times, bounds and the library call per shape in bf16."""
    from open_provence_tpu_torch import ops

    gen = torch.Generator().manual_seed(37)
    fwd = stats.setdefault("flash_attention", {"max_abs_err": {}})
    bwd = stats.setdefault("flash_attention_bwd", {"max_abs_err": {}})
    fwd["design"], bwd["design"] = attention_designs(False), attention_designs(True)
    packed_fwd, packed_bwd = stats["flash_attention_packed"], stats["flash_attention_packed_bwd"]
    shapes = [(32, 512, h, d) for h, d in HEAD_LAYOUTS] + [
        (8, 2048, 24, 32), (8, 2048, 6, 128), (8, 2048, 3, 256)]

    def case(batch, seq, dtype):
        qkv = torch.randn(batch, seq, 3 * HIDDEN, generator=gen).to(device=dev, dtype=dtype)
        mask = ragged_mask(batch, seq, gen, dev)
        mask[-1] = 0
        g = (torch.randn(batch, seq, HIDDEN, generator=gen).to(device=dev, dtype=dtype)
             * mask[..., None].to(dtype))
        return qkv, mask, g

    def merged(x):
        return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], -1)

    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq, heads, head_dim in shapes:
            qkv, mask, g_packed = case(batch, seq, dtype)
            views = ops.packed_views(qkv, heads)
            q, k, v = (t.contiguous() for t in views)
            g = g_packed.view(batch, seq, heads, head_dim).transpose(1, 2)
            rows = mask.bool()[:, None, :].expand(batch, heads, seq)
            for window, theta in ((None, 160000.0), (64, 10000.0)):
                kw = dict(padding_mask=mask, window=window,
                          rope=ops.rope_tables(seq, head_dim, theta, dtype, dev))
                what = f"{heads}x{head_dim} S={seq} window={window} {dtype}"
                out, lse = ops.flash_attention_lse(q, k, v, **kw)
                out_p, lse_p = ops.attention_unpacked_plain(q, k, v, **kw, return_lse=True)
                if not (torch.isfinite(lse).all() and torch.isfinite(out).all()):
                    raise AssertionError(f"attention {what}: out or lse is not finite")
                out_err = check_close(f"attention out {what}", out[rows], out_p[rows], dtype)
                lse_err = check_close(f"attention lse {what}", lse[rows], lse_p[rows],
                                      torch.float32)
                del out_p, lse_p
                grads = ops.flash_attention_bwd(q, k, v, g, out, lse, **kw)
                wants = ops.attention_unpacked_bwd_plain(q, k, v, g, out, lse, **kw)
                grad_err = max(check_grad(f"attention {name} {what}", got, want, dtype)
                               for name, got, want in zip(("dq", "dk", "dv"), grads, wants))
                del wants
                # Strided views of the packed buffer, then the packed wrapper
                # on the buffer itself: the same bits.
                out_v, lse_v = ops.flash_attention_lse(*views, **kw)
                grads_v = ops.flash_attention_bwd(*views, g, out_v, lse_v, **kw)
                pkw = dict(num_heads=heads, **kw)
                out_k, lse_k = ops.flash_attention_packed_lse(qkv, **pkw)
                dqkv = ops.flash_attention_packed_bwd(qkv, g_packed, out_k, lse_k, **pkw)
                same = (torch.equal(out_v, out) and torch.equal(lse_v, lse)
                        and all(torch.equal(a, b) for a, b in zip(grads_v, grads))
                        and torch.equal(out_k, merged(out)) and torch.equal(lse_k, lse)
                        and torch.equal(dqkv, torch.cat([merged(t) for t in grads], dim=-1)))
                if not same:
                    raise AssertionError(f"attention {what}: contiguous tensors, strided views "
                                         "and the packed wrapper disagree")
                for st, err in ((fwd, out_err), (packed_fwd, out_err), (bwd, grad_err),
                                (packed_bwd, grad_err)):
                    st["max_abs_err"][dtype] = max(st["max_abs_err"].get(dtype, 0.0), err)
                phase(f"phase 3d attention {str(dtype)[6:]} B={batch} {heads}x{head_dim} S={seq} "
                      f"window={window}: max_abs_err out {out_err:.3e}, lse {lse_err:.3e}, "
                      f"dq/dk/dv {grad_err:.3e}; views and the packed wrapper bit-equal")
            torch.cuda.synchronize()

    # Times per shape, bf16: the unpacked wrapper on contiguous tensors (its
    # plain version beside it), the packed wrapper on the buffer, the bound of
    # this run's masks and the library call (global and +-64).
    dtype = torch.bfloat16
    for batch, seq, heads, head_dim in shapes:
        qkv, mask, g_packed = case(batch, seq, dtype)
        q, k, v = (t.contiguous() for t in ops.packed_views(qkv, heads))
        g = g_packed.view(batch, seq, heads, head_dim).transpose(1, 2).contiguous()
        label = f"_{heads}x{head_dim}_b{batch}_s{seq}"
        headline = (batch, seq, heads, head_dim) == shapes[0]
        for window, theta in ((64, 10000.0), (None, 160000.0)):
            rope = ops.rope_tables(seq, head_dim, theta, dtype, dev)
            kw = dict(padding_mask=mask, window=window, rope=rope)
            pkw = dict(num_heads=heads, **kw)
            out, lse = ops.flash_attention_lse(q, k, v, **kw)
            out_k, lse_k = ops.flash_attention_packed_lse(qkv, **pkw)
            f_ms = paired_ms(lambda: ops.flash_attention(q, k, v, **kw),
                             lambda: ops.attention_unpacked_plain(q, k, v, **kw))
            b_ms = paired_ms(lambda: ops.flash_attention_bwd(q, k, v, g, out, lse, **kw),
                             lambda: ops.attention_unpacked_bwd_plain(q, k, v, g, out, lse, **kw))
            pf_ms = cuda_ms(lambda: ops.flash_attention_packed_lse(qkv, **pkw))
            pb_ms = cuda_ms(lambda: ops.flash_attention_packed_bwd(qkv, g_packed, out_k, lse_k,
                                                                   **pkw))
            suffix = label + ("" if window is None else "_window64")
            if window is not None:
                lib_f, lib_b = library_attention_ms(qkv, rope, mask, g_packed, heads, head_dim,
                                                    window)
                fwd[f"library_ms{suffix}"], bwd[f"library_ms{suffix}"] = lib_f, lib_b
                phase(f"phase 3d time scaled_dot_product_attention (no rope) B={batch} "
                      f"{heads}x{head_dim} S={seq} window={window} (a band-and-padding mask) "
                      f"bf16: forward {lib_f:.4f} ms, autograd backward {lib_b:.4f} ms")
            for st, packed_st, (ms, plain_ms), packed_ms, backward in (
                    (fwd, packed_fwd, f_ms, pf_ms, False), (bwd, packed_bwd, b_ms, pb_ms, True)):
                b = attention_bound(mask, window, backward, heads, head_dim)
                st.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                           f"bound_ms{suffix}": b["bound_ms"]})
                packed_st[f"ms_packed_buffer{suffix}"] = packed_ms
                if headline and window is None:
                    st.update(ms=ms, plain_ms=plain_ms, **b)
                phase(f"phase 3d time attention {'backward' if backward else 'forward'} B={batch} "
                      f"{heads}x{head_dim} S={seq} window={window} bf16: kernel {ms:.4f} ms "
                      f"(packed buffer, lse written: {packed_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                      f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}; D={head_dim}: "
                      f"{design_note(head_dim, backward)}")
        lib_f, lib_b = library_attention_ms(qkv, rope, mask, g_packed, heads, head_dim)
        fwd[f"library_ms{label}"], bwd[f"library_ms{label}"] = lib_f, lib_b
        if headline:
            fwd["library_ms"], bwd["library_ms"] = lib_f, lib_b
        phase(f"phase 3d time scaled_dot_product_attention (no rope) B={batch} {heads}x{head_dim} "
              f"S={seq} global bf16: forward {lib_f:.4f} ms, autograd backward {lib_b:.4f} ms")


# How far from 0 the plain version's inp (its fp32 sum, before rounding) may
# lie where kernel 13's relu' can differ from it: two fp32 sums of 768
# products of size 0.1 in another order differ by about 1e-6.
RELU_STEP_REACH = 1e-5


def relu_at_the_step(label: str, x, scale, w_i, w_o, g, dtype, stats: dict) -> None:
    """Kernel 13 with relu on operands whose inp comes as near 0 as random
    data brings it. Where the kernel's and the plain version's sums for an inp
    fall on either side of 0, relu' is 0 on one side and 1 on the other, which
    moves that element's row of dx and its row of dWi (the inp half) by a
    whole term. So: dscale and dWo must be inside the tolerance; every value
    of dx outside it must lie in a row, and every value of dWi outside it in a
    row of the inp half, where the plain version has an |inp| below
    RELU_STEP_REACH. The errors are recorded as measured, nothing left out."""
    from open_provence_tpu_torch import ops

    grads = ops.ln_geglu_wo_bwd(x, scale, w_i, w_o, g, "relu")
    dx, dscale, dwi, dwo = ops.ln_geglu_wo_bwd_plain(x, scale, w_i, w_o, g, "relu")
    errs = [check_grad(f"{label} dscale", grads[1], dscale, dtype),
            check_grad(f"{label} dwo", grads[3], dwo, dtype)]
    acc = torch.promote_types(dtype, torch.float32)
    inp = ops.layer_norm_plain(x, scale).to(acc) @ w_i[:INTER].to(acc).t()
    nearest = inp.abs()
    del inp
    reach_rows, reach_cols = nearest.amin(dim=1), nearest.amin(dim=0)
    reach_cols = torch.cat([reach_cols, torch.full_like(reach_cols, float("inf"))])
    notes = []
    for name, got, want, reach in (("dx", grads[0], dx, reach_rows),
                                   ("dwi", grads[2], dwi, reach_cols)):
        err, bad = grad_errors(f"{label} {name}", got, want, dtype)
        off = bad.any(dim=1)
        farthest = reach[off].max().item() if off.any() else 0.0
        errs.append(err.max().item())
        notes.append(f"{name}: {int(bad.sum())} values in {int(off.sum())} rows outside the "
                     f"tolerance, max_abs_err {errs[-1]:.3e}, each such row within "
                     f"{farthest:.3e} of the step ({int((reach < RELU_STEP_REACH).sum())} of "
                     f"{reach.numel()} rows are within {RELU_STEP_REACH})")
        if farthest >= RELU_STEP_REACH:
            raise AssertionError(f"{label} {name}: values outside the tolerance in a row whose "
                                 f"inp stays {farthest:.3e} from 0")
    stats["max_abs_err_relu_at_the_step"] = stats.get("max_abs_err_relu_at_the_step", {})
    stats["max_abs_err_relu_at_the_step"][str(dtype)[6:]] = max(errs)
    phase(f"{label} with inp up to the step: " + "; ".join(notes))


def phase3e_whole_mlp(dev, stats: dict[str, dict]) -> None:
    """The whole MLP in one kernel, forward (kernel 8) and backward (kernel
    13), against its plain version at M = 16384 and a ragged M, fp32 and bf16,
    every activation the kernels know; the backward twice for the same bits.
    Times in bf16 beside the split path's: kernel 4 and the library's Wo
    product; kernel 11 and the library's products for dh and dWo; the bf16
    design (the forward's cluster, the backward row pass's tile)."""
    from open_provence_tpu_torch import kernels, ops

    gen = torch.Generator().manual_seed(38)
    rows = 32 * 512
    fwd = stats.setdefault("ln_geglu_wo", {"max_abs_err": {}})
    bwd = stats.setdefault("ln_geglu_wo_bwd", {"max_abs_err": {}})

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(device=dev, dtype=dtype)

    sign_gen = torch.Generator().manual_seed(39)

    def signs(n):
        """[n, 1] of +-1 in the loop's dtype."""
        return (torch.randint(0, 2, (n, 1), generator=sign_gen) * 2 - 1).to(device=dev, dtype=dtype)

    labels = ("dx", "dscale", "dwi", "dwo")
    for dtype in (torch.float32, torch.bfloat16):
        x = randn(rows, HIDDEN, scale=2.0, dtype=dtype)
        scale = randn(HIDDEN, scale=0.1, dtype=dtype) + 1
        w_i = randn(2 * INTER, HIDDEN, scale=HIDDEN**-0.5, dtype=dtype)
        w_o = randn(HIDDEN, INTER, scale=INTER**-0.5, dtype=dtype)
        g = randn(rows, HIDDEN, scale=0.1, dtype=dtype)
        # relu's derivative is a step at 0, so relu is held to the tolerance on
        # operands whose inp stays away from 0: the first 64 columns of x are
        # +-2 by row and of W_inp +-1/59 by column, together a term of about
        # +-1, and the rest of W_inp is an eighth of its size, a sum with a
        # deviation of about 0.12. inp keeps the size it has for the others.
        x_step, w_step = x.clone(), w_i.clone()
        x_step[:, :64] = 2.0 * signs(rows)
        w_step[:INTER] *= 0.125
        w_step[:INTER, :64] = signs(INTER) / 59
        for m, act, xs, ws in ((rows, "gelu", x, w_i), (rows, "gelu_pytorch_tanh", x, w_i),
                               (rows, "relu", x_step, w_step), (rows, "silu", x, w_i),
                               (rows - 37, "gelu", x, w_i)):
            out = ops.ln_geglu_wo(xs[:m], scale, ws, w_o, act)
            out_err = check_close(f"ln_geglu_wo {act} M={m} {dtype}", out,
                                  ops.ln_geglu_wo_plain(xs[:m], scale, ws, w_o, act), dtype)
            grads = ops.ln_geglu_wo_bwd(xs[:m], scale, ws, w_o, g[:m], act)
            wants = ops.ln_geglu_wo_bwd_plain(xs[:m], scale, ws, w_o, g[:m], act)
            errs = [check_grad(f"ln_geglu_wo_bwd {label} {act} M={m} {dtype}", a, b, dtype)
                    for label, a, b in zip(labels, grads, wants)]
            again = ops.ln_geglu_wo_bwd(xs[:m], scale, ws, w_o, g[:m], act)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError("ln_geglu_wo_bwd gave other bits the second time")
            fwd["max_abs_err"][dtype] = max(fwd["max_abs_err"].get(dtype, 0.0), out_err)
            bwd["max_abs_err"][dtype] = max(bwd["max_abs_err"].get(dtype, 0.0), *errs)
            a, r = BWD_TOL[dtype]
            phase(f"phase 3e whole MLP {str(dtype)[6:]} {act} M={m}: forward max_abs_err "
                  f"{out_err:.3e} (tol atol {TOL[dtype][0]} + rtol {TOL[dtype][1]}); backward "
                  + ", ".join(f"{label} {e:.3e}" for label, e in zip(labels, errs))
                  + f" (tol {a}·max|plain| + {r}·|plain|), the same bits twice")
        relu_at_the_step(f"phase 3e whole MLP {str(dtype)[6:]} relu", x, scale, w_i, w_o, g, dtype,
                         bwd)
        torch.cuda.synchronize()

    # Times at B=32, S=512, bf16 (the last dtype of the loop above).
    hidden = ops.ln_geglu(x, scale, w_i, "gelu")

    def split_backward():
        dh = g @ w_o
        return g.t() @ hidden, ops.ln_geglu_bwd(x, scale, w_i, dh, "gelu")

    timings = {
        "ln_geglu_wo": paired_ms(lambda: ops.ln_geglu_wo(x, scale, w_i, w_o, "gelu"),
                                 lambda: ops.ln_geglu_wo_plain(x, scale, w_i, w_o, "gelu")),
        "ln_geglu_wo_bwd": paired_ms(
            lambda: ops.ln_geglu_wo_bwd(x, scale, w_i, w_o, g, "gelu"),
            lambda: ops.ln_geglu_wo_bwd_plain(x, scale, w_i, w_o, g, "gelu")),
    }
    split = {
        "ln_geglu_wo": cuda_ms(lambda: F.linear(ops.ln_geglu(x, scale, w_i, "gelu"), w_o)),
        "ln_geglu_wo_bwd": cuda_ms(split_backward),
    }
    bounds = gemm_bounds(rows)
    design = kernels.built_mlp_tail_design(HIDDEN)
    phase(f"phase 3e design bf16 K={HIDDEN}: {json.dumps(design)}")
    for name, (ms, plain_ms) in timings.items():
        stats[name].update(ms=ms, plain_ms=plain_ms, library_ms=None, split_path_ms=split[name],
                           design=design, **bounds[name])
        phase(f"phase 3e time {name} B=32 S=512 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bounds[name]['bound_ms']:.4f} ms by {bounds[name]['bound_by']}, one "
              f"PyTorch call none (it takes three); the split path (kernel "
              f"{'4' if name == 'ln_geglu_wo' else '11'} and the library's Wo products) "
              f"{split[name]:.4f} ms")


def base_config(max_length: int = 512, **backbone_overrides):
    """ModernBERT-base widths and depth unless overridden (a cut in depth
    for a CPU comparison, a bias layout)."""
    from open_provence_tpu_torch import ModernBertBackboneConfig, OpenProvenceConfig

    backbone = ModernBertBackboneConfig(pad_token_id=0, num_labels=1, **backbone_overrides)
    return OpenProvenceConfig(
        base_model_config=backbone.to_dict(), num_labels=1,
        pruning_config={"hidden_size": HIDDEN, "classifier_dropout": 0.0},
        max_length=max_length,
    )


def scores(module, ids, mask):
    from open_provence_tpu_torch import keep_probs_from_logits, ranking_score_from_logits

    with torch.inference_mode():
        out = module(ids, mask)
    return ranking_score_from_logits(out["ranking_logits"]), keep_probs_from_logits(out["pruning_logits"])


def phase4_model(config, sd, dev, label: str = "phase 4") -> None:
    from open_provence_tpu_torch import build_module

    cpu = build_module(config)
    cpu.load_state_dict(sd)
    cpu.eval()
    gen = torch.Generator().manual_seed(4)
    ids = torch.randint(3, 50000, (2, 512), generator=gen)
    mask = torch.ones(2, 512, dtype=torch.int32)
    mask[1, 300:] = 0
    ids[mask == 0] = 0
    rank_ref, keep_ref = scores(cpu, ids, mask)
    valid = mask.bool()
    # bf16: the random-weight residual stream grows over 22 layers and the
    # pruning logits read it before the final norm, so bf16 rounding moves
    # keep-probs by up to ~0.07 even on the CPU's own bf16 plain path.
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 0.15)):
        card = copy.deepcopy(cpu).to(device=dev, dtype=dtype)
        rank, keep = (t.cpu() for t in scores(card, ids.to(dev), mask.to(dev)))
        torch.cuda.synchronize()
        rank_err = (rank - rank_ref).abs().max().item()
        keep_diff = (keep - keep_ref)[valid].abs()
        keep_err = keep_diff.max().item()
        phase(f"{label} model {str(dtype)[6:]} card vs fp32 cpu, B=2 S=512, "
              f"{config.backbone().num_hidden_layers} layers: ranking max_abs_err {rank_err:.3e}, "
              f"keep-prob max_abs_err {keep_err:.3e} (mean {keep_diff.mean().item():.3e}; tol {tol})")
        if not (rank_err <= tol and keep_err <= tol):
            raise AssertionError(f"model {dtype} disagrees with the CPU fp32 result")
        del card


def synthetic_pairs(n_pairs: int, sentences_per_doc: int = 24, seed: int = 0):
    """The JAX package's bench_suite.bench_process inputs."""
    rng = np.random.default_rng(seed)
    words = "sushi ramen kyoto market travel budget deadline plants river temple".split()
    questions = [f"what about {rng.choice(words)} ?" for _ in range(n_pairs)]
    contexts = [
        " ".join(
            f"sentence {i} about {rng.choice(words)} and {rng.choice(words)} ."
            for i in range(sentences_per_doc)
        )
        for _ in range(n_pairs)
    ]
    return questions, contexts


def fp32_flips(label: str, config, sd, tokenizer_cls, dev, questions, contexts) -> None:
    """``process()`` in fp32 on the card against fp32 on the CPU: no keep/drop
    decision may differ among sentences further than 1e-4 from the
    threshold."""
    from open_provence_tpu_torch import OpenProvenceModel

    th, margin = 0.1, 1e-4
    kw = dict(threshold=th, show_progress=False, return_sentence_metrics=True)
    outs = [
        OpenProvenceModel(config, sd, tokenizer_cls(), device=d, dtype=torch.float32).process(
            questions, contexts, **kw
        )
        for d in (dev, "cpu")
    ]
    card, cpu = (np.concatenate([np.asarray(p) for p in o["sentence_probabilities"]]) for o in outs)
    decided = np.abs(cpu - th) > margin
    flips = int(np.sum((card > th)[decided] != (cpu > th)[decided]))
    score_err = float(np.max(np.abs(np.subtract(outs[0]["reranking_score"], outs[1]["reranking_score"]))))
    phase(f"{label} fp32 card vs cpu, {len(questions)} pairs: {flips} keep/drop flips among "
          f"{int(decided.sum())} sentences decided by > {margin}, sentence-prob max_abs_err "
          f"{np.max(np.abs(card - cpu)):.3e}, score max_abs_err {score_err:.3e}")
    if flips:
        raise AssertionError(f"{label}: fp32 keep/drop decisions differ between card and CPU")


def check_served(label: str, model, questions, contexts, result) -> np.ndarray:
    """``result`` (``process()`` at threshold 0.1 on the pairs) holds one
    payload a pair and finite scores in [0, 1]; on 16 of the pairs threshold
    0 gives the input back and threshold 1 prunes it all and zeroes the
    score. Returns the scores."""
    ranks = np.asarray(result["reranking_score"], dtype=np.float64)
    if len(result["pruned_context"]) != len(contexts) or not np.all(np.isfinite(ranks)):
        raise AssertionError(f"{label}: process() payload has the wrong length or non-finite "
                             "scores")
    if not np.all((ranks >= 0) & (ranks <= 1)):
        raise AssertionError(f"{label}: scores outside [0, 1]")
    keep_all = model.process(questions[:16], contexts[:16], threshold=0.0, show_progress=False)
    if keep_all["pruned_context"] != contexts[:16]:
        raise AssertionError(f"{label}: threshold 0.0 did not reproduce the input")
    drop_all = model.process(questions[:16], contexts[:16], threshold=1.0, show_progress=False)
    if any(drop_all["pruned_context"]) or any(s != 0.0 for s in drop_all["reranking_score"]):
        raise AssertionError(f"{label}: threshold 1.0 did not prune everything and zero the score")
    return ranks


def phase5_process(config, sd, tokenizer_cls, dev):
    from open_provence_tpu_torch import OpenProvenceModel, kernels

    model = OpenProvenceModel(config, sd, tokenizer_cls(), device=dev)  # bf16 on the card
    questions, contexts = synthetic_pairs(256)

    kernels.reset_launch_counts()
    result = model.process(questions, contexts, threshold=0.1, show_progress=False)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    phase(f"phase 5 process() bf16, 256 pairs, serving path launches: {json.dumps(launches)}")
    missing = [name for name in FORWARD if launches[name] == 0]
    if missing or any(kernels.plain_counts().values()):
        raise AssertionError(f"the serving path never launched {missing} or ran a plain version")
    ranks = check_served("phase 5", model, questions, contexts, result)
    kept = sum(len(c) for c in result["pruned_context"]) / sum(len(c) for c in contexts)
    phase(f"phase 5 process() checks: scores finite in [{ranks.min():.4f}, {ranks.max():.4f}], "
          f"kept {kept:.3f} of the text at threshold 0.1; threshold 0 exact, threshold 1 empty")

    fp32_flips("phase 5", config, sd, tokenizer_cls, dev, questions[:8], contexts[:8])
    return model, launches, (questions, contexts)


@contextlib.contextmanager
def plain_ops():
    """Route the model through the plain versions on the card, for a
    whole-forward comparison only (never on the main path)."""
    from open_provence_tpu_torch import ops
    from open_provence_tpu_torch.models import modernbert

    names = {
        "layer_norm": ops.layer_norm_plain,
        "ln_matmul": ops.ln_matmul_plain,
        "ln_geglu": ops.ln_geglu_plain,
        "flash_attention_packed": ops.attention_packed_plain,
    }
    saved = {n: getattr(modernbert, n) for n in names}
    try:
        for n, fn in names.items():
            setattr(modernbert, n, fn)
        yield
    finally:
        for n, fn in saved.items():
            setattr(modernbert, n, fn)


# Device time by kernel under torch.profiler: the port's own kernels under
# these names, the rest by the first words of theirs (cuBLAS, torch's
# elementwise and reductions).
OUR_KERNELS = {
    # An older tree's (a parent's, to compare with: --layouts).
    ("flash_mma_kernel",): "attention fwd", ("dkv_mma_kernel",): "attention bwd dK/dV",
    ("dq_mma_kernel",): "attention bwd dQ", ("delta_kernel",): "attention bwd delta",
    ("flash_wgmma_kernel",): "attention fwd", ("dkv_wgmma_kernel",): "attention bwd dK/dV",
    ("dkv_split_kernel",): "attention bwd dK/dV", ("dkv_roles_kernel",): "attention bwd dK/dV",
    ("dq_wgmma_kernel",): "attention bwd dQ",
    ("rotate_rows_kernel",): "attention rope into scratch",
    ("gemm_wgmma_kernel", "<true, true"): "GEMM engine, wgmma dW = G^T.xn",
    ("gemm_wgmma_kernel", "<false, true"): "GEMM engine, wgmma dy = G.W",
    ("gemm_wgmma_kernel",): "GEMM engine, wgmma xn.W^T",
    ("dw_sum_kernel",): "GEMM engine, dW chunk sum",
    ("ln_adjoint", "row_kernel"): "LN adjoint rows",  # register_row_kernel, row_kernel
    ("ln_adjoint", "reduce_kernel"): "LN adjoint dscale",
    ("normalize_kernel",): "LN->GEMM normalize",
    ("geglu_grad_kernel",): "GeGLU bwd chain",
    ("add_layer_norm_kernel",): "add + LayerNorm fwd",
    ("tail_fwd_mma_kernel",): "whole MLP fwd", ("tail_bwd_rows_mma_kernel",): "whole MLP bwd rows",
    ("layer_norm_kernel",): "LayerNorm fwd",
}


def profile_by_kernel(label: str, fn, reps: int, shares: dict | None = None) -> float:
    """Print where the device time of ``reps`` calls of ``fn`` goes; returns
    the device milliseconds a call (0.0 if the profiler saw none) and, into
    ``shares`` where given, each group's fraction of it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        began = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - began
    device_us: dict[str, float] = {}
    launches = 0.0
    for evt in prof.key_averages():  # kernel rows only, so nothing counts twice
        if getattr(evt.device_type, "name", "") != "CUDA":
            continue
        us = getattr(evt, "self_device_time_total", 0.0) or getattr(evt, "device_time_total", 0.0)
        name = next((v for keys, v in OUR_KERNELS.items() if all(k in evt.key for k in keys)),
                    evt.key.split("<")[0][:48])
        device_us[name] = device_us.get(name, 0.0) + us
        launches += evt.count / reps
    total_us = sum(device_us.values())
    if not total_us:
        phase(f"{label}: wall {wall * 1e3:.1f} ms; the profiler saw no device time")
        return 0.0
    if shares is not None:
        shares.update({g: us / total_us for g, us in device_us.items()})
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:14]
    top_note = "; ".join(f"{g} {100 * us / total_us:.1f} %" for g, us in top)
    phase(f"{label}: wall {wall * 1e3:.1f} ms, device busy {total_us / 1e3:.1f} ms "
          f"({total_us / 1e6 / wall:.3f} of wall), {launches:.0f} kernel launches a call; "
          f"by kernel: {top_note}")
    return total_us / 1e3 / reps


def forward_ms(model, batch: int, seq: int, label: str, card: str, with_plain: bool = True,
               profile: bool = True) -> float:
    """Milliseconds of one bf16 forward of ``model.module`` at [batch, seq]."""
    from open_provence_tpu_torch import kernels

    gen = torch.Generator().manual_seed(6)
    ids = torch.randint(3, 50000, (batch, seq), generator=gen).to(model.device)
    mask = torch.ones(batch, seq, dtype=torch.int32, device=model.device)

    def forward():
        with torch.inference_mode():
            model.module(ids, mask)

    def forward_plain():
        with plain_ops():
            forward()

    kernels.reset_launch_counts()
    forward()
    per_forward = {k: n for k, n in kernels.launch_counts().items() if n}
    if with_plain:
        fwd_ms, plain_fwd_ms = paired_ms(forward, forward_plain)
        plain_note = (f"; {batch * 1e3 / plain_fwd_ms:.1f} pairs/s ({plain_fwd_ms:.2f} ms/batch) "
                      "on plain versions")
    else:
        fwd_ms, plain_note = (cuda_ms(forward) + cuda_ms(forward)) / 2, ""
    phase(f"{label} forward B={batch} S={seq} bf16: {batch * 1e3 / fwd_ms:.1f} pairs/s, "
          f"{batch * seq * 1e3 / fwd_ms:.0f} tokens/s ({fwd_ms:.2f} ms/batch) on kernels"
          f"{plain_note}; launches a forward {json.dumps(per_forward)} [{card}]")
    if profile:
        profile_by_kernel(f"{label} profile of 5 forwards B={batch} S={seq} bf16", forward, 5)
    return fwd_ms


def phase6_timings(model, pairs, card: str, with_plain: bool = True) -> dict:
    fwd_ms = forward_ms(model, 32, 512, "phase 6", card, with_plain, profile=with_plain)

    questions, contexts = pairs
    for _ in range(2):
        model.process(questions, contexts, threshold=0.1, show_progress=False)
    times, inference = [], []
    for _ in range(5):
        began = time.perf_counter()
        out = model.process(questions, contexts, threshold=0.1, show_progress=False)
        times.append(time.perf_counter() - began)
        inference.append(out["performance_trace"].inference_seconds)
    median = statistics.median(times)
    phase(f"phase 6 process() 256 pairs bf16: {256 / median:.1f} pairs/s (median of 5 calls: "
          f"{median:.3f} s, inference {statistics.median(inference):.3f} s) [{card}]")
    return {"forward_pairs_per_s": 32e3 / fwd_ms, "process_pairs_per_s": 256 / median}


def training_batch(tokenizer, n_real: int, seq: int, seed: int,
                   n_sentences: tuple[int, int] = (6, 16)) -> dict:
    """n_real synthetic (question, document) pairs with sentence spans, a
    relevance label per sentence and a teacher score, collated to [n_real +
    1, seq]: the last pair is padding, as the collator adds it. A document
    has ``n_sentences[0]`` to ``n_sentences[1] - 1`` sentences of about 38
    characters (one token each)."""
    from open_provence_tpu_torch.train import OpenProvenceDataCollator

    rng = np.random.default_rng(seed)
    words = "sushi ramen kyoto market travel budget deadline plants river temple".split()
    rows = []
    for _ in range(n_real):
        topic = str(rng.choice(words))
        sentences, spans, relevance, pos = [], [], [], 0
        for i in range(int(rng.integers(*n_sentences))):
            a, b = rng.choice(words, 2)
            text = f"sentence {i} about {a} and {b} ."
            sentences.append(text)
            spans.append([pos, pos + len(text)])
            relevance.append(int(topic in (a, b)))
            pos += len(text) + 1
        rows.append({
            "query": f"what about {topic} ?", "texts": [" ".join(sentences)],
            "context_spans": [spans], "context_spans_relevance": [relevance],
            "labels": [int(any(relevance))], "teacher_score": [float(rng.uniform())],
        })
    collator = OpenProvenceDataCollator(
        tokenizer=tokenizer, max_length=seq, scores_column="teacher_score",
        chunks_pos_column="context_spans", relevant_chunks_column="context_spans_relevance",
        pad_pairs_to=n_real + 1,
    )
    batch = collator(rows)
    assert batch["pair_mask"][-1] == 0 and batch["attention_mask"][-1].sum() == 0
    return batch


def rel_errs(got: dict, want: dict) -> dict[str, float]:
    """Per tensor: the largest |got − want| over the tensor's largest |want|."""
    return {
        k: ((got[k].float().cpu() - w.float().cpu()).abs().max()
            / w.float().abs().max().clamp_min(1e-30)).item()
        for k, w in want.items()
    }


def max_rel_err(got: dict, want: dict) -> float:
    return max(rel_errs(got, want).values())


# Phase 7 tolerances, each relative to a tensor's own largest value.
# Gradients: fp32 on both sides, 22 layers of sums in another order.
# Updates: the card's update against the CPU optimizer's on the same
# inputs; they differ by the order of the optimizer's means (~1e-6) and by
# one fp32 ulp of p where p + u rounds the other way (at lr 1e-2 under
# 1e-4 of the tensor's largest update).
STEP_GRAD_TOL, STEP_UPDATE_TOL = 1e-4, 1e-3


def phase7_train_step(config, sd, tokenizer, dev, out_dir: Path, batch=None,
                      steps: tuple[int, ...] = (1, 2), label: str = "phase 7") -> None:
    """fp32 steps of the trainer on the card and on the CPU (two, on a B=2,
    S=512 batch, unless told otherwise). The warmup gives the first step a
    learning rate of 0, so both devices take sd's parameters into the
    second, whose rate is 1e-2. Held per step: the loss and every gradient
    tensor, card against CPU; and the card's update (parameters after minus
    before) against the update the CPU's optimizer makes from the card's own
    gradients, optimizer state and parameters. A zeroed, negated or 5x
    update must fail that check."""
    from open_provence_tpu_torch.train import OpenProvenceTrainer
    from open_provence_tpu_torch.train.optim import global_norm

    def cpu_copy(tree):
        return {k: v.detach().cpu().clone() for k, v in tree.items()}

    if batch is None:
        batch = training_batch(tokenizer, 1, 512, seed=7)
    shape = "B={} S={}".format(*batch["input_ids"].shape)
    card, host = (
        OpenProvenceTrainer(config, sd, tokenizer, output_dir=out_dir / d.type, bf16=False,
                            learning_rate=1e-2, total_steps=10, device=d)
        for d in (dev, torch.device("cpu"))
    )
    layers = config.backbone().num_hidden_layers
    for step in steps:
        params_before, state_before = cpu_copy(card.params), cpu_copy(card.opt_state)
        loss_c, _, grads_c = card.loss_and_grads(batch)
        card.apply_gradients(grads_c)
        loss_h, _, grads_h = host.loss_and_grads(batch)
        host.apply_gradients(grads_h)
        grads_c = cpu_copy(grads_c)
        loss_err = abs(float(loss_c) / float(loss_h) - 1)
        norm_c, norm_h = float(global_norm(grads_c)), float(global_norm(grads_h))
        grad_errs = rel_errs(grads_c, grads_h)
        worst_grad = max(grad_errs, key=grad_errs.get)
        # The update the CPU's optimizer makes from the card's inputs, put
        # through the same fp32 add.
        ref, _ = host.optimizer.update(grads_c, state_before, params_before)
        delta_ref = {k: (p + ref[k]) - p for k, p in params_before.items()}
        delta_card = {k: card.params[k].detach().cpu() - p for k, p in params_before.items()}
        update_err = max_rel_err(delta_card, delta_ref)
        largest = max(float(d.abs().max()) for d in delta_ref.values())
        faults = {"zeroed": 0.0, "negated": -1.0, "5x": 5.0}
        fault_errs = {
            name: max_rel_err({k: f * d for k, d in delta_card.items()}, delta_ref)
            for name, f in faults.items()
        }
        phase(f"{label} fp32 train step {step}, {layers} layers, {shape}, card vs cpu: loss "
              f"{float(loss_c):.6f} vs {float(loss_h):.6f} (rel err {loss_err:.3e}), grad norm "
              f"{norm_c:.6f} vs {norm_h:.6f}; gradients: largest error {grad_errs[worst_grad]:.3e} "
              f"of the tensor's largest ({worst_grad}; tol {STEP_GRAD_TOL}); update (largest "
              f"{largest:.3e}): card vs the CPU optimizer on the card's inputs {update_err:.3e} of "
              f"each tensor's largest (tol {STEP_UPDATE_TOL}); a planted fault would read "
              + ", ".join(f"{name} {e:.3e}" for name, e in fault_errs.items()))
        if not (loss_err <= 1e-4 and grad_errs[worst_grad] <= STEP_GRAD_TOL
                and update_err <= STEP_UPDATE_TOL):
            raise AssertionError(f"the fp32 training step {step} on the card disagrees with the CPU")
        if step == 2 and (largest == 0.0 or min(fault_errs.values()) <= STEP_UPDATE_TOL):
            raise AssertionError("the update check cannot tell a faulty update from the card's")


def train_steps(trainer, batches, n: int) -> list[float]:
    return [trainer.train_one_step(batches[i % len(batches)])["loss"] for i in range(n)]


def training_config(config):
    """``config`` with the pruning head's default dropout: masks on."""
    train_config = copy.deepcopy(config)
    train_config.pruning_config["classifier_dropout"] = 0.1
    return train_config


def make_trainer(train_config, sd_card, tokenizer, dev, directory, n_steps: int, **kwargs):
    """A trainer from weights that already lie on the card and no device=
    argument: it must stay where its parameters lie."""
    from open_provence_tpu_torch.train import OpenProvenceTrainer

    made = OpenProvenceTrainer(train_config, sd_card, tokenizer, output_dir=directory,
                               learning_rate=3e-4, total_steps=n_steps + 10, **kwargs)
    if made.device != dev or any(p.device != dev for p in made.params.values()):
        raise AssertionError(f"a trainer given parameters on {dev} runs on {made.device}")
    return made


def train_and_check(label: str, trainer, batches, n_steps: int, required) -> dict[str, int]:
    """``n_steps`` bf16 steps with the launch counts read around them: the
    eval loss on the same pairs (no dropout) must fall, every kernel in
    ``required`` must have launched and no plain version may have run."""
    from open_provence_tpu_torch import kernels

    shape = "B={} S={}".format(*batches[0]["input_ids"].shape)
    eval_before = trainer.evaluate(iter(batches))["eval_loss"]
    kernels.reset_launch_counts()
    losses = train_steps(trainer, batches, n_steps)
    torch.cuda.synchronize()
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    eval_after = trainer.evaluate(iter(batches))["eval_loss"]
    phase(f"{label} bf16 training, {shape}, {n_steps} steps: train loss "
          f"first {losses[0]:.4f}, last {losses[-1]:.4f} (all: "
          f"{', '.join(f'{v:.4f}' for v in losses)}); eval loss on the same pairs, no dropout: "
          f"{eval_before:.4f} -> {eval_after:.4f}; launches {json.dumps(launches)}; "
          f"plain versions {json.dumps(plain)}")
    if not all(np.isfinite(losses)) or not eval_after < eval_before:
        raise AssertionError(f"{label}: the training loss did not fall: {losses}")
    missing = [name for name in required if launches[name] == 0]
    if missing or any(plain.values()):
        raise AssertionError(f"{label}: the training path never launched {missing} or ran a "
                             "plain version")
    return launches


def train_rate(trainer, batches, steps: int = 5) -> tuple[float, float]:
    """(real pairs/s, real tokens/s) over ``steps`` synchronized steps."""
    real_pairs = float(np.mean([b["pair_mask"].sum() for b in batches]))
    real_tokens = float(np.mean([b["attention_mask"].sum() for b in batches]))
    train_steps(trainer, batches, 1)
    torch.cuda.synchronize()
    began = time.perf_counter()
    train_steps(trainer, batches, steps)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - began) / steps
    return real_pairs / per_step, real_tokens / per_step


def resume_check(label: str, trainer, fresh, batch) -> Path:
    """Save a checkpoint, take the next step, then take the same step on
    ``fresh`` (a new trainer) resumed from the checkpoint: the loss and every
    parameter must be bit-equal. Returns the checkpoint's directory."""
    ckpt = trainer.save_checkpoint()
    after = trainer.train_one_step(batch)["loss"]
    fresh.load_checkpoint(ckpt)
    again = fresh.train_one_step(batch)["loss"]
    diff = max_rel_err(fresh._detached(), trainer._detached())
    phase(f"{label} resume from {ckpt.name}: next step loss {again:.6f} vs {after:.6f} "
          f"without the resume; largest parameter difference {diff:.3e}")
    if again != after or diff != 0.0:
        raise AssertionError(f"{label}: the resumed step differs from the uninterrupted one")
    return ckpt


def phase8_train_then_serve(config, sd, tokenizer_cls, pair_tokenizer, dev, card: str,
                            out_dir: Path) -> dict[str, int]:
    from open_provence_tpu_torch import OpenProvenceModel
    from open_provence_tpu_torch.utils import safetensors_io

    batch_size, seq, n_steps = 32, 512, 20
    batches = [training_batch(pair_tokenizer, batch_size - 1, seq, seed=s) for s in (80, 81)]
    train_config = training_config(config)
    sd_card = {k: v.to(dev) for k, v in sd.items()}

    def make(directory):
        return make_trainer(train_config, sd_card, pair_tokenizer, dev, directory, n_steps)

    trainer = make(out_dir / "run")
    launches = train_and_check("phase 8", trainer, batches, n_steps, DEFAULT_EIGHT)

    ckpt = resume_check("phase 8", trainer, make(out_dir / "resumed"), batches[0])

    # Train pairs/s, kernels against plain versions, in turns.
    real_pairs = batch_size - 1

    def rate(plain_path: bool, steps: int = 5) -> float:
        with plain_ops() if plain_path else contextlib.nullcontext():
            return train_rate(trainer, batches, steps)[0]

    p1, k1, k2, p2 = rate(True, 2), rate(False), rate(False), rate(True, 2)
    kernel_rate, plain_rate = (k1 + k2) / 2, (p1 + p2) / 2
    phase(f"phase 8 train step B={batch_size} S={seq} bf16: {kernel_rate:.1f} pairs/s "
          f"({real_pairs / kernel_rate * 1e3:.1f} ms/step) on kernels; {plain_rate:.1f} "
          f"pairs/s ({real_pairs / plain_rate * 1e3:.1f} ms/step) on plain versions [{card}]")

    profile_by_kernel("phase 8 profile of 3 bf16 steps B=32 S=512",
                      lambda: train_steps(trainer, batches, 1), 3)

    # Serve the trained weights.
    weights = safetensors_io.load_file(ckpt / "model.safetensors")
    model = OpenProvenceModel(train_config, weights, tokenizer_cls(), device=dev)
    questions, contexts = synthetic_pairs(8, seed=8)
    result = model.process(questions, contexts, threshold=0.1, show_progress=False)
    ranks = np.asarray(result["reranking_score"], dtype=np.float64)
    if len(result["pruned_context"]) != 8 or not np.all(np.isfinite(ranks)):
        raise AssertionError("process() on the trained weights gave non-finite scores")
    phase(f"phase 8 process() on the trained weights, 8 pairs: scores "
          f"{', '.join(f'{r:.4f}' for r in ranks)}")
    return launches


def count_forwards(model):
    """Wrap the engine's bucketed forward to count what it is given: rows,
    valid tokens and rows by bucket length. Returns the counters."""
    seen = {"rows": 0, "tokens": 0, "by_length": {}}
    inner = model._forward

    def counted(input_ids, attention_mask):
        rows = int((attention_mask.sum(axis=1) > 0).sum())
        seen["rows"] += rows
        seen["tokens"] += int(attention_mask.sum())
        by = seen["by_length"]
        by[input_ids.shape[1]] = by.get(input_ids.shape[1], 0) + rows
        return inner(input_ids, attention_mask)

    model._forward = counted
    return seen


def phase9_long_context(sd, tokenizer_cls, pair_tokenizer, dev, card: str,
                        out_dir: Path) -> dict[str, dict[str, int]]:
    """Long context through the entry points: ``process()`` at max_length
    2048, then a trainer at B=8, S=2048. Returns the launch counts of the
    serving and the training run."""
    from open_provence_tpu_torch import OpenProvenceModel, kernels

    max_length = 2048
    config = base_config(max_length)
    # 48 sentences of ~38 characters (one token each): a pair fills 1700 to
    # 1950 tokens, so it lands in the 2048 bucket as one block.
    questions, contexts = synthetic_pairs(64, sentences_per_doc=48, seed=9)
    model = OpenProvenceModel(config, sd, tokenizer_cls(), device=dev)  # bf16 on the card
    shapes = model.warmup(batch_size=1, lengths=[1024, max_length])
    seen = count_forwards(model)

    kernels.reset_launch_counts()
    result = model.process(questions, contexts, threshold=0.1, show_progress=False)
    torch.cuda.synchronize()
    serve_launches, plain = kernels.launch_counts(), kernels.plain_counts()
    ranks = np.asarray(result["reranking_score"], dtype=np.float64)
    blocks_per_pair = seen["rows"] / len(questions)
    phase(f"phase 9 process() bf16 max_length={max_length}, {len(questions)} pairs (warm-up "
          f"ran {shapes}): {seen['rows']} blocks ({blocks_per_pair:.2f} a pair), rows by bucket "
          f"{json.dumps(seen['by_length'])}, {seen['tokens']} tokens; launches "
          f"{json.dumps(serve_launches)}; plain versions {json.dumps(plain)}")
    missing = [name for name in FORWARD if serve_launches[name] == 0]
    if missing or any(plain.values()):
        raise AssertionError(f"long-context serving never launched {missing} or ran a plain version")
    if seen["by_length"].get(max_length, 0) < len(questions) // 2 or blocks_per_pair > 1.25:
        raise AssertionError("the pairs did not go out as one 2048-token block each")
    if len(result["pruned_context"]) != len(questions) or not np.all(np.isfinite(ranks)):
        raise AssertionError("long-context process() gave the wrong length or non-finite scores")
    if not np.all((ranks >= 0) & (ranks <= 1)):
        raise AssertionError("scores outside [0, 1]")
    keep_all = model.process(questions[:4], contexts[:4], threshold=0.0, show_progress=False)
    if keep_all["pruned_context"] != contexts[:4]:
        raise AssertionError("threshold 0.0 did not reproduce the long input")
    drop_all = model.process(questions[:4], contexts[:4], threshold=1.0, show_progress=False)
    if any(drop_all["pruned_context"]) or any(v != 0.0 for v in drop_all["reranking_score"]):
        raise AssertionError("threshold 1.0 did not prune everything and zero the score")
    kept = sum(len(c) for c in result["pruned_context"]) / sum(len(c) for c in contexts)
    phase(f"phase 9 process() checks: scores finite in [{ranks.min():.4f}, {ranks.max():.4f}], "
          f"kept {kept:.3f} of the text at threshold 0.1; threshold 0 exact, threshold 1 empty")

    times = []
    for _ in range(4):  # the first call is a warm-up
        seen.update(rows=0, tokens=0, by_length={})
        began = time.perf_counter()
        model.process(questions, contexts, threshold=0.1, show_progress=False)
        times.append(time.perf_counter() - began)
    median = statistics.median(times[1:])
    phase(f"phase 9 process() {len(questions)} pairs bf16 max_length={max_length}: "
          f"{len(questions) / median:.1f} pairs/s, {seen['tokens'] / median:.0f} tokens/s "
          f"(median of 3 calls: {median:.3f} s) [{card}]")
    forward_ms(model, 8, max_length, "phase 9", card, with_plain=False)
    del model

    fp32_flips(f"phase 9 max_length={max_length}", config, sd, tokenizer_cls, dev, questions[:3],
               contexts[:3])

    # Training at B=8, S=2048: 7 real pairs of 1500 to 1950 tokens and a
    # padding pair. One fp32 step, card against CPU, at 3 layers (one global,
    # two local: what the CPU's fp32 [B, H, S, S] scores let it finish).
    batch_size, seq, n_steps = 8, max_length, 20
    batches = [training_batch(pair_tokenizer, batch_size - 1, seq, seed=s, n_sentences=(40, 50))
               for s in (90, 91)]
    filled = [int(n) for n in batches[0]["attention_mask"].sum(axis=1)]
    if max(filled) <= 1024 or batches[0]["input_ids"].shape != (batch_size, seq):
        raise AssertionError(f"the long training batch is not long: {filled}")
    cut = base_config(max_length, num_hidden_layers=3)
    from open_provence_tpu_torch import init_params

    phase7_train_step(cut, init_params(cut, torch.Generator().manual_seed(1)), pair_tokenizer,
                      dev, out_dir / "long_fp32", batch=batches[0], steps=(1,), label="phase 9")

    train_config = training_config(config)
    sd_card = {k: v.to(dev) for k, v in sd.items()}
    trainer = make_trainer(train_config, sd_card, pair_tokenizer, dev, out_dir / "long", n_steps)
    train_launches = train_and_check("phase 9", trainer, batches, n_steps, DEFAULT_EIGHT)
    rates = [train_rate(trainer, batches) for _ in range(2)]
    pairs_s, tokens_s = (float(np.mean(v)) for v in zip(*rates))
    phase(f"phase 9 train step B={batch_size} S={seq} bf16, rows filled {filled}: "
          f"{pairs_s:.1f} pairs/s, {tokens_s:.0f} tokens/s "
          f"({(batch_size - 1) / pairs_s * 1e3:.1f} ms/step) on kernels [{card}]")
    profile_by_kernel(f"phase 9 profile of 3 bf16 steps B={batch_size} S={seq}",
                      lambda: train_steps(trainer, batches, 1), 3)
    del trainer
    # What a step holds on the card, with and without per-layer recompute.
    for remat in (False, True):
        probe = make_trainer(train_config, sd_card, pair_tokenizer, dev,
                             out_dir / f"long_remat_{remat}", n_steps,
                             gradient_checkpointing=remat)
        train_steps(probe, batches, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = train_steps(probe, batches, 1)[0]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        phase(f"phase 9 step memory B={batch_size} S={seq} bf16, gradient_checkpointing={remat}: "
              f"peak {peak / 2**20:.0f} MiB, {(peak - base) / 2**20:.0f} MiB above the "
              f"parameters and optimizer state; loss {loss:.4f}")
        if not np.isfinite(loss):
            raise AssertionError("a long-context step gave a non-finite loss")
        del probe
    return {"serve_2048": serve_launches, "train_2048": train_launches}


# The bias-carrying checkpoint layouts: which kernels each must launch when
# serving and when training, beside the attention pair every layout runs.
BIAS_LAYOUTS = {
    "norm_bias": (
        dict(norm_bias=True),
        ("flash_attention_packed", "geglu"),
        ("flash_attention_packed", "geglu", "flash_attention_packed_bwd"),
    ),
    "mlp_bias+attention_bias": (
        dict(mlp_bias=True, attention_bias=True),
        ("layer_norm", "flash_attention_packed", "add_layer_norm"),
        ("layer_norm", "flash_attention_packed", "add_layer_norm", "layer_norm_bwd",
         "flash_attention_packed_bwd"),
    ),
}


def phase10_bias_layouts(tokenizer_cls, pair_tokenizer, dev, out_dir: Path):
    """Each layout at base width and 22 layers, its biases drawn at random
    (init leaves them 0): the model on the card against the CPU in fp32,
    ``process()`` on 16 pairs and 20 training steps, with the launch counts
    of the layout's kernels."""
    from open_provence_tpu_torch import OpenProvenceModel, build_module, init_params, kernels

    all_launches = {}
    for name, (flags, serve_required, train_required) in BIAS_LAYOUTS.items():
        config = base_config(512, **flags)
        gen = torch.Generator().manual_seed(10)
        sd = init_params(config, gen)
        n_bias = 0
        for key, value in sd.items():
            if key.endswith(".bias"):
                sd[key] = torch.randn(value.shape, generator=gen) * 0.05
                n_bias += 1

        cpu = build_module(config)
        cpu.load_state_dict(sd)
        cpu.eval()
        ids = torch.randint(3, 50000, (2, 512), generator=gen)
        mask = torch.ones(2, 512, dtype=torch.int32)
        mask[1, 300:] = 0
        ids[mask == 0] = 0
        rank_ref, keep_ref = scores(cpu, ids, mask)
        card_module = copy.deepcopy(cpu).to(device=dev)
        rank, keep = (t.cpu() for t in scores(card_module, ids.to(dev), mask.to(dev)))
        rank_err = (rank - rank_ref).abs().max().item()
        keep_err = (keep - keep_ref)[mask.bool()].abs().max().item()
        phase(f"phase 10 {name}: {n_bias} bias tensors; fp32 card vs cpu, B=2 S=512, 22 layers: "
              f"ranking max_abs_err {rank_err:.3e}, keep-prob max_abs_err {keep_err:.3e} (tol 1e-3)")
        if not (rank_err <= 1e-3 and keep_err <= 1e-3):
            raise AssertionError(f"the {name} model on the card disagrees with the CPU")
        del card_module, cpu

        model = OpenProvenceModel(config, sd, tokenizer_cls(), device=dev)
        questions, contexts = synthetic_pairs(16, seed=10)
        kernels.reset_launch_counts()
        result = model.process(questions, contexts, threshold=0.1, show_progress=False)
        torch.cuda.synchronize()
        serve, plain = kernels.launch_counts(), kernels.plain_counts()
        ranks = np.asarray(result["reranking_score"], dtype=np.float64)
        keep_all = model.process(questions[:4], contexts[:4], threshold=0.0, show_progress=False)
        phase(f"phase 10 {name} process() bf16, 16 pairs: scores in [{ranks.min():.4f}, "
              f"{ranks.max():.4f}]; launches {json.dumps(serve)}; plain {json.dumps(plain)}")
        missing = [k for k in serve_required if serve[k] == 0]
        if missing or any(plain.values()) or not np.all(np.isfinite(ranks)):
            raise AssertionError(f"{name} serving never launched {missing}, ran a plain version "
                                 "or gave non-finite scores")
        if keep_all["pruned_context"] != contexts[:4]:
            raise AssertionError(f"{name}: threshold 0.0 did not reproduce the input")
        del model

        batches = [training_batch(pair_tokenizer, 31, 512, seed=s) for s in (100, 101)]
        trainer = make_trainer(training_config(config), {k: v.to(dev) for k, v in sd.items()},
                               pair_tokenizer, dev, out_dir / f"bias_{len(all_launches)}", 20)
        train = train_and_check(f"phase 10 {name}", trainer, batches, 20, train_required)
        pairs_s, _ = train_rate(trainer, batches)
        phase(f"phase 10 {name} train step B=32 S=512 bf16: {pairs_s:.1f} pairs/s")
        moved = max(float(v.detach().abs().max()) for k, v in trainer.params.items()
                    if k.endswith(".bias"))
        if not np.isfinite(moved):
            raise AssertionError(f"{name}: a bias is not finite after training")
        del trainer
        all_launches[f"serve_{name}"], all_launches[f"train_{name}"] = serve, train
    return all_launches


# The fp32 card-vs-CPU checks of phases 11 and 12 (drive_path) run on the
# first 3 layers (one global, two local), where the CPU's share of them
# takes seconds; phase 4's model check per layout, phase 5's flips and phase
# 7's steps keep all 22 (a cut that keeps chip_smoke.py under 600 s).
CPU_CHECK_LAYERS = 3


def cut_depth(config, sd, layers: int):
    """``config`` and ``sd`` cut to their first ``layers`` backbone layers."""
    cut = copy.deepcopy(config)
    cut.base_model_config = {**cut.base_model_config, "num_hidden_layers": layers}
    prefix = "ranking_model.model.layers."
    kept = {k: v for k, v in sd.items()
            if not (k.startswith(prefix) and int(k[len(prefix):].split(".")[0]) >= layers)}
    return cut, kept


def drive_path(label: str, config, sd, tokenizer_cls, pair_tokenizer, dev, card: str,
               out_dir: Path, serve_required, train_required, resume: bool = False):
    """One configuration end to end at base width: the model in fp32 and
    bf16 on the card against fp32 on the CPU; ``process()`` in bf16 on the 256
    pairs of phase 5 with the launch counts read around it; fp32 keep/drop
    flips on 8 of them and one fp32 training step (B=2, S=512) against the
    CPU, both on the first CPU_CHECK_LAYERS layers; 20 bf16 training steps
    at B=32, S=512 (phase 8's schedule) whose eval loss must fall and, with
    ``resume``, phase 8's bit-exact resume.
    Every kernel in ``serve_required`` / ``train_required`` must have launched
    and no plain version may have run. Returns (serving launches, training
    launches)."""
    from open_provence_tpu_torch import OpenProvenceModel, kernels

    phase4_model(config, sd, dev, label)
    model = OpenProvenceModel(config, sd, tokenizer_cls(), device=dev)  # bf16 on the card
    questions, contexts = synthetic_pairs(256)
    kernels.reset_launch_counts()
    result = model.process(questions, contexts, threshold=0.1, show_progress=False)
    torch.cuda.synchronize()
    serve, plain = kernels.launch_counts(), kernels.plain_counts()
    ranks = np.asarray(result["reranking_score"], dtype=np.float64)
    phase(f"{label} process() bf16, 256 pairs: scores in [{ranks.min():.4f}, {ranks.max():.4f}]; "
          f"launches {json.dumps(serve)}; plain versions {json.dumps(plain)}")
    missing = [name for name in serve_required if serve[name] == 0]
    if missing or any(plain.values()):
        raise AssertionError(f"{label}: serving never launched {missing} or ran a plain version")
    if len(result["pruned_context"]) != 256 or not np.all(np.isfinite(ranks)):
        raise AssertionError(f"{label}: process() gave the wrong length or non-finite scores")
    if not np.all((ranks >= 0) & (ranks <= 1)):
        raise AssertionError(f"{label}: scores outside [0, 1]")
    keep_all = model.process(questions[:16], contexts[:16], threshold=0.0, show_progress=False)
    if keep_all["pruned_context"] != contexts[:16]:
        raise AssertionError(f"{label}: threshold 0.0 did not reproduce the input")
    times = []
    for _ in range(4):  # the first call is a warm-up
        began = time.perf_counter()
        model.process(questions, contexts, threshold=0.1, show_progress=False)
        times.append(time.perf_counter() - began)
    median = statistics.median(times[1:])
    phase(f"{label} process() 256 pairs bf16: {256 / median:.1f} pairs/s (median of 3 calls: "
          f"{median:.3f} s) [{card}]")
    forward_ms(model, 32, 512, label, card, with_plain=False, profile=False)
    del model
    cut, cut_sd = cut_depth(config, sd, CPU_CHECK_LAYERS)
    fp32_flips(label, cut, cut_sd, tokenizer_cls, dev, questions[:8], contexts[:8])

    tag = label.replace(" ", "_").replace("=", "_")
    phase7_train_step(cut, cut_sd, pair_tokenizer, dev, out_dir / f"{tag}_fp32", steps=(1,),
                      label=label)
    batches = [training_batch(pair_tokenizer, 31, 512, seed=s) for s in (110, 111)]
    sd_card = {k: v.to(dev) for k, v in sd.items()}

    def make(directory):
        return make_trainer(training_config(config), sd_card, pair_tokenizer, dev, directory, 20)

    trainer = make(out_dir / tag)
    train = train_and_check(label, trainer, batches, 20, train_required)
    if resume:
        resume_check(label, trainer, make(out_dir / f"{tag}_resumed"), batches[0])
    pairs_s = float(np.mean([train_rate(trainer, batches)[0] for _ in range(2)]))
    phase(f"{label} train step B=32 S=512 bf16: {pairs_s:.1f} pairs/s "
          f"({31 / pairs_s * 1e3:.1f} ms/step) [{card}]")
    return serve, train


def phase11_head_layouts(tokenizer_cls, pair_tokenizer, dev, card: str, out_dir: Path):
    """The two base-width head layouts for which the JAX package leaves its
    packed kernel: 24 heads of 32 (2·D is no multiple of 128) and 3 heads of
    256 (an odd head count). The model's one call to the packed wrapper
    launches the attention kernels on strided views of the Wqkv output, as it
    does for every layout."""
    from open_provence_tpu_torch import init_params

    others = ("layer_norm", "ln_matmul", "ln_geglu")
    serve_required = (*others, "flash_attention")
    train_required = (*serve_required, "flash_attention_bwd",
                      *(f"{name}_bwd" for name in others))
    all_launches = {}
    for heads in (24, 3):
        config = base_config(num_attention_heads=heads)
        head_dim = config.backbone().head_dim
        sd = init_params(config, torch.Generator().manual_seed(11))
        serve, train = drive_path(
            f"phase 11 {heads}x{head_dim}", config, sd, tokenizer_cls, pair_tokenizer, dev, card,
            out_dir, serve_required, train_required)
        all_launches[f"serve_{heads}x{head_dim}"] = serve
        all_launches[f"train_{heads}x{head_dim}"] = train
    return all_launches


@contextlib.contextmanager
def mlp_tail_gate(value: str):
    """Build modules with the whole-MLP gate at ``value`` (it is read when a
    module is built)."""
    saved = os.environ.get(MLP_TAIL_GATE)
    os.environ[MLP_TAIL_GATE] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ[MLP_TAIL_GATE]
        else:
            os.environ[MLP_TAIL_GATE] = saved


# The three gates round at the same points, so from the same weights, batch
# and dropout masks they differ by bf16 roundings of sums taken in another
# order, carried through 22 layers. Gradients: per tensor, of its largest
# value (an H100 measured 6.4e-3 at most, a median of 3.6e-3). Losses:
# relative, over the first steps of the same schedule (1.0e-3 at most).
GATE_GRAD_TOL, GATE_LOSS_TOL = 2e-2, 1e-2


def gates_agree(trainers: dict, batches) -> None:
    """Hold the fused MLP (gates 1 and bwd) to the split one (gate 0) in bf16
    training: the loss and every gradient tensor of one batch before any
    step, then the losses of the first four steps. The trainers start from
    the same weights and seed. With gate bwd the forward is gate 0's, so its
    first loss has gate 0's bits."""
    losses, grads = {}, {}
    for gate, trainer in trainers.items():
        loss, _, grads[gate] = trainer.loss_and_grads(batches[0])
        losses[gate] = float(loss)
    for gate in ("1", "bwd"):
        errs = {k: ((grads[gate][k] - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
                for k, w in grads["0"].items()}
        worst = max(errs, key=errs.get)
        loss_err = abs(losses[gate] / losses["0"] - 1)
        phase(f"phase 12 gate {gate} against gate 0, bf16, B=32 S=512, before any step: loss "
              f"{losses[gate]:.6f} vs {losses['0']:.6f} (rel err {loss_err:.3e}, tol "
              f"{GATE_LOSS_TOL}); gradients: largest error {errs[worst]:.3e} of the tensor's "
              f"largest ({worst}; median over tensors {statistics.median(errs.values()):.3e}; tol "
              f"{GATE_GRAD_TOL}; a zeroed gradient would read 1)")
        if gate == "bwd" and losses[gate] != losses["0"]:
            raise AssertionError("gate bwd's forward gave another loss than gate 0's")
        if not (loss_err <= GATE_LOSS_TOL and errs[worst] <= GATE_GRAD_TOL):
            raise AssertionError(f"gate {gate}'s loss or gradients left gate 0's")
    del grads
    steps = {gate: train_steps(trainer, batches, 4) for gate, trainer in trainers.items()}
    phase("phase 12 first four bf16 step losses by gate: "
          + "; ".join(f"{gate}: {', '.join(f'{v:.4f}' for v in steps[gate])}" for gate in steps)
          + f" (tol {GATE_LOSS_TOL} of gate 0's)")
    for gate in ("1", "bwd"):
        if any(abs(v / w - 1) > GATE_LOSS_TOL for v, w in zip(steps[gate], steps["0"])):
            raise AssertionError(f"gate {gate}'s step losses left gate 0's")


def phase12_whole_mlp(sd, tokenizer_cls, pair_tokenizer, dev, card: str, out_dir: Path):
    """The whole-MLP fusion on the default layout. First the three values of
    the gate beside each other in this process: the forward at B=32, S=512 and
    B=8, S=2048; the fused gates' loss, gradients and first step losses held
    to gate 0's (``gates_agree``); the training step's wall and device time at
    B=32, S=512, each value once (0, 1, bwd). Then gate 1 end to end
    (``drive_path``, with the bit-exact resume), and gate bwd's training."""
    from open_provence_tpu_torch import OpenProvenceModel, kernels
    from open_provence_tpu_torch.models.modernbert import MLP_TAIL_DEFAULT

    config, gates, turns = base_config(), ("0", "1", "bwd"), ("0", "1", "bwd", "bwd", "1", "0")
    models = {}
    for gate in gates:
        with mlp_tail_gate(gate):
            models[gate] = OpenProvenceModel(config, sd, tokenizer_cls(), device=dev)
    gen = torch.Generator().manual_seed(12)
    for batch, seq in ((32, 512), (8, 2048)):
        ids = torch.randint(3, 50000, (batch, seq), generator=gen).to(dev)
        mask = torch.ones(batch, seq, dtype=torch.int32, device=dev)
        ms = {gate: [] for gate in gates}
        for gate in turns:
            def forward(module=models[gate].module):
                with torch.inference_mode():
                    module(ids, mask)
            ms[gate].append(cuda_ms(forward))
        kernels.reset_launch_counts()
        with torch.inference_mode():
            models["1"].module(ids, mask)
        counts = kernels.launch_counts()
        phase(f"phase 12 forward B={batch} S={seq} bf16, ms a batch by gate (each twice, in turns): "
              + "; ".join(f"{gate}: {ms[gate][0]:.2f}, {ms[gate][1]:.2f}" for gate in gates)
              + f"; gate 1 launches ln_geglu_wo {counts['ln_geglu_wo']}, ln_geglu "
              f"{counts['ln_geglu']} a forward [{card}]")
        if counts["ln_geglu_wo"] != config.backbone().num_hidden_layers or counts["ln_geglu"]:
            raise AssertionError("gate 1 did not send every layer's MLP through kernel 8")
    del models

    batches = [training_batch(pair_tokenizer, 31, 512, seed=s) for s in (120, 121)]
    train_config = training_config(config)
    sd_card = {k: v.to(dev) for k, v in sd.items()}
    trainers = {}
    for gate in gates:
        with mlp_tail_gate(gate):
            trainers[gate] = make_trainer(train_config, sd_card, pair_tokenizer, dev,
                                          out_dir / f"gate_{gate}", 40)
    gates_agree(trainers, batches)
    wall = {gate: [] for gate in gates}
    device = {gate: [] for gate in gates}
    for gate in gates:
        pairs_s = train_rate(trainers[gate], batches, 4)[0]
        wall[gate].append(31 / pairs_s * 1e3)
        device[gate].append(profile_by_kernel(
            f"phase 12 profile of 3 bf16 steps B=32 S=512, gate {gate}",
            lambda: train_steps(trainers[gate], batches, 1), 3))
    phase("phase 12 train step B=32 S=512 bf16 by gate (once each): "
          + "; ".join(f"{gate}: wall {wall[gate][0]:.1f} ms, device {device[gate][0]:.1f} ms"
                      for gate in gates)
          + f"; the default is {MLP_TAIL_DEFAULT} [{card}]")
    del trainers

    split = ("ln_geglu", "ln_geglu_bwd")
    fused_serve = (*(k for k in FORWARD if k not in split), "ln_geglu_wo")
    fused_train = (*(k for k in DEFAULT_EIGHT if k not in split), "ln_geglu_wo", "ln_geglu_wo_bwd")
    all_launches = {}
    with mlp_tail_gate("1"):
        serve, train = drive_path(
            "phase 12 gate=1", config, sd, tokenizer_cls, pair_tokenizer, dev, card, out_dir,
            fused_serve, fused_train, resume=True)
        if any(serve[k] or train[k] for k in split):
            raise AssertionError("gate 1 ran the split MLP kernels")
    all_launches["serve_fused_mlp"], all_launches["train_fused_mlp"] = serve, train
    with mlp_tail_gate("bwd"):
        trainer = make_trainer(train_config, sd_card, pair_tokenizer, dev, out_dir / "gate_bwd_run",
                               20)
        train = train_and_check(
            "phase 12 gate=bwd", trainer, batches, 20,
            (*(k for k in DEFAULT_EIGHT if k != "ln_geglu_bwd"), "ln_geglu_wo_bwd"))
        if train["ln_geglu_bwd"] or train["ln_geglu_wo"]:
            raise AssertionError("gate bwd ran kernel 11 or kernel 8")
        del trainer
    all_launches["train_fused_mlp_bwd"] = train
    return all_launches


# Phase 13's checkpoint layouts, each written from one state dict: the
# names as the reference's legacy root-level files and flat backbones carry
# them (utils/hf_convert.py::normalize_state_dict undoes both).
CHECKPOINT_LAYOUTS = {
    "legacy_root_level": lambda k: k.removeprefix("ranking_model."),
    "flat_backbone": lambda k: k.replace("ranking_model.model.", "ranking_model.", 1),
}
ENCODER_SCORE_TOL, KEEP_MARGIN = 1e-3, 1e-4
# bf16 encoder on the card against the fp32 encoder on the CPU: phase 4's
# bf16 model tolerance on each score and keep probability, and on the mean
# keep-probability error four times the mean phase 4 reads (7.5e-3).
ENCODER_BF16_TOL, ENCODER_BF16_MEAN_TOL = 0.15, 0.03
ENCODER_BF16_PAIRS = 16


def checkpoint_dirs(config, sd, pair_tokenizer_cls, out_dir: Path) -> dict[str, Path]:
    """The same weights written four ways: by the trainer's export_model and
    the encoder's save_pretrained (merged keys), and in the legacy
    root-level and flat-backbone layouts."""
    from open_provence_tpu_torch import OpenProvenceEncoder
    from open_provence_tpu_torch.train import OpenProvenceTrainer
    from open_provence_tpu_torch.utils import safetensors_io

    dirs = {
        "trainer_export": OpenProvenceTrainer(
            config, sd, pair_tokenizer_cls(), output_dir=out_dir / "p13_run", bf16=False,
            device="cpu").export_model(out_dir / "p13_trainer_export"),
        "encoder_save": OpenProvenceEncoder(
            config=config, state_dict=sd, tokenizer=pair_tokenizer_cls(), device="cpu",
        ).save_pretrained(out_dir / "p13_encoder_save"),
    }
    for name, rename in CHECKPOINT_LAYOUTS.items():
        dirs[name] = out_dir / f"p13_{name}"
        config.save(dirs[name])
        safetensors_io.save_file({rename(k): v for k, v in sd.items()},
                                 dirs[name] / "model.safetensors")
    return dirs


def split_context(context: str, parts: int = 3) -> list[str]:
    """A context cut at sentence ends into ``parts`` pieces that join back."""
    sentences = context.split(" . ")
    step = -(-len(sentences) // parts)
    pieces = [" . ".join(sentences[i:i + step]) for i in range(0, len(sentences), step)]
    return [p + " . " for p in pieces[:-1]] + pieces[-1:]


def context_means(raw: dict) -> np.ndarray:
    """predict_with_thresholds' mean keep probability of each context."""
    probs = np.asarray(raw["pruning_probs"], dtype=np.float64)
    return np.array([probs[lo:hi].mean() if hi > lo else np.nan
                     for lo, hi in raw["context_ranges"]])


def encoder_fp32_checks(directory: Path, tokenizer_cls, pair_tokenizer_cls, dev) -> str:
    """fp32 on the card against fp32 on the CPU, 8 pairs: the encoder's
    scores within ENCODER_SCORE_TOL, no keep/drop flip among document
    tokens further than KEEP_MARGIN from the 0.5 threshold, and the engine's
    predict_with_thresholds decisions equal for contexts whose mean lies
    further than KEEP_MARGIN from each threshold."""
    from open_provence_tpu_torch import OpenProvenceEncoder, OpenProvenceModel

    questions, contexts = synthetic_pairs(8, sentences_per_doc=10, seed=13)
    pairs = list(zip(questions, contexts))
    chunks = [[(0, len(c) // 2), (len(c) // 2, len(c))] for c in contexts]
    thresholds = [0.1, 0.5]
    side = []
    for where in (dev, "cpu"):
        enc = OpenProvenceEncoder.from_pretrained(directory, tokenizer=pair_tokenizer_cls(),
                                                  device=where, dtype=torch.float32)
        model = OpenProvenceModel.from_pretrained(directory, tokenizer=tokenizer_cls(),
                                                  device=where, dtype=torch.float32)
        side.append((
            enc.predict(pairs, batch_size=8),
            enc.predict_context(pairs, chunks, batch_size=8),
            [model.predict_with_thresholds(q, split_context(c), thresholds)
             for q, c in pairs],
        ))
        del enc, model
    (card_scores, card_ctx, card_th), (cpu_scores, cpu_ctx, cpu_th) = side
    score_err = float(np.max(np.abs(card_scores - cpu_scores)))
    card_p = np.concatenate([o.token_scores for o in card_ctx])
    cpu_p = np.concatenate([o.token_scores for o in cpu_ctx])
    decided = np.abs(cpu_p - 0.5) > KEEP_MARGIN
    token_flips = int(np.sum((card_p > 0.5)[decided] != (cpu_p > 0.5)[decided]))
    sweep_flips = sweep_decided = 0
    for card_raw, cpu_raw in zip(card_th, cpu_th):
        if card_raw["context_ranges"] != cpu_raw["context_ranges"]:
            raise AssertionError("predict_with_thresholds: the card's context ranges differ")
        means = context_means(cpu_raw)
        for th in thresholds:
            away = np.abs(means - th) > KEEP_MARGIN
            sweep_decided += int(away.sum())
            sweep_flips += int(np.sum(np.asarray(card_raw["predictions"][th])[away]
                                      != np.asarray(cpu_raw["predictions"][th])[away]))
    note = (f"encoder scores max_abs_err {score_err:.3e} (tol {ENCODER_SCORE_TOL}); "
            f"{token_flips} keep/drop flips among {int(decided.sum())} tokens decided by > "
            f"{KEEP_MARGIN}, token max_abs_err {np.max(np.abs(card_p - cpu_p)):.3e}; "
            f"predict_with_thresholds: {sweep_flips} flips among {sweep_decided} decisions")
    if score_err > ENCODER_SCORE_TOL or token_flips or sweep_flips:
        raise AssertionError(f"phase 13 fp32 card vs cpu: {note}")
    return note


def encoder_bf16_check(directory: Path, pair_tokenizer_cls, pairs, chunks, scores,
                       chunked) -> str:
    """The bf16 encoder's outputs on the card (``predict``'s scores and
    ``predict_context``'s token keep probabilities) against the fp32
    encoder's on the CPU on the same pairs, within ENCODER_BF16_TOL each and
    ENCODER_BF16_MEAN_TOL on the mean keep-probability error."""
    from open_provence_tpu_torch import OpenProvenceEncoder

    cpu = OpenProvenceEncoder.from_pretrained(directory, tokenizer=pair_tokenizer_cls(),
                                              device="cpu", dtype=torch.float32)
    ref = cpu.predict_context(pairs, chunks, batch_size=32)
    ref_scores = np.array([o.ranking_scores for o in ref])
    if [len(o.token_scores) for o in ref] != [len(o.token_scores) for o in chunked]:
        raise AssertionError("phase 13 bf16: the card's document spans differ from the CPU's")
    card_p = np.concatenate([o.token_scores for o in chunked])
    cpu_p = np.concatenate([o.token_scores for o in ref])
    score_err = float(np.max(np.abs(scores - ref_scores)))
    chunk_score_err = float(np.max(np.abs(np.array([o.ranking_scores for o in chunked])
                                          - ref_scores)))
    keep_diff = np.abs(card_p - cpu_p)
    note = (f"phase 13 encoder bf16 card vs fp32 cpu, {len(pairs)} pairs: predict scores "
            f"max_abs_err {score_err:.3e} (predict_context's {chunk_score_err:.3e}; CPU scores "
            f"{ref_scores.min():.4f}-{ref_scores.max():.4f}), keep-prob max_abs_err "
            f"{keep_diff.max():.3e} mean {keep_diff.mean():.3e} over {keep_diff.size} tokens "
            f"(CPU keep-probs std {cpu_p.std():.3e}; tol {ENCODER_BF16_TOL}, mean "
            f"{ENCODER_BF16_MEAN_TOL})")
    if not (max(score_err, chunk_score_err, keep_diff.max()) <= ENCODER_BF16_TOL
            and keep_diff.mean() <= ENCODER_BF16_MEAN_TOL):
        raise AssertionError(note)
    return note


def phase13_entry_points(config, sd, tokenizer_cls, pair_tokenizer_cls, dev, card: str,
                         out_dir: Path, forward_rate: float) -> dict[str, dict[str, int]]:
    """The checkpoint and encoder entry points at base width, bf16, max_length
    512: from_pretrained on four checkpoint directories of phase 4's
    weights serves phase 5's 256 pairs with the state-dict model's bits;
    the encoder from_pretrained and the engine's raw-prediction APIs on 64
    pairs; fp32 card against CPU; encoder.predict pairs/s at B=32, S=512.
    Both paths must launch kernels 1-4 and no plain version."""
    from open_provence_tpu_torch import OpenProvenceEncoder, OpenProvenceModel, kernels

    if os.environ.get(MLP_TAIL_GATE, "0") != "0":
        raise AssertionError(f"phase 13 runs at the default {MLP_TAIL_GATE}")
    dirs = checkpoint_dirs(config, sd, pair_tokenizer_cls, out_dir)
    questions, contexts = synthetic_pairs(256)
    kw = dict(threshold=0.1, show_progress=False)
    reference = OpenProvenceModel(config, sd, tokenizer_cls(), device=dev).process(
        questions, contexts, **kw)

    def required(path: str, launches: dict[str, int]) -> None:
        missing = [name for name in FORWARD if launches[name] == 0]
        if missing or any(kernels.plain_counts().values()):
            raise AssertionError(f"{path} never launched {missing} or ran a plain version: "
                                 f"{kernels.plain_counts()}")

    kernels.reset_launch_counts()
    for name, directory in dirs.items():
        model = OpenProvenceModel.from_pretrained(directory, tokenizer=tokenizer_cls(),
                                                  device=dev)
        result = model.process(questions, contexts, **kw)
        same = (result["pruned_context"] == reference["pruned_context"]
                and np.array_equal(np.asarray(result["reranking_score"]),
                                   np.asarray(reference["reranking_score"])))
        if not same:
            raise AssertionError(f"from_pretrained on {name}: process() differs from the "
                                 "state-dict model's bits")
        del model
    torch.cuda.synchronize()
    serve = kernels.launch_counts()
    required("serve_from_pretrained", serve)
    phase(f"phase 13 from_pretrained bf16 on {', '.join(dirs)}: process() on 256 pairs "
          f"bit-equal to the state-dict model each time; launches {json.dumps(serve)}")

    questions, contexts = synthetic_pairs(64, sentences_per_doc=10, seed=14)
    pairs = list(zip(questions, contexts))
    kernels.reset_launch_counts()
    encoder = OpenProvenceEncoder.from_pretrained(dirs["encoder_save"],
                                                  tokenizer=pair_tokenizer_cls(), device=dev)
    model = OpenProvenceModel.from_pretrained(dirs["trainer_export"], tokenizer=tokenizer_cls(),
                                              device=dev)
    scores = encoder.predict(pairs, batch_size=32)
    whole = encoder.predict_with_pruning(pairs, pruning_threshold=0.0, return_documents=True)
    empty = encoder.predict_with_pruning(pairs, pruning_threshold=1.0, return_documents=True)
    half = encoder.prune_texts(questions, contexts, threshold=0.5)
    chunks = [[(0, len(c) // 2), (len(c) // 2, len(c))] for c in contexts]
    chunked = encoder.predict_context(pairs, chunks)
    raw = model.get_raw_predictions_batch(questions, [split_context(c) for c in contexts],
                                          batch_size=32)
    sweeps = [model.predict_with_thresholds(q, split_context(c), [0.0, 0.5, 1.0])
              for q, c in pairs[:8]]
    torch.cuda.synchronize()
    enc_launches = kernels.launch_counts()
    required("encoder_512", enc_launches)
    checks = {
        "scores finite": scores.shape == (64,) and bool(np.isfinite(scores).all()),
        "threshold 0 keeps every document": [o.pruned_documents[0] for o in whole] == contexts
        and all(o.compression_ratio == 0.0 for o in whole),
        "threshold 1 empties every document": all(
            o.pruned_documents[0] == "" and o.compression_ratio == 1.0 for o in empty),
        "prune_texts ratios in [0, 1]": all(0.0 <= r["kept_ratio"] <= 1.0 for r in half),
        "chunk scores finite": all(np.isfinite(o.chunk_scores).all()
                                   and o.chunk_predictions.shape == (2,) for o in chunked),
        "raw predictions: 3 ranges each, probabilities in [0, 1]": len(raw) == 64 and all(
            len(r.context_ranges) == 3 and r.pruning_probs.dtype == np.float32
            and ((r.pruning_probs >= 0) & (r.pruning_probs <= 1)).all() for r in raw),
        "threshold sweep keeps all at 0 and none at 1": all(
            w["predictions"][0.0] == [1, 1, 1] and w["predictions"][1.0] == [0, 0, 0]
            for w in sweeps),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 13 encoder checks failed: {failed}")
    kept = np.mean([r["kept_ratio"] for r in half])
    phase(f"phase 13 encoder bf16, 64 pairs: predict, predict_with_pruning at 0 and 1, "
          f"prune_texts (kept {kept:.3f} at 0.5), predict_context, get_raw_predictions_batch, "
          f"predict_with_thresholds: {', '.join(checks)}; launches {json.dumps(enc_launches)}")
    del model
    n = ENCODER_BF16_PAIRS  # the CPU's fp32 encoder on all 64 pairs takes ~35 s
    phase(encoder_bf16_check(dirs["encoder_save"], pair_tokenizer_cls, pairs[:n], chunks[:n],
                             scores[:n], chunked[:n]))

    phase("phase 13 fp32 card vs cpu, 8 pairs: " + encoder_fp32_checks(
        dirs["encoder_save"], tokenizer_cls, pair_tokenizer_cls, dev))

    questions, contexts = synthetic_pairs(32, seed=15)  # > 512 tokens each: S = 512
    long_pairs = list(zip(questions, contexts))
    for _ in range(2):
        encoder.predict(long_pairs, batch_size=32)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        began = time.perf_counter()
        encoder.predict(long_pairs, batch_size=32)
        times.append(time.perf_counter() - began)
    median = statistics.median(times)
    phase(f"phase 13 encoder.predict B=32 S=512 bf16: {32 / median:.1f} pairs/s (median of 5 "
          f"calls: {median * 1e3:.2f} ms, tokenizing included) beside phase 6's forward "
          f"{forward_rate:.1f} pairs/s [{card}]")
    return {"serve_from_pretrained": serve, "encoder_512": enc_launches}


# Phase 14: the training entry point (the YAML runner, train/data.py and
# backbone dropout) at base width. The config is configs/open-provence-tpu-
# reranker-v1.yaml's model_args and training_args on two local JSON-lines
# sources, with phase 8's batch (16 queries of 2 texts: 32 pairs of 512),
# logging, eval and saves every 10 steps; save_total_limit and logging_steps
# come in as CLI overrides, one bare and one qualified.
P14_TRAIN_ROWS, P14_EVAL_ROWS = 128, 32
P14_OVERRIDES = ["--save_total_limit", "2", "--training_args.logging_steps", "10"]
# What phase 14 leaves in the run's directory for phase 15: the main run's
# config, its final model and the eval set of its eval_datasets hook.
P14_CONFIG, P14_FINAL, P15_EVAL_SET = "p14_config.yaml", "p14_final_model", "p14_eval_set"
P15_EVAL_QUERIES, P15_EVAL_SPANS = 128, 24
# The depth of phase 14's fp32 runner check against the CPU: the first
# CPU_CHECK_LAYERS layers of the backbone (PERF.md section 4 has the cut's times).
P14_FP32_LAYERS = CPU_CHECK_LAYERS


def long_rows(assets, n_rows: int, n_texts: int, seed: int, teacher: str,
              sentences_per_text: tuple[int, int] = (8, 12)) -> list[dict]:
    """Rows in the schema of scripts/make_toy_assets.py::make_row with
    ``n_texts`` texts of 8-12 sentences each by default (a pair fills
    340-520 DummyTokenizer tokens): each text joins the sentences of
    make_row's texts (2-4 sentences each), alternating its relevant first
    text and its irrelevant second, with their relevance, label and teacher
    score."""
    low, high = sentences_per_text
    rng = random.Random(seed)
    rows = []
    for _ in range(n_rows):
        row = {"query": None, "texts": [], "context_spans": [],
               "context_spans_relevance": [], "labels": [], teacher: []}
        for t in range(n_texts):
            sentences, relevance, which = [], [], t % 2
            while len(sentences) < low:
                part = assets.make_row(rng, None, rng.choice(assets.WORDS))
                row["query"] = row["query"] or part["query"]
                text = part["texts"][which]
                sentences += [text[a:b] for a, b in part["context_spans"][which]]
                relevance += part["context_spans_relevance"][which]
                label, score = part["labels"][which], part["teacher_score"][which]
            keep = min(len(sentences), rng.randint(low, high))
            spans, pos = [], 0
            for sentence in sentences[:keep]:
                spans.append([pos, pos + len(sentence)])
                pos += len(sentence) + 1
            row["texts"].append(" ".join(sentences[:keep]))
            row["context_spans"].append(spans)
            row["context_spans_relevance"].append(relevance[:keep])
            row["labels"].append(label)
            row[teacher].append(score)
        rows.append(row)
    return rows


def phase14_assets(sd, out_dir: Path) -> dict[str, Path]:
    """A ModernBERT backbone directory (configs.py's defaults as HF's
    config.json, phase 4's backbone and prediction-head tensors under HF's
    names), its copy with every backbone dropout at 0.1, two JSON-lines
    sources: A (2 texts a row) and B (4 texts a row, its teacher column
    named teacher_scores.base), and the context-relevance eval set of the
    runner's eval_datasets hook (P15_EVAL_QUERIES queries of 2 texts of
    P15_EVAL_SPANS spans, a ``test.jsonl``) with its eval config."""
    from open_provence_tpu_torch import ModernBertBackboneConfig
    from open_provence_tpu_torch.train.data import write_jsonl_splits
    from open_provence_tpu_torch.utils import safetensors_io

    assets = load_by_path(REPO / "scripts" / "make_toy_assets.py")
    dirs = {"backbone": out_dir / "p14_backbone", "dropout": out_dir / "p14_backbone_dropout"}
    hf = {k.removeprefix("ranking_model."): v for k, v in sd.items()
          if k.startswith(("ranking_model.model.", "ranking_model.head."))}
    backbone = ModernBertBackboneConfig(pad_token_id=0, num_labels=1).to_dict()
    rates = dict(attention_dropout=0.1, embedding_dropout=0.1, mlp_dropout=0.1)
    for name, config in (("backbone", backbone), ("dropout", {**backbone, **rates})):
        dirs[name].mkdir(parents=True)
        (dirs[name] / "config.json").write_text(json.dumps(config, indent=2))
    safetensors_io.save_file(hf, dirs["backbone"] / "model.safetensors")
    os.link(dirs["backbone"] / "model.safetensors", dirs["dropout"] / "model.safetensors")
    for name, texts, teacher, seed in (("a", 2, "teacher_score", 140),
                                       ("b", 4, "teacher_scores.base", 141)):
        rows = long_rows(assets, P14_TRAIN_ROWS + P14_EVAL_ROWS, texts, seed, teacher)
        dirs[name] = write_jsonl_splits({"train": rows[:P14_TRAIN_ROWS],
                                         "validation": rows[P14_TRAIN_ROWS:]},
                                        out_dir / f"p14_source_{name}")
    rows = long_rows(assets, P15_EVAL_QUERIES, 2, 150, "teacher_score",
                     sentences_per_text=(P15_EVAL_SPANS, P15_EVAL_SPANS))
    dirs["eval_set"] = write_jsonl_splits({"test": rows}, out_dir / P15_EVAL_SET)
    dirs["eval_config"] = out_dir / "p14_eval.yaml"
    dirs["eval_config"].write_text(
        f'split: test\ndatasets:\n  - dataset_name: "{dirs["eval_set"]}"\n')
    return dirs


def cut_backbone_dir(source: Path, target: Path, layers: int) -> Path:
    """A copy of the ModernBERT backbone directory ``source`` cut to its
    first ``layers`` layers (config.json and model.safetensors)."""
    from open_provence_tpu_torch.utils import safetensors_io

    config = json.loads((source / "config.json").read_text())
    if layers >= config["num_hidden_layers"]:
        return source
    target.mkdir(parents=True, exist_ok=True)
    (target / "config.json").write_text(json.dumps({**config, "num_hidden_layers": layers},
                                                   indent=2))
    prefix = "model.layers."
    weights = safetensors_io.load_file(source / "model.safetensors")
    safetensors_io.save_file(
        {k: v for k, v in weights.items()
         if not (k.startswith(prefix) and int(k[len(prefix):].split(".")[0]) >= layers)},
        target / "model.safetensors")
    return target


def p14_config(path: Path, dirs: dict, run_dir: Path, backbone: str = "backbone",
               **training) -> Path:
    """The run's config as a YAML file (pyyaml's ``safe_dump``)."""
    import yaml
    config = {
        "model_args": {"model_name_or_path": str(dirs[backbone]), "classifier_dropout": 0.0,
                       "max_length": 512},
        "data_args": {"datasets": [
            {"dataset_name": str(dirs["a"])},
            {"dataset_name": str(dirs["b"]), "teacher_column": "teacher_scores.base",
             "items": 2, "upsample_factor": 1.5},
        ]},
        "training_args": {
            "output_dir": str(run_dir), "overwrite_output_dir": True, "optimizer": "adafactor",
            "learning_rate": 5.0e-5, "per_device_train_batch_size": 16,
            "gradient_accumulation_steps": 1, "max_grad_norm": 1.0, "weight_decay": 0.01,
            "lr_scheduler_type": "cosine", "warmup_ratio": 0.1, "logging_steps": 100,
            "save_steps": 10, "save_total_limit": 5, "bf16": True,
            "load_best_model_at_end": True, "num_train_epochs": 1,
            "per_device_eval_batch_size": 16, "eval_steps": 10, "report_to": [],
            "mesh_data": None, "mesh_model": 1, "attention_impl": "auto",
            "gradient_checkpointing": False, **training,
        },
    }
    path.write_text(yaml.safe_dump(config, sort_keys=False))
    return path


def run_train(label: str, config_path: Path, pair_tokenizer, overrides=(), **kwargs):
    """parse_config_file, apply_cli_overrides and runner.train, as main()
    does but with the tokenizer given; returns (final_model, args, wall s)."""
    from open_provence_tpu_torch.train import parse_config_file, runner

    args = parse_config_file(str(config_path))
    if runner.apply_cli_overrides(list(overrides), *args):
        raise AssertionError(f"{label}: overrides left arguments over")
    began = time.perf_counter()
    final = Path(runner.train(*args, tokenizer=pair_tokenizer, **kwargs))
    torch.cuda.synchronize()
    return final, args, time.perf_counter() - began


def trainer_state(checkpoint: Path) -> dict:
    return json.loads((checkpoint / "trainer_state.json").read_text())


def logged_losses(history: list[dict], key: str = "loss") -> list[tuple[int, float]]:
    return [(h["step"], h[key]) for h in history if key in h]


def weights_equal(a: Path, b: Path) -> bool:
    from open_provence_tpu_torch.utils import safetensors_io

    wa, wb = (safetensors_io.load_file(d / "model.safetensors") for d in (a, b))
    return wa.keys() == wb.keys() and all(torch.equal(wa[k], wb[k]) for k in wa)


def serve_final(final: Path, tokenizer_cls, dev) -> str:
    """Phase 5's 256 pairs and checks through from_pretrained(final)."""
    from open_provence_tpu_torch import OpenProvenceModel

    model = OpenProvenceModel.from_pretrained(final, tokenizer=tokenizer_cls(), device=dev)
    questions, contexts = synthetic_pairs(256)
    result = model.process(questions, contexts, threshold=0.1, show_progress=False)
    ranks = check_served("phase 14 final_model", model, questions, contexts, result)
    return f"scores in [{ranks.min():.4f}, {ranks.max():.4f}]; threshold 0 exact, 1 empty"


def p14_dropout_trainers(directory: Path, run_dir: Path, data_args, pair_tokenizer, dev):
    """Phase 8's resume check and the remat check on the dropout backbone:
    trainers on the card from init_encoder's weights, one batch of the
    prepared data (16 queries, 32 pairs of 512)."""
    from open_provence_tpu_torch.train import (
        OpenProvenceDataCollator, OpenProvenceTrainer, init_encoder, prepare_dataset)

    config, _, sd = init_encoder(directory, max_length=512, classifier_dropout=0.0)
    train_rows, _ = prepare_dataset(data_args)
    batch = OpenProvenceDataCollator(
        tokenizer=pair_tokenizer, max_length=512, scores_column="teacher_score",
        chunks_pos_column="context_spans", relevant_chunks_column="context_spans_relevance",
        pad_pairs_to=32)([train_rows[i] for i in range(16)])

    def make(name: str, remat: bool = False):
        return OpenProvenceTrainer(config, sd, pair_tokenizer, output_dir=run_dir / name,
                                   learning_rate=5e-5, total_steps=10, device=dev,
                                   gradient_checkpointing=remat)

    plain, remat = make("plain"), make("remat", remat=True)
    loss, _, grads = plain.loss_and_grads(batch)
    loss_r, _, grads_r = remat.loss_and_grads(batch)
    err = max_rel_err(grads_r, grads)
    same_bits = all(torch.equal(grads[k], grads_r[k]) for k in grads)
    same_state = torch.equal(plain.generator.get_state(), remat.generator.get_state())
    phase(f"phase 14 dropout 0.1 x 3, first step with gradient_checkpointing on vs off: loss "
          f"{float(loss_r):.6f} vs {float(loss):.6f}; gradients' largest error {err:.3e} of "
          f"the tensor's largest (bit-equal: {same_bits}; tol {STEP_GRAD_TOL}); generator "
          f"states equal: {same_state}")
    if not (err <= STEP_GRAD_TOL and same_state and float(loss_r) == float(loss)):
        raise AssertionError("phase 14: the recomputed layers drew other dropout masks")
    del remat
    plain.apply_gradients(grads)
    resume_check("phase 14 dropout", plain, make("resumed"), batch)


def p14_fp32_check(dirs: dict, out_dir: Path, pair_tokenizer, dev,
                   layers: int) -> dict[str, float]:
    """The runner on the card against the runner on the CPU, fp32, 2 pairs a
    step, 3 steps, from the backbone directory cut to its first ``layers``
    layers. Returns the walls of the card's and the CPU's side (s)."""
    from open_provence_tpu_torch.train import init_encoder
    from open_provence_tpu_torch.utils import safetensors_io

    backbone = cut_backbone_dir(dirs["backbone"], out_dir / f"p14_backbone_{layers}", layers)
    dirs = {**dirs, "fp32_backbone": backbone}
    # Step 1 is warmup at lr 0, so step 3's loss and the final weights are the
    # first to depend on an update: the check holds the card's update over
    # the run (final weights less init_encoder's, at the runner's seed)
    # against the CPU's. It runs at phase 7's lr, 1e-2: at 5e-5 a weight's
    # fp32 ulp, where p + u rounds the other way on one side, reaches ~1e-2
    # of a tensor's largest update.
    sides = {}
    for where in (str(dev), "cpu"):
        side_dir = out_dir / f"p14_{where.replace(':', '')}"
        path = p14_config(out_dir / f"p14_{where}.yaml", dirs, side_dir, backbone="fp32_backbone",
                          bf16=False, per_device_train_batch_size=1, logging_steps=1,
                          save_steps=3, learning_rate=1e-2, device=where)
        final, side_args, wall = run_train(f"phase 14 {where}", path, pair_tokenizer,
                                           max_steps_override=3)
        sides[where] = (logged_losses(trainer_state(side_dir / "checkpoint-3")["log_history"]),
                        safetensors_io.load_file(final / "model.safetensors"), wall)
        shutil.rmtree(side_dir)
    *_, initial = init_encoder(backbone, max_length=512, classifier_dropout=0.0,
                               seed=side_args[2].seed)
    (card_losses, card_w, card_wall), (cpu_losses, cpu_w, cpu_wall) = sides[str(dev)], sides["cpu"]
    card_delta = {k: w - initial[k] for k, w in card_w.items()}
    cpu_delta = {k: w - initial[k] for k, w in cpu_w.items()}
    loss_err = max(abs(a[1] / b[1] - 1) for a, b in zip(card_losses, cpu_losses))
    update_err = max_rel_err(card_delta, cpu_delta)
    largest = max(float(d.abs().max()) for d in cpu_delta.values())
    unchanged_err = max_rel_err({k: torch.zeros_like(d) for k, d in card_delta.items()},
                                cpu_delta)
    phase(f"phase 14 fp32 runner.train, {layers} layers, 1 query (2 pairs of 512) a step, 3 "
          f"steps at lr 1e-2, card vs cpu: losses {card_losses} vs {cpu_losses} "
          f"(largest rel err {loss_err:.3e}, tol 1e-4); update over the run (largest "
          f"{largest:.3e}): largest error {update_err:.3e} of each tensor's largest (tol "
          f"{STEP_UPDATE_TOL}; weights left unchanged would read {unchanged_err:.3e}); wall "
          f"card {card_wall:.1f} s, cpu {cpu_wall:.1f} s")
    if len(card_losses) != 3 or [s for s, _ in card_losses] != [s for s, _ in cpu_losses] \
            or loss_err > 1e-4 or update_err > STEP_UPDATE_TOL:
        raise AssertionError("phase 14: the runner on the card disagrees with the CPU")
    if largest == 0.0 or unchanged_err <= STEP_UPDATE_TOL:
        raise AssertionError("phase 14: the update check cannot tell unchanged weights from "
                             "the card's")
    if backbone != dirs["backbone"]:
        shutil.rmtree(backbone)
    return {"card": card_wall, "cpu": cpu_wall}


def phase14_train_cli(sd, tokenizer_cls, pair_tokenizer, dev, card: str,
                      out_dir: Path) -> dict[str, dict[str, int]]:
    """The training entry point at base width: parse_config_file,
    apply_cli_overrides and runner.train on a ModernBERT backbone directory
    and two JSON-lines sources, its eval_datasets hook evaluating the final
    model on the card (the path ``train_cli_512``, launch counts read around
    the call); a resume from checkpoint-10; the same run card against CPU in
    fp32; and the backbone with every dropout at 0.1. The final model, its
    config and its eval set stay for phase 15."""
    from open_provence_tpu_torch import kernels
    from open_provence_tpu_torch.eval import cli as eval_cli
    from open_provence_tpu_torch.train import init_encoder, prepare_dataset

    began = mark = time.perf_counter()
    steps: dict[str, float] = {}

    def lap(name: str) -> None:  # phase 14 timed step by step
        nonlocal mark
        steps[name] = time.perf_counter() - mark
        mark = time.perf_counter()

    dirs = phase14_assets(sd, out_dir)
    # The backbone directory loads as a ModernBERT checkpoint: backbone and
    # prediction head from the file, the classifier and pruning head fresh.
    _, _, loaded = init_encoder(dirs["backbone"], max_length=512, classifier_dropout=0.0)
    from_file = [k for k in sd if k.startswith(("ranking_model.model.", "ranking_model.head."))]
    heads = ("ranking_model.classifier.weight", "pruning_head.classifier.weight")
    if not (all(torch.equal(loaded[k], sd[k]) for k in from_file)
            and not any(torch.equal(loaded[k], sd[k]) for k in heads)):
        raise AssertionError("phase 14: the backbone directory did not load as a ModernBERT "
                             "checkpoint (backbone from the file, heads fresh)")
    del loaded
    lap("assets and the backbone check")
    run_dir = out_dir / "p14_run"
    config_path = p14_config(out_dir / P14_CONFIG, dirs, run_dir, eval_datasets={
        "config": str(dirs["eval_config"]), "threshold": 0.1, "batch_size": 64})

    # What the card holds when the hook's eval begins, against before the
    # run: the trainer's weights and optimizer state must be gone by then.
    real_eval, at_eval = eval_cli.main, {}

    def eval_main(argv, *, tokenizer=None):
        torch.cuda.synchronize()
        at_eval.update(allocated=torch.cuda.memory_allocated(), argv=list(argv),
                       same_tokenizer=tokenizer is pair_tokenizer)
        return real_eval(argv, tokenizer=tokenizer)

    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()
    eval_cli.main = eval_main
    kernels.reset_launch_counts()
    try:
        final, args, wall = run_train("phase 14", config_path, pair_tokenizer, P14_OVERRIDES)
    finally:
        eval_cli.main = real_eval
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    lap("runner.train with its eval hook")
    _, data_args, training_args = args
    train_rows, eval_rows = prepare_dataset(data_args, seed=training_args.seed)
    sizes = (len(train_rows), len(eval_rows))
    # A: 128 train + 32 validation rows; B: 128 train rows upsampled x1.5
    # (64 drawn again), 32 validation; items=2 keeps every row of B.
    if sizes != (128 + 192, 32 + 32):
        raise AssertionError(f"phase 14: prepared {sizes} rows, not (320, 64)")
    state = trainer_state(run_dir / "checkpoint-20")
    history = state["log_history"]
    evals = logged_losses(history, "eval_loss")
    best_step = min(evals, key=lambda e: e[1])[0]
    checkpoints = sorted(int(p.name.split("-")[1]) for p in run_dir.glob("checkpoint-*"))
    recorded = json.loads((final / "training_args.json").read_text())["training_args"]
    all_losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    checks = {
        "20 steps": state["global_step"] == 20,
        "at most 2 checkpoints and the best": best_step in checkpoints
        and len([s for s in checkpoints if s != best_step]) <= 2,
        "final_model holds config.json, model.safetensors": all(
            (final / f).exists() for f in ("config.json", "model.safetensors")),
        f"final_model is checkpoint-{best_step}'s weights, bit for bit": weights_equal(
            final, run_dir / f"checkpoint-{best_step}"),
        "training_args.json records both overrides": recorded["save_total_limit"] == 2
        and recorded["logging_steps"] == 10,
        "every logged loss finite": bool(all_losses) and all(np.isfinite(all_losses)),
        "the eval_datasets hook wrote results.json and results.md": all(
            (final / "eval_datasets" / f).exists() for f in ("results.json", "results.md")),
        "the hook's eval got the run's tokenizer and device": at_eval.get("same_tokenizer")
        and at_eval["argv"][at_eval["argv"].index("--device") + 1] == str(dev),
    }
    weights_mb = sum(t.numel() for t in sd.values()) * 4 / 2**20
    held_mb = (at_eval.get("allocated", 0) - allocated_before) / 2**20
    checks["the trainer is released before the eval model loads"] = held_mb < weights_mb / 2
    missing = [name for name in DEFAULT_EIGHT if launches[name] == 0]
    phase(f"phase 14 runner.train bf16, ModernBERT backbone directory, sources A + B as JSON "
          f"lines, prepared {sizes[0]} train / {sizes[1]} eval rows, {state['global_step']} "
          f"steps of 16 queries (32 pairs of 512): wall {wall:.1f} s [{card}]; train losses "
          f"{logged_losses(history)}, eval losses {evals}, checkpoints {checkpoints}; "
          f"launches {json.dumps(launches)}; plain versions {json.dumps(plain)}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed or missing or any(plain.values()):
        raise AssertionError(f"phase 14: {failed} failed; never launched {missing}; plain "
                             f"versions {plain}")
    phase(f"phase 14 checks: {', '.join(checks)} (the card held {held_mb:.1f} MB more than "
          f"before the run when the eval began; the fp32 weights alone are {weights_mb:.1f} MB); "
          "from_pretrained(final_model), 256 pairs: " + serve_final(final, tokenizer_cls, dev))
    lap("checks and serving final_model")

    # Resume: the same run directory from checkpoint-10 to step 20; its
    # history goes on from the checkpoint's.
    before = trainer_state(run_dir / "checkpoint-10")["log_history"]
    _, _, wall = run_train("phase 14 resume", config_path, pair_tokenizer,
                           P14_OVERRIDES + ["--resume_from_checkpoint",
                                            str(run_dir / "checkpoint-10"),
                                            "--eval_datasets", "none"])
    resumed = trainer_state(run_dir / "checkpoint-20")
    after = resumed["log_history"]
    if not (resumed["global_step"] == 20 and after[:len(before)] == before
            and len(after) > len(before) and all(10 < h["step"] <= 20
                                                 for h in after[len(before):])):
        raise AssertionError(f"phase 14: the resumed history does not go on from "
                             f"checkpoint-10's: {before} -> {after}")
    phase(f"phase 14 resume from checkpoint-10: steps 11-20, wall {wall:.1f} s; history "
          f"{len(before)} entries, then {logged_losses(after[len(before):])} (train) and "
          f"{logged_losses(after[len(before):], 'eval_loss')} (eval) [{card}]")
    shutil.move(final, out_dir / P14_FINAL)
    shutil.rmtree(run_dir)
    lap("resume")
    walls = p14_fp32_check(dirs, out_dir, pair_tokenizer, dev, P14_FP32_LAYERS)
    lap(f"fp32 check at {P14_FP32_LAYERS} layers (card {walls['card']:.1f} s and cpu "
        f"{walls['cpu']:.1f} s of runner.train)")

    # Every backbone dropout at 0.1: 10 bf16 steps through the runner, then
    # the remat and resume checks on trainers of the same weights.
    drop_dir = out_dir / "p14_dropout"
    path = p14_config(out_dir / "p14_dropout.yaml", dirs, drop_dir, backbone="dropout",
                      logging_steps=1, do_eval=False)
    kernels.reset_launch_counts()
    _, args, wall = run_train("phase 14 dropout", path, pair_tokenizer, max_steps_override=10)
    drop_launches, plain = kernels.launch_counts(), kernels.plain_counts()
    losses = logged_losses(trainer_state(drop_dir / "checkpoint-10")["log_history"])
    phase(f"phase 14 runner.train bf16, every backbone dropout 0.1, 10 steps: wall {wall:.1f} s; "
          f"losses {losses}; launches {json.dumps(drop_launches)}; plain versions "
          f"{json.dumps(plain)} [{card}]")
    if len(losses) != 10 or not all(np.isfinite([v for _, v in losses])) \
            or any(drop_launches[k] == 0 for k in ("ln_matmul", "ln_geglu")) or any(plain.values()):
        raise AssertionError("phase 14: training with backbone dropout failed its checks")
    lap("runner.train with dropout")
    p14_dropout_trainers(dirs["dropout"], drop_dir, args[1], pair_tokenizer, dev)
    shutil.rmtree(drop_dir)
    lap("dropout remat and resume")
    phase(f"phase 14 took {time.perf_counter() - began:.0f} s: "
          + "; ".join(f"{name} {wall:.1f} s" for name, wall in steps.items()))
    return {"train_cli_512": launches}


# Phase 15: the release surface at base width, bf16, max_length 512: the
# HF-style wrappers at shapes the engine never sends (no bucketing: S of no
# multiple of 64, B = 1), the standalone bundle served in a process of its
# own, and the evaluation of phase 14's final model through the eval-only
# mode of the trainer's CLI.
WRAPPER_SHAPES = ((32, 512), (1, 77), (3, 300))
LOSS_RTOL = 1e-4
BUNDLE_SERVE = r"""
import importlib.util, json, sys, time
import modeling_open_provence_tpu as m
from open_provence_tpu_torch import kernels

started = time.perf_counter()
tokenizers_file, pairs_file, device = sys.argv[1:4]
spec = importlib.util.spec_from_file_location("dummy_tokenizers", tokenizers_file)
dummy = importlib.util.module_from_spec(spec)
spec.loader.exec_module(dummy)
with open(pairs_file) as f:
    questions, contexts = json.load(f)
began = time.perf_counter()
if device != "cpu":
    kernels.library()
build_s = time.perf_counter() - began
model = m.OpenProvenceModel.from_pretrained(".", tokenizer=dummy.DummyTokenizer(), device=device)
kernels.reset_launch_counts()
result = model.process(questions, contexts, threshold=0.1, show_progress=False)
launches, plain = kernels.launch_counts(), kernels.plain_counts()
print(json.dumps({
    "build_s": build_s, "total_s": time.perf_counter() - started,
    "library": str(kernels.library_path()), "launches": launches,
    "plain": plain, "pruned": result["pruned_context"], "scores": result["reranking_score"],
    "package": sys.modules["open_provence_tpu_torch"].__file__,
    "foreign": sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "open_provence_tpu")),
}))
"""


def wrapper_inputs(batch: int, seq: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """int32 ids and mask; the last row of a batch is padded from S/2 on."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, 50000, (batch, seq), generator=gen, dtype=torch.int32)
    mask = torch.ones(batch, seq, dtype=torch.int32)
    if batch > 1:
        mask[-1, seq // 2:] = 0
    ids[mask == 0] = 0
    return ids.numpy(), mask.numpy()


def require_forward(label: str, launches: dict, plain: dict) -> None:
    missing = [name for name in FORWARD if launches[name] == 0]
    if missing or any(plain.values()):
        raise AssertionError(f"{label} never launched {missing} or ran a plain version: {plain}")


def p15_wrappers(directory: Path, tokenizer_cls, dev, card: str) -> dict[str, int]:
    """Both wrappers from a checkpoint directory on the card at
    WRAPPER_SHAPES (launch counts read around their calls alone), their
    logits and keep probabilities bit-equal to the engine's forward_logits
    at each shape; then fp32 card against fp32 CPU losses on 8 pairs."""
    from open_provence_tpu_torch import OpenProvenceModel, kernels, keep_probs_from_logits
    from open_provence_tpu_torch.inference.engine import forward_logits
    from open_provence_tpu_torch.models.hf_wrappers import (
        OpenProvenceForSequenceClassification, OpenProvenceForTokenClassification)
    from open_provence_tpu_torch.utils.hf_convert import load_checkpoint

    seq_cls = OpenProvenceForSequenceClassification.from_pretrained(directory, device=dev)
    tok_cls = OpenProvenceForTokenClassification.from_pretrained(directory, device=dev)
    inputs = {shape: wrapper_inputs(*shape, seed=150 + i) for i, shape in enumerate(WRAPPER_SHAPES)}
    kernels.reset_launch_counts()
    outs = {shape: (seq_cls(ids, mask), tok_cls(ids, mask))
            for shape, (ids, mask) in inputs.items()}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require_forward("phase 15 wrappers", launches, kernels.plain_counts())

    engine = OpenProvenceModel.from_pretrained(directory, tokenizer=tokenizer_cls(), device=dev)
    for (batch, seq), (ids, mask) in inputs.items():
        ranking, keep = forward_logits(engine.module, dev, ids, mask)
        seq_out, tok_out = outs[(batch, seq)]
        same = {
            "ranking logits": torch.equal(seq_out.logits.float(), ranking),
            "keep probabilities": torch.equal(keep_probs_from_logits(seq_out.pruning_logits), keep),
            "token view": torch.equal(tok_out.logits, seq_out.pruning_logits)
            and torch.equal(tok_out.ranking_logits, seq_out.logits),
        }
        if not all(same.values()):
            raise AssertionError(f"phase 15 wrappers B={batch} S={seq}: not bit-equal to the "
                                 f"engine's forward_logits: {same}")
    phase(f"phase 15 wrappers bf16 from {directory.name} at (B, S) {list(WRAPPER_SHAPES)}: "
          "logits, keep probabilities and the token view bit-equal to the engine's "
          f"forward_logits at each shape; launches {json.dumps(launches)} [{card}]")
    del seq_cls, tok_cls, engine, outs

    config, state_dict = load_checkpoint(directory)
    ids, mask = wrapper_inputs(8, 256, seed=153)
    rng = np.random.default_rng(15)
    targets = rng.random(8).astype(np.float32)
    labels = rng.integers(0, 2, (8, 256))
    labels[0, :5] = -100
    losses = {}
    for where in (dev, "cpu"):
        kw = dict(device=where, dtype=torch.float32)
        seq_loss = OpenProvenceForSequenceClassification(config, state_dict, **kw)(
            ids, mask, labels=targets).loss
        tok_loss = OpenProvenceForTokenClassification(config, state_dict, **kw)(
            ids, mask, labels=labels).loss
        losses[str(where)] = (float(seq_loss), float(tok_loss))
    (card_bce, card_ce), (cpu_bce, cpu_ce) = losses[str(dev)], losses["cpu"]
    errs = (abs(card_bce / cpu_bce - 1), abs(card_ce / cpu_ce - 1))
    phase(f"phase 15 wrapper losses fp32 card vs cpu, 8 pairs of 256: BCE {card_bce:.7f} vs "
          f"{cpu_bce:.7f}, token CE {card_ce:.7f} vs {cpu_ce:.7f} (rel err {errs[0]:.3e}, "
          f"{errs[1]:.3e}; tol {LOSS_RTOL})")
    if max(errs) > LOSS_RTOL:
        raise AssertionError("phase 15: the wrappers' fp32 losses on the card disagree with "
                             "the CPU")
    return launches


def p15_bundle(directory: Path, tokenizer_cls, dev, card: str, out_dir: Path,
               meanwhile) -> dict[str, int]:
    """The standalone bundle written into a copy of ``directory``, served in a
    subprocess whose working directory is the copy, without the repository
    on sys.path and with OPEN_PROVENCE_TPU_TORCH_BUILD_DIR an empty
    directory: it builds the kernels from its own sources, and process() on
    phase 5's 256 pairs gives the in-repo package's bits. ``meanwhile()``
    runs in this process while the subprocess builds and serves."""
    from open_provence_tpu_torch import OpenProvenceModel
    from open_provence_tpu_torch.utils.modeling_export import write_standalone_bundle

    bundle = out_dir / "p15_bundle"
    shutil.copytree(directory, bundle, copy_function=os.link)
    write_standalone_bundle(bundle)
    shipped = {p.relative_to(bundle).as_posix() for p in bundle.rglob("*") if p.is_file()}
    if not (any(f.startswith("open_provence_tpu_torch/kernels/csrc/") and f.endswith(".cu")
                for f in shipped)
            and not any(f.endswith((".so", ".o")) or "/_build/" in f for f in shipped)):
        raise AssertionError("phase 15: the bundle lacks kernel sources or ships a build")
    build_dir = out_dir / "p15_build"
    build_dir.mkdir()
    questions, contexts = synthetic_pairs(256)
    pairs_file = out_dir / "p15_pairs.json"
    pairs_file.write_text(json.dumps([questions, contexts]))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OPEN_PROVENCE_TPU_TORCH_BUILD_DIR"] = str(build_dir)
    stdout, stderr = out_dir / "p15_bundle.out", out_dir / "p15_bundle.err"
    with open(stdout, "w") as out, open(stderr, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", BUNDLE_SERVE, str(REPO / "tests" / "dummy_tokenizers.py"),
             str(pairs_file), str(dev)],
            cwd=bundle, env=env, stdout=out, stderr=err, text=True)
    try:
        meanwhile()
        returncode = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if returncode != 0:
        raise AssertionError(f"phase 15 bundle process failed:\n{stderr.read_text()[-4000:]}")
    got = json.loads(stdout.read_text().strip().splitlines()[-1])
    library = Path(got["library"])
    want = OpenProvenceModel.from_pretrained(directory, tokenizer=tokenizer_cls(),
                                             device=dev).process(
        questions, contexts, threshold=0.1, show_progress=False)
    checks = {
        "the package imported is the bundle's": Path(got["package"]).resolve().is_relative_to(
            bundle.resolve()),
        "no jax, no open_provence_tpu": got["foreign"] == [],
        "the library built into the empty build directory": library.parent == build_dir
        and library.exists(),
        "pruned contexts equal": got["pruned"] == want["pruned_context"],
        "scores bit-equal": np.array_equal(np.asarray(got["scores"]),
                                           np.asarray(want["reranking_score"])),
    }
    phase(f"phase 15 bundle: {len(shipped)} files ({sum(f.endswith('.cu') for f in shipped)} "
          f".cu sources, no build); its process (beside this one's wrapper and fp32 eval "
          f"checks) served 256 pairs bf16 {got['total_s']:.1f} s after its imports, the "
          f"kernels built from its own csrc in {got['build_s']:.1f} s into "
          f"{library.relative_to(out_dir)}; {', '.join(checks)}; launches "
          f"{json.dumps(got['launches'])} [{card}]")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 15 bundle: {failed} failed")
    require_forward("phase 15 bundle", got["launches"], got["plain"])
    return got["launches"]


def p15_eval(pair_tokenizer, dev, card: str, out_dir: Path) -> dict[str, int]:
    """The eval-only mode of the trainer's CLI (``--eval-datasets-model``)
    on phase 14's final model, handed the tokenizer: both reports rewritten,
    and the eval rate."""
    from open_provence_tpu_torch import kernels
    from open_provence_tpu_torch.train import runner

    final, reports = out_dir / P14_FINAL, out_dir / P14_FINAL / "eval_datasets"
    stamp = json.loads((reports / "results.json").read_text())["args"]["timestamp_utc"]
    kernels.reset_launch_counts()
    began = time.perf_counter()
    runner.main([str(out_dir / P14_CONFIG), "--eval-datasets-model", str(final)],
                tokenizer=pair_tokenizer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - began
    launches = kernels.launch_counts()
    require_forward("phase 15 eval", launches, kernels.plain_counts())
    payload = json.loads((reports / "results.json").read_text())
    (metrics,) = payload["results"]["0.1"].values()
    contexts = P15_EVAL_QUERIES * 2
    checks = {
        "results.json rewritten": payload["args"]["timestamp_utc"] != stamp,
        "results.md holds the threshold's table": "### Threshold 0.1"
        in (reports / "results.md").read_text(),
        f"{contexts} contexts of {P15_EVAL_SPANS} spans": metrics["contexts"] == contexts
        and metrics["span_total"] == contexts * P15_EVAL_SPANS and metrics["span_skipped"] == 0,
        "F2, precision and recall present": all(metrics[k] is not None
                                                for k in ("f2", "precision", "recall")),
    }
    rate = metrics["contexts"] / metrics["process_time_seconds"]
    cm = metrics["confusion_matrix"]
    phase(f"phase 15 eval-only CLI bf16 on {P14_FINAL}, threshold 0.1: {contexts} contexts in "
          f"{metrics['process_time_seconds']:.3f} s of process() = {rate:.1f} contexts/s "
          f"(wall {wall:.1f} s, loading included); F2 {metrics['f2']:.4f}, precision "
          f"{metrics['precision']:.4f}, recall {metrics['recall']:.4f}, confusion {cm}; "
          f"{', '.join(checks)}; launches {json.dumps(launches)} [{card}]")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 15 eval: {failed} failed")
    return launches


def p15_eval_parity(pair_tokenizer, dev, out_dir: Path) -> None:
    """fp32 card against fp32 CPU span decisions of phase 14's final model on
    the first 8 queries of the eval set: no flip outside KEEP_MARGIN of the
    threshold, and equal confusion counts where nothing flipped."""
    from open_provence_tpu_torch import OpenProvenceModel
    from open_provence_tpu_torch.eval import DatasetSpec, evaluate_dataset, load_dataset_split

    final = out_dir / P14_FINAL
    rows = load_dataset_split(DatasetSpec(dataset_name=str(out_dir / P15_EVAL_SET),
                                          n_samples=8), "test")
    th = 0.1
    side = {}
    for where in (dev, "cpu"):
        model = OpenProvenceModel.from_pretrained(final, tokenizer=pair_tokenizer, device=where,
                                                  dtype=torch.float32)
        side[str(where)] = evaluate_dataset(model, rows, threshold=th, batch_size=64)
        del model
    card_m, cpu_m = side[str(dev)], side["cpu"]
    scores = np.asarray(cpu_m["roc_data"]["scores"])
    near = np.abs(scores - th) <= KEEP_MARGIN
    flips = (np.asarray(card_m["roc_data"]["predictions"])
             != np.asarray(cpu_m["roc_data"]["predictions"]))
    err = float(np.max(np.abs(np.asarray(card_m["roc_data"]["scores"]) - scores)))
    phase(f"phase 15 eval fp32 card vs cpu, 8 queries ({cpu_m['contexts']} contexts, "
          f"{cpu_m['span_total']} spans): {int(np.sum(flips & ~near))} flips outside "
          f"{KEEP_MARGIN} of the threshold ({int(near.sum())} spans within it), confusion "
          f"{card_m['confusion_matrix']} vs {cpu_m['confusion_matrix']}, sentence-prob "
          f"max_abs_err {err:.3e}")
    if np.any(flips & ~near) or (not flips.any()
                                 and card_m["confusion_matrix"] != cpu_m["confusion_matrix"]):
        raise AssertionError("phase 15: fp32 span decisions differ between card and CPU")


def phase15_release(tokenizer_cls, pair_tokenizer, dev, card: str,
                    out_dir: Path) -> dict[str, dict[str, int]]:
    """The release surface (see above): phase 13's trainer export of phase
    4's weights for the wrappers and the bundle, phase 14's final model for
    the evaluation. The wrappers and the fp32 eval check run while the
    bundle's process builds and serves; the eval rate is taken after it."""
    began = time.perf_counter()
    checkpoint = out_dir / "p13_trainer_export"
    by_path = {}

    def meanwhile():
        by_path["wrappers_512"] = p15_wrappers(checkpoint, tokenizer_cls, dev, card)
        p15_eval_parity(pair_tokenizer, dev, out_dir)

    by_path["bundle_serve_512"] = p15_bundle(checkpoint, tokenizer_cls, dev, card, out_dir,
                                             meanwhile)
    by_path["eval_512"] = p15_eval(pair_tokenizer, dev, card, out_dir)
    phase(f"phase 15 took {time.perf_counter() - began:.0f} s")
    return by_path


# --- phase 16: the mesh --------------------------------------------------------

# A rank's shard of base width under tensor parallelism over 2 ranks: Wqkv's
# 3 x 6 x 64 rows (6 of the 12 heads) and 576 of the MLP's 1152 columns (Wi's
# 1152 rows, 576 inputs paired with their 576 gates).
TP = 2
TP_QKV, TP_HEADS, TP_INTER = 3 * HIDDEN // TP, HEADS // TP, INTER // TP
SHARDED = ("ln_matmul", "flash_attention_packed", "ln_geglu", "ln_geglu_bwd",
           "ln_matmul_bwd", "flash_attention_packed_bwd")
P16_STEPS, P16_LR, P16_THRESHOLD = 3, 3e-4, 0.1
# The depth of phase 16's fp32 mesh training against one process: the first
# CPU_CHECK_LAYERS layers (PERF.md section 4 has the cut's times). The bf16 steps
# and the bf16 serve stay at 22.
P16_FP32_LAYERS = CPU_CHECK_LAYERS
# Phase 14's limits on an fp32 run held to another: losses 1e-4 relative,
# the update over the run 1e-3 of each tensor's largest.
P16_LOSS_TOL, P16_UPDATE_TOL = 1e-4, STEP_UPDATE_TOL
# bf16 process() under data parallelism against one process: a score moves
# only where a product's algorithm changes with the rows it is given.
P16_BF16_TOL = TOL[torch.bfloat16][0]


def phase16_kernels(dev, stats: dict[str, dict]) -> None:
    """Kernels 2, 3, 4, 11, 12 and 14 at the widths a rank of a tp = 2 mesh
    gives them at base width, against their plain versions: fp32 and bf16,
    M = 16384 (a 1 x 2 rank at B=32, S=512) and 8192 - 37 (a 2 x 2 rank's
    rows, ragged), attention at B = 32 and 16 with ragged masks and a
    padding row, global and +-64; then bf16 times at M = 16384 beside the
    bound, the plain version and the library's call, into the kernel
    table's ``tp2`` entries."""
    from open_provence_tpu_torch import ops

    gen = torch.Generator().manual_seed(16)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(device=dev, dtype=dtype)

    errs = {name: {} for name in SHARDED}

    def note(name, dtype, *values):
        errs[name][dtype] = max(errs[name].get(dtype, 0.0), *values)

    def grads(name, got, want, dtype):
        return [check_grad(f"{name} tp2 {dtype}", a, b, dtype) for a, b in zip(got, want)]

    for dtype in (torch.float32, torch.bfloat16):
        scale = randn(HIDDEN, scale=0.1, dtype=dtype) + 1
        w_qkv = randn(TP_QKV, HIDDEN, scale=HIDDEN**-0.5, dtype=dtype)
        w_i = randn(2 * TP_INTER, HIDDEN, scale=HIDDEN**-0.5, dtype=dtype)
        for m in (16384, 8192 - 37):
            x = randn(m, HIDDEN, scale=2.0, dtype=dtype)
            note("ln_matmul", dtype, check_close(f"ln_matmul tp2 {dtype} M={m}",
                 ops.ln_matmul(x, scale, w_qkv), ops.ln_matmul_plain(x, scale, w_qkv), dtype))
            note("ln_geglu", dtype, check_close(f"ln_geglu tp2 {dtype} M={m}",
                 ops.ln_geglu(x, scale, w_i, "gelu"), ops.ln_geglu_plain(x, scale, w_i, "gelu"),
                 dtype))
            g_qkv, g_mlp = randn(m, TP_QKV, scale=0.1, dtype=dtype), randn(m, TP_INTER, scale=0.1,
                                                                         dtype=dtype)
            note("ln_matmul_bwd", dtype, *grads("ln_matmul_bwd",
                 ops.ln_matmul_bwd(x, scale, w_qkv, g_qkv),
                 ops.ln_matmul_bwd_plain(x, scale, w_qkv, g_qkv), dtype))
            note("ln_geglu_bwd", dtype, *grads("ln_geglu_bwd",
                 ops.ln_geglu_bwd(x, scale, w_i, g_mlp, "gelu"),
                 ops.ln_geglu_bwd_plain(x, scale, w_i, g_mlp, "gelu"), dtype))
        for batch in (32, 16):
            qkv = randn(batch, 512, TP_QKV, dtype=dtype)
            mask = ragged_mask(batch, 512, gen, dev)
            mask[-1] = 0
            valid = mask.bool()
            g = randn(batch, 512, TP_QKV // 3, dtype=dtype) * mask[..., None].to(dtype)
            for window, theta in ((None, 160000.0), (64, 10000.0)):
                rope = ops.rope_tables(512, HEAD_DIM, theta, dtype, dev)
                kw = dict(num_heads=TP_HEADS, padding_mask=mask, window=window, rope=rope)
                out, lse = ops.flash_attention_packed_lse(qkv, **kw)
                note("flash_attention_packed", dtype, check_close(
                    f"flash_attention_packed tp2 {dtype} B={batch}", out[valid],
                    ops.attention_packed_plain(qkv, **kw)[valid], dtype))
                note("flash_attention_packed_bwd", dtype, *grads(
                    "flash_attention_packed_bwd", (ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw),),
                    (ops.attention_packed_bwd_plain(qkv, g, out, lse, **kw),), dtype))
        torch.cuda.synchronize()

    # bf16 times at a 1 x 2 rank's rows, B=32, S=512 (the last dtype above).
    x = randn(16384, HIDDEN, scale=2.0, dtype=dtype)
    g_qkv, g_mlp = randn(16384, TP_QKV, scale=0.1, dtype=dtype), randn(16384, TP_INTER, scale=0.1,
                                                                     dtype=dtype)
    qkv = randn(32, 512, TP_QKV, dtype=dtype)
    mask = ragged_mask(32, 512, gen, dev)
    g = randn(32, 512, TP_QKV // 3, dtype=dtype) * mask[..., None].to(dtype)
    rope = ops.rope_tables(512, HEAD_DIM, 160000.0, dtype, dev)
    kw = dict(num_heads=TP_HEADS, padding_mask=mask, window=None, rope=rope)
    out, lse = ops.flash_attention_packed_lse(qkv, **kw)
    # The forwards take ~0.06-0.09 ms here, near the host's time to issue a
    # call through the wrapper: they are timed as CUDA-graph replays.
    timings = {
        "ln_matmul": paired_ms(lambda: ops.ln_matmul(x, scale, w_qkv),
                               lambda: ops.ln_matmul_plain(x, scale, w_qkv), graph_ms),
        "flash_attention_packed": paired_ms(lambda: ops.flash_attention_packed(qkv, **kw),
                                            lambda: ops.attention_packed_plain(qkv, **kw),
                                            graph_ms),
        "ln_geglu": paired_ms(lambda: ops.ln_geglu(x, scale, w_i, "gelu"),
                              lambda: ops.ln_geglu_plain(x, scale, w_i, "gelu"), graph_ms),
        "ln_geglu_bwd": paired_ms(lambda: ops.ln_geglu_bwd(x, scale, w_i, g_mlp, "gelu"),
                                  lambda: ops.ln_geglu_bwd_plain(x, scale, w_i, g_mlp, "gelu")),
        "ln_matmul_bwd": paired_ms(lambda: ops.ln_matmul_bwd(x, scale, w_qkv, g_qkv),
                                   lambda: ops.ln_matmul_bwd_plain(x, scale, w_qkv, g_qkv)),
        "flash_attention_packed_bwd": paired_ms(
            lambda: ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw),
            lambda: ops.attention_packed_bwd_plain(qkv, g, out, lse, **kw)),
    }
    bounds = gemm_bounds(16384, n=TP_QKV, i=TP_INTER)
    bounds["flash_attention_packed"] = attention_bound(mask, None, False, heads=TP_HEADS)
    bounds["flash_attention_packed_bwd"] = attention_bound(mask, None, True, heads=TP_HEADS)
    # The library: sdpa and its backward on the same heads; for the GEMM
    # kernels, which no one call computes, torch.matmul on their products
    # (kernel 12: dy and dW; kernel 11: the projection, dy and dW).
    xn = ops.layer_norm(x, scale)
    sdpa = library_attention_ms(qkv, rope, mask, g, heads=TP_HEADS)
    library = {
        "flash_attention_packed": sdpa[0], "flash_attention_packed_bwd": sdpa[1],
        "ln_matmul": None, "ln_geglu": None, "ln_matmul_bwd": None, "ln_geglu_bwd": None,
    }
    g_wi = torch.cat([g_mlp, g_mlp], 1)  # the cotangent of Wi's output, [M, 2I/tp]
    matmul = {
        "ln_matmul": graph_ms(lambda: torch.matmul(xn, w_qkv.t())),
        "ln_geglu": graph_ms(lambda: torch.matmul(xn, w_i.t())),
        "ln_matmul_bwd": cuda_ms(lambda: (g_qkv @ w_qkv, g_qkv.t() @ xn)),
        "ln_geglu_bwd": cuda_ms(lambda: (xn @ w_i.t(), g_wi @ w_i, g_wi.t() @ xn)),
    }
    for name in SHARDED:
        ms, plain_ms = timings[name]
        entry = {"max_abs_err": errs[name][torch.bfloat16],
                 "max_abs_err_fp32": errs[name][torch.float32], "ms": ms, "plain_ms": plain_ms,
                 **bounds[name], "library_ms": library[name]}
        if name in matmul:
            entry["matmul_ms"] = matmul[name]
        stats[name]["tp2"] = entry
        extra = (f"torch.matmul on its products {matmul[name]:.4f} ms" if name in matmul
                 else f"library {library[name]:.4f} ms")
        phase(f"phase 16 {name} at the tp = 2 shard: max_abs_err fp32 "
              f"{entry['max_abs_err_fp32']:.3e}, bf16 {entry['max_abs_err']:.3e}; bf16 B=32 S=512 "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms by "
              f"{entry['bound_by']}, {extra}")


def p16_train(mesh, sd, batches, steps: int, bf16: bool, ref_path: str | None,
              out_dir: Path, device: torch.device = torch.device("cuda", 0),
              config=None) -> dict:
    """``steps`` trainer steps over ``mesh`` on phase 8's batches in turn
    (``config`` defaults to base_config()):
    the losses, each parameter's sum (ranks of a mesh must agree), the wall,
    the launches it made and, on the main rank with ``ref_path``, the update
    over the run against one process's."""
    from open_provence_tpu_torch import kernels
    from open_provence_tpu_torch.train import OpenProvenceTrainer

    before = kernels.launch_counts()
    began = time.perf_counter()
    trainer = OpenProvenceTrainer(config or base_config(), sd, None, output_dir=out_dir, bf16=bf16,
                                  learning_rate=P16_LR, total_steps=10, mesh=mesh,
                                  tensor_parallel=True, device=device)
    losses = [trainer.train_one_step(batches[i % len(batches)])["loss"] for i in range(steps)]
    torch.cuda.synchronize()
    out = {"losses": losses, "wall": time.perf_counter() - began, "device": str(trainer.device),
           "sums": [float(p.detach().double().sum()) for p in trainer.params.values()],
           "launches": {k: v - before[k] for k, v in kernels.launch_counts().items()}}
    if ref_path is not None and mesh.is_main:
        ref = torch.load(ref_path, mmap=True, weights_only=True)
        errs = rel_errs({k: trainer.params[k].detach().cpu() - sd[k] for k in sd}, ref)
        out["update_err"], out["worst"] = max(errs.values()), max(errs, key=errs.get)
    return out


def p16_serve(model, pairs) -> dict:
    """process() on ``pairs`` at threshold 0.1 with the sentence metrics."""
    began = time.perf_counter()
    out = model.process(*pairs, threshold=P16_THRESHOLD, show_progress=False,
                        return_sentence_metrics=True)
    torch.cuda.synchronize()
    return {"scores": np.asarray(out["reranking_score"], dtype=np.float64),
            "probs": np.concatenate([np.asarray(p) for p in out["sentence_probabilities"]]),
            "pruned": out["pruned_context"], "wall": time.perf_counter() - began,
            "device": str(model.device)}


def p16_all_reduce_ms(mesh, device: torch.device = torch.device("cuda", 0)) -> float:
    """Milliseconds of one gloo all-reduce of 50 MB of fp32 on the card
    over ``mesh``'s model group (two ranks), the lowest of three: the size
    of one activation sum of tensor parallelism at B=32, S=512."""
    t = torch.ones(50 * 2**20 // 4, device=device)
    times = []
    for _ in range(3):
        mesh.barrier()
        torch.cuda.synchronize()
        began = time.perf_counter()
        mesh.all_reduce(t, "model")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - began) * 1e3)
    return min(times)


def p16_rank(rank: int, sd_path: str, batches: list, ref_path: str, out_dir: str) -> dict:
    """One of phase 16's four ranks, all on card 0. Ranks 0 and 1 serve
    (process() under 2 x 1 in bf16 at 22 layers, under 1 x 2 in fp32 at
    CPU_CHECK_LAYERS) and train fp32 under 2 x 1 while ranks 2 and 3 train
    fp32 under 1 x 2, which evens out the two pairs' walls: gloo carries
    every activation sum of tensor parallelism through the host at about
    1 GB/s (phase 16 prints it), so at full depth the fp32 1 x 2 serve
    alone outlasts both pairs' training. Then all four train fp32 and
    briefly bf16 under 2 x 2. fp32 trains the first P16_FP32_LAYERS layers,
    bf16 all 22. Returns what it measured and the launches of every
    kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.set_device(0)
    from open_provence_tpu_torch import OpenProvenceModel, kernels
    from open_provence_tpu_torch.parallel.mesh import create_mesh

    out_dir = Path(out_dir)
    sd = torch.load(sd_path, mmap=True, weights_only=True)
    pairs = {(devices, shape): create_mesh(*shape, devices=devices)
             for devices in ((0, 1), (2, 3)) for shape in ((2, 1), (1, 2))}
    full = create_mesh(2, 2)
    mine = (0, 1) if rank < 2 else (2, 3)
    kernels.reset_launch_counts()
    result = {"role": "serve" if rank < 2 else "train", "rank": rank,
              "gloo_ms": p16_all_reduce_ms(pairs[mine, (1, 2)])}
    if rank < 2:
        DummyTokenizer, _ = load_dummy_tokenizers()
        for shape, label, dtype, (config, weights) in (
                ((2, 1), "2x1", torch.bfloat16, (base_config(), sd)),
                ((1, 2), "1x2", torch.float32, cut_depth(base_config(), sd, CPU_CHECK_LAYERS))):
            mesh = pairs[mine, shape]
            model = OpenProvenceModel(config, weights, DummyTokenizer(),
                                      device=torch.device("cuda", 0), dtype=dtype, mesh=mesh,
                                      tensor_parallel=mesh.model > 1)
            result[f"serve {label}"] = p16_serve(model, synthetic_pairs(256))
            del model
    label = "2x1" if rank < 2 else "1x2"
    cut, cut_sd = cut_depth(base_config(), sd, P16_FP32_LAYERS)
    result[f"fp32 {label}"] = p16_train(pairs[mine, (2, 1) if rank < 2 else (1, 2)], cut_sd,
                                        batches, P16_STEPS, False, ref_path,
                                        out_dir / f"p16_{label}", config=cut)
    result["fp32 2x2"] = p16_train(full, cut_sd, batches, P16_STEPS, False, ref_path,
                                   out_dir / "p16_2x2", config=cut)
    result["bf16 2x2"] = p16_train(full, sd, batches, 2, True, None, out_dir / "p16_2x2_bf16")
    result["launches"], result["plain"] = kernels.launch_counts(), kernels.plain_counts()
    result["jax_modules"] = sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "open_provence_tpu"))
    return result


def p16_flips(got: np.ndarray, want: np.ndarray, margin: float) -> tuple[int, int]:
    """(keep/drop flips, sentences decided) among sentences further than
    ``margin`` from the threshold in ``want``."""
    decided = np.abs(want - P16_THRESHOLD) > margin
    flips = int(np.sum((got > P16_THRESHOLD)[decided] != (want > P16_THRESHOLD)[decided]))
    return flips, int(decided.sum())


def phase16_mesh(config, sd, tokenizer_cls, pair_tokenizer, dev, card: str, out_dir: Path,
                 stats: dict[str, dict]) -> dict[str, dict[str, int]]:
    """The mesh (see above). Returns the launches of the four ranks, summed."""
    from open_provence_tpu_torch import OpenProvenceModel, kernels
    from open_provence_tpu_torch.parallel.dryrun import dryrun_multichip, run_ranks
    from open_provence_tpu_torch.train import OpenProvenceTrainer

    began = time.perf_counter()
    phase16_kernels(dev, stats)
    batches = [training_batch(pair_tokenizer, 31, 512, seed=s) for s in (80, 81)]
    cut, cut_sd = cut_depth(config, sd, P16_FP32_LAYERS)
    one = OpenProvenceTrainer(cut, cut_sd, None, output_dir=out_dir / "p16_one", bf16=False,
                              learning_rate=P16_LR, total_steps=10, device=dev)
    t0 = time.perf_counter()
    want_losses = [one.train_one_step(batches[i % 2])["loss"] for i in range(P16_STEPS)]
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    update = {k: one.params[k].detach().cpu() - cut_sd[k] for k in cut_sd}
    del one
    sd_path, ref_path = out_dir / "p16_weights.pt", out_dir / "p16_update.pt"
    torch.save(sd, sd_path)
    torch.save(update, ref_path)
    pairs = synthetic_pairs(256)
    want_serve = {}
    for dtype, (cfg, weights) in ((torch.bfloat16, (config, sd)),
                                  (torch.float32, cut_depth(config, sd, CPU_CHECK_LAYERS))):
        model = OpenProvenceModel(cfg, weights, tokenizer_cls(), device=dev, dtype=dtype)
        want_serve[dtype] = p16_serve(model, pairs)
        del model
    torch.cuda.empty_cache()
    phase(f"phase 16 one process: fp32 {P16_STEPS} steps B=32 S=512 at {P16_FP32_LAYERS} layers, "
          "losses "
          f"{', '.join(f'{v:.6f}' for v in want_losses)}, wall {one_wall:.1f} s; process() 256 "
          f"pairs bf16 {want_serve[torch.bfloat16]['wall']:.1f} s, fp32 at {CPU_CHECK_LAYERS} "
          f"layers {want_serve[torch.float32]['wall']:.1f} s [{card}]")

    # dryrun_multichip(4) spawns its four ranks beside these four.
    dryrun = {}

    def run_dryrun():
        t = time.perf_counter()
        try:
            dryrun["loss"] = dryrun_multichip(4)
        except Exception as e:  # raised after the join below
            dryrun["error"] = e
        dryrun["wall"] = time.perf_counter() - t

    side = threading.Thread(target=run_dryrun)
    t0 = time.perf_counter()
    side.start()
    ranks = run_ranks(p16_rank, 4, str(sd_path), batches, str(ref_path), str(out_dir))
    spawn_wall = time.perf_counter() - t0
    side.join()
    if "error" in dryrun:
        raise AssertionError(f"phase 16: dryrun_multichip(4) failed: {dryrun['error']!r}")
    leaked = sorted({m for r in ranks for m in r["jax_modules"]})
    if leaked:
        raise AssertionError(f"phase 16: a rank imported {leaked[:5]}")
    for r in ranks:
        runs = [v for k, v in r.items() if k.startswith(("fp32", "bf16", "serve"))]
        if any(r["plain"].values()) or any(v["device"] != "cuda:0" for v in runs):
            raise AssertionError(f"phase 16 rank {r['rank']} ran a plain version or left the "
                                 f"card: {r['plain']}")
    layers = config.backbone().num_hidden_layers
    for label, members in (("2x1", ranks[:2]), ("1x2", ranks[2:]), ("2x2", ranks)):
        runs = [r[f"fp32 {label}"] for r in members]
        main = next(run for run in runs if "update_err" in run)
        loss_err = max(abs(a / b - 1) for a, b in zip(main["losses"], want_losses))
        agree = all(run["sums"] == main["sums"] and run["losses"] == main["losses"] for run in runs)
        walls = ", ".join(f"{run['wall']:.1f}" for run in runs)
        phase(f"phase 16 fp32 {label} mesh, {P16_STEPS} steps B=32 S=512, "
              f"{P16_FP32_LAYERS} layers: losses "
              f"{', '.join(f'{v:.6f}' for v in main['losses'])} (largest rel err {loss_err:.3e}, "
              f"tol {P16_LOSS_TOL}); update over the run: largest error {main['update_err']:.3e} "
              f"of each tensor's largest ({main['worst']}; tol {P16_UPDATE_TOL}); ranks agree "
              f"{agree}; walls {walls} s")
        if not (loss_err <= P16_LOSS_TOL and main["update_err"] <= P16_UPDATE_TOL and agree):
            raise AssertionError(f"phase 16: the {label} mesh's fp32 run is not one process's")
    bf16 = [r["bf16 2x2"] for r in ranks]
    for run in bf16:
        missing = [name for name in DEFAULT_EIGHT if run["launches"][name] == 0]
        if missing or not all(np.isfinite(run["losses"])):
            raise AssertionError(f"phase 16 bf16 2x2: losses {run['losses']}, never launched "
                                 f"{missing}")
    losses = ", ".join(f"{v:.4f}" for v in bf16[0]["losses"])
    walls = ", ".join(f"{run['wall']:.1f}" for run in bf16)
    counts = "; ".join("/".join(str(run["launches"][k]) for k in FORWARD) for run in bf16)
    phase(f"phase 16 bf16 2x2 mesh, 2 steps: losses {losses}; walls {walls} s; kernels 1-4 "
          f"launched a rank {counts}")

    served = {label: [r[f"serve {label}"] for r in ranks[:2]] for label in ("2x1", "1x2")}
    for label, dtype, tol, margin in (("2x1", torch.bfloat16, P16_BF16_TOL, P16_BF16_TOL),
                                      ("1x2", torch.float32, 1e-3, 1e-4)):
        want = want_serve[dtype]
        for got in served[label]:
            score_err = float(np.max(np.abs(got["scores"] - want["scores"])))
            equal = int(np.sum(got["scores"] == want["scores"]))
            flips, decided = p16_flips(got["probs"], want["probs"], margin)
            depth = layers if label == "2x1" else CPU_CHECK_LAYERS
            phase(f"phase 16 process() {label} {str(dtype)[6:]} at {depth} layers, 256 pairs "
                  "against one process: "
                  f"{equal} of 256 scores bit-equal, score max_abs_err {score_err:.3e} (tol {tol}), "
                  f"sentence-prob max_abs_err {np.max(np.abs(got['probs'] - want['probs'])):.3e}, "
                  f"{flips} keep/drop flips among {decided} sentences decided by > {margin}; "
                  f"wall {got['wall']:.1f} s")
            if score_err > tol or flips:
                raise AssertionError(f"phase 16: process() under {label} is not one process's")
    for r in ranks:
        phase(f"phase 16 rank {r['rank']} ({r['role']}) launches: {json.dumps(r['launches'])}")
    gloo_ms = ", ".join(f"{r['gloo_ms']:.1f}" for r in ranks)
    phase(f"phase 16 four ranks on card 0 over gloo: {spawn_wall:.1f} s from spawn to join; one "
          f"all-reduce of 50 MB of fp32 on the card between two ranks {gloo_ms} ms (each rank's "
          f"lowest of 3) [{card}]; the ranks share one card, so no wall here says anything of "
          "scaling")

    phase(f"phase 16 dryrun_multichip(4) on card 0, beside the four ranks: loss "
          f"{dryrun['loss']:.4f}, {dryrun['wall']:.1f} s")
    phase(f"phase 16 took {time.perf_counter() - began:.0f} s")
    total = {name: sum(r["launches"][name] for r in ranks) for name in kernels.KERNELS}
    return {"mesh_16": total}


# --- phase 17: the data factory and the MLDR evaluation ---------------------

# Phase 17 drives the data factory's commands (datasets_factory/cli.py) and
# the MLDR evaluation's CLI (eval/mldr_cli.py) through their main() on
# JSON-lines data, with phase 14's final model (base width, 22 layers, bf16,
# max_length 512) as the span teacher, the reranker teacher and the pruner.
# The judge of the MLDR CLI is a stand-in set into eval/mldr_eval.py: the
# real one needs the network.
P17_ROWS, P17_PLANTED = 64, 8  # sentence-transformers rows; planted duplicates
P17_QUERIES, P17_NEGATIVES = 16, 3  # MLDR queries; negatives a query
P17_CHECK_ROWS, P17_CHECK_QUERIES = 8, 2  # fp32 card against CPU
P17_WORDS = "sushi ramen kyoto market travel budget deadline plants river temple".split()


def p17_text(rng: random.Random, tag: str, low: int, high: int) -> str:
    """``low``-``high`` sentences that name ``tag``, so that no two texts
    repeat unless copied."""
    return " ".join(f"{tag} sentence {i} is about {rng.choice(P17_WORDS)} and "
                    f"{rng.choice(P17_WORDS)}." for i in range(rng.randint(low, high)))


def p17_triplets(seed: int = 170) -> list[dict]:
    """P17_ROWS rows of (query, positive, negative_1..3) of 8-24 sentences a
    text; the last P17_PLANTED copy the positive and first negative of
    earlier rows under new queries, so that two texts of each repeat."""
    rng = random.Random(seed)
    rows = []
    for r in range(P17_ROWS - P17_PLANTED):
        row = {"query": f"what about {rng.choice(P17_WORDS)} in row {r} ?",
               "positive": p17_text(rng, f"r{r}p", 8, 24)}
        for k in range(1, 4):
            row[f"negative_{k}"] = p17_text(rng, f"r{r}n{k}", 8, 24)
        rows.append(row)
    for d in range(P17_PLANTED):
        original = rows[7 * d]
        rows.append({"query": f"what about row {7 * d} again ?", "positive": original["positive"],
                     "negative_1": original["negative_1"],
                     "negative_2": p17_text(rng, f"d{d}n2", 8, 24),
                     "negative_3": p17_text(rng, f"d{d}n3", 8, 24)})
    return rows


def p17_mldr_rows(seed: int = 171) -> list[dict]:
    """An MLDR split: P17_QUERIES queries, each with 1 positive and
    P17_NEGATIVES negatives of 4000-8000 characters; half the passages
    titled, half with a None title."""
    rng = random.Random(seed)
    rows = []
    for q in range(P17_QUERIES):
        topic = rng.choice(P17_WORDS)
        passages = []
        for k in range(1 + P17_NEGATIVES):
            target, text, i = rng.randint(4000, 7900), "", 0
            while len(text) < target:
                text += (f"Passage {q}-{k} line {i} tells of {rng.choice(P17_WORDS)} and "
                         f"{rng.choice(P17_WORDS)}. ")
                i += 1
            passages.append({"docid": f"d{q}-{k}", "title": f"On {topic}" if (q + k) % 2 else None,
                             "text": text.strip()})
        rows.append({"query_id": f"p17-q{q}", "query": f"what about {topic} ?",
                     "positive_passages": passages[:1], "negative_passages": passages[1:]})
    return rows


def p17_read(path: Path) -> dict[str, list[dict]]:
    from open_provence_tpu_torch.train.data import open_splits

    return {name: table.to_list() for name, table in open_splits(str(path))[0].items()}


class P17Recording:
    """An encoder that keeps each ``predict_context`` output."""

    def __init__(self, encoder):
        self.encoder, self.outputs = encoder, []

    def predict_context(self, *args, **kwargs):
        out = self.encoder.predict_context(*args, **kwargs)
        self.outputs.append(out)
        return out


def p17_factory_fp32(teacher: Path, rows: list[dict], pair_tokenizer_cls, dev) -> str:
    """The encoder teacher in fp32 on the card against fp32 on the CPU, on
    ``rows`` at CPU_CHECK_LAYERS layers: no span flag flips unless a token
    of the span lies within KEEP_MARGIN of the token threshold (0.5), and
    teacher scores within 1e-4."""
    from open_provence_tpu_torch import OpenProvenceEncoder
    from open_provence_tpu_torch.datasets_factory import (
        add_teacher_scores, annotate_span_relevance, make_encoder_annotator)
    from open_provence_tpu_torch.train.data import RowTable
    from open_provence_tpu_torch.utils.hf_convert import load_checkpoint

    cut, cut_sd = cut_depth(*load_checkpoint(teacher), CPU_CHECK_LAYERS)
    table = RowTable.from_list(rows)
    side = {}
    for where in (dev, "cpu"):
        encoder = OpenProvenceEncoder(config=cut, state_dict=cut_sd, tokenizer=pair_tokenizer_cls(),
                                      device=where, dtype=torch.float32)
        recorder = P17Recording(encoder)
        labeled = annotate_span_relevance(table, make_encoder_annotator(recorder))
        scored = add_teacher_scores(labeled, lambda pairs: encoder.predict(pairs, batch_size=32),
                                    teacher_name="t", batch_size=32)
        side[str(where)] = (scored.to_list(), recorder.outputs)
        del encoder, recorder
    (card_rows, card_out), (cpu_rows, cpu_out) = side[str(dev)], side["cpu"]
    outputs = iter(zip(card_out, cpu_out))
    flips = near = spans_total = 0
    token_err = 0.0
    for card_row, cpu_row in zip(card_rows, cpu_rows):
        for spans, card_flags, cpu_flags in zip(cpu_row["context_spans"],
                                                card_row["context_spans_relevance"],
                                                cpu_row["context_spans_relevance"]):
            card_o, cpu_o = next(outputs)
            probs = np.asarray(cpu_o.token_scores, dtype=np.float64)
            token_err = max(token_err, float(np.max(np.abs(
                np.asarray(card_o.token_scores, dtype=np.float64) - probs))))
            start = 0  # the annotator's document: the spans joined by one space
            for (a, b), got, want in zip(spans, card_flags, cpu_flags):
                close = bool(np.any(np.abs(probs[start:start + b - a] - 0.5) <= KEEP_MARGIN))
                near += close
                flips += got != want and not close
                spans_total += 1
                start += b - a + 1
    score_err = max(abs(a - b) for card_row, cpu_row in zip(card_rows, cpu_rows)
                    for a, b in zip(card_row["teacher_scores.t"], cpu_row["teacher_scores.t"]))
    note = (f"phase 17 factory fp32 card vs cpu, {len(rows)} rows at {CPU_CHECK_LAYERS} layers: "
            f"{flips} span flips among {spans_total} spans ({near} hold a token within "
            f"{KEEP_MARGIN} of the threshold), token-prob max_abs_err {token_err:.3e}, teacher "
            f"score max_abs_err {score_err:.3e} (tol 1e-4)")
    if flips or score_err > 1e-4:
        raise AssertionError(note)
    return note


def p17_factory(pair_tokenizer_cls, dev, card: str, out_dir: Path) -> dict[str, int]:
    """``factory_512``: generate (--lang en), frequency_filter (threshold 1),
    add_context_spans_relevance with the encoder teacher and
    add_reranker_teacher_scores through datasets_factory/cli.py::main on a
    JSON-lines source; launch counts read around the two teacher commands."""
    from open_provence_tpu_torch import kernels
    from open_provence_tpu_torch.datasets_factory import cli as factory_cli
    from open_provence_tpu_torch.datasets_factory.converter import _eval_carve_plan
    from open_provence_tpu_torch.train.data import write_jsonl_splits

    teacher = out_dir / P14_FINAL
    d = {name: out_dir / f"p17_{name}"
         for name in ("source", "generated", "filtered", "labeled", "scored")}
    write_jsonl_splits({"train": p17_triplets()}, d["source"])

    def run(*argv, **kwargs) -> float:
        began = time.perf_counter()
        if factory_cli.main([str(a) for a in argv], **kwargs) != 0:
            raise AssertionError(f"phase 17: datasets_factory.cli {argv[0]} failed")
        torch.cuda.synchronize()
        return time.perf_counter() - began

    walls = {"generate": run("generate", "--dataset", d["source"], "--lang", "en",
                             "--output-dir", d["generated"]),
             "frequency_filter": run("frequency_filter", "--dataset", d["generated"],
                                     "--threshold", "1", "--output-dir", d["filtered"])}
    kernels.reset_launch_counts()
    walls["add_context_spans_relevance"] = run(
        "add_context_spans_relevance", "--dataset", d["filtered"], "--teacher-model", teacher,
        "--device", dev, "--output-dir", d["labeled"], tokenizer=pair_tokenizer_cls())
    walls["add_reranker_teacher_scores"] = run(
        "add_reranker_teacher_scores", "--dataset", d["labeled"], "--teacher-model", teacher,
        "--device", dev, "--batch-size", "32", "--output-dir", d["scored"],
        tokenizer=pair_tokenizer_cls())
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    require_forward("phase 17 factory_512", launches, plain)

    generated, filtered, scored = (p17_read(d[k]) for k in ("generated", "filtered", "scored"))
    val, test = _eval_carve_plan(P17_ROWS)
    stats = json.loads((d["filtered"] / "frequency_filter_stats.json").read_text())["train"]
    seen, later = set(), set()  # the later row of each planted pair in train
    for row in generated["train"]:
        if row["texts"][0] in seen:
            later.add(row["id"])
        seen.add(row["texts"][0])
    dropped = {r["id"] for r in generated["train"]} - {r["id"] for r in filtered["train"]}
    column = f"teacher_scores.{P14_FINAL}"
    columns = ["id", "query", "texts", "context_spans", "labels", "context_spans_relevance",
               column]
    every = [r for rows in scored.values() for r in rows]
    flags = [f for r in every for text in r["context_spans_relevance"] for f in text]
    scores = np.asarray([v for r in every for v in r[column]], dtype=np.float64)
    checks = {
        f"carved {val} validation and {test} test rows (_eval_carve_plan({P17_ROWS}))":
            (len(generated["validation"]), len(generated["test"]), len(generated["train"]))
            == (val, test, P17_ROWS - val - test),
        f"dropped the later row of each planted pair in train and no other "
        f"({len(later)} of {P17_PLANTED})": dropped == later and stats["rows_removed"] == len(later)
            and len(later) >= P17_PLANTED - val - test,
        "validation and test pass the filter unchanged": all(
            filtered[k] == generated[k] for k in ("validation", "test")),
        "the rows keep their order": [r["id"] for r in scored["train"]]
            == [r["id"] for r in filtered["train"]],
        f"columns {columns}": all(list(r) == columns for r in every),
        "one flag a span": all([len(f) for f in r["context_spans_relevance"]]
                               == [len(s) for s in r["context_spans"]] for r in every)
            and set(flags) <= {0, 1},
        "a finite teacher score a text": all(len(r[column]) == len(r["texts"]) for r in every)
            and bool(np.isfinite(scores).all()),
    }
    pairs = sum(len(r["texts"]) for r in every)
    phase(f"phase 17 factory_512 bf16 through datasets_factory.cli on {P14_FINAL}: "
          f"{P17_ROWS} rows -> splits {[len(v) for v in generated.values()]} -> "
          f"{len(filtered['train'])} train rows after the filter ({stats['rows_removed']} "
          f"dropped); {pairs} (query, text) pairs labeled one a call and scored 32 a batch: "
          f"{sum(flags)} of {len(flags)} spans flagged, teacher scores in "
          f"[{scores.min():.4f}, {scores.max():.4f}]; walls "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
          + f" ({pairs / walls['add_context_spans_relevance']:.1f} pairs/s labeled, loading "
          f"included) [{card}]; {', '.join(checks)}; launches {json.dumps(launches)}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 17 factory_512: {failed} failed")
    phase(p17_factory_fp32(teacher, filtered["train"][:P17_CHECK_ROWS], pair_tokenizer_cls, dev))
    return launches


def p17_mldr_fp32(model_dir: Path, rows: list[dict], tokenizer_cls, dev) -> str:
    """process() as build_records calls it, in fp32 on the card against fp32
    on the CPU, on ``rows`` at CPU_CHECK_LAYERS layers: scores within 1e-4,
    no keep/drop flip among sentences further than KEEP_MARGIN from the
    threshold."""
    from open_provence_tpu_torch import OpenProvenceModel
    from open_provence_tpu_torch.eval.mldr_eval import normalize_title
    from open_provence_tpu_torch.utils.hf_convert import load_checkpoint

    cut, cut_sd = cut_depth(*load_checkpoint(model_dir), CPU_CHECK_LAYERS)
    passages = [r["positive_passages"] + r["negative_passages"] for r in rows]
    th = 0.1
    kw = dict(question=[r["query"] for r in rows],
              context=[[p["text"] for p in ps] for ps in passages],
              title=[[normalize_title(p["title"]) for p in ps] for ps in passages], threshold=th,
              batch_size=32, show_progress=False, return_sentence_texts=True,
              return_sentence_metrics=True)
    outs = []
    for where in (dev, "cpu"):
        model = OpenProvenceModel(cut, cut_sd, tokenizer_cls(), device=where, dtype=torch.float32)
        outs.append(model.process(**kw))
        del model

    def flat(nested) -> np.ndarray:
        if isinstance(nested, (list, tuple)):
            parts = [flat(v) for v in nested]
            return np.concatenate(parts) if parts else np.zeros(0)
        return np.asarray([nested], dtype=np.float64)

    card_p, cpu_p = (flat(o["sentence_probabilities"]) for o in outs)
    decided = np.abs(cpu_p - th) > KEEP_MARGIN
    flips = int(np.sum((card_p > th)[decided] != (cpu_p > th)[decided]))
    score_err = float(np.max(np.abs(flat(outs[0]["reranking_score"])
                                    - flat(outs[1]["reranking_score"]))))
    note = (f"phase 17 mldr fp32 card vs cpu, {len(rows)} queries x {len(passages[0])} passages "
            f"at {CPU_CHECK_LAYERS} layers: {flips} keep/drop flips among {int(decided.sum())} "
            f"sentences decided by > {KEEP_MARGIN}, sentence-prob max_abs_err "
            f"{np.max(np.abs(card_p - cpu_p)):.3e}, score max_abs_err {score_err:.3e} (tol 1e-4)")
    if flips or score_err > 1e-4 or len(card_p) != len(cpu_p):
        raise AssertionError(note)
    return note


def p17_mldr(tokenizer_cls, dev, card: str, out_dir: Path) -> dict[str, int]:
    """``mldr_512``: eval/mldr_cli.py::main on a JSON-lines MLDR split with
    --threshold 0.1 --batch-size 32 and the stand-in judge (launch counts
    read around it), then the stage-skip rerun, --text-source original and
    --threshold 0; the stage-1 rate; fp32 card against CPU."""
    from open_provence_tpu_torch import OpenProvenceModel, kernels
    from open_provence_tpu_torch.eval import mldr_cli, mldr_eval
    from open_provence_tpu_torch.train.data import write_jsonl_splits

    model_dir = out_dir / P14_FINAL
    rows = p17_mldr_rows()
    source = write_jsonl_splits({"test": rows}, out_dir / "p17_mldr")
    run_dir = out_dir / "p17_mldr_run"
    judged = []

    async def judge(prompt, config):
        judged.append(prompt)
        return {"has_answer": int(" tells of sushi " in prompt), "answer_score": 0.5,
                "reasoning": "stand-in judge"}

    base = ["--model", model_dir, "--dataset", source, "--limit", P17_QUERIES,
            "--batch-size", 32, "--device", dev, "--no-progress"]

    def run(*argv) -> float:
        began = time.perf_counter()
        if mldr_cli.main([str(a) for a in (*base, *argv)], tokenizer=tokenizer_cls()) != 0:
            raise AssertionError(f"phase 17: eval.mldr_cli {argv} failed")
        torch.cuda.synchronize()
        return time.perf_counter() - began

    real_judge, mldr_eval.call_openai_judge = mldr_eval.call_openai_judge, judge
    try:
        kernels.reset_launch_counts()
        wall = run("--output-dir", run_dir, "--threshold", 0.1)
        launches, plain = kernels.launch_counts(), kernels.plain_counts()
        require_forward("phase 17 mldr_512", launches, plain)
        first_judged = len(judged)
        stamp = (run_dir / "process" / "summary.json").stat().st_mtime_ns
        rerun = run("--output-dir", run_dir, "--threshold", 0.1)
        skipped = (len(judged) == first_judged
                   and (run_dir / "process" / "summary.json").stat().st_mtime_ns == stamp)
        run("--output-dir", run_dir, "--text-source", "original", "--no-eval")
        run("--output-dir", out_dir / "p17_mldr_keep_all", "--threshold", 0, "--no-eval")
    finally:
        mldr_eval.call_openai_judge = real_judge

    records = mldr_cli.read_records(run_dir / "process" / "dataset")[0]
    original = mldr_cli.read_records(run_dir / "process_original" / "dataset")[0]
    keep_all = mldr_cli.read_records(out_dir / "p17_mldr_keep_all" / "process" / "dataset")[0]
    summary = json.loads((run_dir / "process" / "summary.json").read_text())
    judge_summary = json.loads((run_dir / "eval_llm" / "summary.json").read_text())
    n = P17_QUERIES * (1 + P17_NEGATIVES)
    titles = [p["title"] for r in rows for p in r["positive_passages"] + r["negative_passages"]]
    scores = np.asarray([r["reranking_score"] for r in records], dtype=np.float64)
    counts = judge_summary["counts"]
    checks = {
        f"{n} records of {P17_QUERIES} queries": len(records) == summary["num_records"] == n
            and summary["num_queries"] == P17_QUERIES,
        "the titled passages' titles": all(r["title"] == t for r, t in zip(records, titles) if t),
        "scores finite in [0, 1]": bool(np.isfinite(scores).all())
            and bool(((scores >= 0) & (scores <= 1)).all()),
        "kept and removed sentences listed": all(r["kept_sentences"] or r["removed_sentences"]
                                                 for r in records),
        f"the {P17_QUERIES} positives judged": first_judged == P17_QUERIES
            and judge_summary["records_evaluated"] == P17_QUERIES
            and counts["has_answer_1"] + counts["has_answer_0"] == P17_QUERIES
            and counts["failed"] == 0,
        "summary.json, result.md, eval_llm/summary.md written": all(
            (run_dir / f).exists() for f in ("process/result.md", "eval_llm/summary.md")),
        "the rerun skipped both stages": skipped,
        "--text-source original and --threshold 0 give every passage back": all(
            r["pruned_text"] == r["original_text"] for r in original + keep_all)
            and len(original) == len(keep_all) == n,
    }
    # The stage-1 rate: build_records on one warm model, as the CLI runs it.
    model = OpenProvenceModel.from_pretrained(model_dir, tokenizer=tokenizer_cls(), device=dev)
    times = []
    for _ in range(2):  # the first call is a warm-up
        began = time.perf_counter()
        mldr_eval.build_records(model.process, rows, threshold=0.1, batch_size=32)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - began)
    del model
    chars = sum(len(r["original_text"]) for r in records)
    # An untitled passage goes in with the title "None" (ROADMAP C, as in the
    # JAX package): count the records that carry it.
    none_titles = sum(r["title"] == "None" for r, t in zip(records, titles) if t is None)
    phase(f"phase 17 mldr_512 bf16 through eval.mldr_cli on {P14_FINAL}: {n} passages of "
          f"{chars / n:.0f} characters on average, threshold 0.1: compression pos "
          f"{summary['avg_pos_compression']:.2f} / neg {summary['avg_neg_compression']:.2f} %, "
          f"scores pos {summary['avg_pos_score']:.4f} / neg {summary['avg_neg_score']:.4f}; both "
          f"stages {wall:.1f} s (stage 1 {summary['process_time_seconds']:.1f} s, loading "
          f"included), the skipping rerun {rerun:.1f} s; build_records alone {times[1]:.3f} s = "
          f"{n / times[1]:.1f} passages/s [{card}]; {', '.join(checks)} ({none_titles} of "
          f"{titles.count(None)} untitled passages titled 'None'); launches {json.dumps(launches)}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 17 mldr_512: {failed} failed")
    phase(p17_mldr_fp32(model_dir, rows[:P17_CHECK_QUERIES], tokenizer_cls, dev))
    return launches


def phase17_factory_and_mldr(tokenizer_cls, pair_tokenizer_cls, dev, card: str,
                             out_dir: Path) -> dict[str, dict[str, int]]:
    """The data factory and the MLDR evaluation (see above). Both paths must
    launch kernels 1-4 and no plain version."""
    began = time.perf_counter()
    by_path = {"factory_512": p17_factory(pair_tokenizer_cls, dev, card, out_dir),
               "mldr_512": p17_mldr(tokenizer_cls, dev, card, out_dir)}
    phase(f"phase 17 took {time.perf_counter() - began:.0f} s")
    return by_path


def mesh_cards_main(tree: Path) -> int:
    try:
        return mesh_cards(tree)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def mesh_cards(tree: Path) -> int:
    """``torchrun --nproc-per-node 4 chip_smoke.py --mesh-cards``: the mesh
    across cards, one rank a card, with the process group the trainer's CLI
    starts (``parallel.mesh.init_from_env``: nccl). Phase 8's batch trained
    in fp32 for 3 steps at base width and depth under 2 x 2 against one
    process on rank 0's card (losses 1e-4 relative, the update 1e-3 of each
    tensor's largest), phase 5's 256 pairs served in fp32 under 2 x 2
    against one process (scores 1e-3, no flips), and one all-reduce of 50 MB
    between two cards. Prints on rank 0; any rank's failure fails the run."""
    import torch.distributed as dist

    sys.path.insert(0, str(tree))
    from open_provence_tpu_torch import OpenProvenceModel, init_params
    from open_provence_tpu_torch.parallel.mesh import Mesh, create_mesh, init_from_env, local_rank

    if not init_from_env(None) or dist.get_world_size() != 4:
        print("--mesh-cards runs under torchrun --nproc-per-node 4", file=sys.stderr)
        return 2
    dev = torch.device("cuda", local_rank())
    rank = dist.get_rank()
    mesh = create_mesh(2, 2)
    DummyTokenizer, PairDummyTokenizer = load_dummy_tokenizers()
    config = base_config()
    sd = init_params(config, torch.Generator().manual_seed(0))
    batches = [training_batch(PairDummyTokenizer(), 31, 512, seed=s) for s in (80, 81)]
    pairs = synthetic_pairs(256)
    # One directory for every rank of this run: the reference update goes
    # through it.
    out = Path(tempfile.gettempdir()) / f"op_mesh_cards_{os.environ['MASTER_PORT']}"
    ref_path = out / "update.pt"
    if rank == 0:
        from open_provence_tpu_torch.train import OpenProvenceTrainer

        out.mkdir(parents=True, exist_ok=True)
        # One process: a 1 x 1 mesh (the default would span the group).
        one = OpenProvenceTrainer(config, sd, None, output_dir=out / "one", bf16=False,
                                  learning_rate=P16_LR, total_steps=10, device=dev, mesh=Mesh())
        began = time.perf_counter()
        want_losses = [one.train_one_step(batches[i % 2])["loss"] for i in range(P16_STEPS)]
        torch.cuda.synchronize()
        one_wall = time.perf_counter() - began
        torch.save({k: one.params[k].detach().cpu() - sd[k] for k in sd}, ref_path)
        del one
        want = p16_serve(OpenProvenceModel(config, sd, DummyTokenizer(), device=dev,
                                           dtype=torch.float32), pairs)
    mesh.barrier()
    nccl_ms = p16_all_reduce_ms(mesh, dev)
    got = p16_train(mesh, sd, batches, P16_STEPS, False, str(ref_path), out / "mesh", dev)
    served = p16_serve(OpenProvenceModel(config, sd, DummyTokenizer(), device=dev,
                                         dtype=torch.float32, mesh=mesh, tensor_parallel=True),
                       pairs)
    mesh.barrier()
    if rank != 0:
        return 0
    shutil.rmtree(out, ignore_errors=True)
    loss_err = max(abs(a / b - 1) for a, b in zip(got["losses"], want_losses))
    score_err = float(np.max(np.abs(served["scores"] - want["scores"])))
    flips, decided = p16_flips(served["probs"], want["probs"], 1e-4)
    phase(f"mesh-cards: backend {dist.get_backend()}, {torch.cuda.device_count()} cards "
          f"[{card_line()}]; one all-reduce of 50 MB between two cards {nccl_ms:.2f} ms")
    phase(f"mesh-cards fp32 2x2, {P16_STEPS} steps B=32 S=512: losses "
          f"{', '.join(f'{v:.6f}' for v in got['losses'])} against one process's "
          f"{', '.join(f'{v:.6f}' for v in want_losses)} (largest rel err {loss_err:.3e}, tol "
          f"{P16_LOSS_TOL}); update over the run: largest error {got['update_err']:.3e} of "
          f"each tensor's largest (tol {P16_UPDATE_TOL}); walls {got['wall']:.1f} s against "
          f"{one_wall:.1f} s")
    phase(f"mesh-cards process() fp32 2x2, 256 pairs: score max_abs_err {score_err:.3e} (tol "
          f"1e-3), {flips} flips among {decided} sentences decided by > 1e-4; wall "
          f"{served['wall']:.1f} s against {want['wall']:.1f} s")
    ok = (loss_err <= P16_LOSS_TOL and got["update_err"] <= P16_UPDATE_TOL
          and score_err <= 1e-3 and not flips)
    print(json.dumps({"ok": ok, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}), flush=True)
    return 0 if ok else 1


def rates_main(tree: Path) -> int:
    """Serving and training rates at B=32, S=512 of the package under
    ``tree``: the forward, ``process()`` on 256 pairs and the bf16 training
    step. One JSON line."""
    sys.path.insert(0, str(tree))
    from open_provence_tpu_torch import OpenProvenceModel, init_params, kernels

    DummyTokenizer, PairDummyTokenizer = load_dummy_tokenizers()
    dev = torch.device("cuda", 0)
    card = card_line()
    kernels.library()
    config = base_config()
    sd = init_params(config, torch.Generator().manual_seed(0))
    model = OpenProvenceModel(config, sd, DummyTokenizer(), device=dev)
    rates = phase6_timings(model, synthetic_pairs(256), card, with_plain=False)
    del model
    batches = [training_batch(PairDummyTokenizer(), 31, 512, seed=s) for s in (80, 81)]
    with tempfile.TemporaryDirectory() as tmp:
        trainer = make_trainer(training_config(config), {k: v.to(dev) for k, v in sd.items()},
                               PairDummyTokenizer(), dev, Path(tmp), 20)
        train_steps(trainer, batches, 3)
        rates["train_pairs_per_s"] = float(np.mean([train_rate(trainer, batches)[0]
                                                    for _ in range(3)]))
    print(json.dumps({"tree": str(tree), "card": card, **rates}), flush=True)
    return 0


def launch_ms(fn, reps: int) -> dict[str, float]:
    """Device milliseconds a call of ``fn`` spends in each kernel it
    launches, from torch.profiler over ``reps`` calls (the kernel's name up
    to its template arguments)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_call: dict[str, float] = {}
    for evt in prof.key_averages():
        if getattr(evt.device_type, "name", "") != "CUDA":
            continue
        us = getattr(evt, "self_device_time_total", 0.0) or getattr(evt, "device_time_total", 0.0)
        full = evt.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
        base, _, args = full.partition("<")
        name = base.split("::")[-1] + (f"<{args}" if args and len(args) < 12 else "")
        per_call[name] = per_call.get(name, 0.0) + us / 1e3 / reps
    return dict(sorted(per_call.items(), key=lambda kv: -kv[1]))


def host_ms(fn, reps: int = 20) -> float:
    """Host milliseconds to issue one call of ``fn``, begun on an idle card:
    the card runs behind and the queue does not fill in ``reps`` calls, so
    this is the Python and launch cost alone."""
    fn()
    torch.cuda.synchronize()
    began = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - began) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def sass_digests(kernels, wanted=("flash_attention", "rotate_rows")) -> dict[str, dict]:
    """The machine code of the built library's functions whose names hold
    one of ``wanted``, from ``cuobjdump -sass``: a function's instruction count, a
    digest of its instructions and one with the kernel-argument offsets
    (``c[0x0][...]``) blanked, keyed by its mangled name without the unit's
    hashes, so that two trees' builds compare function by function."""
    cuobjdump = Path(kernels.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(kernels.library_path())],
                          capture_output=True, text=True, check=True, timeout=600).stdout
    code: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = re.sub(r"_cu_[0-9a-f]{8}", "_cu", re.sub(
                r"__N__[0-9a-f]{8}_", "__N__", line.split("Function :")[1].strip()))
            name = name if any(w in name for w in wanted) else None
            if name:
                code[name] = []
        elif name:
            found = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*([^;]*);", line)
            if found:
                code[name].append(found.group(1).strip())

    def digest(lines):
        return hashlib.sha1("\n".join(lines).encode()).hexdigest()[:12]

    return {fn: {"instructions": len(lines), "digest": digest(lines),
                 "digest_without_argument_offsets": digest(
                     [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][arg]", x) for x in lines])}
            for fn, lines in sorted(code.items())}


def layouts_main(tree: Path) -> int:
    """The head layouts of phase 11 (24 x 32, 3 x 256) with the package
    under ``tree``: the device time of a bf16 forward at B=32, S=512 (5
    forwards) and of a bf16 training step (3 steps) and the attention
    kernels' shares of each, from torch.profiler, so that two trees can be
    compared inside one call. One JSON line."""
    sys.path.insert(0, str(tree))
    from open_provence_tpu_torch import OpenProvenceModel, init_params, kernels

    DummyTokenizer, PairDummyTokenizer = load_dummy_tokenizers()
    dev = torch.device("cuda", 0)
    card = card_line()
    kernels.library()
    result = {}
    for heads in (24, 3):
        config = base_config(num_attention_heads=heads)
        label = f"{heads}x{config.backbone().head_dim}"
        sd = init_params(config, torch.Generator().manual_seed(11))
        model = OpenProvenceModel(config, sd, DummyTokenizer(), device=dev)
        ids = torch.randint(3, 50000, (32, 512), generator=torch.Generator().manual_seed(6))
        ids, mask = ids.to(dev), torch.ones(32, 512, dtype=torch.int32, device=dev)

        def forward():
            with torch.inference_mode():
                model.module(ids, mask)

        fwd_shares, step_shares = {}, {}
        fwd = profile_by_kernel(f"{label} profile of 5 forwards B=32 S=512 bf16", forward, 5,
                                fwd_shares)
        del model
        batches = [training_batch(PairDummyTokenizer(), 31, 512, seed=s) for s in (110, 111)]
        with tempfile.TemporaryDirectory() as tmp:
            trainer = make_trainer(training_config(config),
                                   {k: v.to(dev) for k, v in sd.items()}, PairDummyTokenizer(),
                                   dev, Path(tmp), 20)
            train_steps(trainer, batches, 2)
            step = profile_by_kernel(f"{label} profile of 3 bf16 steps B=32 S=512",
                                     lambda: train_steps(trainer, batches, 1), 3, step_shares)
        result[label] = {
            "forward_device_ms": fwd, "train_step_device_ms": step,
            "forward_attention_share": sum(v for k, v in fwd_shares.items()
                                           if k.startswith("attention")),
            "train_step_attention_share": sum(v for k, v in step_shares.items()
                                              if k.startswith("attention"))}
    print(json.dumps({"tree": str(tree), "card": card, "layouts": result}), flush=True)
    return 0


# The shapes --attention and --same-buffers time: every head layout at B=32,
# S=512, and three at B=8, S=2048.
ATTENTION_SHAPES = [(32, 512, h, d) for h, d in HEAD_LAYOUTS] + [
    (8, 2048, HEADS, HEAD_DIM), (8, 2048, 6, 128), (8, 2048, 3, 256)]


def attention_operands(ops, batch: int, seq: int, heads: int, gen, dev):
    """bf16 operands of one timed attention shape: the packed qkv, a ragged
    mask whose last row is padding, the cotangent g (zero on padding), and
    q, k, v and g as contiguous [B, H, S, D] tensors."""
    dtype = torch.bfloat16
    qkv = torch.randn(batch, seq, 3 * HIDDEN, generator=gen).to(device=dev, dtype=dtype)
    mask = ragged_mask(batch, seq, gen, dev)
    mask[-1] = 0
    g = (torch.randn(batch, seq, HIDDEN, generator=gen).to(device=dev, dtype=dtype)
         * mask[..., None].to(dtype))
    q, k, v = (t.contiguous() for t in ops.packed_views(qkv, heads))
    g_heads = g.view(batch, seq, heads, HIDDEN // heads).transpose(1, 2).contiguous()
    return qkv, mask, g, q, k, v, g_heads


def same_buffers_main(other: Path) -> int:
    """This checkout's attention kernels and those of the package under
    ``other``, imported side by side into one process (the other as
    ``other_tree``; the package's own imports are relative): at the shapes of
    ``--attention``, each tree's bf16 forward and backward, through the
    packed wrapper and on contiguous q, k, v, launched on the same tensors
    and timed in turns (other, this, this, other; three rounds), so that a
    difference between the two builds comes neither from the process nor
    from where the tensors lie. Then the same for the LN adjoint: kernel 10
    in bf16 at K = 768 without and with gh at M = 16384, 16347 and 32,
    kernels 12, 11 and 13 whole, and the adjoint's launches inside 12 and 11
    (torch.profiler); and the whole-MLP kernels, 8 and 13, each launch
    inside them from the profiler, beside this tree's split paths (kernel 4
    or 11 and the library's products with Wo). One JSON line."""
    import importlib
    import importlib.util

    sys.path.insert(0, str(REPO))
    from open_provence_tpu_torch import kernels, ops

    root = other / "open_provence_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_tree", root / "__init__.py", submodule_search_locations=[str(root)])
    sys.modules["other_tree"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["other_tree"])
    trees = {"other": importlib.import_module("other_tree.ops"), "this": ops}
    dev = torch.device("cuda", 0)
    card = card_line()
    phase(card)
    kernels.library()
    importlib.import_module("other_tree.kernels").library()
    print_ptxas(kernels.library_path().with_suffix(".log").read_text(), ("tail_",))
    gen = torch.Generator().manual_seed(41)
    times = {}
    for batch, seq, heads, head_dim in ATTENTION_SHAPES:
        qkv, mask, g, q, k, v, g_heads = attention_operands(ops, batch, seq, heads, gen, dev)
        for window, theta in ((None, 160000.0), (64, 10000.0)):
            kw = dict(padding_mask=mask, window=window,
                      rope=ops.rope_tables(seq, head_dim, theta, torch.bfloat16, dev))
            calls = {}
            for name, o in trees.items():
                out, lse = o.flash_attention_packed_lse(qkv, num_heads=heads, **kw)
                out_u, lse_u = o.flash_attention_lse(q, k, v, **kw)
                calls[name] = {
                    "forward_ms": lambda o=o: o.flash_attention_packed(qkv, num_heads=heads, **kw),
                    "backward_ms": lambda o=o, out=out, lse=lse: o.flash_attention_packed_bwd(
                        qkv, g, out, lse, num_heads=heads, **kw),
                    "contiguous_forward_ms": lambda o=o: o.flash_attention(q, k, v, **kw),
                    "contiguous_backward_ms": lambda o=o, out=out_u, lse=lse_u: (
                        o.flash_attention_bwd(q, k, v, g_heads, out, lse, **kw))}
            runs = {name: {what: [] for what in fns} for name, fns in calls.items()}
            for _ in range(3):
                for name in ("other", "this", "this", "other"):
                    for what, fn in calls[name].items():
                        runs[name][what].append(cuda_ms(fn))
            key = f"{heads}x{head_dim}_b{batch}_s{seq}_window{window}"
            times[key] = runs
            phase(f"same buffers {key} bf16, lowest of 6 means of 20, other / this: " + "; ".join(
                f"{what} {min(runs['other'][what]):.4f} / {min(runs['this'][what]):.4f}"
                for what in calls["this"]))
    # The LN adjoint: kernel 10 and the whole calls of kernels 12, 11 and 13;
    # beside them, the forward row kernels 1 and 7, which keep their source.
    # The whole-MLP kernels (rows 8 and 13; row 13 is one of adjoint_calls)
    # beside this tree's split paths: kernel 4 and the library's Wo product,
    # kernel 11 and the library's products for dh and dWo.
    t = adjoint_operands(dev, gen)
    x, scale, w_i, w_o = t["x"], t["scale"], t["w_i"], t["w_o"]
    hidden = ops.ln_geglu(x, scale, w_i, "gelu")
    split_paths = {
        "ln_geglu_wo split path": lambda: F.linear(ops.ln_geglu(x, scale, w_i, "gelu"), w_o),
        "ln_geglu_wo_bwd split path": lambda: (
            t["g"].t() @ hidden, ops.ln_geglu_bwd(x, scale, w_i, t["g"] @ w_o, "gelu")),
    }
    calls = {}
    for name, o in trees.items():
        calls[name] = adjoint_calls(o, t, LN_ADJOINT_ROW_COUNTS[:3])
        calls[name]["layer_norm"] = lambda o=o: o.layer_norm(t["x"], t["scale"])
        calls[name]["add_layer_norm"] = lambda o=o: o.add_layer_norm(t["x"], t["g"], t["scale"])
        calls[name]["ln_geglu_wo"] = lambda o=o: o.ln_geglu_wo(x, scale, w_i, w_o, "gelu")
    ln_times = {what: {name: [] for name in trees} for what in calls["this"]}
    ln_times.update({what: {"this": []} for what in split_paths})
    for _ in range(3):
        for name in ("other", "this", "this", "other"):
            for what, fn in calls[name].items():
                ln_times[what][name].append(graph_ms(fn))
        for what, fn in split_paths.items():
            ln_times[what]["this"].append(graph_ms(fn))
    # Each launch inside kernels 12 and 11 (the LN adjoint's, normalize, the
    # products, ...), from the profiler, with L2 flushed between calls: back
    # to back, a call's first launch (normalize, reading x) would find in L2
    # what the call before it left there, which differs between the trees.
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    for _ in range(3):
        for name in ("other", "this", "this", "other"):
            for what in ("ln_matmul_bwd", "ln_geglu_bwd", "ln_geglu_wo_bwd", "ln_geglu_wo"):
                split = launch_split(calls[name][what], flush=flush)
                if what.endswith("_bwd"):
                    split["LN adjoint"] = {"ms": sum(v["ms"] for k, v in split.items()
                                                     if k.startswith("LN adjoint"))}
                for label, entry in split.items():
                    ln_times.setdefault(f"{what}: {label}", {n: [] for n in trees})[name].append(
                        entry["ms"])
    for what, runs in ln_times.items():
        if "other" not in runs:  # a split path, this tree's kernels only
            phase(f"same buffers {what} bf16 K={HIDDEN}, this tree: lowest {min(runs['this']):.4f}"
                  f" ms, highest {max(runs['this']):.4f} ms (3 graph replays of 20)")
            continue
        low, high = ({n: f"{fn(v):.4f}" if v else "none" for n, v in runs.items()}
                     for fn in (min, max))  # a launch one tree does not make: none
        phase(f"same buffers {what} bf16 K={HIDDEN}, other / this: lowest "
              f"{low['other']} / {low['this']} ms, highest {high['other']} / {high['this']} ms "
              "(6 graph replays of 20; a launch inside a call: profiler device time)")
    print(json.dumps({"other": str(other), "card": card, "attention": times,
                      "ln_adjoint": ln_times}), flush=True)
    return 0


def attention_main(tree: Path) -> int:
    """The attention kernels of the package under ``tree`` alone: the ptxas
    report of their units, the edge cases against the plain versions, then
    the forward and backward times in bf16 at the shapes of the table of TPU
    kernels (every head layout at B=32, S=512; 12 x 64, 6 x 128 and 3 x 256
    at B=8, S=2048; global and +-64), through the packed wrapper and through
    the unpacked one on contiguous q, k, v, beside the library call on the
    same data (for +-64 with a band-and-padding mask), so that two trees and
    the library can be compared inside one call. One JSON line."""
    sys.path.insert(0, str(tree))
    from open_provence_tpu_torch import kernels, ops

    dev = torch.device("cuda", 0)
    card = card_line()
    phase(card)
    kernels.library()
    print_ptxas(kernels.library_path().with_suffix(".log").read_text(), ("flash", "dkv", "dq_"))
    sass = sass_digests(kernels)
    for fn, d in sass.items():
        phase(f"sass {fn}: {d['instructions']} instructions, digest {d['digest']}, without "
              f"kernel-argument offsets {d['digest_without_argument_offsets']}")
    if hasattr(kernels, "attention_design"):  # an older tree has one design and no report
        for _, head_dim in HEAD_LAYOUTS:
            phase(f"design D={head_dim}: forward {design_note(head_dim, False)}; backward "
                  f"{design_note(head_dim, True)}")
    attention_edge_cases(dev, {})
    gen = torch.Generator().manual_seed(41)
    dtype, times = torch.bfloat16, {}
    for batch, seq, heads, head_dim in ATTENTION_SHAPES:
        qkv, mask, g, q, k, v, g_heads = attention_operands(ops, batch, seq, heads, gen, dev)
        shape = f"{heads}x{head_dim}_b{batch}_s{seq}"
        for window, theta in ((None, 160000.0), (64, 10000.0)):
            rope = ops.rope_tables(seq, head_dim, theta, dtype, dev)
            kw = dict(padding_mask=mask, window=window, rope=rope)
            out, lse = ops.flash_attention_packed_lse(qkv, num_heads=heads, **kw)
            out_u, lse_u = ops.flash_attention_lse(q, k, v, **kw)
            fwd = [cuda_ms(lambda: ops.flash_attention_packed(qkv, num_heads=heads, **kw))
                   for _ in range(3)]
            bwd = [cuda_ms(lambda: ops.flash_attention_packed_bwd(qkv, g, out, lse,
                                                                   num_heads=heads, **kw))
                   for _ in range(3)]
            fwd_u, bwd_u = [], []
            for qc, kc, vc in [[t.clone() for t in (q, k, v)] for _ in range(3)]:
                # three placements of q, k, v in memory
                fwd_u.append(cuda_ms(lambda: ops.flash_attention(qc, kc, vc, **kw)))
                bwd_u.append(cuda_ms(lambda: ops.flash_attention_bwd(qc, kc, vc, g_heads, out_u,
                                                                     lse_u, **kw)))
            issue = {"forward_ms": host_ms(lambda: ops.flash_attention_packed(
                         qkv, num_heads=heads, **kw)),
                     "backward_ms": host_ms(lambda: ops.flash_attention_packed_bwd(
                         qkv, g, out, lse, num_heads=heads, **kw))}
            key = f"{shape}_window{window}"
            launches = launch_ms(lambda: (ops.flash_attention_packed_bwd(
                qkv, g, out, lse, num_heads=heads, **kw), ops.flash_attention_packed(
                qkv, num_heads=heads, **kw)), 10)
            times[key] = {"forward_ms": min(fwd), "backward_ms": min(bwd),
                          "contiguous_forward_ms": min(fwd_u),
                          "contiguous_backward_ms": min(bwd_u),
                          "contiguous_forward_ms_each": fwd_u,
                          "contiguous_backward_ms_each": bwd_u, "host_issue_ms": issue,
                          "launch_ms": launches}
            phase(f"time attention {key} bf16: forward {min(fwd):.4f} ms, backward "
                  f"{min(bwd):.4f} ms; contiguous q, k, v: forward {min(fwd_u):.4f} ms, "
                  f"backward {min(bwd_u):.4f} ms (lowest of 3 means of 20; contiguous: of 3 "
                  f"placements in memory); the host issues a call in {issue['forward_ms']:.4f} / "
                  f"{issue['backward_ms']:.4f} ms; a backward and a forward launch by launch: "
                  + ", ".join(f"{name} {ms:.4f} ms" for name, ms in launches.items()))
            lib = [library_attention_ms(qkv, rope, mask, g, heads, head_dim, window)
                   for _ in range(3)]
            times[key]["library_attention_ms"] = {"forward_ms": min(f for f, _ in lib),
                                                  "backward_ms": min(b for _, b in lib)}
            phase(f"time scaled_dot_product_attention (no rope) {key} bf16: forward "
                  f"{min(f for f, _ in lib):.4f} ms, autograd backward "
                  f"{min(b for _, b in lib):.4f} ms (lowest of 3 means of 20"
                  f"{'' if window is None else '; a band-and-padding mask'})")
    print(json.dumps({"tree": str(tree), "card": card, "sass": sass, "attention": times}),
          flush=True)
    return 0


def gemm_main(tree: Path) -> int:
    """The GEMM engine of the package under ``tree`` alone: the ptxas report
    of its kernels, the design of every layout, phase 3's GEMM edge cases,
    then kernels 2, 4 and 6 in bf16 at M = 16384 (B=32, S=512 and B=8,
    S=2048 alike) and torch.matmul on the same product (the normalized rows
    times the weight), lowest of 3 means of 20 launches; kernels 12, 11 and
    13 the same way, with each of their launches under the profiler and
    torch.matmul on each of their products; the dW split swept; phase 3b's
    backward edge cases. Two trees can be compared inside one call. One JSON
    line."""
    sys.path.insert(0, str(tree))
    from open_provence_tpu_torch import kernels, ops

    dev = torch.device("cuda", 0)
    card = card_line()
    phase(card)
    kernels.library()
    print_ptxas(kernels.library_path().with_suffix(".log").read_text(),
                ("gemm_wgmma", "gemm_mma", "gemm_fma", "normalize_kernel", "dw_sum"))
    if hasattr(kernels, "gemm_design"):  # an older tree reports no design
        for name, design in gemm_designs().items():
            phase(f"design {name} bf16: {gemm_design_note(design)}")
    gemm_edge_cases(dev, {})
    gen = torch.Generator().manual_seed(60)
    dtype, rows = torch.bfloat16, 32 * 512

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device=dev, dtype=dtype)

    x, scale = randn(rows, HIDDEN, scale=2.0), randn(HIDDEN, scale=0.1) + 1
    w_qkv = randn(3 * HIDDEN, HIDDEN, scale=HIDDEN**-0.5)
    w_i = randn(2 * INTER, HIDDEN, scale=HIDDEN**-0.5)
    xn = ops.layer_norm(x, scale)
    calls = {
        "ln_matmul": (lambda: ops.ln_matmul(x, scale, w_qkv), w_qkv),
        "ln_geglu": (lambda: ops.ln_geglu(x, scale, w_i, "gelu"), w_i),
        "geglu": (lambda: ops.geglu(xn, w_i, "gelu"), w_i),
    }
    bounds, times = gemm_bounds(rows), {}
    for name, (kernel, w) in calls.items():
        ms, matmul_ms = lowest_ms(kernel), lowest_ms(lambda: torch.matmul(xn, w.t()))
        times[name] = {"ms": ms, "matmul_ms": matmul_ms, "bound_ms": bounds[name]["bound_ms"]}
        phase(f"time {name} M={rows} bf16: kernel {ms:.4f} ms, torch.matmul on the product "
              f"{matmul_ms:.4f} ms, bound {bounds[name]['bound_ms']:.4f} ms "
              "(lowest of 3 means of 20)")
    # Kernels 12, 11 and 13: the whole call, each of its launches under the
    # profiler, and torch.matmul on each bare product (G = [gi | gg] for 11;
    # for 13 its two weight gradients, dWi = G^T.xn and dWo = g^T.h with h
    # shaped as g_mlp, timed together).
    g_qkv, g_mlp = randn(rows, 3 * HIDDEN, scale=0.1), randn(rows, INTER, scale=0.1)
    g_cat = torch.cat([g_mlp, g_mlp], dim=1)
    w_o, g_out = randn(HIDDEN, INTER, scale=INTER**-0.5), randn(rows, HIDDEN, scale=0.1)
    calls = {
        "ln_matmul_bwd": (lambda: ops.ln_matmul_bwd(x, scale, w_qkv, g_qkv),
                          {"dW = G^T.xn": lambda: torch.matmul(g_qkv.t(), xn),
                           "dy = G.W": lambda: torch.matmul(g_qkv, w_qkv)}),
        "ln_geglu_bwd": (lambda: ops.ln_geglu_bwd(x, scale, w_i, g_mlp, "gelu"),
                         {"projection xn.Wi^T": lambda: torch.matmul(xn, w_i.t()),
                          "dW = G^T.xn": lambda: torch.matmul(g_cat.t(), xn),
                          "dy = G.W": lambda: torch.matmul(g_cat, w_i)}),
        "ln_geglu_wo_bwd": (lambda: ops.ln_geglu_wo_bwd(x, scale, w_i, w_o, g_out, "gelu"),
                            {"dW = G^T.xn": lambda: (torch.matmul(g_cat.t(), xn),
                                                     torch.matmul(g_out.t(), g_mlp))}),
    }
    for name, (kernel, products) in calls.items():
        ms, split = lowest_ms(kernel), launch_split(kernel)
        matmul = {label: lowest_ms(fn) for label, fn in products.items()}
        bound_ms = bounds[name]["bound_ms"]
        times[name] = {"ms": ms, "bound_ms": bound_ms, "launches": split, "matmul_ms": matmul}
        phase(f"time {name} M={rows} bf16: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"(lowest of 3 means of 20); its products on torch.matmul "
              f"{sum(matmul.values()):.4f} ms")
        for label, entry in sorted(split.items(), key=lambda kv: -kv[1]["ms"]):
            beside = f", torch.matmul {matmul[label]:.4f} ms" if label in matmul else ""
            phase(f"  {name} launch {label}: {entry['ms']:.4f} ms a call over "
                  f"{entry['launches']:.0f} launch(es){beside}")
    if hasattr(kernels, "DW_CTAS"):  # an older tree does not split dW
        times["dw_split"] = dw_split_sweep(lambda: ops.ln_matmul_bwd(x, scale, w_qkv, g_qkv),
                                           rows, 3 * HIDDEN, HIDDEN)
    gemm_bwd_edge_cases(dev, {})
    print(json.dumps({"tree": str(tree), "card": card, "gemm": times}), flush=True)
    return 0


def adjoint_operands(dev, gen) -> dict:
    """bf16 operands at M = 16384, base width, of the calls that end on the
    LN adjoint (adjoint_calls)."""
    rows = 32 * 512

    def randn(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(device=dev, dtype=torch.bfloat16)

    return {
        "x": randn(rows, HIDDEN, s=2.0), "scale": randn(HIDDEN, s=0.1) + 1,
        "g": randn(rows, HIDDEN), "gh": randn(rows, HIDDEN),
        "w_qkv": randn(3 * HIDDEN, HIDDEN, s=HIDDEN**-0.5),
        "w_i": randn(2 * INTER, HIDDEN, s=HIDDEN**-0.5), "w_o": randn(HIDDEN, INTER, s=INTER**-0.5),
        "g_qkv": randn(rows, 3 * HIDDEN, s=0.1), "g_mlp": randn(rows, INTER, s=0.1),
    }


def adjoint_calls(ops, t: dict, row_counts) -> dict:
    """Calls that end on the LN adjoint, on adjoint_operands ``t``: kernel 10
    without and with gh over the first m rows for each of ``row_counts``,
    then kernels 12, 11 and 13 whole at M = 16384."""
    calls = {}
    for m in row_counts:
        x, g, gh = t["x"][:m], t["g"][:m], t["gh"][:m]
        calls[f"layer_norm_bwd M={m}"] = lambda x=x, g=g: ops.layer_norm_bwd(x, t["scale"], g)
        calls[f"layer_norm_bwd M={m} with gh"] = lambda x=x, g=g, gh=gh: ops.layer_norm_bwd(
            x, t["scale"], g, 1e-5, gh)
    x, scale = t["x"], t["scale"]
    calls["ln_matmul_bwd"] = lambda: ops.ln_matmul_bwd(x, scale, t["w_qkv"], t["g_qkv"])
    calls["ln_geglu_bwd"] = lambda: ops.ln_geglu_bwd(x, scale, t["w_i"], t["g_mlp"], "gelu")
    calls["ln_geglu_wo_bwd"] = lambda: ops.ln_geglu_wo_bwd(x, scale, t["w_i"], t["w_o"], t["g"],
                                                           "gelu")
    return calls


def adjoint_instance(entry: str) -> str:
    """An LN-adjoint register instance's types, gh form and width, from its
    mangled name (register_row_kernel<T, DY, ADD_GH, NCH>)."""
    m = re.search(r"register_row_kernelI(13__nv_bfloat16|f)(S2_|13__nv_bfloat16|f)Lb([01])ELi(\d)E",
                  entry)
    if not m:
        return entry
    x = "bf16" if m[1] != "f" else "fp32"
    dy = x if m[2] == "S2_" else ("bf16" if m[2] != "f" else "fp32")
    return f"{x} x, {dy} dy{', gh' if m[3] == '1' else ''}, K={256 * int(m[4])}"


def ln_adjoint_main(tree: Path) -> int:
    """The LN adjoint of the package under ``tree`` alone (kernel 10, and the
    tail of kernels 11, 12 and 13): the ptxas report of its kernels, its
    design, kernel 10 against its plain version at every width of
    LN_ADJOINT_WIDTHS and row count of LN_ADJOINT_ROW_COUNTS (fp32 and bf16,
    with and without gh, two launches bit-equal), its times at M = 16384
    for each width and dtype beside its bound (and in bf16 at 768 the
    library's LayerNorm backward), and kernels 12, 11 and 13 whole and
    launch by launch. One JSON line."""
    sys.path.insert(0, str(tree))
    from open_provence_tpu_torch import kernels, ops

    dev = torch.device("cuda", 0)
    card = card_line()
    phase(card)
    kernels.library()
    log = kernels.library_path().with_suffix(".log").read_text()
    for entry, used, spills in ptxas_entries(log, ("ln_adjoint",)):
        phase(f"ptxas {adjoint_instance(entry)}: {used}; {spills}")
    if hasattr(kernels, "built_ln_adjoint_design"):  # an older tree reports none
        for width in LN_ADJOINT_WIDTHS:
            for m in LN_ADJOINT_ROW_COUNTS:
                built = kernels.built_ln_adjoint_design(m, width)
                parts = kernels.ln_adjoint_partial(m, width, dev).shape[0]
                registers = width in kernels.LN_ADJOINT_REGISTER_WIDTHS
                if (built["parts"] != parts
                        or built["instance"] != ("registers" if registers else "strided")):
                    raise AssertionError(f"LN adjoint design at {m} x {width}: the library "
                                         f"reports {built}, the wrappers size {parts} partial "
                                         f"rows and expect registers={registers}")
            phase(f"LN adjoint design K={width}: {kernels.built_ln_adjoint_design(32 * 512, width)}")
    worst: dict = {}

    def check(dtype, case, got, want):
        errs = [check_grad(f"layer_norm_bwd {case} {dtype}", a, b, dtype)
                for a, b in zip(got, want)]
        worst[dtype] = max(worst.get(dtype, 0.0), *errs)

    pairs = ln_adjoint_cases(dev, LN_ADJOINT_WIDTHS, LN_ADJOINT_ROW_COUNTS, check)
    phase(f"LN adjoint cases: {pairs} pairs, max_abs_err fp32 {worst[torch.float32]:.3e}, bf16 "
          f"{worst[torch.bfloat16]:.3e}; null gh and repeated launches bit-equal")
    gen = torch.Generator().manual_seed(93)
    rows, times = 32 * 512, {}
    for dtype in (torch.bfloat16, torch.float32):
        for width in LN_ADJOINT_WIDTHS[:3]:
            x, g, gh = ((torch.randn(rows, width, generator=gen) * s).to(device=dev, dtype=dtype)
                        for s in (2.0, 1.0, 1.0))
            scale = (torch.randn(width, generator=gen) * 0.1 + 1).to(device=dev, dtype=dtype)
            for with_gh in (False, True):
                ms = min(graph_ms(lambda: ops.layer_norm_bwd(
                    x, scale, g, 1e-5, gh if with_gh else None)) for _ in range(3))
                b = ln_adjoint_bound(rows, width, dtype, dtype, with_gh)["bound_ms"]
                key = f"{str(dtype)[6:]}_k{width}{'_gh' if with_gh else ''}"
                times[key] = {"ms": ms, "bound_ms": b}
                phase(f"time layer_norm_bwd {str(dtype)[6:]} M={rows} K={width}"
                      f"{' with gh' if with_gh else ''}: kernel {ms:.4f} ms, bound {b:.4f} ms "
                      f"({b / ms:.2f} of it; lowest of 3 graph replays of 20)")
            if dtype == torch.bfloat16 and width == HIDDEN:
                lib_ms = min(library_ln_bwd_ms(x, scale, g) for _ in range(3))
                times[key.removesuffix("_gh")]["library_ms"] = lib_ms
                phase(f"time the library's LayerNorm backward bf16 M={rows} K={width}: "
                      f"{lib_ms:.4f} ms (lowest of 3 graph replays of 20)")
    # The adjoint inside kernels 12, 11 and 13 (its fp32 dy: x, dy and dx move
    # 100.7 MB at base width), launch by launch.
    fp32_dy = ln_adjoint_bound(rows, HIDDEN, torch.bfloat16, torch.float32)["bound_ms"]
    for name, fn in adjoint_calls(ops, adjoint_operands(dev, gen), ()).items():
        ms, split = min(graph_ms(fn) for _ in range(3)), launch_split(fn)
        times[name] = {"ms": ms, "launches": split}
        inside = {k: v for k, v in split.items() if k.startswith("LN adjoint")}
        phase(f"time {name} bf16 M={rows}: {ms:.4f} ms; its LN adjoint "
              + ", ".join(f"{k} {v['ms']:.4f} ms over {v['launches']:.0f} launch(es)"
                          for k, v in inside.items())
              + f" (bound of the adjoint on an fp32 dy {fp32_dy:.4f} ms)")
    print(json.dumps({"tree": str(tree), "card": card, "ln_adjoint": times}), flush=True)
    return 0


def dw_split_sweep(kernel, m: int, n: int, k: int) -> dict:
    """Kernel 12 with dW [n, k] over m rows cut into 1 to 14 chunks (the
    rule's target CTA count set in turn; kernels.DW_CTAS is restored after):
    the whole call, and dW's product and chunk sum under the profiler."""
    from open_provence_tpu_torch import kernels

    aimed, sweep = kernels.DW_CTAS, {}
    tiles = -(-n // kernels.DW_TILE[0]) * -(-k // kernels.DW_TILE[1])
    try:
        for chunks in (1, 2, 3, 5, 7, 10, 14):
            kernels.DW_CTAS = chunks * tiles
            split = launch_split(kernel)
            dw_ms = sum(split.get(label, {"ms": 0.0})["ms"]
                        for label in ("dW = G^T.xn", "dW chunk sum"))
            sweep[chunks] = {"ms": lowest_ms(kernel), "dw_ms": dw_ms,
                             "chunk_rows": kernels.dw_chunk_rows(m, n, k)}
            phase(f"dW split, {kernels.dw_chunks(m, n, k)} chunk(s) of "
                  f"{sweep[chunks]['chunk_rows']} rows ({chunks * tiles} CTAs): ln_matmul_bwd "
                  f"{sweep[chunks]['ms']:.4f} ms, dW product + chunk sum {dw_ms:.4f} ms")
    finally:
        kernels.DW_CTAS = aimed
    return sweep


def load_by_path(path: Path):
    """The module in the file at ``path``, loaded by path (an installed
    package may own the top-level name ``tests``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_dummy_tokenizers():
    """tests/dummy_tokenizers.py's DummyTokenizer and PairDummyTokenizer."""
    module = load_by_path(REPO / "tests" / "dummy_tokenizers.py")
    return module.DummyTokenizer, module.PairDummyTokenizer


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if len(sys.argv) > 1:
        modes = {"--rates": rates_main, "--attention": attention_main, "--gemm": gemm_main,
                 "--layouts": layouts_main, "--same-buffers": same_buffers_main,
                 "--ln-adjoint": ln_adjoint_main, "--mesh-cards": mesh_cards_main}
        if sys.argv[1] not in modes or len(sys.argv) > 3:
            print(f"usage: chip_smoke.py [{' | '.join(modes)} [TREE]]", file=sys.stderr)
            return 2
        tree = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else REPO
        return modes[sys.argv[1]](tree)
    sys.path.insert(0, str(REPO))
    from open_provence_tpu_torch import init_params, kernels, native

    DummyTokenizer, PairDummyTokenizer = load_dummy_tokenizers()
    dev = torch.device("cuda", 0)
    started = time.perf_counter()

    def elapsed(what: str) -> None:
        phase(f"elapsed after {what}: {time.perf_counter() - started:.0f} s")

    card = card_line()
    phase(card)  # name, power limit: nvidia-smi's own line
    phase(f"phase 1 torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    lib_path = kernels.library_path()
    lib_path.unlink(missing_ok=True)  # always build from the checkout's sources
    began = time.perf_counter()
    kernels.build()
    kernels.library()
    phase(f"phase 2 built {lib_path.name} from {', '.join(kernels.SOURCES)} "
          f"({len(kernels.UNITS)} nvcc processes side by side) in {time.perf_counter() - began:.1f} s")
    print_ptxas(lib_path.with_suffix(".log").read_text(), ("",))
    host_built = native.is_available()
    phase(f"phase 2 native host library built from {native._SOURCE.relative_to(REPO)}: {host_built}")
    if not host_built:
        raise AssertionError("native/ did not build its host library")

    stats = phase3_kernels(dev)
    stats.update(phase3b_backward(dev))
    phase3c_long_context(dev, stats)
    phase3d_head_layouts(dev, stats)
    phase3e_whole_mlp(dev, stats)
    elapsed("the kernel checks")

    config = base_config()
    sd = init_params(config, torch.Generator().manual_seed(0))
    phase4_model(config, sd, dev)
    model, serve_launches, pairs = phase5_process(config, sd, DummyTokenizer, dev)
    rates = phase6_timings(model, pairs, card)
    del model
    elapsed("serving at 512")
    by_path = {"serve_512": serve_launches}
    with tempfile.TemporaryDirectory() as tmp:
        phase7_train_step(config, sd, PairDummyTokenizer(), dev, Path(tmp))
        by_path["train_512"] = phase8_train_then_serve(
            config, sd, DummyTokenizer, PairDummyTokenizer(), dev, card, Path(tmp)
        )
        elapsed("training at 512")
        by_path.update(phase9_long_context(sd, DummyTokenizer, PairDummyTokenizer(), dev, card,
                                           Path(tmp)))
        elapsed("long context")
        by_path.update(phase10_bias_layouts(DummyTokenizer, PairDummyTokenizer(), dev, Path(tmp)))
        elapsed("the bias layouts")
        by_path.update(phase11_head_layouts(DummyTokenizer, PairDummyTokenizer(), dev, card,
                                            Path(tmp)))
        elapsed("the head layouts")
        by_path.update(phase12_whole_mlp(sd, DummyTokenizer, PairDummyTokenizer(), dev, card,
                                         Path(tmp)))
        elapsed("the whole-MLP fusion")
        by_path.update(phase13_entry_points(config, sd, DummyTokenizer, PairDummyTokenizer, dev,
                                            card, Path(tmp), rates["forward_pairs_per_s"]))
        elapsed("the checkpoint and encoder entry points")
        pair_tokenizer = PairDummyTokenizer()
        by_path.update(phase14_train_cli(sd, DummyTokenizer, pair_tokenizer, dev, card,
                                         Path(tmp)))
        elapsed("the training entry point")
        by_path.update(phase15_release(DummyTokenizer, pair_tokenizer, dev, card, Path(tmp)))
        elapsed("the release surface")
        by_path.update(phase16_mesh(config, sd, DummyTokenizer, pair_tokenizer, dev, card,
                                    Path(tmp), stats))
        elapsed("the mesh")
        by_path.update(phase17_factory_and_mldr(DummyTokenizer, PairDummyTokenizer, dev, card,
                                                Path(tmp)))
        elapsed("the data factory and the MLDR evaluation")

    # Every kernel must have launched on a main path (the comparisons of
    # phase 3 are outside every count), rows 5 and 15 on the long ones.
    table = []
    for name, (source, replaces, rows) in KERNEL_INFO.items():
        launches = {path: counts[name] for path, counts in by_path.items()}
        if sum(launches.values()) == 0:
            raise AssertionError(f"no main path launched {name}")
        long_paths = {"flash_attention_packed": ("serve_2048", "train_2048"),
                      "flash_attention_packed_bwd": ("train_2048",)}.get(name, ())
        if any(launches[path] == 0 for path in long_paths):
            raise AssertionError(f"a long-context path never launched {name}")
        extras = {k: v for k, v in stats[name].items()
                  if k not in ("max_abs_err", "cases", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}
        table.append({
            "name": name,
            "route": "cuda",
            "source": f"open_provence_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces[0],
            "launches": sum(launches.values()),
            "max_abs_err": stats[name]["max_abs_err"][torch.bfloat16],
            "ms": stats[name]["ms"],
            "plain_ms": stats[name]["plain_ms"],
            "bound_ms": stats[name]["bound_ms"],
            "bound_by": stats[name]["bound_by"],
            "library_ms": stats[name]["library_ms"],
            "also_replaces": replaces[1:],
            "counted_with": kernels.SAME_LAUNCH.get(name),
            "tpu_rows": rows,
            "launches_by_path": launches,
            **extras,
        })
    elapsed("everything")
    print(json.dumps({"kernels": table}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
