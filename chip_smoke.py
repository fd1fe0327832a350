#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (open_provence_tpu_torch) once on one NVIDIA
card and check it, in phases:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the eight hand-written kernels from kernels/csrc with nvcc;
3. each forward kernel against its plain PyTorch version on the card, at
   the ModernBERT-base shapes the engine dispatches (M = B·S for B in 1/8/32
   and S in 64/192/512, ragged padding, global and ±64 windows), fp32 and
   bf16;
3b. each backward kernel against its plain version at the training shapes
   (B=32, S=512), fp32 and bf16, with kernel and plain times;
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
   and ``process()`` served from the trained weights.

Every phase prints a line; any failure raises and the script exits
non-zero without printing a result. The line before the last is the JSON
kernel table; the last is {"ok": true, "device": {...}}.

Usage (from the repository root, on a machine with one CUDA card):
    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HIDDEN, HEADS, HEAD_DIM, INTER = 768, 12, 64, 1152
# Kernel -> (source, the TPU kernel it replaces), in the order a training
# step first reaches them: the forward, then the backward.
KERNEL_INFO = {
    "layer_norm": ("layer_norm.cu", "open_provence_tpu/ops/layer_norm.py:36"),
    "ln_matmul": ("ln_gemm.cu", "open_provence_tpu/ops/geglu.py:790"),
    "flash_attention_packed": ("flash_attention.cu", "open_provence_tpu/ops/flash_attention.py:856"),
    "ln_geglu": ("ln_gemm.cu", "open_provence_tpu/ops/geglu.py:152"),
    "layer_norm_bwd": ("layer_norm.cu", "open_provence_tpu/ops/layer_norm.py:91"),
    "ln_geglu_bwd": ("ln_gemm_bwd.cu", "open_provence_tpu/ops/geglu.py:353"),
    "flash_attention_packed_bwd": ("flash_attention_bwd.cu",
                                   "open_provence_tpu/ops/flash_attention.py:1579"),
    "ln_matmul_bwd": ("ln_gemm_bwd.cu", "open_provence_tpu/ops/geglu.py:886"),
}
FORWARD = ("layer_norm", "ln_matmul", "flash_attention_packed", "ln_geglu")
BACKWARD = ("layer_norm_bwd", "ln_geglu_bwd", "flash_attention_packed_bwd", "ln_matmul_bwd")
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


def paired_ms(kernel_fn, plain_fn) -> tuple[float, float]:
    """Time kernel and plain in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = cuda_ms(plain_fn), cuda_ms(kernel_fn), cuda_ms(kernel_fn), cuda_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


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


def check_grad(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    a, r = BWD_TOL[dtype]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    bad = err > a * want.abs().max() + r * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values off, max abs err "
            f"{err.max().item():.3e} (max |plain| {want.abs().max().item():.3e}; "
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

    stats = {name: {"max_abs_err": {}, "cases": 0} for name in FORWARD}

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
        for name, st in stats.items():
            atol, rtol = TOL[dtype]
            phase(f"phase 3 {name} {str(dtype)[6:]}: max_abs_err {st['max_abs_err'][dtype]:.3e} "
                  f"(tol atol {atol} + rtol {rtol}) over {st['cases']} cases so far")

    # Times at the main path's largest bucket: B=32, S=512, bf16.
    dtype, batch, seq = torch.bfloat16, 32, 512
    x = randn(batch * seq, HIDDEN, scale=2.0, dtype=dtype)
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
    }
    local = paired_ms(lambda: ops.flash_attention_packed(qkv, **attn_l),
                      lambda: ops.attention_packed_plain(qkv, **attn_l))
    for name, (ms, plain_ms) in timings.items():
        stats[name]["ms"], stats[name]["plain_ms"] = ms, plain_ms
        phase(f"phase 3 time {name} B=32 S=512 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    phase(f"phase 3 time flash_attention_packed window=64: kernel {local[0]:.4f} ms, "
          f"plain {local[1]:.4f} ms")
    return stats


def phase3b_backward(dev) -> dict[str, dict]:
    """Each backward kernel against its plain version on the same inputs,
    at the training shapes B=32, S=512 (M = 16384 rows), fp32 and bf16."""
    from open_provence_tpu_torch import ops

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
        for m in (rows, batch):  # the embedding / final norms, the head norm
            g = randn(m, HIDDEN, dtype=dtype)
            errs = record("layer_norm_bwd", dtype, ("dx", "dscale"),
                          ops.layer_norm_bwd(x[:m], scale, g),
                          ops.layer_norm_bwd_plain(x[:m], scale, g))
            report("layer_norm_bwd", dtype, f"M={m}", errs)
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

    # Times at B=32, S=512, bf16 (the last dtype of the loop above).
    timings = {
        "layer_norm_bwd": paired_ms(lambda: ops.layer_norm_bwd(x, scale, x),
                                    lambda: ops.layer_norm_bwd_plain(x, scale, x)),
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
        phase(f"phase 3b time flash_attention_packed_bwd window={window}: kernel "
              f"{timings['flash_attention_packed_bwd'][0]:.4f} ms, plain "
              f"{timings['flash_attention_packed_bwd'][1]:.4f} ms")
    for name, (ms, plain_ms) in timings.items():
        stats[name]["ms"], stats[name]["plain_ms"] = ms, plain_ms
        if name != "flash_attention_packed_bwd":
            phase(f"phase 3b time {name} B=32 S=512 bf16: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
    return stats


def base_config():
    from open_provence_tpu_torch import ModernBertBackboneConfig, OpenProvenceConfig

    backbone = ModernBertBackboneConfig(pad_token_id=0, num_labels=1)  # base widths
    return OpenProvenceConfig(
        base_model_config=backbone.to_dict(), num_labels=1,
        pruning_config={"hidden_size": HIDDEN, "classifier_dropout": 0.0}, max_length=512,
    )


def scores(module, ids, mask):
    from open_provence_tpu_torch import keep_probs_from_logits, ranking_score_from_logits

    with torch.inference_mode():
        out = module(ids, mask)
    return ranking_score_from_logits(out["ranking_logits"]), keep_probs_from_logits(out["pruning_logits"])


def phase4_model(config, sd, dev) -> None:
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
        phase(f"phase 4 model {str(dtype)[6:]} card vs fp32 cpu, B=2 S=512, "
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
    ranks = np.asarray(result["reranking_score"], dtype=np.float64)
    if len(result["pruned_context"]) != 256 or not np.all(np.isfinite(ranks)):
        raise AssertionError("process() payload has the wrong length or non-finite scores")
    if not np.all((ranks >= 0) & (ranks <= 1)):
        raise AssertionError("scores outside [0, 1]")

    keep_all = model.process(questions[:16], contexts[:16], threshold=0.0, show_progress=False)
    if keep_all["pruned_context"] != contexts[:16]:
        raise AssertionError("threshold 0.0 did not reproduce the input")
    drop_all = model.process(questions[:16], contexts[:16], threshold=1.0, show_progress=False)
    if any(drop_all["pruned_context"]) or any(s != 0.0 for s in drop_all["reranking_score"]):
        raise AssertionError("threshold 1.0 did not prune everything and zero the score")
    kept = sum(len(c) for c in result["pruned_context"]) / sum(len(c) for c in contexts)
    phase(f"phase 5 process() checks: scores finite in [{ranks.min():.4f}, {ranks.max():.4f}], "
          f"kept {kept:.3f} of the text at threshold 0.1; threshold 0 exact, threshold 1 empty")

    # fp32 on the card against fp32 on the CPU, 8 pairs.
    th, margin = 0.1, 1e-4
    kw = dict(threshold=th, show_progress=False, return_sentence_metrics=True)
    outs = [
        OpenProvenceModel(config, sd, tokenizer_cls(), device=d, dtype=torch.float32).process(
            questions[:8], contexts[:8], **kw
        )
        for d in (dev, "cpu")
    ]
    card, cpu = (np.concatenate([np.asarray(p) for p in o["sentence_probabilities"]]) for o in outs)
    decided = np.abs(cpu - th) > margin
    flips = int(np.sum((card > th)[decided] != (cpu > th)[decided]))
    score_err = float(np.max(np.abs(np.subtract(outs[0]["reranking_score"], outs[1]["reranking_score"]))))
    phase(f"phase 5 fp32 card vs cpu, 8 pairs: {flips} keep/drop flips among {int(decided.sum())} "
          f"sentences decided by > {margin}, sentence-prob max_abs_err "
          f"{np.max(np.abs(card - cpu)):.3e}, score max_abs_err {score_err:.3e}")
    if flips:
        raise AssertionError("fp32 keep/drop decisions differ between card and CPU")
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


def phase6_timings(model, pairs, card: str) -> dict:
    gen = torch.Generator().manual_seed(6)
    ids = torch.randint(3, 50000, (32, 512), generator=gen).to(model.device)
    mask = torch.ones(32, 512, dtype=torch.int32, device=model.device)

    def forward():
        with torch.inference_mode():
            model.module(ids, mask)

    def forward_plain():
        with plain_ops():
            forward()

    fwd_ms, plain_fwd_ms = paired_ms(forward, forward_plain)
    phase(f"phase 6 forward B=32 S=512 bf16: {32e3 / fwd_ms:.1f} pairs/s ({fwd_ms:.2f} ms/batch) "
          f"on kernels; {32e3 / plain_fwd_ms:.1f} pairs/s ({plain_fwd_ms:.2f} ms/batch) on plain "
          f"versions [{card}]")

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


def training_batch(tokenizer, n_real: int, seq: int, seed: int) -> dict:
    """n_real synthetic (question, document) pairs with sentence spans, a
    relevance label per sentence and a teacher score, collated to [n_real +
    1, seq]: the last pair is padding, as the collator adds it."""
    from open_provence_tpu_torch.train import OpenProvenceDataCollator

    rng = np.random.default_rng(seed)
    words = "sushi ramen kyoto market travel budget deadline plants river temple".split()
    rows = []
    for _ in range(n_real):
        topic = str(rng.choice(words))
        sentences, spans, relevance, pos = [], [], [], 0
        for i in range(int(rng.integers(6, 16))):
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


def phase7_train_step(config, sd, tokenizer, dev, out_dir: Path) -> None:
    """Two fp32 steps of the trainer on the card and on the CPU. The warmup
    gives the first step a learning rate of 0, so both devices take sd's
    parameters into the second, whose rate is 1e-2. Held per step: the loss
    and every gradient tensor, card against CPU; and the card's update
    (parameters after minus before) against the update the CPU's optimizer
    makes from the card's own gradients, optimizer state and parameters. A
    zeroed, negated or 5x update must fail that check."""
    from open_provence_tpu_torch.train import OpenProvenceTrainer
    from open_provence_tpu_torch.train.optim import global_norm

    def cpu_copy(tree):
        return {k: v.detach().cpu().clone() for k, v in tree.items()}

    batch = training_batch(tokenizer, 1, 512, seed=7)
    card, host = (
        OpenProvenceTrainer(config, sd, tokenizer, output_dir=out_dir / d.type, bf16=False,
                            learning_rate=1e-2, total_steps=10, device=d)
        for d in (dev, torch.device("cpu"))
    )
    layers = config.backbone().num_hidden_layers
    for step in (1, 2):
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
        phase(f"phase 7 fp32 train step {step}, {layers} layers, B=2 S=512, card vs cpu: loss "
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


def phase8_train_then_serve(config, sd, tokenizer_cls, pair_tokenizer, dev, card: str,
                            out_dir: Path) -> dict[str, int]:
    from open_provence_tpu_torch import OpenProvenceModel, kernels
    from open_provence_tpu_torch.train import OpenProvenceTrainer
    from open_provence_tpu_torch.utils import safetensors_io

    batch_size, seq, n_steps = 32, 512, 20
    batches = [training_batch(pair_tokenizer, batch_size - 1, seq, seed=s) for s in (80, 81)]
    train_config = copy.deepcopy(config)
    train_config.pruning_config["classifier_dropout"] = 0.1  # the head's default: masks on

    # Weights already on the card and no device= argument: the trainer
    # stays where its parameters lie.
    sd_card = {k: v.to(dev) for k, v in sd.items()}

    def make(directory):
        made = OpenProvenceTrainer(train_config, sd_card, pair_tokenizer, output_dir=directory,
                                   learning_rate=3e-4, total_steps=n_steps + 10)
        if made.device != dev or any(p.device != dev for p in made.params.values()):
            raise AssertionError(f"a trainer given parameters on {dev} runs on {made.device}")
        return made

    trainer = make(out_dir / "run")
    eval_before = trainer.evaluate(iter(batches))["eval_loss"]
    kernels.reset_launch_counts()
    losses = train_steps(trainer, batches, n_steps)
    torch.cuda.synchronize()
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    eval_after = trainer.evaluate(iter(batches))["eval_loss"]
    phase(f"phase 8 bf16 training, B={batch_size} S={seq}, {n_steps} steps: train loss "
          f"first {losses[0]:.4f}, last {losses[-1]:.4f} (all: "
          f"{', '.join(f'{v:.4f}' for v in losses)}); eval loss on the same pairs, no dropout: "
          f"{eval_before:.4f} -> {eval_after:.4f}; launches {json.dumps(launches)}; "
          f"plain versions {json.dumps(plain)}")
    if not all(np.isfinite(losses)) or not eval_after < eval_before:
        raise AssertionError(f"the training loss did not fall: {losses}")
    if min(launches.values()) == 0 or any(plain.values()):
        raise AssertionError("the training path skipped a kernel or ran a plain version")

    # Resume: the step after the checkpoint, with and without a reload.
    ckpt = trainer.save_checkpoint()
    after = trainer.train_one_step(batches[0])["loss"]
    resumed = make(out_dir / "resumed")
    resumed.load_checkpoint(ckpt)
    again = resumed.train_one_step(batches[0])["loss"]
    diff = max_rel_err(resumed._detached(), trainer._detached())
    phase(f"phase 8 resume from {ckpt.name}: next step loss {again:.6f} vs {after:.6f} "
          f"without the resume; largest parameter difference {diff:.3e}")
    if again != after or diff != 0.0:
        raise AssertionError("the resumed step differs from the uninterrupted one")
    del resumed

    # Train pairs/s, kernels against plain versions, in turns.
    real_pairs = batch_size - 1

    def rate(plain_path: bool, steps: int = 5) -> float:
        with plain_ops() if plain_path else contextlib.nullcontext():
            train_steps(trainer, batches, 1)
            torch.cuda.synchronize()
            began = time.perf_counter()
            train_steps(trainer, batches, steps)
            torch.cuda.synchronize()
        return real_pairs * steps / (time.perf_counter() - began)

    p1, k1, k2, p2 = rate(True, 2), rate(False), rate(False), rate(True, 2)
    kernel_rate, plain_rate = (k1 + k2) / 2, (p1 + p2) / 2
    phase(f"phase 8 train step B={batch_size} S={seq} bf16: {kernel_rate:.1f} pairs/s "
          f"({real_pairs / kernel_rate * 1e3:.1f} ms/step) on kernels; {plain_rate:.1f} "
          f"pairs/s ({real_pairs / plain_rate * 1e3:.1f} ms/step) on plain versions [{card}]")

    # Where a step's time goes: torch.profiler over 3 steps.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        began = time.perf_counter()
        train_steps(trainer, batches, 3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - began
    # Device time by kernel: the port's own under their names, the rest by
    # the first words of theirs (cuBLAS, torch's elementwise and reductions).
    ours = {("flash_mma_kernel",): "attention fwd", ("dkv_mma_kernel",): "attention bwd dK/dV",
            ("dq_mma_kernel",): "attention bwd dQ", ("delta_kernel",): "attention bwd delta",
            ("gemm_mma_kernel",): "LN->GEMM GEMMs (fwd and bwd)",
            ("ln_adjoint", "row_kernel"): "LN adjoint rows",
            ("ln_adjoint", "reduce_kernel"): "LN adjoint dscale",
            ("normalize_kernel",): "LN->GEMM normalize",
            ("geglu_grad_kernel",): "GeGLU bwd chain", ("layer_norm_kernel",): "LayerNorm fwd"}
    device_us: dict[str, float] = {}
    launches_per_step = 0.0
    for evt in prof.key_averages():  # kernel rows only, so nothing counts twice
        if getattr(evt.device_type, "name", "") != "CUDA":
            continue
        us = getattr(evt, "self_device_time_total", 0.0) or getattr(evt, "device_time_total", 0.0)
        name = next((v for keys, v in ours.items() if all(k in evt.key for k in keys)),
                    evt.key.split("<")[0][:48])
        device_us[name] = device_us.get(name, 0.0) + us
        launches_per_step += evt.count / 3
    total_us = sum(device_us.values())
    if total_us:
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:14]
        shares = "; ".join(f"{g} {100 * us / total_us:.1f} %" for g, us in top)
        phase(f"phase 8 profile of 3 bf16 steps: wall {wall * 1e3:.1f} ms, device busy "
              f"{total_us / 1e3:.1f} ms ({total_us / 1e6 / wall:.3f} of wall), "
              f"{launches_per_step:.0f} kernel launches a step; by kernel: {shares}")
    else:
        phase(f"phase 8 profile of 3 bf16 steps: wall {wall * 1e3:.1f} ms; the profiler saw "
              "no device time")

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


def load_dummy_tokenizers():
    """tests/dummy_tokenizers.py's DummyTokenizer and PairDummyTokenizer,
    loaded by path (an installed package may own the top-level name
    ``tests``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "dummy_tokenizers", REPO / "tests" / "dummy_tokenizers.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.DummyTokenizer, module.PairDummyTokenizer


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from open_provence_tpu_torch import init_params, kernels

    DummyTokenizer, PairDummyTokenizer = load_dummy_tokenizers()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)

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
          f"in {time.perf_counter() - began:.1f} s")
    entry = spills = ""
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line:
            phase(f"phase 2 ptxas {entry}: {line.split(':', 1)[1].strip()}; {spills}")

    stats = phase3_kernels(dev)
    stats.update(phase3b_backward(dev))

    config = base_config()
    sd = init_params(config, torch.Generator().manual_seed(0))
    phase4_model(config, sd, dev)
    model, _, pairs = phase5_process(config, sd, DummyTokenizer, dev)
    phase6_timings(model, pairs, card)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        phase7_train_step(config, sd, PairDummyTokenizer(), dev, Path(tmp))
        launches = phase8_train_then_serve(
            config, sd, DummyTokenizer, PairDummyTokenizer(), dev, card, Path(tmp)
        )

    table = [
        {
            "name": name,
            "route": "cuda",
            "source": f"open_provence_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"][torch.bfloat16],
            "ms": stats[name]["ms"],
            "plain_ms": stats[name]["plain_ms"],
        }
        for name, (source, replaces) in KERNEL_INFO.items()
    ]
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
