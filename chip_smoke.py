#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (open_provence_tpu_torch) once on one NVIDIA
card and check it, in phases:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the four hand-written kernels from kernels/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   ModernBERT-base shapes the engine dispatches (M = B·S for B in 1/8/32 and
   S in 64/192/512, ragged padding, global and ±64 windows), fp32 and bf16;
4. the whole model at base width on seeded random weights: fp32 on the card
   against fp32 on the CPU (plain versions), and bf16 on the card against
   the same CPU result;
5. ``process()`` in bf16 on the card — the main path — with every kernel's
   launch count read around it; threshold 0 reproduces the input, threshold
   1 prunes everything; then fp32 card against fp32 CPU on 8 pairs;
6. timings: per-kernel time beside its plain version's, the forward in
   pairs/s at B=32, S=512, and process() on 256 pairs in pairs/s.

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
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HIDDEN, HEADS, HEAD_DIM, INTER = 768, 12, 64, 1152
# Kernel -> (source, the TPU kernel it replaces), in the order the forward
# first reaches them.
KERNEL_INFO = {
    "layer_norm": ("layer_norm.cu", "open_provence_tpu/ops/layer_norm.py:36"),
    "ln_matmul": ("ln_gemm.cu", "open_provence_tpu/ops/geglu.py:790"),
    "flash_attention_packed": ("flash_attention.cu", "open_provence_tpu/ops/flash_attention.py:856"),
    "ln_geglu": ("ln_gemm.cu", "open_provence_tpu/ops/geglu.py:152"),
}
# |kernel - plain| <= atol + rtol·|plain|. fp32: both sides compute in true
# fp32 and differ only in summation order (K = 768 sums, online softmax).
# bf16: both round at the same points, but a sum that lands beside a bf16
# rounding boundary can round one ulp apart (2^-7 relative), and GeGLU's
# chain of three roundings can compound that.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


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

    stats = {name: {"max_abs_err": {}, "cases": 0} for name in KERNEL_INFO}

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
    phase(f"phase 5 process() bf16, 256 pairs, main path launches: {json.dumps(launches)}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
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


def load_dummy_tokenizer():
    """tests/dummy_tokenizers.py::DummyTokenizer, loaded by path (an
    installed package may own the top-level name ``tests``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "dummy_tokenizers", REPO / "tests" / "dummy_tokenizers.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.DummyTokenizer


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from open_provence_tpu_torch import init_params, kernels

    DummyTokenizer = load_dummy_tokenizer()

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

    config = base_config()
    sd = init_params(config, torch.Generator().manual_seed(0))
    phase4_model(config, sd, dev)
    model, launches, pairs = phase5_process(config, sd, DummyTokenizer, dev)
    phase6_timings(model, pairs, card)

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
