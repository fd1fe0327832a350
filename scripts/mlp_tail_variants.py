#!/usr/bin/env python3
"""Where the bf16 whole-MLP forward (kernel 8, ``mlp_tail.cu``) spends its
time on one CUDA card: copies of this checkout's package whose kernel source
is patched to leave one part of the work out, each imported under its own
name and timed beside the unpatched kernel and the split path on the same
tensors (CUDA graphs of 20 calls, the lowest of two).

The variants compute wrong outputs on purpose; only their times mean
anything:

- ``solo``: the same CTAs launched without clusters (each its own cluster of
  one), with no handover of h: what the cluster launch costs;
- ``nocopy``: clusters, their barriers and waits, but no bulk copies of h
  (the peers' panels stay stale): what moving h costs;
- ``noig`` / ``nowo``: no products for [inp | gate] / for the output.

Usage, from the repository root (the copies, and their builds, go to a
temporary directory that is removed at the end)::

    python3 scripts/mlp_tail_variants.py [VARIANT ...]
"""

from __future__ import annotations

import importlib
import importlib.util
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SOURCE = "kernels/csrc/mlp_tail.cu"
VARIANTS = {
    "solo": [("config.numAttrs = 1;", "config.numAttrs = 0;"),
             ("mbar_init(&h_free, CONSUMERS * C);", "mbar_init(&h_free, CONSUMERS);"),
             ("      for (int p = 0; p < C; ++p)\n        hop::mbar_arrive_cluster",
              "      for (int p = 0; p < 1; ++p)\n        hop::mbar_arrive_cluster"),
             ("        if (p != rank)", "        if (false)"),
             ("(C - 1) * PANEL_BYTES);", "0);")],
    "nocopy": [("        if (p != rank)", "        if (false)"),
               ("(C - 1) * PANEL_BYTES);", "0);")],
    "noig": [("        hop::wgmma_ss<2 * SHARE>(ig, hop::k_major<BK>(a, kk), "
              "hop::k_major<BK>(b, kk), 1);", "")],
    "nowo": [("        hop::wgmma_rs<OUT_COLS, 0>(acc, af[kk], hop::k_major<BK>(b, kk), 1);", "")],
}
SHAPES = ((16384, 768, 1152), (16384, 1024, 1152), (16384, 256, 1152))


def patched_package(name: str, where: Path) -> Path:
    """A copy of the package under ``where`` with VARIANTS[name] applied to
    its kernel."""
    root = where / f"mlp_tail_{name}" / "open_provence_tpu_torch"
    shutil.copytree(REPO / "open_provence_tpu_torch", root,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = root / SOURCE
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: the kernel no longer has {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return root


def load(module: str, root: Path):
    spec = importlib.util.spec_from_file_location(
        module, root / "__init__.py", submodule_search_locations=[str(root)])
    sys.modules[module] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[module])
    importlib.import_module(f"{module}.kernels").library()
    return importlib.import_module(f"{module}.ops")


def graph_ms(fn, reps: int = 20) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("mlp_tail_variants: needs a CUDA card", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"usage: mlp_tail_variants.py [{' | '.join(VARIANTS)} ...]", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from open_provence_tpu_torch import kernels, ops

    kernels.library()
    with tempfile.TemporaryDirectory() as where:
        trees = {"this": ops, **{n: load(f"mlp_tail_{n}", patched_package(n, Path(where)))
                                 for n in names}}
        time_variants(trees)
    return 0


def time_variants(trees: dict) -> None:
    """Each tree's ln_geglu_wo beside the split path, at SHAPES."""
    from open_provence_tpu_torch import kernels, ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen, dev = torch.Generator().manual_seed(5), torch.device("cuda")

    def randn(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(dev, torch.bfloat16)

    for m, k, i in SHAPES:
        x, scale = randn(m, k, s=2.0), randn(k, s=0.1) + 1
        wi, wo = randn(2 * i, k, s=k ** -0.5), randn(k, i, s=i ** -0.5)
        times = {name: min(graph_ms(lambda o=o: o.ln_geglu_wo(x, scale, wi, wo, "gelu"))
                           for _ in range(2)) for name, o in trees.items()}
        split = min(graph_ms(lambda: torch.nn.functional.linear(ops.ln_geglu(x, scale, wi, "gelu"),
                                                                wo)) for _ in range(2))
        print(f"M={m} K={k} I={i}, clusters of {kernels.mlp_tail_cluster(k)}: "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in times.items())
              + f" ms; the split path {split:.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
