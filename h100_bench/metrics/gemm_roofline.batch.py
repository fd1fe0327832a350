"""gemm_roofline.batch: roofline share of the encoder's projection products
(Wqkv, attention Wo, Wi with the GeGLU, MLP Wo) and the heads' products in
the batch cells: the least time of that work, counted from the blocks'
valid lengths (lib/work.py, kind "gemm"), over the device time of the
kernels that do it (the port's GEMM kernels and cuBLAS's), matched by
kernel name, never by namespace: the port's GEMM namespace holds its
LayerNorm pass too. The patterns are ``kernel_groups.json``'s "gemm"
group."""

from h100_bench.lib import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "pairs_per_s"
WORK = ("gemm",)
PATTERNS = (r"\bgemm_(wgmma|fma)_kernel<", r"\bdw_sum_kernel<", r"^nvjet_", r"\bgemv",
            r"xmma_gemm", r"^void cutlass::", r"\bcublasLt::", r"cublas(Gemv|Dot)")


def read(run):
    return readers.roofline(run, WORK, PATTERNS)
