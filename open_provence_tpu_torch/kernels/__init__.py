"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per unit (a source, and for the attention
sources also one per head dim), all started together, and
linked into one shared library with a plain C interface, which is loaded
with ``ctypes``: no ninja and no libtorch headers, so a build takes seconds.
The library lands in ``build_dir()`` under a name that carries the hash of
the sources, so an edited source rebuilds; a file lock keeps concurrent
processes from building the same library twice. ``build_dir()`` is the
directory ``OPEN_PROVENCE_TPU_TORCH_BUILD_DIR`` names when it is set, else
the package's ``_build/`` (listed in ``.gitignore``) when it is writable,
else ``~/.cache/open_provence_tpu_torch/kernels`` (an install into a
read-only ``site-packages``).

Importing this module builds nothing and needs neither ``nvcc`` nor a card.

Every wrapper in ``ops/`` adds one to its kernel's launch count right after
a successful launch, so a run can show that the main path went through the
kernels (``reset_launch_counts`` / ``launch_counts``). A CUDA graph's capture
launches nothing, so the launches its wrappers counted are taken back out
(``recorded_launches``), and each replay of the graph adds them once
(``add_launches``): the kernels ran, without their wrappers. A
wrapper that takes its plain version (a CPU tensor) adds one to that
kernel's plain count instead (``plain_counts``). A tensor on a CUDA card
never takes the plain version: the library is built for ``sm_90a`` alone,
so on a card of any compute capability but ``KERNEL_CAPABILITY``
``on_cuda`` raises, naming the card; a caller who wants plain PyTorch there
moves the tensors to the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import stat
import subprocess
from collections.abc import Iterator
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
# The package's own build directory, used when it is writable; the
# environment variable names another, and ~/.cache/... takes over where the
# package lies read-only.
BUILD_DIR = _HERE / "_build"
BUILD_DIR_ENV = "OPEN_PROVENCE_TPU_TORCH_BUILD_DIR"
USER_BUILD_DIR = Path(".cache") / "open_provence_tpu_torch" / "kernels"  # under ~
SOURCES = (
    "layer_norm.cu", "ln_gemm.cu", "flash_attention.cu", "ln_gemm_bwd.cu",
    "flash_attention_bwd.cu", "mlp_tail.cu", "mlp_tail_bwd.cu",
)
HEADERS = (
    "common.cuh", "activation.cuh", "attention_common.cuh", "gemm.cuh", "ln_adjoint.cuh",
    "mlp_tail.cuh", "hopper.cuh", "attention_wgmma.cuh", "gemm_wgmma.cuh",
)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# The one compute capability those flags give machine code for; a tensor
# on a card of any other is refused.
KERNEL_CAPABILITY = (9, 0)
# The rest of the recipe: each unit's compile (with the ptxas report), then
# the link of the objects into one shared library.
COMPILE_FLAGS = ("-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)
# The head dims the attention kernels are instantiated for
# (attention_common.cuh: OPT_ATTN_FOR_EACH_D).
ATTENTION_HEAD_DIMS = (32, 64, 128, 256)
_PER_HEAD_DIM = ("flash_attention.cu", "flash_attention_bwd.cu")
# One nvcc process each: (source, extra flags). The attention sources are
# compiled once per head dim (the kernels of that D) and once without the
# macro (the entry points), so the instances build side by side.
UNITS = tuple(
    (src, flags)
    for src in SOURCES
    for flags in (
        [(), *((f"-DOPT_HEAD_DIM={d}",) for d in ATTENTION_HEAD_DIMS)]
        if src in _PER_HEAD_DIM else [()]
    )
)

# The kernels' names: the default layout's eight in the order a training
# step first reaches them (the forward, then the backward from the heads
# down), the two of the bias-carrying layouts, then attention on separate
# q, k, v and the whole-MLP fusion, forward and backward; the C entry point
# of each is ``opt_<name>`` (but see SAME_LAUNCH).
KERNELS = (
    "layer_norm", "ln_matmul", "flash_attention_packed", "ln_geglu",
    "layer_norm_bwd", "ln_geglu_bwd", "flash_attention_packed_bwd", "ln_matmul_bwd",
    "add_layer_norm", "geglu",
    "flash_attention", "flash_attention_bwd", "ln_geglu_wo", "ln_geglu_wo_bwd",
)
# The eight the bias-free default layout runs; ``add_layer_norm`` and
# ``geglu`` run only for checkpoints that carry biases (mlp_bias, norm_bias).
DEFAULT_PATH_KERNELS = KERNELS[:8]
# On Hopper attention on the packed buffer and on separate q, k, v is one
# kernel behind one C entry point, launched on strided operands: the packed
# names stand for the TPU kernels they replace and read that kernel's count.
SAME_LAUNCH = {
    "flash_attention_packed": "flash_attention",
    "flash_attention_packed_bwd": "flash_attention_bwd",
}

# The LN-adjoint kernels (ln_adjoint.cuh; the tail of kernels 10-13): rows
# of x a CTA takes, one fp32 partial row of dscale each (ROWS), and the
# widths with a register-resident instance (REGISTER_CHUNKS x CHUNK); every
# other width runs the strided instance.
LN_ADJOINT_ROWS = 64
LN_ADJOINT_REGISTER_WIDTHS = (768, 1024)

# The bf16 weight gradients dW [n, k] = G[m, n]^T · X[m, k] (kernels 11, 12,
# 13; gemm.cuh) sum m rows into few 128 × 256 tiles (gemm_wgmma.cuh: wgm::BM,
# BN), so the rows are cut into chunks, one CTA a tile and chunk, each chunk
# summed in fp32 into scratch and the chunks added in order by a second
# pass. A chunk is a whole number of 64-row k-steps (wgm::BK) but the last;
# the split aims at DW_CTAS CTAs, one wave of one CTA an SM on an H100's 132
# (a constant: the split, and so the bits, never depend on the card), and
# gives each chunk at least DW_MIN_STEPS k-steps, so the fill and the
# epilogue of a tile stay small beside its products. At base width that is
# 2 chunks: 1, 3, 5, 7, 10 and 14 measured slower on an H100 (PERF.md).
DW_TILE = (128, 256)
DW_STEP = 64
DW_CTAS = 128
DW_MIN_STEPS = 8

# The bf16 backward LayerNorm→GEMM kernels 11 and 12 (ln_gemm_bwd.cu) apply
# the LN adjoint to each fp32 tile of dy = G·W in the kernel that sums it
# (gemm_wgmma.cuh's LN_ADJOINT epilogue, tiles of wgm::BM × BN): a row's
# tiles are held by ln_gemm_bwd_cluster(K) CTAs, which add their row sums in
# rank order, and each tile of LN_GEMM_BWD_TILE[0] rows writes one fp32
# partial row of dscale. A row takes at most LN_GEMM_BWD_MAX_CLUSTER CTAs,
# so K <= 2048 takes that route; fp32 and wider rows take the split one (dy
# in fp32 scratch, then ln_adjoint.cuh). The route reads the dtype and K
# alone.
LN_GEMM_BWD_TILE = (128, 256)
LN_GEMM_BWD_MAX_CLUSTER = 8

# The bf16 whole-MLP forward (kernel 8; mlp_tail.cuh, wgf::): a cluster of
# mlp_tail_cluster(K) CTAs shares each tile of 128 rows, each CTA owning
# MLP_TAIL_OUT_COLS output columns (64 fp32 sums a consumer thread, within
# the 168 registers a thread of a three-warpgroup CTA gets); a cluster holds
# at most MLP_TAIL_MAX_CLUSTER CTAs, the portable limit, so K <= 1024.
MLP_TAIL_OUT_COLS = 128
MLP_TAIL_MAX_CLUSTER = 8

_launches = dict.fromkeys(KERNELS, 0)
_plain_calls = dict.fromkeys(KERNELS, 0)
_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for counts in (_launches, _plain_calls):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict[str, int]:
    return {name: _launches[SAME_LAUNCH.get(name, name)] for name in KERNELS}


def plain_counts() -> dict[str, int]:
    return dict(_plain_calls)


def count_launch(name: str) -> None:
    _launches[name] += 1


@contextlib.contextmanager
def recorded_launches() -> Iterator[dict[str, int]]:
    """Launches counted inside the block, taken back out of the counts and
    left in the dict it yields (by kernel, those that launched): what a CUDA
    graph's capture recorded, which runs only when the graph is replayed."""
    before = dict(_launches)
    recorded: dict[str, int] = {}
    try:
        yield recorded
    finally:
        recorded.update({k: n - before[k] for k, n in _launches.items() if n != before[k]})
        _launches.update(before)


def add_launches(counts: dict[str, int]) -> None:
    """Count the launches of a CUDA graph's replay: ``counts`` as
    ``recorded_launches`` gave them at its capture."""
    for name, n in counts.items():
        _launches[name] += n


def count_plain(name: str) -> None:
    _plain_calls[name] += 1


def ln_adjoint_partial(rows: int, hidden: int, device: torch.device) -> torch.Tensor:
    """fp32 scratch for the fixed-order dscale sum of an LN-adjoint launch."""
    parts = (rows + LN_ADJOINT_ROWS - 1) // LN_ADJOINT_ROWS
    return torch.empty((parts, hidden), dtype=torch.float32, device=device)


def ln_adjoint_aligned(t: torch.Tensor | None, hidden: int) -> torch.Tensor | None:
    """``t``, or a copy of it where the LN adjoint's register instance
    (hidden 768, 1024), which moves rows in 16-byte words, would be handed
    a pointer off a 16-byte boundary. Every other width takes any
    alignment."""
    if t is None or hidden not in LN_ADJOINT_REGISTER_WIDTHS or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


def dw_chunk_rows(m: int, n: int, k: int) -> int:
    """Rows of the contraction each chunk of dW [n, k] = G[m, n]^T · X[m, k]
    sums: a multiple of DW_STEP, a function of the shape alone."""
    tiles = -(-n // DW_TILE[0]) * -(-k // DW_TILE[1])
    steps = -(-m // DW_STEP)
    chunks = max(1, min(DW_CTAS // tiles, steps // DW_MIN_STEPS))
    return max(1, -(-steps // chunks)) * DW_STEP


def dw_chunks(m: int, n: int, k: int) -> int:
    """How many chunks of ``dw_chunk_rows`` rows cover m rows (the last may
    be shorter)."""
    return max(1, -(-m // dw_chunk_rows(m, n, k)))


def dw_partial(products, device: torch.device) -> torch.Tensor:
    """fp32 scratch for the chunks' partial sums of the weight gradients
    ``products``, (m, n, k) each, launched one after another: as large as
    the largest needs."""
    numel = max(dw_chunks(m, n, k) * n * k for m, n, k in products)
    return torch.empty(numel, dtype=torch.float32, device=device)


def ln_gemm_bwd_cluster(hidden: int) -> int:
    """The CTAs that hold a row of kernels 11 and 12's fused dy and LN
    adjoint at hidden size K: one a tile of 256 columns."""
    return -(-hidden // LN_GEMM_BWD_TILE[1])


def ln_gemm_bwd_fused(hidden: int, dtype: torch.dtype) -> bool:
    """True where kernels 11 and 12 run dy and the LN adjoint in one launch
    (bf16, a row in at most LN_GEMM_BWD_MAX_CLUSTER CTAs); False for the
    split route."""
    return dtype == torch.bfloat16 and ln_gemm_bwd_cluster(hidden) <= LN_GEMM_BWD_MAX_CLUSTER


def ln_gemm_bwd_rows(rows: int, hidden: int) -> int:
    """fp32 words of the fused route's row scratch (ln_gemm_bwd.cu's
    RowScratch): each row's mean and rstd (padded to 16 bytes), the row
    tiles' exchanged sums [ceil(rows / 128)][C][128] float2 and their
    arrival counts [ceil(rows / 128)] int32."""
    tiles = -(-rows // LN_GEMM_BWD_TILE[0])
    stats = -(-2 * rows // 4) * 4
    return stats + tiles * ln_gemm_bwd_cluster(hidden) * LN_GEMM_BWD_TILE[0] * 2 + tiles


def ln_gemm_bwd_partial(rows: int, hidden: int, device: torch.device) -> torch.Tensor:
    """fp32 scratch for dscale's partial rows on the fused route: one a tile
    of LN_GEMM_BWD_TILE[0] rows."""
    parts = -(-rows // LN_GEMM_BWD_TILE[0])
    return torch.empty((parts, hidden), dtype=torch.float32, device=device)


def mlp_tail_cluster(hidden: int) -> int:
    """The CTAs of the bf16 whole-MLP forward's cluster at hidden size K:
    one a slice of MLP_TAIL_OUT_COLS output columns."""
    return -(-hidden // MLP_TAIL_OUT_COLS)


def nvcc_path() -> str:
    """``nvcc`` from CUDA_HOME, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_digest() -> str:
    """The hash of the whole recipe: every header and source, the units with
    their own flags, and the target, compile and link flags."""
    h = hashlib.sha256()
    for name in (*HEADERS, *SOURCES):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(repr((UNITS, ARCH_FLAGS, COMPILE_FLAGS, LINK_FLAGS)).encode())
    return h.hexdigest()[:16]


def _writable(directory: Path) -> bool:
    """True when this process may create files in ``directory`` (or, where
    it does not exist yet, in its nearest existing ancestor): write access,
    a write bit in its mode (so a tree made read-only stays so for root too)
    and a file system mounted read-write."""
    probe = directory
    while not probe.exists():
        if probe.parent == probe:
            return False
        probe = probe.parent
    if not probe.is_dir():
        return False
    return (
        os.access(probe, os.W_OK | os.X_OK)
        and bool(probe.stat().st_mode & (stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH))
        and not os.statvfs(probe).f_flag & os.ST_RDONLY
    )


def build_dir() -> Path:
    """Where the library is built and looked for: the directory
    ``OPEN_PROVENCE_TPU_TORCH_BUILD_DIR`` names, else the package's
    ``_build/`` when it is writable, else ``~/.cache/open_provence_tpu_torch/
    kernels``."""
    override = os.environ.get(BUILD_DIR_ENV)
    if override:
        return Path(override).expanduser()
    if _writable(BUILD_DIR):
        return BUILD_DIR
    return Path.home() / USER_BUILD_DIR


def library_path() -> Path:
    return build_dir() / f"libopt_kernels_{_source_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    Returns its path; the ptxas report is kept beside it as ``.log``."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lib_path.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():  # built by another process while we waited
            return lib_path
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        names = ["".join([Path(src).stem, *flags]) for src, flags in UNITS]
        objects = [tmp.with_name(f"{tmp.name}.{name}.o") for name in names]
        compiles = [
            subprocess.Popen(
                [nvcc_path(), *ARCH_FLAGS, *COMPILE_FLAGS, *flags, str(CSRC / src), "-o",
                 str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for (src, flags), obj in zip(UNITS, objects)
        ]
        logs = [proc.communicate()[0] for proc in compiles]
        log = "".join(logs)
        failed = [name for name, proc in zip(names, compiles) if proc.returncode != 0]
        report = "".join(out for out, proc in zip(logs, compiles) if proc.returncode != 0)
        if not failed:
            link = subprocess.run(
                [nvcc_path(), *ARCH_FLAGS, *LINK_FLAGS, *map(str, objects), "-o", str(tmp)],
                capture_output=True, text=True, check=False,
            )
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed, report = ["link"], link.stdout + link.stderr
        lib_path.with_suffix(".log").write_text(log)
        for obj in objects:
            obj.unlink(missing_ok=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{report[:6000]}")
        os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    signatures = {
        "flash_attention": [p] * 9 + [i, i, i, i, strides, i, f, i, p],
        "flash_attention_bwd": [p] * 14 + [i, i, i, i, strides, i, f, i, p],
        "ln_geglu_wo": [p] * 6 + [i, i, i, f, i, i, p],
        "ln_geglu_wo_bwd": [p] * 15 + [i, i, i, i, i, f, i, i, p],
        "layer_norm": [p, p, p, i, i, f, i, p],
        "ln_matmul": [p] * 5 + [i, i, i, f, i, p],
        "ln_geglu": [p] * 5 + [i, i, i, f, i, i, p],
        "layer_norm_bwd": [p, p, p, p, p, p, p, i, i, f, i, p],
        "add_layer_norm": [p, p, p, p, p, i, i, f, i, p],
        "geglu": [p, p, p, i, i, i, i, i, p],
        "ln_matmul_bwd": [p] * 12 + [i, i, i, i, f, i, p],
        "ln_geglu_bwd": [p] * 13 + [i, i, i, i, f, i, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, f"opt_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.opt_flash_attention_design.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.opt_flash_attention_design.restype = ctypes.c_int
    lib.opt_gemm_design.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.opt_gemm_design.restype = ctypes.c_int
    lib.opt_ln_adjoint_design.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.opt_ln_adjoint_design.restype = ctypes.c_int
    lib.opt_ln_gemm_bwd_design.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.opt_ln_gemm_bwd_design.restype = ctypes.c_int
    lib.opt_mlp_tail_design.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.opt_mlp_tail_design.restype = ctypes.c_int
    lib.opt_error_string.argtypes = [ctypes.c_int]
    lib.opt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def attention_design(head_dim: int, backward: bool = False) -> dict:
    """How the bf16 attention kernels of ``head_dim`` were built (it is fixed
    at compile time): the route to the tensor cores, how the streamed side
    reaches shared memory, the ring's stages, the tile shape, the consumer
    warpgroups a CTA, how the rotation happens and how many [B, H, S, D]
    operands a call with rope tables rotates into scratch first. Backward:
    ``stages`` and ``rotation`` are the dK/dV pass's, ``dq_stages`` the dQ
    pass's."""
    out = (ctypes.c_int * 12)()
    if library().opt_flash_attention_design(head_dim, int(backward), out) != 0:
        raise ValueError(f"no attention kernel for head_dim {head_dim}")
    (consumers, stages, own_rows, streamed_rows, other_rows, other_consumers, other_stages,
     tables, _, form, rotated, route) = out
    products, fill = {2: ("wgmma", "cp.async ring with mbarriers, a producer warpgroup")}[route]
    design = {
        "products": products,
        "fill": fill,
        "stages": stages,
        "rotation": ("in the ring, cos/sin staged beside each tile" if tables
                     else "into scratch before the pass"),
        "scratch": rotated,
    }
    if backward:
        # attention_wgmma.cuh: DkvForm
        lay = {0: "", 1: " splitting the D columns", 2: " making dV or dK by the tile's parity"}
        design.update(
            tile=f"dK/dV {own_rows}x{streamed_rows}, dQ {other_rows}x{streamed_rows}",
            consumers=f"dK/dV {consumers}{lay[form]}, dQ {other_consumers}",
            dq_stages=other_stages)
    elif other_rows != own_rows:
        design.update(
            tile=f"{other_rows}x{streamed_rows} global, {own_rows}x{streamed_rows} with a window",
            consumers=f"{other_consumers} global, {consumers} with a window")
    else:
        design.update(tile=f"{own_rows}x{streamed_rows}", consumers=str(consumers))
    return design


@functools.lru_cache(maxsize=None)
def attention_scratch_operands(head_dim: int, backward: bool) -> int:
    """How many [B, H, S, D] operands the bf16 attention kernels of
    ``head_dim`` rotate into scratch when they get rope tables (the wrapper
    allocates it): fixed when the library is built."""
    return attention_design(head_dim, backward)["scratch"]


def gemm_design(ta: bool, tb: bool, dtype: torch.dtype) -> dict:
    """How the GEMM engine runs the layout C = A·B with A (``ta``) or B
    (``tb``) transposed in ``dtype``, as the library was built: the products,
    how the operands reach shared memory, the ring's stages and the tile
    (rows x B rows x depth; under GEGLU half of the B rows are gate rows)."""
    out = (ctypes.c_int * 6)()
    if library().opt_gemm_design(int(ta), int(tb), dtype_code_of(dtype), out) != 0:
        raise ValueError(f"no GEMM for {dtype}")
    products, fill, stages, rows, cols, depth = out
    return {
        "products": {0: "fma", 2: "wgmma"}[products],
        "fill": {0: "loads between two barriers a tile",
                 2: "TMA ring with mbarriers, one producer thread"}[fill],
        "stages": stages,
        "tile": f"{rows}x{cols}x{depth}",
    }


def built_ln_adjoint_design(rows: int, hidden: int) -> dict:
    """The LN adjoint's design for rows x hidden as the library reports it:
    the instance, the partial rows of dscale (``ln_adjoint_partial``'s
    rows), the CTA's rows and warps, the 256-column chunks a row holds in
    registers (0 when strided) and the warps of the partials' reduction."""
    out = (ctypes.c_int * 6)()
    if library().opt_ln_adjoint_design(rows, hidden, out) != 0:
        raise ValueError(f"no LN adjoint over {rows} x {hidden}")
    registers, parts, cta_rows, warps, chunks, reduce_warps = out
    return {"instance": "registers" if registers else "strided", "parts": parts,
            "cta_rows": cta_rows, "warps": warps, "chunks": chunks,
            "reduce_warps": reduce_warps}


def built_ln_gemm_bwd_design(hidden: int, dtype: torch.dtype) -> dict:
    """How kernels 11 and 12 run at hidden size K in ``dtype`` as the library
    reports it: the route (``fused``: dy and the LN adjoint in one launch;
    ``split``), the CTAs that hold a row on the fused route (0 when split), the rows of
    x a partial row of dscale sums, the most CTAs a row takes, and how many
    groups of ``cluster`` CTAs the fused route's persistent grid holds on
    the current card (0 when split)."""
    out = (ctypes.c_int * 5)()
    if library().opt_ln_gemm_bwd_design(hidden, dtype_code_of(dtype), out) != 0:
        raise ValueError(f"no backward LN->GEMM kernel for {dtype}")
    fused, cluster, partial_rows, max_cluster, groups = out
    return {"route": "fused" if fused else "split", "cluster": cluster,
            "partial_rows": partial_rows, "max_cluster": max_cluster, "groups": groups}


def built_mlp_tail_design(hidden: int) -> dict:
    """The bf16 design of the whole-MLP kernels at hidden size K as the
    library reports it: the forward's cluster (CTAs, output columns and
    columns of h a CTA, ring stages, tile rows, how many the card holds at
    once) and the backward row pass's tile (rows x columns of I) and ring
    stages."""
    out = (ctypes.c_int * 9)()
    if library().opt_mlp_tail_design(hidden, out) != 0:
        raise ValueError(f"no whole-MLP kernel for hidden size {hidden}")
    cluster, out_cols, share, stages, rows, bwd_rows, bwd_cols, bwd_stages, at_once = out
    return {"cluster": cluster, "out_cols": out_cols, "share": share, "stages": stages,
            "rows": rows, "clusters_at_once": at_once, "bwd_tile": f"{bwd_rows}x{bwd_cols}",
            "bwd_stages": bwd_stages}


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code_of(dtype: torch.dtype) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}") from None


def dtype_code(t: torch.Tensor) -> int:
    return dtype_code_of(t.dtype)


@functools.lru_cache(maxsize=None)
def card_capability(index: int) -> tuple[int, int]:
    """The compute capability of CUDA card ``index``, read once a card."""
    return tuple(torch.cuda.get_device_capability(index))


def on_cuda(t: torch.Tensor) -> bool:
    """True for a tensor on a Hopper card (take the kernel); False for a CPU
    tensor (take the plain version). A tensor on a card of another compute
    capability raises, since the library holds sm_90a code alone, and so
    does any other device. The choice reads the card's capability, never a
    build or launch error: on a Hopper card a failed build or launch raises."""
    device = t.device
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernel or plain path for device {device}")
    index = torch.cuda.current_device() if device.index is None else device.index
    capability = card_capability(index)
    if capability != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"cuda:{index} ({torch.cuda.get_device_name(index)}) has compute capability "
            f"{capability[0]}.{capability[1]}; the port's kernel library holds sm_90a code "
            f"alone (capability {KERNEL_CAPABILITY[0]}.{KERNEL_CAPABILITY[1]}). Pass "
            'device="cpu" to run the plain PyTorch versions'
        )
    return True


def first_card() -> torch.device:
    """The device an entry point runs on when none is named: the first CUDA
    card. Without one it raises instead of carrying on on the CPU, which is
    for callers that ask for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            'device=None means the first CUDA card, and there is none here; pass device="cpu" '
            "to run on the CPU"
        )
    return torch.device("cuda", 0)


def records_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd would record an op on these tensors. The wrappers
    then go through their autograd Function; otherwise (serving under
    ``inference_mode``) they call the same forward directly, without the
    Function's per-call cost."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def require_16_byte_rows(*tensors: torch.Tensor) -> None:
    """The bf16 kernels move rows in 16-byte vectors: each tensor must start
    on a 16-byte boundary with every stride but the last a multiple of 8."""
    for t in tensors:
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]) or t.stride(-1) != 1:
            raise ValueError(
                f"bf16 kernels need 16-byte aligned rows of 8k elements; got shape "
                f"{tuple(t.shape)}, strides {t.stride()}"
            )


def strides_of(*tensors: torch.Tensor):
    """The (batch, head, row) strides of [B, H, S, D] tensors, in elements,
    as the C array the unpacked attention entry points take."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error; count the launch if not."""
    if code != 0:
        msg = library().opt_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({code})")
    count_launch(name)
