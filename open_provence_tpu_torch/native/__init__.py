"""ctypes bindings for the native host ops, with auto-build and pure-Python
fallbacks.

The C++ source is ``host_ops.cpp`` beside this file, the port's own copy of
the JAX package's ``native/host_ops.cpp`` (a test holds the two byte for
byte), so the port opens nothing outside its package. The shared library is
compiled from it at first use into this directory; when no C++ toolchain is
available the Python fallbacks are used — they are behavior-identical
(tests/test_native_ops.py asserts parity on randomized cases).
"""

from __future__ import annotations

import ctypes
import itertools
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE / "host_ops.cpp"
_LIB_PATH = _HERE / "libhost_ops.so"

_lib: ctypes.CDLL | None = None
_build_attempted = False


def _build_library() -> bool:
    compiler = os.environ.get("CXX", "g++")
    # Build under a per-process name and rename: concurrent test workers
    # must never load a half-written library.
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        compiler, "-O3", "-shared", "-fPIC", "-std=c++17",
        str(_SOURCE), "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception as exc:
        tmp.unlink(missing_ok=True)
        logger.info("native host_ops build failed (%s); using Python fallbacks", exc)
        return False


def _load() -> ctypes.CDLL | None:
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    if os.environ.get("OPEN_PROVENCE_TPU_DISABLE_NATIVE"):
        return None
    if not _LIB_PATH.exists() or (
        _SOURCE.exists() and _SOURCE.stat().st_mtime > _LIB_PATH.stat().st_mtime
    ):
        if _build_attempted:
            return None
        _build_attempted = True
        if not _build_library():
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as exc:
        logger.info("native host_ops load failed (%s); using Python fallbacks", exc)
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.op_find_subsequence.restype = ctypes.c_int32
    lib.op_find_subsequence.argtypes = [i32p, ctypes.c_int32, i32p, ctypes.c_int32]
    lib.op_greedy_pack.restype = ctypes.c_int32
    lib.op_greedy_pack.argtypes = [
        i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p,
    ]
    lib.op_pad_block_batch_i32.restype = None
    lib.op_pad_block_batch_i32.argtypes = [
        i32p, i32p, ctypes.c_int32, ctypes.c_int32, i32p, i32p,
    ]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.op_en_split_spans.restype = ctypes.c_int64
    lib.op_en_split_spans.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64,
    ]
    _lib = lib
    return lib


def is_available() -> bool:
    return _load() is not None


def _as_i32(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.int32)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# --- public ops (native with Python fallback) --------------------------------


def find_subsequence(haystack, needle) -> int:
    """First index of needle in haystack, -1 if absent/empty
    (reference standalone:2159-2170 semantics: empty needle → -1)."""
    hay = _as_i32(list(haystack))
    ndl = _as_i32(list(needle))
    if ndl.size == 0:
        return -1
    lib = _load()
    if lib is not None:
        return int(lib.op_find_subsequence(_ptr(hay), hay.size, _ptr(ndl), ndl.size))
    # Python fallback
    n, m = hay.size, ndl.size
    if n < m:
        return -1
    hay_list = hay.tolist()
    ndl_list = ndl.tolist()
    for i in range(n - m + 1):
        if hay_list[i : i + m] == ndl_list:
            return i
    return -1


def greedy_pack(lens, base_len: int, available_len: int):
    """Greedy packing plan: (block_ids, new_lens, n_blocks)
    (reference standalone:2222-2259 semantics).

    Small inputs (the typical per-cell case: a few dozen fragments) take a
    plain-list Python path — numpy/ctypes marshalling costs more than the
    O(n) loop it would replace."""
    lens_list = list(lens)
    if len(lens_list) <= 64:
        capacity = max(1, int(available_len) - int(base_len))
        block_ids: list[int] = []
        new_lens: list[int] = []
        block, current_len, block_open = 0, int(base_len), False
        for length in lens_list:
            if current_len + length <= available_len:
                block_ids.append(block)
                new_lens.append(length)
                current_len += length
                block_open = True
                continue
            if block_open:
                block += 1
                block_open = False
                current_len = int(base_len)
            truncated = min(length, capacity)
            block_ids.append(block)
            new_lens.append(truncated)
            current_len = int(base_len) + truncated
            block_open = True
        return block_ids, new_lens, (block + 1 if lens_list else 0)
    lens_arr = _as_i32(lens_list)
    n = int(lens_arr.size)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 0
    block_ids = np.zeros(n, dtype=np.int32)
    new_lens = np.zeros(n, dtype=np.int32)
    lib = _load()
    if lib is not None:
        n_blocks = int(
            lib.op_greedy_pack(
                _ptr(lens_arr), n, int(base_len), int(available_len),
                _ptr(block_ids), _ptr(new_lens),
            )
        )
        return block_ids, new_lens, n_blocks
    # Python fallback
    capacity = max(1, int(available_len) - int(base_len))
    block = 0
    current_len = int(base_len)
    block_open = False
    for i, length in enumerate(lens_arr.tolist()):
        if current_len + length <= available_len:
            block_ids[i] = block
            new_lens[i] = length
            current_len += length
            block_open = True
            continue
        if block_open:
            block += 1
            block_open = False
            current_len = int(base_len)
        truncated = min(length, capacity)
        block_ids[i] = block
        new_lens[i] = truncated
        current_len = int(base_len) + truncated
        block_open = True
    return block_ids, new_lens, block + 1


def pad_block_batch_i32(
    rows: list[list[int]], seq_len: int, batch_size: int, pad_id: int
) -> tuple[np.ndarray, np.ndarray]:
    """Fill padded [batch, seq] (input_ids, attention) arrays from ragged
    rows (rows beyond len(rows) are full padding)."""
    input_ids = np.full((batch_size, seq_len), pad_id, dtype=np.int32)
    attention = np.zeros((batch_size, seq_len), dtype=np.int32)
    n_rows = min(len(rows), batch_size)
    lib = _load()
    if lib is not None and n_rows:
        lens = [len(r) for r in rows[:n_rows]]
        row_lens = _as_i32(lens)
        total = sum(lens)
        # fromiter over a chain: ~1.6x over building a flat Python list
        # first (this flatten was most of the wrapper's cost).
        flat = np.fromiter(
            itertools.chain.from_iterable(rows[:n_rows]),
            dtype=np.int32,
            count=total,
        )
        if flat.size == 0:
            flat = np.zeros(1, dtype=np.int32)
        lib.op_pad_block_batch_i32(
            _ptr(flat), _ptr(row_lens), n_rows, int(seq_len),
            _ptr(input_ids), _ptr(attention),
        )
        return input_ids, attention
    for r, row in enumerate(rows[:n_rows]):
        n = min(len(row), seq_len)
        if n:
            input_ids[r, :n] = row[:n]
            attention[r, :n] = 1
    return input_ids, attention


_EN_SPAN_TLS = threading.local()


def en_split_spans(text: str, max_chars: int) -> list[tuple[int, int]] | None:
    """Native ASCII English sentence splitting: (start, end) spans of
    ``text`` whose slices equal ``_EnglishSplitter``'s output in regex mode
    (text/splitters.py). Returns None when the native library is
    unavailable or ``text`` is not pure ASCII (the Python path handles
    those). Parity is fuzz-tested in tests/test_native_ops.py.

    The output buffer is cached per thread (grown on demand) — per-call
    numpy allocation and scalar unboxing were most of the wrapper's cost,
    and the C call releases the GIL, so the engine's preprocess worker
    threads must not share one buffer."""
    lib = _load()
    if lib is None or not text.isascii():
        return None
    raw = text.encode("ascii")
    n = len(raw)
    cap = getattr(_EN_SPAN_TLS, "cap", 0)
    if cap < 64:
        cap = _EN_SPAN_TLS.cap = 4096
        _EN_SPAN_TLS.buf = (ctypes.c_int64 * (2 * cap))()
    while True:
        buf = _EN_SPAN_TLS.buf
        count = lib.op_en_split_spans(raw, n, max_chars, buf, cap)
        if count <= cap:
            return [(buf[2 * k], buf[2 * k + 1]) for k in range(count)]
        cap = _EN_SPAN_TLS.cap = count
        _EN_SPAN_TLS.buf = (ctypes.c_int64 * (2 * cap))()
