"""A small reader and writer of the safetensors format, with no dependency
but torch.

The format: an 8-byte little-endian header length N, then N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [start, end]}}`` plus an
optional ``"__metadata__"`` of strings), padded with spaces to a multiple
of 8, then the raw little-endian tensor data. The writer lays the tensors
out as the ``safetensors`` package does (largest dtype first, then by name)
and writes the same bytes for the same dict, so the JAX package's
``utils/hf_convert.py::load_safetensors_state_dict`` reads it.
"""

from __future__ import annotations

import json
import struct
import sys
from collections.abc import Mapping
from pathlib import Path

import torch

_NAMES = {
    torch.bool: "BOOL",
    torch.uint8: "U8",
    torch.int8: "I8",
    torch.int16: "I16",
    torch.float16: "F16",
    torch.bfloat16: "BF16",
    torch.int32: "I32",
    torch.float32: "F32",
    torch.float64: "F64",
    torch.int64: "I64",
}
_DTYPES = {name: dtype for dtype, name in _NAMES.items()}
# The safetensors package's dtype order; its writer puts larger ones first.
_ORDER = ("BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32", "F32", "F64", "I64")


def _require_little_endian() -> None:
    if sys.byteorder != "little":
        raise RuntimeError("safetensors_io reads and writes on little-endian hosts only")


def save_file(
    tensors: Mapping[str, torch.Tensor],
    path: str | Path,
    metadata: Mapping[str, str] | None = None,
) -> None:
    """Write ``tensors`` (any device; copied to the host) to ``path``."""
    _require_little_endian()
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name here")
    items = sorted(
        tensors.items(), key=lambda kv: (-_ORDER.index(_NAMES[kv[1].dtype]), kv[0])
    )
    header: dict = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    blobs, offset = [], 0
    for name, t in items:
        data = t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {
            "dtype": _NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(data)],
        }
        blobs.append(data)
        offset += len(data)
    encoded = json.dumps(header, separators=(",", ":")).encode()
    encoded += b" " * (-len(encoded) % 8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(encoded)))
        f.write(encoded)
        for data in blobs:
            f.write(data)


def load_file(path: str | Path, device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Read every tensor of a safetensors file onto ``device``."""
    _require_little_endian()
    raw = Path(path).read_bytes()
    (length,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8 : 8 + length])
    header.pop("__metadata__", None)
    base = 8 + length
    out = {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        data = bytearray(raw[base + start : base + end])
        flat = torch.frombuffer(data, dtype=torch.uint8) if data else torch.empty(0, dtype=torch.uint8)
        out[name] = flat.view(_DTYPES[info["dtype"]]).reshape(info["shape"]).to(device)
    return out
