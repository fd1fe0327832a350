"""Standalone checkpoint bundles.

The reference's flagship portability property is that a checkpoint
directory is self-contained: the standalone modeling file is copied next to
the weights so the model runs without installing the package (reference
utils/modeling_export.py:8-14; encoder.py:993-1000). The JAX package
vendors its inference subset; the port does the same with its own:
``write_standalone_bundle`` copies the inference subset of
``open_provence_tpu_torch`` into ``<checkpoint>/open_provence_tpu_torch/``,
the CUDA sources of its kernels included, and writes the loader shim
``<checkpoint>/modeling_open_provence_tpu.py``, which needs only torch and
numpy (and a tokenizer).

No compiled code is copied: the kernel library builds from the bundle's
``kernels/csrc`` at first use on a Hopper card, into ``kernels.build_dir()``
(``$OPEN_PROVENCE_TPU_TORCH_BUILD_DIR``, else the bundle's own
``kernels/_build/`` when writable, else the user cache), and the host
library of ``native/`` builds with g++ beside its source, falling back to
its Python versions where that directory is not writable.

The shim keeps the JAX bundle's file name, because ``config.json``'s
``auto_map`` names ``modeling_open_provence_tpu.*`` in both packages'
exports: a checkpoint holds one shim, and writing the port's bundle
replaces a JAX bundle's shim (its ``open_provence_tpu/`` directory stays).
"""

from __future__ import annotations

import shutil
from pathlib import Path

_PACKAGE_ROOT = Path(__file__).resolve().parent.parent

# Inference-only subset: no train/ (a stub), no eval/.
_BUNDLE_INCLUDE = [
    "__init__.py",
    "configs.py",
    "data_structures.py",
    "encoder.py",
    "modeling_open_provence_tpu.py",
    "models",
    "ops",
    "text",
    "inference",
    "native",
    "kernels",
    "parallel/__init__.py",
    "parallel/mesh.py",
    "utils/__init__.py",
    "utils/convert.py",
    "utils/hf_convert.py",
    "utils/safetensors_io.py",
    "utils/tracing.py",
    "utils/modeling_export.py",
]

# Build outputs and caches: a bundle ships sources and builds them.
_IGNORE = shutil.ignore_patterns("_build", "__pycache__", "*.pyc", "*.so", "*.o", "*.tmp")

_SHIM = '''"""Self-contained loader for this OpenProvence checkpoint (PyTorch/CUDA).

Usage without installing the package:

    import modeling_open_provence_tpu as m
    model = m.OpenProvenceModel.from_pretrained(".")  # device="cpu" on a CPU
    result = model.process("question?", "context text...")

On a Hopper card the kernels build from open_provence_tpu_torch/kernels/csrc
at first use (nvcc from the CUDA toolkit).
"""

import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
if str(_HERE) not in sys.path:
    sys.path.insert(0, str(_HERE))

from open_provence_tpu_torch.configs import OpenProvenceConfig  # noqa: E402,F401
from open_provence_tpu_torch.encoder import OpenProvenceEncoder  # noqa: E402,F401
from open_provence_tpu_torch.inference import OpenProvenceModel  # noqa: E402,F401
from open_provence_tpu_torch.models.hf_wrappers import (  # noqa: E402,F401
    OpenProvenceForSequenceClassification,
    OpenProvenceForTokenClassification,
)
'''


def write_standalone_bundle(checkpoint_dir: str | Path) -> Path:
    """Vendor the inference package subset and the loader shim into a
    checkpoint directory; a refresh removes the vendored package first.
    Returns the shim's path."""
    checkpoint_dir = Path(checkpoint_dir)
    target_pkg = checkpoint_dir / "open_provence_tpu_torch"
    if target_pkg.exists():
        shutil.rmtree(target_pkg)
    for rel in _BUNDLE_INCLUDE:
        src = _PACKAGE_ROOT / rel
        dst = target_pkg / rel
        if src.is_dir():
            shutil.copytree(src, dst, ignore=_IGNORE)
        else:
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(src, dst)
    # encoder.py imports train.encoder_init lazily, only to build a model
    # from a backbone directory; a stub package keeps the bundle
    # inference-only but importable.
    (target_pkg / "train").mkdir(exist_ok=True)
    (target_pkg / "train" / "__init__.py").write_text(
        '"""Training is not included in standalone checkpoint bundles."""\n'
    )
    shim_path = checkpoint_dir / "modeling_open_provence_tpu.py"
    shim_path.write_text(_SHIM)
    return shim_path


def write_modeling_open_provence(source: Path, destination: Path) -> None:
    """Verbatim file copy (reference utils/modeling_export.py:8-14)."""
    destination.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy2(source, destination)
