"""Package boundaries of the port: what it imports, what importing does, and
how its kernel wrappers dispatch by device."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "transformers", "tokenizers", "safetensors", "open_provence_tpu")


def _run(code: str, env: dict | None = None) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=env,
    )


def test_port_imports_no_jax_stack():
    code = (
        "import sys\n"
        "import open_provence_tpu_torch, open_provence_tpu_torch.inference.engine\n"
        "import open_provence_tpu_torch.ops, open_provence_tpu_torch.kernels\n"
        "import open_provence_tpu_torch.utils.convert\n"
        f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_kernel_modules_import_and_run_plain_without_nvcc(tmp_path):
    """Importing builds nothing: with no nvcc reachable the kernel modules
    import, and CPU tensors take the plain versions without a build."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)  # no nvcc on it
    code = (
        "import torch\n"
        "from open_provence_tpu_torch import kernels\n"
        "from open_provence_tpu_torch.ops import layer_norm, ln_matmul, ln_geglu, flash_attention_packed\n"
        "x = torch.randn(4, 8, 128); s = torch.ones(128)\n"
        "layer_norm(x, s); ln_matmul(x.view(32, 128), s, torch.randn(384, 128))\n"
        "ln_geglu(x.view(32, 128), s, torch.randn(384, 128), 'gelu')\n"
        "flash_attention_packed(torch.randn(2, 8, 384), num_heads=2, padding_mask=None, window=None)\n"
        "assert kernels._lib is None\n"
        "assert set(kernels.launch_counts().values()) == {0}\n"
        "print('plain')\n"
    )
    proc = _run(code, env)
    assert proc.returncode == 0 and "plain" in proc.stdout, proc.stderr


def test_wrappers_refuse_other_devices():
    from open_provence_tpu_torch.ops import layer_norm

    x = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        layer_norm(x, torch.ones(4, device="meta"))


def test_build_names_library_by_source_hash():
    from open_provence_tpu_torch import kernels

    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR and path.suffix == ".so"
    assert path == kernels.library_path()  # stable for unchanged sources
    assert set(kernels.KERNELS) == {
        "layer_norm", "ln_matmul", "flash_attention_packed", "ln_geglu",
    }


def test_unported_bias_configs_raise():
    from open_provence_tpu_torch import ModernBertBackboneConfig, OpenProvenceConfig, build_module

    for flag in ("norm_bias", "attention_bias", "mlp_bias"):
        bb = ModernBertBackboneConfig(
            vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=1,
            num_attention_heads=2, **{flag: True},
        )
        config = OpenProvenceConfig(base_model_config=bb.to_dict(), max_length=32)
        with pytest.raises(NotImplementedError, match=flag):
            build_module(config)


def test_profiler_trace_writes_chrome_trace(tmp_path):
    from open_provence_tpu_torch.utils.tracing import profiler_trace

    with profiler_trace(None) as prof:
        assert prof is None
    with profiler_trace(str(tmp_path)) as prof:
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("matmul" in e.key or "dot" in e.key for e in prof.key_averages())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_cuda(cuda_device, dtype):
    """Each CUDA kernel against its plain version on the card, ragged sizes."""
    from open_provence_tpu_torch import kernels
    from open_provence_tpu_torch.ops import (
        attention_packed_plain, flash_attention_packed, layer_norm, layer_norm_plain,
        ln_geglu, ln_geglu_plain, ln_matmul, ln_matmul_plain, rope_tables,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)

    def t(*shape, s=1.0):
        return torch.tensor(rng.normal(size=shape) * s, dtype=dtype, device=cuda_device)

    tol = 1e-4 if dtype == torch.float32 else 3e-2
    x, scale = t(77, 768), t(768, s=0.1) + 1
    w, wi = t(2304, 768, s=0.03), t(2304, 768, s=0.03)
    kernels.reset_launch_counts()
    pairs = [
        (layer_norm(x, scale), layer_norm_plain(x, scale)),
        (ln_matmul(x, scale, w), ln_matmul_plain(x, scale, w)),
        (ln_geglu(x, scale, wi, "gelu"), ln_geglu_plain(x, scale, wi, "gelu")),
    ]
    qkv, mask = t(3, 200, 2304), torch.ones(3, 200, dtype=torch.int32, device=cuda_device)
    mask[1, 150:] = 0
    rope = rope_tables(200, 64, 10000.0, dtype, cuda_device)
    for window in (None, 64):
        kw = dict(num_heads=12, padding_mask=mask, window=window, rope=rope)
        valid = mask.bool()
        pairs.append(
            (flash_attention_packed(qkv, **kw)[valid], attention_packed_plain(qkv, **kw)[valid])
        )
    torch.cuda.synchronize()
    for got, want in pairs:
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert kernels.launch_counts() == {
        "layer_norm": 1, "ln_matmul": 1, "flash_attention_packed": 2, "ln_geglu": 1,
    }
