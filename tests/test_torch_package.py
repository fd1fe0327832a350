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
        "import open_provence_tpu_torch.train, open_provence_tpu_torch.utils.safetensors_io\n"
        "import open_provence_tpu_torch.encoder, open_provence_tpu_torch.utils.hf_convert\n"
        "import open_provence_tpu_torch.train.encoder_init\n"
        "import open_provence_tpu_torch.train.data, open_provence_tpu_torch.train.runner\n"
        "import open_provence_tpu_torch.train.cli\n"
        "open_provence_tpu_torch.OpenProvenceEncoder\n"
        "open_provence_tpu_torch.OpenProvenceTrainer, open_provence_tpu_torch.OpenProvenceLoss\n"
        "open_provence_tpu_torch.OpenProvenceDataCollator, open_provence_tpu_torch.runner\n"
        f"bad = [m for m in {FORBIDDEN + ('yaml', 'datasets')!r} if m in sys.modules]\n"
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


def test_wrappers_skip_the_function_when_autograd_records_nothing():
    """Recording: each wrapper goes through its autograd Function. Under
    no_grad, or on inputs that need no gradient (serving), the same forward
    runs without it, with the same result."""
    from open_provence_tpu_torch import kernels
    from open_provence_tpu_torch.ops import (
        flash_attention_packed, layer_norm, ln_geglu, ln_matmul, rope_tables,
    )

    gen = torch.Generator().manual_seed(0)
    x, s = torch.randn(32, 128, generator=gen), torch.rand(128, generator=gen) + 0.5
    w, qkv = torch.randn(384, 128, generator=gen), torch.randn(2, 16, 384, generator=gen)
    mask = torch.ones(2, 16, dtype=torch.int32)
    mask[1, 10:] = 0
    rope = rope_tables(16, 64, 10000.0, torch.float32, torch.device("cpu"))
    calls = {
        "LayerNormFunction": lambda x, s, w, qkv: layer_norm(x, s),
        "LnMatmulFunction": lambda x, s, w, qkv: ln_matmul(x, s, w),
        "LnGegluFunction": lambda x, s, w, qkv: ln_geglu(x, s, w, "gelu"),
        "FlashAttentionPackedFunction": lambda x, s, w, qkv: flash_attention_packed(
            qkv, num_heads=2, padding_mask=mask, window=4, rope=rope),
    }
    for name, call in calls.items():
        leaves = [t.clone().requires_grad_() for t in (x, s, w, qkv)]
        recorded = call(*leaves)
        assert type(recorded.grad_fn).__name__ == f"{name}Backward", name
        kernels.reset_launch_counts()
        with torch.no_grad():
            direct = call(*leaves)
        assert direct.grad_fn is None and sum(kernels.plain_counts().values()) == 1, name
        torch.testing.assert_close(direct, recorded.detach(), rtol=0, atol=0)
        torch.testing.assert_close(call(x, s, w, qkv), direct, rtol=0, atol=0)


def test_build_names_library_by_source_hash():
    from open_provence_tpu_torch import kernels

    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR and path.suffix == ".so"
    assert path == kernels.library_path()  # stable for unchanged sources
    assert kernels.KERNELS == (
        "layer_norm", "ln_matmul", "flash_attention_packed", "ln_geglu",
        "layer_norm_bwd", "ln_geglu_bwd", "flash_attention_packed_bwd", "ln_matmul_bwd",
        "add_layer_norm", "geglu",
        "flash_attention", "flash_attention_bwd", "ln_geglu_wo", "ln_geglu_wo_bwd",
    )
    assert kernels.DEFAULT_PATH_KERNELS == kernels.KERNELS[:8]
    for name in (*kernels.SOURCES, *kernels.HEADERS):
        assert (kernels.CSRC / name).is_file(), name
    # Every file under csrc/ is hashed, the wgmma headers included, so an edit
    # to any of them rebuilds the library.
    assert {p.name for p in kernels.CSRC.iterdir()} == {*kernels.SOURCES, *kernels.HEADERS}
    assert {"hopper.cuh", "attention_wgmma.cuh"} <= set(kernels.HEADERS)
    # One nvcc unit a source, the attention sources also one per head dim.
    assert len(kernels.UNITS) == len(kernels.SOURCES) + 2 * len(kernels.ATTENTION_HEAD_DIMS)
    assert {src for src, _ in kernels.UNITS} == set(kernels.SOURCES)


def test_library_name_hashes_the_whole_recipe(monkeypatch):
    """The library's file name changes with the units (and their per-unit
    flags) and with every flag constant of the build, so no stale library is
    loaded after any of them changes; it stays the same otherwise. Nothing is
    built."""
    from open_provence_tpu_torch import kernels

    path = kernels.library_path()
    changed = {
        "UNITS": kernels.UNITS[:-1],
        "ARCH_FLAGS": ("-gencode", "arch=compute_90,code=sm_90"),
        "COMPILE_FLAGS": (*kernels.COMPILE_FLAGS, "-lineinfo"),
        "LINK_FLAGS": (*kernels.LINK_FLAGS, "-lcuda"),
    }
    seen = {path}
    for name, value in changed.items():
        with monkeypatch.context() as patch:
            patch.setattr(kernels, name, value)
            seen.add(kernels.library_path())
        assert kernels.library_path() == path, name
    assert len(seen) == 1 + len(changed)
    with monkeypatch.context() as patch:  # another set of head dims: other unit flags
        patch.setattr(kernels, "UNITS", tuple(
            (src, tuple(f.replace("=256", "=96") for f in flags)) for src, flags in kernels.UNITS))
        assert kernels.library_path() != path
    assert kernels._lib is None or kernels.library_path() == path


class _OnCard(torch.Tensor):
    """A CPU tensor that reports cuda:0 as its device, so the route a wrapper
    takes on a card can be checked where there is none."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("capability,name,takes_kernel", [
    ((9, 0), "NVIDIA H100 80GB HBM3", True),
    ((8, 0), "NVIDIA A100-SXM4-80GB", False),
    ((12, 0), "NVIDIA GeForce RTX 5090", False),
])
def test_only_a_hopper_card_takes_the_kernels(monkeypatch, capability, name, takes_kernel):
    """The route follows the card's compute capability, read once a card: a
    tensor on any card but (9, 0) raises in every wrapper, naming the card
    and its capability, and never runs the plain version there."""
    from open_provence_tpu_torch import kernels
    from open_provence_tpu_torch.ops import layer_norm, ln_matmul

    reads = []
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda index: reads.append(index) or capability)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda index: name)
    kernels.card_capability.cache_clear()
    try:
        x = torch.randn(4, 8, 32, generator=torch.Generator().manual_seed(0))
        on_card = x.as_subclass(_OnCard)
        assert on_card.device.type == "cuda"
        if takes_kernel:
            assert kernels.on_cuda(on_card) is True
            assert kernels.on_cuda(on_card) is True
        else:
            kernels.reset_launch_counts()
            scale = torch.ones(32)
            for call in (lambda: kernels.on_cuda(on_card),
                         lambda: layer_norm(on_card, scale),
                         lambda: ln_matmul(on_card.reshape(32, 32), scale, torch.randn(96, 32))):
                with pytest.raises(RuntimeError) as err:
                    call()
                message = str(err.value)
                assert name in message and f"{capability[0]}.{capability[1]}" in message
                assert "sm_90a" in message
            assert not any(kernels.plain_counts().values())
            assert not any(kernels.launch_counts().values())
        assert reads == [0]  # read once for the card
        assert kernels.on_cuda(x) is False  # a CPU tensor reads no capability
        assert reads == [0]
    finally:
        kernels.card_capability.cache_clear()


def test_library_path_under_the_override(tmp_path, monkeypatch):
    """OPEN_PROVENCE_TPU_TORCH_BUILD_DIR names the build directory; the
    library keeps its recipe-hash name. Nothing is built."""
    from open_provence_tpu_torch import kernels

    name = kernels.library_path().name
    monkeypatch.setenv(kernels.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    assert kernels.library_path() == tmp_path / "kernels" / name
    monkeypatch.delenv(kernels.BUILD_DIR_ENV)
    assert kernels.library_path().name == name


def test_library_path_leaves_a_read_only_package_directory(tmp_path, monkeypatch):
    """A package directory nobody may write to (an install into a read-only
    site-packages) sends the build to ~/.cache/open_provence_tpu_torch/
    kernels, lock included; a writable one keeps it in the package's
    _build/."""
    from open_provence_tpu_torch import kernels

    package = tmp_path / "site-packages" / "open_provence_tpu_torch" / "kernels"
    package.mkdir(parents=True)
    monkeypatch.setattr(kernels, "BUILD_DIR", package / "_build")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv(kernels.BUILD_DIR_ENV, raising=False)
    name = kernels.library_path().name
    assert kernels.library_path() == package / "_build" / name
    cache = tmp_path / "home" / ".cache" / "open_provence_tpu_torch" / "kernels"

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "nvcc_path", no_nvcc)
    package.chmod(0o555)
    try:
        assert kernels.library_path() == cache / name
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernels.build()
        assert (cache / "build.lock").is_file()
        assert not (package / "_build").exists()
    finally:
        package.chmod(0o755)


def test_pyproject_ships_the_ports_host_source():
    """An installed port carries native/host_ops.cpp, so its host library
    builds there too."""
    import tomllib

    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    package_data = data["tool"]["setuptools"]["package-data"]
    assert package_data["open_provence_tpu_torch.native"] == ["*.cpp"]
    assert (REPO / "open_provence_tpu_torch" / "native" / "host_ops.cpp").is_file()


def test_native_host_library_builds_where_gxx_is():
    import shutil

    from open_provence_tpu_torch import native

    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler on PATH to build the host library with")
    if os.environ.get("OPEN_PROVENCE_TPU_DISABLE_NATIVE"):
        pytest.skip("OPEN_PROVENCE_TPU_DISABLE_NATIVE is set")
    assert native.is_available()


def test_unported_bias_configs_raise():
    """The bias-carrying layouts build and run (they were refused until their
    kernels were ported), and so does backbone dropout in training (it
    raised until it was ported): what raises now is training-mode dropout
    without a generator to draw its masks from."""
    from open_provence_tpu_torch import ModernBertBackboneConfig, OpenProvenceConfig, build_module

    ids = torch.arange(1, 9).reshape(1, 8)
    for flag in ("norm_bias", "attention_bias", "mlp_bias"):
        bb = ModernBertBackboneConfig(
            vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
            num_attention_heads=2, **{flag: True},
        )
        config = OpenProvenceConfig(base_model_config=bb.to_dict(), max_length=32)
        module = build_module(config).eval()
        assert any(k.endswith(".bias") and "layers.1" in k for k in module.state_dict()), flag
        with torch.inference_mode():
            out = module(ids, torch.ones(1, 8, dtype=torch.int32))
        assert torch.isfinite(out["pruning_logits"]).all()
    bb = ModernBertBackboneConfig(
        vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=1,
        num_attention_heads=2, mlp_dropout=0.1,
    )
    module = build_module(OpenProvenceConfig(base_model_config=bb.to_dict(), max_length=32))
    with pytest.raises(ValueError, match="generator"):
        module.train()(ids, torch.ones(1, 8, dtype=torch.int32))
    out = module.train()(ids, torch.ones(1, 8, dtype=torch.int32), generator=torch.Generator())
    assert torch.isfinite(out["pruning_logits"]).all()


def test_host_ops_source_is_the_ports_own_copy():
    """The port builds its host library from a file inside its own package,
    byte for byte the JAX package's, so the two cannot drift unnoticed."""
    from open_provence_tpu_torch import native

    own = REPO / "open_provence_tpu_torch" / "native" / "host_ops.cpp"
    assert native._SOURCE == own
    assert own.read_bytes() == (REPO / "open_provence_tpu" / "native" / "host_ops.cpp").read_bytes()
    sources = list((REPO / "open_provence_tpu_torch").rglob("*.py"))
    opened = [p.name for p in sources if '"open_provence_tpu"' in p.read_text()]
    assert not opened, f"the port builds a path into the JAX package: {opened}"


def test_ln_adjoint_design_mirrors_the_source():
    """kernels.LN_ADJOINT_ROWS and LN_ADJOINT_REGISTER_WIDTHS are the rows a
    CTA takes (WARPS x ROWS_PER_WARP) and the register instance's widths
    (REGISTER_CHUNKS x CHUNK) as ln_adjoint.cuh defines them, so the
    wrappers' dscale scratch, ceil(M / ROWS) rows, is what the kernels
    write: a function of the shape alone. (The cuda-marked
    test_ln_adjoint_design_is_reported reads the built library's report.)"""
    import re

    from open_provence_tpu_torch import kernels

    source = (kernels.CSRC / "ln_adjoint.cuh").read_text()
    warps, rows_per_warp = re.search(
        r"constexpr int WARPS = (\d+), ROWS_PER_WARP = (\d+);", source).groups()
    chunk = int(re.search(r"constexpr int CHUNK = (\d+);", source)[1])
    chunks = re.search(r"REGISTER_CHUNKS\[\] = \{([\d, ]+)\}", source)[1]
    assert kernels.LN_ADJOINT_ROWS == int(warps) * int(rows_per_warp)
    assert kernels.LN_ADJOINT_REGISTER_WIDTHS == tuple(chunk * int(n) for n in chunks.split(","))
    for k in (768, 264):
        for m in (1, 64, 65, 16347):
            partial = kernels.ln_adjoint_partial(m, k, torch.device("cpu"))
            assert partial.shape == (-(-m // kernels.LN_ADJOINT_ROWS), k)
            assert partial.dtype == torch.float32


def test_mlp_tail_cluster_mirrors_the_source():
    """kernels.MLP_TAIL_OUT_COLS and MLP_TAIL_MAX_CLUSTER are the output
    columns a CTA of the bf16 whole-MLP forward owns and the widest cluster,
    as mlp_tail.cuh defines them (wgf::OUT_COLS, MAX_CLUSTER), so the
    cluster is ceil(K / 128) CTAs: six at the base width, eight at K = 1024,
    one up to 128; and the widest hidden size the wrappers send to the
    kernels is what that cluster covers. (The cuda-marked
    test_mlp_tail_design_is_reported reads the built library's report.)"""
    import re

    from open_provence_tpu_torch import kernels, ops
    from open_provence_tpu_torch.ops.geglu import GEGLU_WO_MAX_HIDDEN

    source = (kernels.CSRC / "mlp_tail.cuh").read_text()
    assert kernels.MLP_TAIL_OUT_COLS == int(
        re.search(r"constexpr int OUT_COLS = (\d+);", source)[1])
    assert kernels.MLP_TAIL_MAX_CLUSTER == int(
        re.search(r"constexpr int MAX_CLUSTER = (\d+);", source)[1])
    widths = {16: 1, 128: 1, 144: 2, 256: 2, 768: 6, 1008: 8, 1024: 8}
    assert {k: kernels.mlp_tail_cluster(k) for k in widths} == widths
    assert GEGLU_WO_MAX_HIDDEN == 1024
    assert ops.geglu_wo_supported(1024, 1152, torch.bfloat16, "gelu")
    assert not ops.geglu_wo_supported(1040, 1152, torch.bfloat16, "gelu")


@pytest.mark.cuda
def test_mlp_tail_design_is_reported(cuda_device):
    """The library's bf16 whole-MLP design at each hidden size the wrappers
    take: the forward's cluster of kernels.mlp_tail_cluster(K) CTAs of
    MLP_TAIL_OUT_COLS columns and 128 rows, a ring of at least two stages,
    and the backward row pass's tiles; a K past the widest cluster has none."""
    from open_provence_tpu_torch import kernels

    for k in (128, 256, 768, 1024, 144):
        built = kernels.built_mlp_tail_design(k)
        assert built["cluster"] == kernels.mlp_tail_cluster(k)
        assert built["out_cols"] == kernels.MLP_TAIL_OUT_COLS and built["rows"] == 128
        assert 2 <= built["stages"] <= 4 and built["bwd_tile"] == "192x64"
        assert built["clusters_at_once"] >= 1
    with pytest.raises(ValueError, match="no whole-MLP kernel"):
        kernels.built_mlp_tail_design(1040)


@pytest.mark.parametrize("hidden", [768, 1024, 264])
def test_ln_adjoint_aligned_copies_only_for_the_register_instance(hidden):
    """A tensor off a 16-byte boundary is copied (same values, aligned) at
    the register instance's widths and passed through at any other; an
    aligned one and None always pass through."""
    from open_provence_tpu_torch import kernels

    base = torch.arange(3 * hidden + 1, dtype=torch.float32)
    misaligned = base[1:].view(3, hidden)
    assert misaligned.data_ptr() % 16 and kernels.ln_adjoint_aligned(None, hidden) is None
    aligned = base[: 3 * hidden].view(3, hidden)
    assert kernels.ln_adjoint_aligned(aligned, hidden) is aligned
    got = kernels.ln_adjoint_aligned(misaligned, hidden)
    if hidden in kernels.LN_ADJOINT_REGISTER_WIDTHS:
        assert got is not misaligned and got.data_ptr() % 16 == 0
        assert torch.equal(got, misaligned)
    else:
        assert got is misaligned


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
    # A width past a whole tile (I = 100) and a K past the base model's.
    wi_ragged, x_wide, s_wide = t(200, 768, s=0.03), t(77, 1536), t(1536, s=0.1) + 1
    w_wide = t(200, 1536, s=0.03)
    kernels.reset_launch_counts()
    pairs = [
        (layer_norm(x, scale), layer_norm_plain(x, scale)),
        (ln_matmul(x, scale, w), ln_matmul_plain(x, scale, w)),
        (ln_matmul(x_wide, s_wide, w_wide), ln_matmul_plain(x_wide, s_wide, w_wide)),
        (ln_geglu(x, scale, wi, "gelu"), ln_geglu_plain(x, scale, wi, "gelu")),
        (ln_geglu(x, scale, wi_ragged, "silu"), ln_geglu_plain(x, scale, wi_ragged, "silu")),
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
        **dict.fromkeys(kernels.KERNELS, 0),
        "layer_norm": 1, "ln_matmul": 2, "flash_attention_packed": 2, "ln_geglu": 2,
        "flash_attention": 2,  # one kernel, counted under both names
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_layout_kernels_match_plain_on_cuda(cuda_device, dtype):
    """Kernels 6 and 7 and kernel 10 with gh against their plain versions on
    the card at ragged sizes; add + LN equals an add followed by kernel 1
    bit for bit, and gh = None gives kernel 10's bits."""
    from open_provence_tpu_torch import kernels, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)

    def t(*shape, s=1.0):
        return torch.tensor(rng.normal(size=shape) * s, dtype=dtype, device=cuda_device)

    tol = 1e-4 if dtype == torch.float32 else 3e-2
    x, y, scale = t(77, 768), t(77, 768), t(768, s=0.1) + 1
    wi, wi_ragged = t(2304, 768, s=0.03), t(200, 768, s=0.03)
    kernels.reset_launch_counts()
    for w, act in ((wi, "gelu"), (wi_ragged, "silu")):
        torch.testing.assert_close(ops.geglu(x, w, act).float(), ops.geglu_plain(x, w, act).float(),
                                   atol=tol, rtol=tol)
    h, n = ops.add_layer_norm(x, y, scale)
    h_plain, n_plain = ops.add_layer_norm_plain(x, y, scale)
    assert torch.equal(h, h_plain)
    torch.testing.assert_close(n.float(), n_plain.float(), atol=tol, rtol=tol)
    assert torch.equal(n, ops.layer_norm(x + y, scale))
    g, gh = t(77, 768), t(77, 768)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip(ops.layer_norm_bwd(h, scale, g, 1e-5, gh),
                         ops.layer_norm_bwd_plain(h, scale, g, 1e-5, gh)):
        torch.testing.assert_close(got.float(), want.float(), rtol=rel,
                                   atol=rel * want.float().abs().max().item())
    assert all(torch.equal(a, b) for a, b in zip(ops.layer_norm_bwd(h, scale, g, 1e-5, None),
                                                 ops.layer_norm_bwd(h, scale, g)))
    # Through autograd: the Functions launch the kernels in both directions.
    xg, yg, sg, wg = (v.clone().requires_grad_() for v in (x, y, scale, wi))
    hh, nn = ops.add_layer_norm(xg, yg, sg)
    (ops.geglu(nn, wg, "gelu").float().sum() + hh.float().sum()).backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in (xg, yg, sg, wg))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["geglu"] == 3 and counts["add_layer_norm"] == 2
    assert counts["layer_norm_bwd"] == 4 and counts["layer_norm"] == 1
    assert not any(kernels.plain_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("seq,batch", [(1024, 2), (2048, 1), (1100, 1)])
def test_attention_kernels_match_plain_at_long_context(cuda_device, seq, batch):
    """Kernels 3 and 14 past S = 512, window 64 and global, a ragged mask and
    (S = 1100) a ragged last tile, a padding row included, fp32."""
    from open_provence_tpu_torch import ops

    rng = np.random.default_rng(seq)
    dtype = torch.float32
    qkv = torch.tensor(rng.normal(size=(batch + 1, seq, 2304)), dtype=dtype, device=cuda_device)
    mask = torch.ones(batch + 1, seq, dtype=torch.int32, device=cuda_device)
    mask[0, seq - 333:] = 0
    mask[-1] = 0  # a padding pair
    valid = mask.bool()
    g = torch.tensor(rng.normal(size=(batch + 1, seq, 768)), dtype=dtype,
                     device=cuda_device) * mask[..., None]
    for window, theta in ((None, 160000.0), (64, 10000.0)):
        kw = dict(num_heads=12, padding_mask=mask, window=window,
                  rope=ops.rope_tables(seq, 64, theta, dtype, cuda_device))
        out, lse = ops.flash_attention_packed_lse(qkv, **kw)
        out_p, lse_p = ops.attention_packed_plain(qkv, **kw, return_lse=True)
        assert torch.isfinite(lse).all() and torch.isfinite(out).all()
        torch.testing.assert_close(out[valid], out_p[valid], atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(lse.transpose(1, 2)[valid], lse_p.transpose(1, 2)[valid],
                                   atol=1e-4, rtol=1e-4)
        got = ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw)
        want = ops.attention_packed_bwd_plain(qkv, g, out, lse, **kw)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


def _edge_mask(batch, seq, rng, short, device):
    """A key mask that is no prefix: rows valid to a random length (row 0
    full; with ``short`` all under seq/2), single padded keys scattered through
    them and, where it fits, a wholly padded stretch of 130 keys inside the
    valid run, so that at least one aligned 64-key tile holds no valid key."""
    lengths = (rng.integers(max(seq // 8, 1), max(seq // 2 - 1, 2), batch) if short
               else rng.integers(seq // 2, seq + 1, batch))
    if not short:
        lengths[0] = seq
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    mask[rng.random((batch, seq)) < 0.05] = 0
    for row, length in enumerate(lengths):
        if length >= 162:
            start = int(rng.integers(8, length - 138))
            mask[row, start:start + 130] = 0
    mask[:, 0] = 1
    return torch.tensor(mask, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,head_dim", [(24, 32), (12, 64), (6, 128), (3, 256)])
@pytest.mark.parametrize("batch,seq,short,padded_row", [
    (1, 65, False, False), (1, 513, False, False), (2, 1100, False, False), (3, 512, True, False),
    (2, 65, False, True), (2, 513, False, True), (2, 1100, False, True)])
def test_attention_kernels_match_plain_on_fragile_cases(cuda_device, dtype, heads, head_dim,
                                                        batch, seq, short, padded_row):
    """What tiles, an asynchronously filled ring and skipped key tiles make
    fragile: S that is no multiple of 64, B = 1, windows 0, 16, 128 and one
    past S beside global and 64, masks with holes and a wholly padded stretch,
    rows that are all short, a batch row that is all padding (what the dK/dV
    pass's key tiles of one pair of warpgroups at D = 128, or of the dV and dK
    CTAs at D = 256, and the rotation into scratch make fragile). Forward on
    valid rows and the backward (cotangent zero on padded rows) against the
    plain versions; the backward twice gives the same bits; no plain version
    runs."""
    from open_provence_tpu_torch import kernels, ops

    rng = np.random.default_rng(seq + head_dim)
    qkv = torch.tensor(rng.normal(size=(batch, seq, 2304)), dtype=dtype, device=cuda_device)
    mask = _edge_mask(batch, seq, rng, short, cuda_device)
    if padded_row:
        mask[-1] = 0
    valid = mask.bool()
    kernels.reset_launch_counts()
    g = torch.tensor(rng.normal(size=(batch, seq, 768)), dtype=dtype,
                     device=cuda_device) * mask[..., None].to(dtype)
    tol, grad_tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    for window in (None, 0, 16, 64, 128, seq + 7):
        kw = dict(num_heads=heads, padding_mask=mask, window=window,
                  rope=ops.rope_tables(seq, head_dim, 10000.0, dtype, cuda_device))
        out, lse = ops.flash_attention_packed_lse(qkv, **kw)
        out_p, lse_p = ops.attention_packed_plain(qkv, **kw, return_lse=True)
        assert torch.isfinite(lse).all() and torch.isfinite(out).all()
        torch.testing.assert_close(out[valid].float(), out_p[valid].float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse.transpose(1, 2)[valid], lse_p.transpose(1, 2)[valid],
                                   atol=1e-4, rtol=1e-4)
        got = ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw)
        want = ops.attention_packed_bwd_plain(qkv, g, out, lse, **kw).float()
        torch.testing.assert_close(got.float(), want, rtol=grad_tol,
                                   atol=grad_tol * want.abs().max().item())
        assert torch.equal(ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw), got)
    assert set(kernels.plain_counts().values()) == {0}


@pytest.mark.cuda
def test_attention_design_is_reported(cuda_device):
    """Which design each head dim's bf16 kernels run is fixed when the library
    is compiled and can be read back: wgmma from a cp.async ring with
    mbarriers at every head dim, both ways; the operands a call rotates into
    scratch first: K in the forward at D = 256, Q and K in the backward past
    D = 64, none elsewhere."""
    from open_provence_tpu_torch import kernels

    scratch = {(32, False): 0, (32, True): 0, (64, False): 0, (64, True): 0,
               (128, False): 0, (128, True): 2, (256, False): 1, (256, True): 2}
    for (head_dim, backward), operands in scratch.items():
        design = kernels.attention_design(head_dim, backward)
        assert design["products"] == "wgmma" and design["stages"] >= 2
        assert "cp.async" in design["fill"] and "mbarrier" in design["fill"]
        assert design["scratch"] == operands
        assert kernels.attention_scratch_operands(head_dim, backward) == operands
    with pytest.raises(ValueError):
        kernels.attention_design(48)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(64, 768), (16384 - 37, 200), (16384, 768)])
def test_gemm_engine_edges_match_plain_on_cuda(cuda_device, dtype, m, k):
    """Kernels 2, 4 and 6 against their plain versions where the GEMM
    engine's tiles make them fragile: M = 64 (B=1, S=64), a ragged M and
    M = 16384; an output width of one whole tile (256 columns; 128 under
    GeGLU) and ragged ones (452 and 100: no multiple of the tile or of 8);
    K = 768 and K = 200 (no multiple of 64); every GeGLU activation. In bf16
    two launches give the same bits, and kernel 4 gives kernel 6's bits on
    kernel 1's rows."""
    from open_provence_tpu_torch import kernels, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(m + k)

    def t(*shape, s=1.0):
        return torch.tensor(rng.normal(size=shape) * s, dtype=dtype, device=cuda_device)

    tol = 1e-4 if dtype == torch.float32 else 3e-2
    kernels.reset_launch_counts()
    x, scale = t(m, k, s=2.0), t(k, s=0.1) + 1
    xn, xn_kernel = ops.layer_norm_plain(x, scale), ops.layer_norm(x, scale)
    runs = []
    for n in (256, 452):
        w = t(n, k, s=k**-0.5)
        runs.append((lambda w=w: ops.ln_matmul(x, scale, w), ops.ln_matmul_plain(x, scale, w)))
    for inter in (128, 100):
        wi = t(2 * inter, k, s=k**-0.5)
        for act in ("gelu", "gelu_new", "relu", "silu"):
            runs.append((lambda wi=wi, act=act: ops.ln_geglu(x, scale, wi, act),
                         ops.ln_geglu_plain(x, scale, wi, act)))
            runs.append((lambda wi=wi, act=act: ops.geglu(xn, wi, act),
                         ops.geglu_plain(xn, wi, act)))
            if dtype == torch.bfloat16:
                assert torch.equal(ops.ln_geglu(x, scale, wi, act), ops.geglu(xn_kernel, wi, act))
    for kernel, want in runs:
        got = kernel()
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        if dtype == torch.bfloat16:
            assert torch.equal(got, kernel())
    assert not any(kernels.plain_counts().values())


@pytest.mark.cuda
def test_gemm_design_is_reported(cuda_device):
    """The route is fixed by type when the library is compiled: every bf16
    layout (the K-major x K-major product of kernels 2, 4, 6 and kernel 11's
    recomputed projection, dW = G^T.xn and dy = G.W of kernels 11 and 12) on
    wgmma fed by a TMA ring, and fp32 on FMA."""
    from open_provence_tpu_torch import kernels

    for ta, tb in ((False, False), (True, True), (False, True)):
        design = kernels.gemm_design(ta, tb, torch.bfloat16)
        assert design["products"] == "wgmma" and design["stages"] >= 2
        assert "TMA" in design["fill"] and "mbarrier" in design["fill"]
        assert kernels.gemm_design(ta, tb, torch.float32)["products"] == "fma"
    with pytest.raises(TypeError):
        kernels.gemm_design(False, False, torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_on_cuda(cuda_device, dtype):
    """Each backward kernel against its plain version on the card at ragged
    sizes (77 rows: partial GEMM and row tiles; S = 200: partial attention
    tiles), the tolerance a share of each output's largest value."""
    from open_provence_tpu_torch import kernels, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)

    def t(*shape, s=1.0):
        return torch.tensor(rng.normal(size=shape) * s, dtype=dtype, device=cuda_device)

    def close(got, want):
        rel = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=rel,
                                   atol=rel * want.float().abs().max().item())

    x, scale = t(77, 768, s=2.0), t(768, s=0.1) + 1
    w, wi = t(2304, 768, s=0.03), t(2304, 768, s=0.03)
    kernels.reset_launch_counts()
    g_ln, g_mm, g_mlp = t(77, 768), t(77, 2304, s=0.1), t(77, 1152, s=0.1)
    # Kernels 10, 12 and 11 end on the LN adjoint; each gives the same bits
    # twice.
    row_kernels = [
        (lambda: ops.layer_norm_bwd(x, scale, g_ln), ops.layer_norm_bwd_plain(x, scale, g_ln)),
        (lambda: ops.ln_matmul_bwd(x, scale, w, g_mm), ops.ln_matmul_bwd_plain(x, scale, w, g_mm)),
        (lambda: ops.ln_geglu_bwd(x, scale, wi, g_mlp, "gelu"),
         ops.ln_geglu_bwd_plain(x, scale, wi, g_mlp, "gelu")),
    ]
    cases = []
    for kernel, want in row_kernels:
        got = kernel()
        assert all(torch.equal(a, b) for a, b in zip(got, kernel()))
        cases.append((got, want))
    qkv, mask = t(3, 200, 2304), torch.ones(3, 200, dtype=torch.int32, device=cuda_device)
    mask[1, 150:] = 0
    g = t(3, 200, 768) * mask[..., None].to(dtype)
    rope = ops.rope_tables(200, 64, 10000.0, dtype, cuda_device)
    for window in (None, 64):
        kw = dict(num_heads=12, padding_mask=mask, window=window, rope=rope)
        out, lse = ops.flash_attention_packed_lse(qkv, **kw)
        cases.append(((ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw),),
                      (ops.attention_packed_bwd_plain(qkv, g, out, lse, **kw),)))
    torch.cuda.synchronize()
    for got, want in cases:
        for a, b in zip(got, want):
            close(a, b)
    counts = kernels.launch_counts()
    assert counts["layer_norm_bwd"] == counts["ln_matmul_bwd"] == counts["ln_geglu_bwd"] == 2
    assert counts["flash_attention_packed_bwd"] == 2
    assert not any(kernels.plain_counts().values())


# |kernel - plain| <= a·max|plain| + r·|plain| for the LN adjoint (as
# chip_smoke.py's BWD_TOL): fp32 differs by summation order only; in bf16 a
# sum beside a rounding boundary can round one ulp apart.
LN_ADJOINT_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [768, 1024, 264, 36])
def test_ln_adjoint_matches_plain_on_cuda(cuda_device, dtype, k):
    """Kernel 10 against its plain version at the widths of its register
    instances (768, 1024) and two strided ones (264, 36), at M = 1, 32 and
    16347 (a ragged last CTA), without gh and with it; two launches give the
    same bits, and a null gh the form without gh's; no plain version runs."""
    from open_provence_tpu_torch import kernels, ops

    rng = np.random.default_rng(k)

    def t(*shape, s=1.0):
        return torch.tensor(rng.normal(size=shape) * s, dtype=dtype, device=cuda_device)

    a, r = LN_ADJOINT_TOL[dtype]
    x, scale = t(16347, k, s=2.0), t(k, s=0.1) + 1
    kernels.reset_launch_counts()
    for m in (1, 32, 16347):
        g, gh = t(m, k), t(m, k)
        for extra in (None, gh):
            got = ops.layer_norm_bwd(x[:m], scale, g, 1e-5, extra)
            for out, want in zip(got, ops.layer_norm_bwd_plain(x[:m], scale, g, 1e-5, extra)):
                assert torch.isfinite(out).all()
                torch.testing.assert_close(out.float(), want.float(), rtol=r,
                                           atol=a * want.float().abs().max().item())
            assert all(torch.equal(p, q) for p, q in
                       zip(got, ops.layer_norm_bwd(x[:m], scale, g, 1e-5, extra)))
        assert all(torch.equal(p, q) for p, q in zip(ops.layer_norm_bwd(x[:m], scale, g),
                                                     ops.layer_norm_bwd(x[:m], scale, g, 1e-5)))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["layer_norm_bwd"] == 18
    assert not any(kernels.plain_counts().values())


@pytest.mark.cuda
def test_ln_adjoint_design_is_reported(cuda_device):
    """The library's LN-adjoint design at each shape: the register instance
    at kernels.LN_ADJOINT_REGISTER_WIDTHS and the strided one elsewhere, and
    the partial rows the wrappers' scratch (ln_adjoint_partial) holds, a
    function of the shape alone."""
    from open_provence_tpu_torch import kernels

    for k in (768, 1024, 264, 36, 2048):
        registers = k in kernels.LN_ADJOINT_REGISTER_WIDTHS
        for m in (1, 32, 64, 65, 16347, 16384):
            built = kernels.built_ln_adjoint_design(m, k)
            assert built["instance"] == ("registers" if registers else "strided")
            assert built["cta_rows"] == kernels.LN_ADJOINT_ROWS
            assert built["chunks"] == (k // 256 if registers else 0)
            assert kernels.ln_adjoint_partial(m, k, cuda_device).shape == (built["parts"], k)


def _off_relu_step(x, scale, wi, g):
    """g with 0 where the card's inp (kernel 2 on the whole wi: the bits of
    kernel 11's recomputed projection) and the plain version's fall on either
    side of relu's step, where relu' may be 1 on one side and 0 on the other."""
    from open_provence_tpu_torch import ops

    inter = g.shape[1]
    acc = torch.promote_types(g.dtype, torch.float32)
    inp_plain = (ops.layer_norm_plain(x, scale).to(acc) @ wi.to(acc).t()).to(g.dtype)
    inp_card = ops.ln_matmul(x, scale, wi)
    return g.masked_fill((inp_card[:, :inter] > 0) != (inp_plain[:, :inter] > 0), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [64, 77, 16384 - 37, 16384])
@pytest.mark.parametrize("k", [768, 200])
def test_backward_gemm_edges_match_plain_on_cuda(cuda_device, dtype, m, k):
    """Kernels 12 and 11 against their plain versions where the transposed
    products' tiles and the dW split over rows make them fragile: M = 64
    (less than one chunk), 77 (a ragged k-step), 16384 - 37 (a ragged last
    chunk) and 16384; dW row counts of one whole tile (256; 2I = 256) and
    ragged ones (456; 2I = 464); K = 768 and 200; every GeGLU activation
    (under relu the cotangent is 0 where the card and the plain version put
    inp on either side of the step). The tolerance is a share of each
    output's largest value. In bf16 two launches give the same bits. Each
    call is one launch of its kernel and no plain version runs."""
    from open_provence_tpu_torch import kernels, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(m + k)

    def t(*shape, s=1.0):
        return torch.tensor(rng.normal(size=shape) * s, dtype=dtype, device=cuda_device)

    rel = 1e-4 if dtype == torch.float32 else 2e-2
    x, scale = t(m, k, s=2.0), t(k, s=0.1) + 1
    runs = []
    for n in (256, 456):
        w, g = t(n, k, s=k**-0.5), t(m, n, s=0.1)
        runs.append(("ln_matmul_bwd", lambda w=w, g=g: ops.ln_matmul_bwd(x, scale, w, g),
                     ops.ln_matmul_bwd_plain(x, scale, w, g)))
    for inter in (128, 232):
        wi, g = t(2 * inter, k, s=k**-0.5), t(m, inter, s=0.1)
        for act in ("gelu", "gelu_new", "relu", "silu"):
            g_act = _off_relu_step(x, scale, wi, g) if act == "relu" else g
            runs.append(("ln_geglu_bwd",
                         lambda wi=wi, g=g_act, act=act: ops.ln_geglu_bwd(x, scale, wi, g, act),
                         ops.ln_geglu_bwd_plain(x, scale, wi, g_act, act)))
    for name, kernel, want in runs:
        kernels.reset_launch_counts()
        got = kernel()
        assert kernels.launch_counts()[name] == 1 and not any(kernels.plain_counts().values())
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=rel,
                                       atol=rel * b.float().abs().max().item())
        if dtype == torch.bfloat16:
            assert all(torch.equal(a, b) for a, b in zip(got, kernel()))


@pytest.mark.cuda
def test_trainer_keeps_cuda_params_on_the_card(cuda_device, tmp_path):
    """Parameters on the card and no device=: the trainer steps there,
    through all eight kernels and no plain version. (Here, not beside the
    JAX parity tests, so that it runs where only torch is installed.)"""
    import importlib.util

    from open_provence_tpu_torch import (
        ModernBertBackboneConfig, OpenProvenceConfig, init_params, kernels,
    )
    from open_provence_tpu_torch.train import OpenProvenceDataCollator, OpenProvenceTrainer

    spec = importlib.util.spec_from_file_location(
        "dummy_tokenizers", REPO / "tests" / "dummy_tokenizers.py")
    tokenizers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tokenizers)
    bb = ModernBertBackboneConfig(
        vocab_size=256, hidden_size=128, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, local_attention=64, pad_token_id=0, num_labels=1,
    )
    config = OpenProvenceConfig(base_model_config=bb.to_dict(), num_labels=1, max_length=128,
                                pruning_config={"hidden_size": 128, "classifier_dropout": 0.1})
    rows = [{"query": "q", "texts": ["abc def. ghi."], "context_spans": [[[0, 8], [9, 13]]],
             "context_spans_relevance": [[1, 0]], "labels": [1], "teacher_score": [0.8]}]
    batch = OpenProvenceDataCollator(
        tokenizer=tokenizers.PairDummyTokenizer(), max_length=128,
        scores_column="teacher_score", chunks_pos_column="context_spans",
        relevant_chunks_column="context_spans_relevance", pad_pairs_to=2,
    )(rows)
    params = {k: v.to(cuda_device) for k, v in
              init_params(config, torch.Generator().manual_seed(0)).items()}
    trainer = OpenProvenceTrainer(config, params, tokenizers.PairDummyTokenizer(),
                                  output_dir=tmp_path, bf16=False)
    assert trainer.device.type == "cuda"
    assert all(p.is_cuda for p in trainer.params.values())
    kernels.reset_launch_counts()
    assert np.isfinite(trainer.train_one_step(batch)["loss"])
    counts = kernels.launch_counts()
    assert min(counts[name] for name in kernels.DEFAULT_PATH_KERNELS) > 0, counts
    assert not any(kernels.plain_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,head_dim", [(24, 32), (12, 64), (6, 128), (3, 256)])
@pytest.mark.parametrize("batch,seq", [(3, 200), (4, 512)])
def test_unpacked_attention_kernels_match_plain_on_cuda(cuda_device, dtype, heads, head_dim,
                                                        batch, seq):
    """Kernels 9 and 16 against their plain versions on the card, every head
    layout of width 768, at a ragged S = 200 and at the serving S = 512:
    contiguous [B, H, S, D] tensors and strided views of a packed buffer give
    the same bits, and so does the packed wrapper."""
    from open_provence_tpu_torch import kernels, ops

    rng = np.random.default_rng(seq + head_dim)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype, device=cuda_device)

    rel = 1e-4 if dtype == torch.float32 else 2e-2
    fwd_tol = 1e-4 if dtype == torch.float32 else 3e-2
    qkv = t(batch, seq, 3 * heads * head_dim)
    mask = torch.ones(batch, seq, dtype=torch.int32, device=cuda_device)
    mask[1, seq - 50:] = 0
    mask[-1] = 0  # a padding row
    valid = mask.bool()
    g_packed = t(batch, seq, heads * head_dim) * mask[..., None].to(dtype)
    g = g_packed.view(batch, seq, heads, head_dim).transpose(1, 2)
    views = ops.packed_views(qkv, heads)
    q, k, v = (x.contiguous() for x in views)
    kernels.reset_launch_counts()
    for window, theta in ((None, 160000.0), (64, 10000.0)):
        kw = dict(padding_mask=mask, window=window,
                  rope=ops.rope_tables(seq, head_dim, theta, dtype, cuda_device))
        out, lse = ops.flash_attention_lse(q, k, v, **kw)
        out_p, lse_p = ops.attention_unpacked_plain(q, k, v, **kw, return_lse=True)
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        rows = valid[:, None, :].expand(batch, heads, seq)
        torch.testing.assert_close(out[rows].float(), out_p[rows].float(), atol=fwd_tol,
                                   rtol=fwd_tol)
        torch.testing.assert_close(lse[rows], lse_p[rows], atol=1e-4, rtol=1e-4)
        grads = ops.flash_attention_bwd(q, k, v, g, out, lse, **kw)
        wants = ops.attention_unpacked_bwd_plain(q, k, v, g, out, lse, **kw)
        for got, want in zip(grads, wants):
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got.float(), want.float(), rtol=rel,
                                       atol=rel * want.float().abs().max().item())
        # Strided views of the packed buffer: the same bits.
        out_v, lse_v = ops.flash_attention_lse(*views, **kw)
        assert torch.equal(out_v, out) and torch.equal(lse_v, lse)
        for got, want in zip(ops.flash_attention_bwd(*views, g, out_v, lse_v, **kw), grads):
            assert torch.equal(got, want)
        # The packed wrapper on the buffer: the same bits.
        merged = torch.cat([x.transpose(1, 2).reshape(batch, seq, -1) for x in grads], dim=-1)
        pkw = dict(num_heads=heads, **kw)
        out_k, lse_k = ops.flash_attention_packed_lse(qkv, **pkw)
        assert torch.equal(out_k.view(batch, seq, heads, head_dim).transpose(1, 2), out)
        assert torch.equal(lse_k, lse)
        assert torch.equal(ops.flash_attention_packed_bwd(qkv, g_packed, out_k, lse_k, **pkw),
                           merged)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 6 and counts["flash_attention_bwd"] == 6
    assert counts["flash_attention_packed"] == 6 and counts["flash_attention_packed_bwd"] == 6
    assert not any(kernels.plain_counts().values())
    # Through autograd: the model's one call.
    leaf = qkv.clone().requires_grad_()
    ops.flash_attention_packed(leaf, num_heads=heads, padding_mask=mask, window=64,
                               rope=kw["rope"]).float().mul(g_packed.float()).sum().backward()
    assert torch.equal(leaf.grad, merged)
    after = kernels.launch_counts()
    assert after["flash_attention"] == 7 and after["flash_attention_bwd"] == 7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,inter,act", [(77, 128, 72, "silu"), (1000, 768, 1152, "gelu"),
                                           (130, 1024, 200, "gelu_new"), (64, 256, 64, "relu"),
                                           (1000, 1024, 1152, "silu"),
                                           (16347, 768, 1152, "gelu")])
def test_whole_mlp_kernels_match_plain_on_cuda(cuda_device, dtype, m, k, inter, act):
    """Kernels 8 and 13 against their plain versions on the card: a small
    ragged shape, the base width, the widest K (a cluster of eight CTAs in
    bf16, at a short I and at the full one), the base width with a ragged
    last row tile, and every activation; the backward gives the same bits
    twice; the Function launches both."""
    from open_provence_tpu_torch import kernels, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(m)

    def t(*shape, s=1.0):
        return torch.tensor(rng.normal(size=shape) * s, dtype=dtype, device=cuda_device)

    x, scale = t(m, k, s=2.0), t(k, s=0.1) + 1
    wi, wo, g = t(2 * inter, k, s=k**-0.5), t(k, inter, s=inter**-0.5), t(m, k, s=0.1)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    kernels.reset_launch_counts()
    out = ops.ln_geglu_wo(x, scale, wi, wo, act)
    torch.testing.assert_close(out.float(), ops.ln_geglu_wo_plain(x, scale, wi, wo, act).float(),
                               atol=tol, rtol=tol)
    grads = ops.ln_geglu_wo_bwd(x, scale, wi, wo, g, act)
    for got, want in zip(grads, ops.ln_geglu_wo_bwd_plain(x, scale, wi, wo, g, act)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=rel,
                                   atol=rel * want.float().abs().max().item())
    assert all(torch.equal(a, b)
               for a, b in zip(grads, ops.ln_geglu_wo_bwd(x, scale, wi, wo, g, act)))
    for fuse_forward in (True, False):
        leaves = [v.clone().requires_grad_() for v in (x, scale, wi, wo)]
        ops.ln_geglu_wo(*leaves, act, fuse_forward=fuse_forward).backward(g)
        assert all(torch.equal(leaf.grad, want) for leaf, want in zip(leaves, grads))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["ln_geglu_wo"] == 2 and counts["ln_geglu_wo_bwd"] == 4
    assert counts["ln_geglu"] == 1 and not any(kernels.plain_counts().values())


@pytest.mark.cuda
def test_new_wrappers_raise_where_no_kernel_instance_exists(cuda_device):
    """A dtype or a head dim the kernels have no instance for raises on the
    card; nothing falls back to a plain version."""
    from open_provence_tpu_torch import kernels, ops

    half = dict(dtype=torch.float16, device=cuda_device)
    q = torch.zeros(1, 2, 64, 64, **half)
    kernels.reset_launch_counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q, q, q, padding_mask=None, window=None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.ln_geglu_wo(torch.zeros(8, 64, **half), torch.ones(64, **half),
                        torch.zeros(128, 64, **half), torch.zeros(64, 64, **half), "gelu")
    q48 = torch.zeros(1, 2, 64, 48, device=cuda_device)
    with pytest.raises(ValueError, match="instantiated for head_dim"):
        ops.flash_attention(q48, q48, q48, padding_mask=None, window=None)
    with pytest.raises(ValueError, match="instantiated for head_dim"):
        ops.multi_head_attention(q48, q48, q48, padding_mask=None, window=None)
    with pytest.raises(ValueError, match="instantiated for head_dim"):
        ops.flash_attention_packed(torch.zeros(1, 64, 3 * 2 * 48, device=cuda_device),
                                   num_heads=2, padding_mask=None, window=None)
    with pytest.raises(ValueError, match="whole-MLP kernels"):
        ops.ln_geglu_wo(torch.zeros(8, 2048, device=cuda_device),
                        torch.ones(2048, device=cuda_device),
                        torch.zeros(128, 2048, device=cuda_device),
                        torch.zeros(2048, 64, device=cuda_device), "gelu")
    assert not any(kernels.launch_counts().values())
    assert not any(kernels.plain_counts().values())


@pytest.mark.cuda
def test_from_pretrained_serves_on_the_card_through_the_kernels(cuda_device, tmp_path):
    """A checkpoint written by the encoder's save_pretrained, served by
    OpenProvenceModel.from_pretrained and by the encoder on the card: the
    four forward kernels launch and no plain version runs."""
    import importlib.util

    from open_provence_tpu_torch import (
        ModernBertBackboneConfig, OpenProvenceConfig, OpenProvenceEncoder, OpenProvenceModel,
        init_params, kernels,
    )

    spec = importlib.util.spec_from_file_location(
        "dummy_tokenizers", REPO / "tests" / "dummy_tokenizers.py")
    tokenizers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tokenizers)
    bb = ModernBertBackboneConfig(
        vocab_size=512, hidden_size=128, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, local_attention=64, pad_token_id=0, num_labels=1,
    )
    config = OpenProvenceConfig(base_model_config=bb.to_dict(), num_labels=1, max_length=128,
                                pruning_config={"hidden_size": 128, "classifier_dropout": 0.0})
    sd = init_params(config, torch.Generator().manual_seed(0))
    OpenProvenceEncoder(config=config, state_dict=sd, tokenizer=tokenizers.PairDummyTokenizer(),
                        device="cpu").save_pretrained(tmp_path)
    model = OpenProvenceModel.from_pretrained(tmp_path, tokenizer=tokenizers.DummyTokenizer())
    assert model.device.type == "cuda"
    assert model.module.ranking_model.classifier.weight.dtype == torch.bfloat16
    encoder = OpenProvenceEncoder.from_pretrained(tmp_path,
                                                  tokenizer=tokenizers.PairDummyTokenizer())
    context = "First sentence about sushi. Second one about work. Third about plants."
    kernels.reset_launch_counts()
    result = model.process("what food?", context, threshold=0.0, show_progress=False)
    scores = encoder.predict([("what food?", context), ("why?", "Because.")])
    torch.cuda.synchronize()
    assert result["pruned_context"] == context and np.isfinite(scores).all()
    counts = kernels.launch_counts()
    assert min(counts[name] for name in kernels.DEFAULT_PATH_KERNELS[:4]) > 0, counts
    assert not any(kernels.plain_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [8192 - 37, 16384])
def test_kernels_match_plain_at_the_tensor_parallel_shard(cuda_device, dtype, m):
    """Kernels 2, 3, 4, 11, 12 and 14 at the widths a rank of a tp = 2 mesh
    gives them at base width: Wqkv's 1152 rows (6 heads of 64; the wgmma
    engine's 256-column tiles leave a partial last one), the MLP's 576
    intermediate columns (Wi's 1152 rows), attention on 6 heads of a
    [B, S, 1152] packed buffer (B = m // 512 rows, ragged, one padding
    row), each forward and backward against its plain version; no plain
    version runs on the card's tensors."""
    from open_provence_tpu_torch import kernels, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(m)

    def t(*shape, s=1.0):
        return torch.tensor(rng.normal(size=shape) * s, dtype=dtype, device=cuda_device)

    tol, grad_tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    x, scale = t(m, 768, s=2.0), t(768, s=0.1) + 1
    w_qkv, w_i = t(1152, 768, s=768**-0.5), t(1152, 768, s=768**-0.5)
    g_qkv, g_mlp = t(m, 1152, s=0.1), t(m, 576, s=0.1)
    kernels.reset_launch_counts()
    pairs = [(ops.ln_matmul(x, scale, w_qkv), ops.ln_matmul_plain(x, scale, w_qkv)),
             (ops.ln_geglu(x, scale, w_i, "gelu"), ops.ln_geglu_plain(x, scale, w_i, "gelu"))]
    grads = [*zip(ops.ln_matmul_bwd(x, scale, w_qkv, g_qkv),
                  ops.ln_matmul_bwd_plain(x, scale, w_qkv, g_qkv)),
             *zip(ops.ln_geglu_bwd(x, scale, w_i, g_mlp, "gelu"),
                  ops.ln_geglu_bwd_plain(x, scale, w_i, g_mlp, "gelu"))]
    batch = max(m // 512, 2)
    qkv = t(batch, 512, 1152)
    lengths = rng.integers(256, 513, batch)
    mask = torch.tensor(np.arange(512)[None] < lengths[:, None], dtype=torch.int32,
                        device=cuda_device)
    mask[-1] = 0
    valid = mask.bool()
    g = t(batch, 512, 384) * mask[..., None].to(dtype)
    for window, theta in ((None, 160000.0), (64, 10000.0)):
        kw = dict(num_heads=6, padding_mask=mask, window=window,
                  rope=ops.rope_tables(512, 64, theta, dtype, cuda_device))
        out, lse = ops.flash_attention_packed_lse(qkv, **kw)
        pairs.append((out[valid], ops.attention_packed_plain(qkv, **kw)[valid]))
        grads.append((ops.flash_attention_packed_bwd(qkv, g, out, lse, **kw),
                      ops.attention_packed_bwd_plain(qkv, g, out, lse, **kw)))
    torch.cuda.synchronize()
    for got, want in pairs:
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for got, want in grads:
        want = want.float()
        torch.testing.assert_close(got.float(), want, rtol=grad_tol,
                                   atol=grad_tol * want.abs().max().item())
    launched = kernels.launch_counts()
    assert all(launched[name] > 0 for name in (
        "ln_matmul", "ln_geglu", "flash_attention_packed", "ln_matmul_bwd", "ln_geglu_bwd",
        "flash_attention_packed_bwd"))
    assert set(kernels.plain_counts().values()) == {0}
