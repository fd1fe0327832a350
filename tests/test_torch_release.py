"""The port's release surface on the CPU: the standalone checkpoint bundle
(``utils/modeling_export.py``) and the release CLIs
(``scripts/convert_checkpoint_torch.py``,
``scripts/hf_utils/{hf_model_process_check,update_standalone}_torch.py``,
``scripts/utils/sync_output_modeling_torch.py``).

* The bundle ships the port's inference subset with its kernels' CUDA
  sources and no compiled library, a stub ``train/`` and the loader shim;
  a refresh replaces the port's vendored package only.
* In a subprocess whose working directory is a copy of the checkpoint and
  whose ``sys.path`` lacks the repository, the shim loads the bundle, and
  ``process()`` there gives the in-repo port's result (the same text,
  scores within SCORE_ATOL) with neither ``jax`` nor
  ``open_provence_tpu`` imported.
* The four CLIs run on ``--device cpu``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from open_provence_tpu_torch import OpenProvenceEncoder, OpenProvenceModel
from open_provence_tpu_torch.utils.modeling_export import write_standalone_bundle

REPO = Path(__file__).resolve().parent.parent
SCORE_ATOL = 1e-6
QUESTION = "what about sushi ?"
CONTEXTS = ["sushi is a dish . budget is boring . kyoto has temples .",
            "the train station is near the river . rice and green tea ."]


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The toy ModernBERT backbone directory (fast tokenizer, config, no
    weights) and an OpenProvence checkpoint the port's encoder made of it."""
    assets = _load(REPO / "scripts" / "make_toy_assets.py")
    root = tmp_path_factory.mktemp("release")
    tokenizer, vocab_size = assets.build_tokenizer(root / "backbone")
    assets.build_backbone_dir(root / "backbone", vocab_size)
    encoder = OpenProvenceEncoder(root / "backbone", tokenizer=tokenizer, max_length=64,
                                  device="cpu", seed=3)
    return {"root": root, "backbone": root / "backbone", "tokenizer": tokenizer,
            "checkpoint": encoder.save_pretrained(root / "ckpt")}


def _files(directory: Path) -> set[str]:
    return {str(p.relative_to(directory)) for p in directory.rglob("*") if p.is_file()}


def test_bundle_ships_sources_and_no_build(exported, tmp_path, monkeypatch):
    """Bundled from a copy of the package that holds build outputs beside
    its sources (a built kernel library, the host library, objects)."""
    from open_provence_tpu_torch.utils import modeling_export

    package = tmp_path / "src" / "open_provence_tpu_torch"
    shutil.copytree(REPO / "open_provence_tpu_torch", package)
    for stray in ("kernels/_build/libopt_kernels_0.so", "kernels/_build/build.lock",
                  "native/libhost_ops.so", "kernels/csrc/unit.o", "ops/__pycache__/x.pyc"):
        (package / stray).parent.mkdir(parents=True, exist_ok=True)
        (package / stray).write_bytes(b"")
    monkeypatch.setattr(modeling_export, "_PACKAGE_ROOT", package)
    portable = tmp_path / "portable"
    shutil.copytree(exported["checkpoint"], portable)
    shim = write_standalone_bundle(portable)
    assert shim == portable / "modeling_open_provence_tpu.py"
    vendored = portable / "open_provence_tpu_torch"
    files = _files(vendored)
    sources = {p.name for p in (REPO / "open_provence_tpu_torch" / "kernels" / "csrc").iterdir()}
    assert {f"kernels/csrc/{name}" for name in sources} <= files
    assert any(name.endswith(".cu") for name in sources)
    assert {"native/host_ops.cpp", "inference/engine.py", "models/hf_wrappers.py",
            "utils/modeling_export.py", "modeling_open_provence_tpu.py"} <= files
    assert not [f for f in files if f.endswith((".so", ".o", ".pyc")) or "_build" in f
                or "__pycache__" in f]
    assert not any(f.startswith("eval/") for f in files)
    assert [f for f in files if f.startswith("train/")] == ["train/__init__.py"]
    # A refresh replaces the port's package and shim; a JAX bundle's stays.
    (portable / "open_provence_tpu").mkdir()
    (portable / "open_provence_tpu" / "__init__.py").write_text("")
    (vendored / "stale.py").write_text("")
    write_standalone_bundle(portable)
    assert not (vendored / "stale.py").exists()
    assert (portable / "open_provence_tpu" / "__init__.py").exists()
    assert "open_provence_tpu_torch" in shim.read_text()


BUNDLE_SCRIPT = """
import json, sys
import modeling_open_provence_tpu as m
model = m.OpenProvenceModel.from_pretrained(".", device="cpu", bucket_step=16)
result = model.process({question!r}, {contexts!r}, threshold=0.3, show_progress=False)
wrapper = m.OpenProvenceForSequenceClassification.from_pretrained(".", device="cpu")
logits = wrapper([5, 6, 7, 8]).logits
print(json.dumps({{
    "pruned": result["pruned_context"], "scores": result["reranking_score"],
    "logits": logits.flatten().tolist(),
    "package": sys.modules["open_provence_tpu_torch"].__file__,
    "imported": sorted(n for n in sys.modules
                       if n.split(".")[0] in ("jax", "flax", "open_provence_tpu")),
    "path": sys.path,
}}))
"""


def test_bundle_serves_without_the_repo(exported, tmp_path):
    portable = tmp_path / "portable"
    shutil.copytree(exported["checkpoint"], portable)
    write_standalone_bundle(portable)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", BUNDLE_SCRIPT.format(question=QUESTION, contexts=CONTEXTS)],
        cwd=portable, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    payload = json.loads(proc.stdout.strip().splitlines()[-1])
    assert payload["imported"] == []
    assert Path(payload["package"]).resolve().is_relative_to(portable.resolve())
    assert not any((portable / p).resolve() == REPO for p in payload["path"])

    model = OpenProvenceModel.from_pretrained(exported["checkpoint"], device="cpu",
                                              bucket_step=16)
    want = model.process(QUESTION, CONTEXTS, threshold=0.3, show_progress=False)
    assert payload["pruned"] == want["pruned_context"]
    np.testing.assert_allclose(payload["scores"], want["reranking_score"], atol=SCORE_ATOL,
                               rtol=0)
    from open_provence_tpu_torch.models.hf_wrappers import OpenProvenceForSequenceClassification

    direct = OpenProvenceForSequenceClassification.from_pretrained(exported["checkpoint"],
                                                                   device="cpu")
    np.testing.assert_allclose(payload["logits"], direct([5, 6, 7, 8]).logits.flatten(),
                               atol=SCORE_ATOL, rtol=0)


def test_convert_cli_and_process_check(exported, tmp_path, capsys):
    convert = _load(REPO / "scripts" / "convert_checkpoint_torch.py")
    out = tmp_path / "converted"
    assert convert.main(["--input", str(exported["backbone"]), "--output", str(out),
                         "--max-length", "64", "--default-threshold", "0.2", "--bundle",
                         "--device", "cpu"]) == 0
    config = json.loads((out / "config.json").read_text())
    assert config["model_type"] == "open_provence" and config["default_threadshold"] == 0.2
    assert (out / "modeling_open_provence_tpu.py").exists()
    assert (out / "open_provence_tpu_torch" / "kernels" / "csrc").is_dir()
    assert (out / "tokenizer.json").exists()
    # Re-converting the export keeps its weights bit for bit (fp32 on the way).
    again = tmp_path / "again"
    assert convert.main(["--input", str(out), "--output", str(again), "--max-length", "64",
                         "--device", "cpu"]) == 0
    from open_provence_tpu_torch.utils import safetensors_io

    first, second = (safetensors_io.load_file(d / "model.safetensors") for d in (out, again))
    assert first.keys() == second.keys()
    assert all(torch.equal(first[k], second[k]) for k in first)

    check = _load(REPO / "scripts" / "hf_utils" / "hf_model_process_check_torch.py")
    capsys.readouterr()
    assert check.main(["--model", str(out), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "5/5 cases passed" in printed
    for name in ("str", "list", "aligned", "nested", "titles"):
        assert f"✓ {name}" in printed


def test_update_standalone_local(exported, tmp_path):
    local = tmp_path / "local_repo"
    shutil.copytree(exported["checkpoint"], local)
    update = _load(REPO / "scripts" / "hf_utils" / "update_standalone_torch.py")
    assert update.main([str(local)]) == 0
    assert (local / "modeling_open_provence_tpu.py").exists()
    assert (local / "open_provence_tpu_torch" / "kernels" / "__init__.py").exists()


def test_sync_output_modeling(exported, tmp_path):
    out_root = tmp_path / "output" / "run1"
    shutil.copytree(exported["checkpoint"], out_root)
    config = json.loads((out_root / "config.json").read_text())
    config["splitter_default_language"] = "ja"
    (out_root / "config.json").write_text(json.dumps(config))
    other = tmp_path / "output" / "backbone_only"  # not an OpenProvence checkpoint
    shutil.copytree(exported["backbone"], other)
    sync = _load(REPO / "scripts" / "utils" / "sync_output_modeling_torch.py")
    assert sync.main(["--root", str(tmp_path / "output")]) == 0
    synced = json.loads((out_root / "config.json").read_text())
    assert "splitter_default_language" not in synced
    assert synced == {k: v for k, v in config.items() if k != "splitter_default_language"}
    assert (out_root / "modeling_open_provence_tpu.py").exists()
    assert not (other / "modeling_open_provence_tpu.py").exists()
    assert sync.main(["--root", str(tmp_path / "nothing_here")]) == 0
