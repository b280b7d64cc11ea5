"""The port's boundary: it imports no JAX, no flax/optax/msgpack and
nothing of the JAX package, and its entry points default to CUDA and raise
without it."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import satellite_computervision_tpu_torch as port
from satellite_computervision_tpu_torch import predict as cli
from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.inference.batch import run_batch_prediction

ROOT = pathlib.Path(port.__file__).resolve().parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "satellite_computervision_tpu")


def _module(path):
    parts = path.relative_to(ROOT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = sorted(_module(p) for p in ROOT.rglob("*.py"))


def test_imports_with_jax_blocked():
    """Every module imports in a fresh interpreter whose meta-path refuses
    jax/flax/optax/msgpack and the JAX package."""
    code = f"""
import sys
BLOCKED = {BLOCKED!r}
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Blocker())
import importlib
for m in {MODULES!r}:
    importlib.import_module(m)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(sys.modules)
print("ok", len({MODULES!r}))
"""
    root = str(ROOT.parent)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok", str(len(MODULES))]


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")) + [ROOT.parent / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT if ROOT in p.parents else ROOT.parent)))
def test_no_jax_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, f"{path}: imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_defaults_to_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TiledInferenceEngine(lambda c: c)
    assert TiledInferenceEngine(lambda c: c, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("mode", ["scene", "sweep", "patches"])
def test_cli_defaults_to_cuda(no_cuda, tmp_path, mode):
    np.save(tmp_path / "s.npy", np.zeros((8, 8, 6), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([mode, "--input", str(tmp_path / "s.npy"), "--ckpt", str(tmp_path)])


def test_batch_prediction_defaults_to_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_batch_prediction(str(tmp_path), lambda x: x, ["B2"], str(tmp_path / "out"), "p")


def test_new_modules_are_covered():
    for name in ("inference.staging", "inference.batch", "inference.mixer",
                 "inference.writers", "train.flax_msgpack", "models.siamese",
                 "data.chip_generators", "models.deeplab", "inference.tune",
                 "train.evaluate", "evaluate"):
        assert f"satellite_computervision_tpu_torch.{name}" in MODULES
