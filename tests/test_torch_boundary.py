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
from satellite_computervision_tpu_torch import change_convergence
from satellite_computervision_tpu_torch import change_detection_end_to_end as change_twin
from satellite_computervision_tpu_torch import multistate_sweep as sweep_twin
from satellite_computervision_tpu_torch import (
    parking_convergence,
    solar_convergence,
    swath_codec_sweep,
)
from satellite_computervision_tpu_torch import predict as cli
from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.cloud import compositing, pc
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.inference.batch import run_batch_prediction
from satellite_computervision_tpu_torch.parallel import initialize_distributed
from satellite_computervision_tpu_torch.parallel.spatial import make_spatial_inference
from satellite_computervision_tpu_torch.train import __main__ as train_cli

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


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")) + [ROOT.parent / "chip_smoke.py",
                                                               ROOT.parent / "convergence_runs.py"],
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


@pytest.mark.parametrize("twin", [change_twin, sweep_twin, solar_convergence, swath_codec_sweep,
                                  change_convergence, parking_convergence],
                         ids=["change", "multistate", "solar_convergence", "swath_codec_sweep",
                              "change_convergence", "parking_convergence"])
def test_twins_default_to_cuda(no_cuda, twin):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.main([])


def test_compositing_defaults_to_cuda(no_cuda):
    stack = np.ones((2, 4, 4, 3), np.float32)
    items = [{"datetime": "2021-06-01", "bands": {"B02": np.ones((4, 4), np.float32)}}]
    for call in (lambda: compositing.median_composite(stack),
                 lambda: compositing.normalize_composite(stack[0]),
                 lambda: compositing.composite_stack(stack),
                 lambda: compositing.composite_items(items, ["B02"]),
                 lambda: compositing.change_pair_composite(items, items, ["B02"]),
                 lambda: pc.predict_scene(stack[0], lambda c: c)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert compositing.median_composite(stack, device="cpu").device.type == "cpu"


def test_new_modules_are_covered():
    for name in ("inference.staging", "inference.batch", "inference.mixer",
                 "inference.writers", "train.flax_msgpack", "models.siamese",
                 "data.chip_generators", "models.deeplab", "inference.tune",
                 "train.evaluate", "evaluate", "models.convlstm", "models.acnn",
                 "models.hybrid", "ops.harmonics", "cloud", "cloud.masking",
                 "cloud.compositing", "cloud.calibration", "cloud.pc", "cloud.ee",
                 "cloud.blob", "geo.crs", "geo.transforms", "geo.assembly", "ops.bands",
                 "ops.stats", "change_detection_end_to_end", "multistate_sweep", "parallel",
                 "parallel.mesh", "parallel.data_parallel", "parallel.sharded_inference",
                 "parallel.spatial", "train.retrain", "train.keras_import",
                 "train.keras_export", "export", "ops.chips", "data.matching", "testing",
                 "utils", "utils.profiling", "utils.logging", "utils.viz", "compat",
                 "convergence_common", "solar_convergence", "swath_codec_sweep",
                 "change_convergence", "parking_convergence"):
        assert f"satellite_computervision_tpu_torch.{name}" in MODULES


def test_parallel_entry_points_default_to_cuda(no_cuda, tmp_path):
    """initialize_distributed and the spatial engine raise without CUDA
    unless the CPU is asked for; the train CLI with its new flags too."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_distributed(f"file://{tmp_path / 'pg'}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_spatial_inference(lambda c: c, mesh=None, blend="hann")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--config", "solar", "--train", str(tmp_path / "x"), "--remat",
                        "--orbax"])
    assert not dist.is_initialized()
    initialize_distributed(None, device="cpu")  # no coordinator: nothing to join
    assert not dist.is_initialized()


def test_optional_packages_are_imported_in_functions_only():
    """h5py (the .h5 bridge), matplotlib and PIL (utils.viz) may be absent
    on a card host: every module imports with them refused."""
    code = f"""
import sys
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("h5py", "matplotlib", "PIL"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Blocker())
import importlib
for m in {MODULES!r}:
    importlib.import_module(m)
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT.parent),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok"]


def test_h5_entry_points_default_to_cuda(no_cuda, tmp_path):
    """The export CLI, evaluate --h5 and the compat functions that build an
    engine or run a model raise without CUDA unless the CPU is asked for."""
    from satellite_computervision_tpu_torch import compat
    from satellite_computervision_tpu_torch import evaluate as evaluate_cli
    from satellite_computervision_tpu_torch import export as export_cli

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_cli.main(["--ckpt", str(tmp_path), "--out", str(tmp_path / "x.h5")])
    (tmp_path / "e.tfrecord.gz").touch()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_cli.main(["--h5", str(tmp_path / "x.h5"), "--eval",
                           str(tmp_path / "e.tfrecord.gz")])
    scene = np.zeros((64, 64, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compat.predict_chips(scene, None, scene[..., :1], lambda c: c[..., :1], kernel=16,
                             buff=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compat.predict_chunk(scene.transpose(2, 0, 1), m=lambda c: c)
    assert compat.predict_chips(scene, None, scene[..., :1], lambda c: c[..., :1], kernel=16,
                                buff=8, device="cpu").device.type == "cpu"
