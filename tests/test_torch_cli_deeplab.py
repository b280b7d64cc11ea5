"""The parking workflow through the port's CLIs on the CPU at small sizes
(the parking preset at 64² chips, the deeplab family at ResNet stages
1/1/1/1 and an ASPP of 16): ``train --config parking --model deeplab``
warm-started by ``--torch-weights``, its ``model.pt`` (and a JAX
``state.msgpack`` of the same weights) served by ``predict scene`` against
the JAX engine with the JAX model at one geometry (probabilities within
1e-5), ``sweep`` and ``patches`` on the same checkpoint, and the exits."""

import dataclasses
import os

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from satellite_computervision_tpu.inference import TiledInferenceEngine as JaxEngine
from satellite_computervision_tpu.models import DeepLabV3Plus as JaxDeepLab
from satellite_computervision_tpu.train import save_checkpoint as jax_save_checkpoint
from satellite_computervision_tpu.train.trainer import TrainState
from satellite_computervision_tpu_torch import predict as cli
from satellite_computervision_tpu_torch.data.tfrecord import (
    TFRecordWriter,
    build_example,
    read_tfrecord_file,
    write_tfrecord_file,
)
from satellite_computervision_tpu_torch.geo import read_geotiff
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.inference.mixer import MixerInfo, write_mixer
from satellite_computervision_tpu_torch.models import (
    DeepLabV3Plus,
    export_torch_resnet_weights,
    flax_init_,
    flax_to_torch,
)
from satellite_computervision_tpu_torch.train import __main__ as train_cli
from satellite_computervision_tpu_torch.train import zoo
from satellite_computervision_tpu_torch.train.checkpoint import (
    build_empty,
    load_checkpoint,
    save_checkpoint,
)
from satellite_computervision_tpu_torch.train.config import PARKING_CONFIG
from test_torch_deeplab import two_torch_threads  # noqa: F401

K = 64
NARROW = dict(stage_sizes=(1, 1, 1, 1), aspp_features=16)
GEOM = ["--kernel", "32", "--buffer", "32", "--batch-size", "4"]
TF = (0.6, 0.0, 380000.0, 0.0, -0.6, 4300000.0)


@pytest.fixture
def small_parking(monkeypatch):
    small = dataclasses.replace(PARKING_CONFIG, kernel_size=K, kernel_buffer=32, batch_size=2)
    monkeypatch.setitem(cli.CONFIGS, "parking", small)  # the train CLI's dict too
    fam = zoo.FAMILIES["deeplab"]
    monkeypatch.setitem(zoo.FAMILIES, "deeplab", dataclasses.replace(
        fam, build=lambda cfg, **kw: fam.build(cfg, **NARROW, **kw)))
    return small


def _seeded(cfg, seed):
    """The zoo's deeplab for ``cfg`` with flax's initialization from
    ``seed``, drawn once (as the train CLI draws it)."""
    model = build_empty(zoo.get_family("deeplab").build, cfg).to_empty(device="cpu")
    return flax_init_(model, torch.Generator().manual_seed(seed))


def _write_chips(path, n, seed):
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(n):
        ex = {b: rng.uniform(0, 1, K * K).astype(np.float32) for b in "RGB"}
        label = np.zeros((K, K), np.float32)
        label[10:30, 10:40] = 1.0
        ex["impervious"] = label.reshape(-1)
        examples.append(ex)
    write_tfrecord_file(str(path), examples)


def torch_to_flax(model):
    """The port's model as a flax ``{params, batch_stats}`` tree: the
    inverse of ``flax_to_torch`` (OIHW -> HWIO kernels, BN weight/bias ->
    scale/bias, running statistics -> mean/var)."""
    tree = {"params": {}, "batch_stats": {}}

    def put(root, path, value):
        node = tree[root]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value.detach().numpy().copy()

    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, torch.nn.Conv2d):
            put("params", path + ("kernel",), mod.weight.permute(2, 3, 1, 0))
            if mod.bias is not None:
                put("params", path + ("bias",), mod.bias)
        elif isinstance(mod, torch.nn.BatchNorm2d):
            put("params", path + ("scale",), mod.weight)
            put("params", path + ("bias",), mod.bias)
            put("batch_stats", path + ("mean",), mod.running_mean)
            put("batch_stats", path + ("var",), mod.running_var)
    return tree


def test_train_then_serve_matches_jax(small_parking, tmp_path, rng, capsys):
    chips = tmp_path / "train.tfrecord.gz"
    _write_chips(chips, 4, seed=0)
    donor = _seeded(small_parking, 5)
    pth = str(tmp_path / "resnet.pth")
    exported = export_torch_resnet_weights(donor, pth)
    ckpt = str(tmp_path / "run")
    lr = small_parking.learning_rate
    trainer = train_cli.main([
        "--config", "parking", "--model", "deeplab", "--train", str(chips), "--eval", str(chips),
        "--ckpt", ckpt, "--epochs", "1", "--steps-per-epoch", "2", "--batch-size", "2",
        "--torch-weights", pth, "--device", "cpu"])
    assert "warm-started ResNet backbone" in capsys.readouterr().out
    model = trainer.state.model
    assert isinstance(model, DeepLabV3Plus) and trainer.state.step == 2
    assert torch.load(tmp_path / "run" / "best" / "model.pt", weights_only=True)["arch"] == \
        "deeplab"
    # the warm start reached the model: the stem is the file's plus two Adam steps
    moved = (model.backbone.stem_conv.weight.detach() - exported["conv1.weight"]).abs().max()
    assert float(moved) <= 4 * lr * 2

    served, _ = load_checkpoint(ckpt)
    tree = torch_to_flax(served)
    for key, value in flax_to_torch(tree["params"], tree["batch_stats"], served).items():
        if not key.endswith("num_batches_tracked"):  # flax keeps no count
            torch.testing.assert_close(value, served.state_dict()[key], rtol=0, atol=0, msg=key)
    jmodel = JaxDeepLab(n_classes=1, **NARROW)
    tx = optax.adam(1e-3)
    jax_save_checkpoint(str(tmp_path / "jax" / "best"), TrainState(
        step=jnp.asarray(2, jnp.int32), params=tree["params"], batch_stats=tree["batch_stats"],
        opt_state=tx.init(tree["params"]), apply_fn=jmodel.apply, tx=tx), step=2)

    scene = rng.uniform(0, 1, (100, 70, 3)).astype(np.float32)
    np.save(tmp_path / "scene.npy", scene)
    want = np.asarray(JaxEngine.from_model(jmodel, tree, kernel=32, buffer=32, batch_size=4,
                                           blend="hann").predict_scene(scene))
    assert want.std() > 1e-3 and 0.0 < want.min() and want.max() < 1.0
    for source in (ckpt, str(tmp_path / "jax")):
        out = str(tmp_path / f"{os.path.basename(source)}.tif")
        cli.main(["scene", "--config", "parking", "--model", "deeplab", "--input",
                  str(tmp_path / "scene.npy"), "--ckpt", source, "--device", "cpu",
                  "--output", out, "--crs", "EPSG:26918", "--transform", *map(str, TF), *GEOM])
        got, meta = read_geotiff(out)
        assert got.shape == (100, 70, 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert meta.get("nodata") is None and tuple(meta["transform"]) == TF


def test_sweep_and_patches_serve_deeplab(small_parking, tmp_path, rng):
    model = _seeded(small_parking, 6).eval()
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, model, {})
    indir = tmp_path / "scenes"
    indir.mkdir()
    scenes = [rng.uniform(0, 1, shape).astype(np.float32) for shape in ((64, 96, 3), (80, 64, 3))]
    for i, s in enumerate(scenes):
        np.save(indir / f"s{i}.npy", s)
    written = cli.main(["sweep", "--config", "parking", "--model", "deeplab", "--input",
                        str(indir), "--ckpt", ckpt, "--outdir", str(tmp_path / "out"),
                        "--device", "cpu", "--prefetch", "1", *GEOM])
    engine = TiledInferenceEngine(lambda x: model(x)["probs"], kernel=32, buffer=32,
                                  batch_size=4, blend="hann", device="cpu")
    for path, scene in zip(written, scenes):
        got, meta = read_geotiff(path)
        np.testing.assert_allclose(got, engine.predict_scene(scene).numpy(), rtol=0, atol=1e-6)
        assert meta.get("nodata") is None

    side = K + small_parking.kernel_buffer
    export = tmp_path / "export"
    export.mkdir()
    with TFRecordWriter(str(export / "lots-00000.tfrecord.gz"), "GZIP") as wr:
        for _ in range(3):
            wr.write(build_example({b: rng.uniform(0, 1, side * side).astype(np.float32)
                                    for b in "RGB"}))
    write_mixer(str(export / "mixer.json"), MixerInfo(3, 3, (K, K), TF, "EPSG:26918"))
    written = cli.main(["patches", "--config", "parking", "--model", "deeplab", "--input",
                        str(export), "--ckpt", ckpt, "--outdir", str(tmp_path / "preds"),
                        "--base", "lots", "--device", "cpu", "--batch-size", "2"])
    records = read_tfrecord_file(written[0], compression=None)
    assert len(records) == 3 and all(len(r["b1"]) == K * K for r in records)
    vals = np.concatenate([np.asarray(r["b1"]) for r in records])
    assert np.isfinite(vals).all() and 0.0 <= vals.min() and vals.max() <= 1.0


def test_deeplab_cli_exits(small_parking, tmp_path, monkeypatch):
    np.save(tmp_path / "s.npy", np.zeros((64, 64, 3), np.float32))
    scene = ["scene", "--config", "parking", "--model", "deeplab", "--input",
             str(tmp_path / "s.npy"), "--ckpt", str(tmp_path), "--device", "cpu"]
    with pytest.raises(SystemExit, match="--fold-bn currently supports the unet family"):
        cli.main(scene + ["--fold-bn"])
    with pytest.raises(SystemExit, match="change mode serves the siamese family, not deeplab"):
        cli.main(["change", "--config", "parking", "--model", "deeplab", "--ckpt",
                  str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="scene mode serves the unet or deeplab family"):
        cli.main(scene[:4] + ["siamese"] + scene[5:])
    chips = tmp_path / "c.tfrecord.gz"
    _write_chips(chips, 1, seed=1)
    train = ["--config", "parking", "--train", str(chips), "--ckpt", str(tmp_path / "run"),
             "--device", "cpu"]
    with pytest.raises(SystemExit, match="--torch-weights applies to --model deeplab"):
        train_cli.main(train + ["--model", "unet", "--torch-weights", "x.pth"])
    with pytest.raises(SystemExit, match="--model acnn is not ported yet"):
        train_cli.main(train + ["--model", "acnn"])
    with pytest.raises(SystemExit, match="--train tfrecord glob is required for deeplab"):
        train_cli.main(["--config", "parking", "--model", "deeplab", "--device", "cpu"])
    assert not (tmp_path / "run").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(scene[:-2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(train[:-2] + ["--model", "deeplab"])
