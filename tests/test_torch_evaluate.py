"""The port's evaluation report (train/evaluate.py) and its evaluate CLI
(``python -m satellite_computervision_tpu_torch.evaluate``) against the JAX
package's ``train/evaluate.py`` and ``scripts/evaluate.py --ckpt``.

``evaluate_confusion`` and ``format_confusion_report`` equal JAX's exactly.
The CLIs read one JAX ``state.msgpack`` of a narrow U-Net or DeepLab (both
packages' builders monkeypatched to the same widths, as
tests/test_torch_cli_change.py does) and the same GZIP TFRecords. The JAX
CLI serves in bfloat16 and the port's CPU path in float32, so the counts
may differ only on pixels whose float32 probability lies within 1e-2 of
the threshold: each such pixel moves one count between two cells, and the
summed difference is bounded by twice their number. The supports (the
labels' counts) are equal."""

import dataclasses
import functools
import importlib.util
import json
import pathlib
import sys
import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.models import DeepLabV3Plus as JaxDeepLab
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.train import save_checkpoint as jax_save_checkpoint
from satellite_computervision_tpu.train.config import PARKING_CONFIG as JAX_PARKING
from satellite_computervision_tpu.train.evaluate import evaluate_confusion as jax_evaluate
from satellite_computervision_tpu.train.evaluate import format_confusion_report as jax_format
from satellite_computervision_tpu.train.trainer import TrainState
from satellite_computervision_tpu_torch import evaluate as cli
from satellite_computervision_tpu_torch import predict
from satellite_computervision_tpu_torch.data.pipeline import get_eval_dataset, make_preprocess_fn
from satellite_computervision_tpu_torch.data.tfrecord import write_tfrecord_file
from satellite_computervision_tpu_torch.models import DeepLabV3Plus, UNet
from satellite_computervision_tpu_torch.train import zoo
from satellite_computervision_tpu_torch.train.config import PARKING_CONFIG
from satellite_computervision_tpu_torch.train.evaluate import (
    evaluate_confusion,
    format_confusion_report,
)
from test_torch_deeplab import random_variables, two_torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
K = 64
NARROW = {"unet": dict(filters=(4, 8), factors=(2, 2)),
          "deeplab": dict(stage_sizes=(1, 1, 1, 1), aspp_features=16)}


@pytest.mark.parametrize("labels", ["int", "onehot"])
@pytest.mark.parametrize("classes", [2, 3])
def test_evaluate_confusion_matches_jax(rng, labels, classes):
    truth = [rng.integers(0, classes, (2, 8, 8)) for _ in range(3)]
    preds = [np.where(rng.uniform(size=t.shape) < 0.7, t, rng.integers(0, classes, t.shape))
             for t in truth]
    preds[0][truth[0] == classes - 1] = 0  # the last class under-predicted
    ys = [np.eye(classes, dtype=np.float32)[t] if labels == "onehot" else t for t in truth]
    names = [f"c{i}" for i in range(classes)]
    batches = list(zip(range(3), ys))
    want = jax_evaluate(lambda i: preds[i], batches, classes, names)
    got = evaluate_confusion(lambda i: torch.from_numpy(preds[i]),
                             [(i, torch.from_numpy(y)) for i, y in batches], classes, names)
    for key in ("counts", "rates"):
        assert got[key].dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert got["per_class"] == want["per_class"] and got["overall"] == want["overall"]
    assert format_confusion_report(got) == jax_format(want)
    # a (B, H, W, 1) label squeezes as JAX squeezes it; no batch at all
    y1 = truth[0][..., None].astype(np.float32)
    assert evaluate_confusion(lambda x: preds[0], [(None, y1)], classes)["per_class"] == \
        jax_evaluate(lambda x: preds[0], [(None, y1)], classes)["per_class"]
    empty = evaluate_confusion(lambda x: x, [], classes)
    np.testing.assert_array_equal(empty["counts"], np.zeros((classes, classes)))


def _jax_evaluate_cli():
    spec = importlib.util.spec_from_file_location("jax_evaluate_cli",
                                                  ROOT / "scripts" / "evaluate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # puts scripts/ on sys.path and imports predict
    return mod, sys.modules["predict"]


def _shaped_state(model, rng, sample_input, tx=None, learning_rate=9e-4, model_args=()):
    """The JAX CLI's train-state template from shapes only (zeros):
    ``load_checkpoint`` overwrites every value, and an eager DeepLab init
    costs tens of seconds on the CPU."""
    shapes = jax.eval_shape(model.init, rng, sample_input, *model_args)
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    tx = tx or optax.adam(learning_rate)
    return TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                      batch_stats=v.get("batch_stats", {}), opt_state=tx.init(v["params"]),
                      apply_fn=model.apply, tx=tx)


@pytest.fixture
def small_parking(monkeypatch):
    """The parking preset at 64² chips, and both packages' unet and
    deeplab builders at narrow widths (float32 in the port; the JAX CLI
    serves its bfloat16). The JAX CLI's state template comes from shapes
    and its apply is jitted, which changes its cost, not its function."""
    jev, jpredict = _jax_evaluate_cli()
    small = dataclasses.replace(PARKING_CONFIG, kernel_size=K, kernel_buffer=32, batch_size=4)
    jsmall = dataclasses.replace(JAX_PARKING, kernel_size=K, kernel_buffer=32, batch_size=4)
    monkeypatch.setitem(cli.CONFIGS, "parking", small)  # the predict CLI's dict too
    monkeypatch.setitem(jev.CONFIGS, "parking", jsmall)
    monkeypatch.setattr(jpredict, "UNet", functools.partial(JaxUNet, **NARROW["unet"]))
    monkeypatch.setattr(jpredict, "DeepLabV3Plus",
                        functools.partial(JaxDeepLab, **NARROW["deeplab"]))
    monkeypatch.setattr(jpredict, "create_train_state", _shaped_state)
    load = jev.load_model

    def jitted_load_model(*args, **kwargs):
        # the JAX CLI applies the model op by op; one jit of the same
        # function costs a few seconds of compile instead of tens
        model, variables = load(*args, **kwargs)
        return types.SimpleNamespace(apply=jax.jit(model.apply)), variables

    monkeypatch.setattr(jev, "load_model", jitted_load_model)
    monkeypatch.setattr(predict, "UNet", functools.partial(UNet, **NARROW["unet"]))
    fam = zoo.FAMILIES["deeplab"]
    monkeypatch.setitem(zoo.FAMILIES, "deeplab", dataclasses.replace(
        fam, build=lambda cfg, **kw: fam.build(cfg, **NARROW["deeplab"], **kw)))
    return jev, small


def _write_eval_chips(path, n, seed):
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(n):
        ex = {b: rng.uniform(0, 1, K * K).astype(np.float32) for b in "RGB"}
        label = np.zeros((K, K), np.float32)
        y, x = rng.integers(0, K // 2, 2)
        label[y : y + 20, x : x + 24] = 1.0
        for b in "RGB":
            ex[b].reshape(K, K)[label > 0] += 0.5
        ex["impervious"] = label.reshape(-1)
        examples.append(ex)
    write_tfrecord_file(str(path), examples)


def _jax_ckpt(root, arch, seed):
    """A JAX ``<root>/best/state.msgpack`` of a narrow model, weights and
    BN statistics from ``seed``."""
    model = (JaxUNet(n_classes=1, head="sigmoid", **NARROW["unet"]) if arch == "unet"
             else JaxDeepLab(n_classes=1, **NARROW["deeplab"]))
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, K, K, 3)))
    v = random_variables(shapes, np.random.default_rng(seed))
    tx = optax.adam(1e-3)
    state = TrainState(step=jnp.asarray(7, jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                       apply_fn=model.apply, tx=tx)
    jax_save_checkpoint(str(root / "best"), state, step=7)
    return str(root)


@pytest.mark.parametrize("arch", ["unet", "deeplab"])
def test_evaluate_cli_matches_jax_cli(small_parking, tmp_path, arch, capsys):
    jev, small = small_parking
    data = tmp_path / "eval"
    data.mkdir()
    for i in range(2):
        _write_eval_chips(data / f"eval-{i}.tfrecord.gz", 3, seed=20 + i)
    ckpt = _jax_ckpt(tmp_path / "ckpt", arch, seed=3)
    args = ["--config", "parking", "--model", arch, "--ckpt", ckpt,
            "--eval", str(data / "*.tfrecord.gz"), "--batch-size", "4"]
    jev.main(args + ["--out", str(tmp_path / "jax.json")])
    got = cli.main(args + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    printed = capsys.readouterr().out
    want = json.loads((tmp_path / "jax.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert set(port) == set(want) == {"counts", "rates", "per_class", "overall"}
    assert json.dumps(port, indent=2) in printed
    np.testing.assert_array_equal(np.asarray(got["counts"]), np.asarray(port["counts"]))
    counts, jcounts = np.asarray(port["counts"]), np.asarray(want["counts"])
    assert counts.sum() == jcounts.sum() == 6 * K * K
    for name in ("0", "1"):
        assert port["per_class"][name]["support"] == want["per_class"][name]["support"]

    # the float32 probabilities of the eval pixels, through the port's own
    # pipeline: those within 1e-2 of the threshold may take either class
    model = predict.load_model(ckpt, torch.device("cpu"), cfg=small, arch=arch)
    assert isinstance(model, UNet if arch == "unet" else DeepLabV3Plus)
    names = list(small.bands) + [small.response]
    preprocess = make_preprocess_fn(list(small.bands), small.response, axes=small.axes,
                                    augment=False, device="cpu")
    near, probs = 0, []
    for raw in get_eval_dataset(sorted(map(str, data.glob("*"))), names, kernel_size=K,
                                batch_size=4, device="cpu"):
        x, _ = preprocess(raw, train=False)
        with torch.no_grad():
            p = model(x)["probs"]
        probs.append(p)
        near += int(((p - small.threshold).abs() < 1e-2).sum())
    probs = torch.cat(probs)
    assert 0.0 < float((probs > small.threshold).float().mean()) < 1.0  # both classes
    assert np.abs(counts - jcounts).sum() <= 2 * near


def test_evaluate_cli_exits(tmp_path, monkeypatch):
    base = ["--config", "parking", "--eval", str(tmp_path / "*.tfrecord.gz"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="--model acnn is not ported yet"):
        cli.main(base + ["--model", "acnn", "--ckpt", str(tmp_path)])
    for flag in (["--h5", "x.h5"], ["--family", "unet"], ["--no-fold"]):
        with pytest.raises(SystemExit, match=f"{flag[0]} is not ported yet"):
            cli.main(base + flag)
    with pytest.raises(SystemExit, match="--ckpt is required"):
        cli.main(base)
    with pytest.raises(SystemExit, match="no files match"):
        cli.main(base + ["--ckpt", str(tmp_path)])
    _write_eval_chips(tmp_path / "e.tfrecord.gz", 1, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--config", "parking", "--eval", str(tmp_path / "*.tfrecord.gz"),
                  "--ckpt", str(tmp_path)])
