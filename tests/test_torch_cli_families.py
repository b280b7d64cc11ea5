"""The timeseries and landcover families through the port's zoo and CLIs,
against the JAX package's, on the CPU at tiny widths (the zoo's builders
monkeypatched, as tests/test_zoo.py does for the JAX CLI):

- each of the five families (convlstm, lstm_autoencoder, hybrid, acnn,
  hierarchical) builds from its preset, its example inputs and labels
  have the JAX zoo's shapes, and the first train step's loss from the
  same bridged weights and batch equals JAX's (rtol 1e-5; train-mode BN,
  flax's one-pass variance) with the same confusion counts;
- ``python -m satellite_computervision_tpu_torch.train`` trains each
  family: convlstm and lstm_autoencoder on ``--series``, hierarchical and
  hybrid on ``--unet-source``/``--series``/``--labels`` (wetland with
  ``--series-s1``), acnn on TFRecords with an eval stream; the hybrid at
  the landcover preset's 256² raises before any data is read (as the JAX
  CLI's init does), the hierarchical family exits below 4 classes;
- ``python -m satellite_computervision_tpu_torch.evaluate --model acnn``
  on a JAX ``state.msgpack`` gives ``scripts/evaluate.py``'s report: the
  same JSON exactly when both serve float32, and with the JAX CLI's own
  bfloat16 the counts differ only where the port's float32 top-two
  probabilities lie within 1e-2 (each such pixel moves one count)."""

import dataclasses
import functools
import json
import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu import testing as fx
from satellite_computervision_tpu.models import ACNN as JaxACNN
from satellite_computervision_tpu.train import save_checkpoint as jax_save_checkpoint
from satellite_computervision_tpu.train import zoo as jzoo
from satellite_computervision_tpu.train.config import CONFIGS as JAX_CONFIGS
from satellite_computervision_tpu.train.trainer import TrainState
from satellite_computervision_tpu.train.trainer import make_train_step as jax_make_train_step
from satellite_computervision_tpu_torch import evaluate as evaluate_cli
from satellite_computervision_tpu_torch import predict
from satellite_computervision_tpu_torch.data.pipeline import get_eval_dataset, make_preprocess_fn
from satellite_computervision_tpu_torch.data.tfrecord import write_tfrecord_file
from satellite_computervision_tpu_torch.models import ACNN, flax_to_torch
from satellite_computervision_tpu_torch.train import __main__ as train_cli
from satellite_computervision_tpu_torch.train import zoo
from satellite_computervision_tpu_torch.train.checkpoint import build_empty
from satellite_computervision_tpu_torch.train.config import CONFIGS
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step
from test_torch_deeplab import random_variables, two_torch_threads  # noqa: F401
from test_torch_evaluate import _jax_evaluate_cli, _shaped_state

TINY = {
    "convlstm": dict(features=4),
    "lstm_autoencoder": dict(features=4),
    "hybrid": dict(filters=(4, 8), factors=(3, 2), lstm_features=4),
    "acnn": dict(n_blocks=3, features=4),
    "hierarchical": dict(n_blocks=3, features=4, lstm_features=4),
}
PRESET = {"convlstm": "timeseries", "lstm_autoencoder": "timeseries", "hybrid": "landcover",
          "acnn": "landcover", "hierarchical": "landcover"}
K = 24


def _labels_like(a, rng):
    """One-hot labels of ``a``'s shape when its first class is set (the
    zoo's one-hot examples), else regression targets in [0, 1.5]."""
    if a[..., 0].all() and not a[..., 1:].any():
        return np.eye(a.shape[-1], dtype=np.float32)[rng.integers(0, a.shape[-1],
                                                                  (2,) + a.shape[1:-1])]
    return rng.uniform(0, 1.5, (2,) + a.shape[1:]).astype(np.float32)


@pytest.mark.parametrize("family", sorted(TINY))
def test_first_train_step_matches_jax(family, rng):
    cfg = dataclasses.replace(CONFIGS[PRESET[family]], kernel_size=K)
    jcfg = dataclasses.replace(JAX_CONFIGS[PRESET[family]], kernel_size=K)
    fam, jfam = zoo.get_family(family), jzoo.get_family(family)
    inputs, jinputs = fam.example_inputs(cfg), jfam.example_inputs(jcfg)
    labels, jlabels = fam.example_labels(cfg), jfam.example_labels(jcfg)
    assert [a.shape for a in inputs] == [np.shape(a) for a in jinputs]
    pairs = zip(*(ls if isinstance(ls, tuple) else (ls,) for ls in (labels, jlabels)))
    for a, ja in pairs:
        np.testing.assert_array_equal(a, np.asarray(ja))
    x = tuple(rng.normal(size=(2,) + a.shape[1:]).astype(np.float32) for a in inputs)
    y = tuple(_labels_like(a, rng) for a in labels) if isinstance(labels, tuple) \
        else _labels_like(labels, rng)
    if family == "hierarchical":  # the sub head's labels from the main ones, as the CLI
        y = (y[0], np.eye(y[1].shape[-1], dtype=np.float32)[
            np.minimum(np.argmax(y[0], -1) // 2, y[1].shape[-1] - 1)])

    jmodel = jfam.build(jcfg, **TINY[family])
    v = random_variables(jax.eval_shape(jmodel.init, jax.random.key(0), *x), rng)
    v["params"] = jax.tree_util.tree_map(lambda a: a * 0.5, v["params"])
    jloss_fn, jkey = jfam.loss(jcfg)
    tx = optax.adam(cfg.learning_rate)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                        apply_fn=jmodel.apply, tx=tx)
    jbatch = (x if len(x) > 1 else x[0], y)
    _, jout = jax_make_train_step(jloss_fn, jkey, num_classes=max(cfg.num_classes, 2),
                                  donate=False)(jstate, jbatch)

    model = build_empty(fam.build, cfg, **TINY[family])
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model), assign=True)
    loss_fn, key = fam.loss(cfg)
    assert key == jkey
    step = make_train_step(loss_fn, key, num_classes=max(cfg.num_classes, 2))
    tx_in = tuple(torch.from_numpy(a) for a in x)
    ty = tuple(torch.from_numpy(a) for a in y) if isinstance(y, tuple) else torch.from_numpy(y)
    out = step(create_train_state(model, cfg.learning_rate),
               (tx_in if len(tx_in) > 1 else tx_in[0], ty))
    assert np.isfinite(float(out["loss"]))
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(out["cm"].numpy(), np.asarray(jout["cm"]))


def _tiny(monkeypatch, *families):
    for name in families:
        fam = zoo.FAMILIES[name]
        monkeypatch.setitem(zoo.FAMILIES, name, dataclasses.replace(
            fam, build=functools.partial(
                lambda fam, name, cfg, **kw: fam.build(cfg, **{**TINY[name], **kw}), fam, name)))


def _run(argv, tmp_path):
    ckpt = str(tmp_path / "run")
    trainer = train_cli.main(argv + ["--ckpt", ckpt, "--epochs", "1", "--steps-per-epoch", "2",
                                     "--batch-size", "2", "--device", "cpu"])
    assert trainer.state.step == 2
    assert all(np.isfinite(r["train"]["loss"]) for r in trainer.history)
    return torch.load(tmp_path / "run" / "best" / "model.pt", weights_only=True), trainer


@pytest.mark.parametrize("family", ["convlstm", "lstm_autoencoder"])
def test_cli_trains_timeseries_family(tmp_path, monkeypatch, family):
    _tiny(monkeypatch, family)
    fx.make_series_chips(str(tmp_path / "series"), n_chips=4, n_time=7, dim=20)
    blob, trainer = _run(["--config", "timeseries", "--model", family, "--series",
                          str(tmp_path / "series/*.npy"), "--series-dim", "16"], tmp_path)
    assert blob["arch"] == family and blob["model_kwargs"]["features"] == 4
    assert blob["model_kwargs"]["in_channels"] == 4
    if family == "lstm_autoencoder":
        assert blob["model_kwargs"]["n_time"] == 6


def _landcover(monkeypatch, name="landcover", **kw):
    small = dataclasses.replace(CONFIGS[name], **{"kernel_size": K, "batch_size": 2, **kw})
    monkeypatch.setitem(train_cli.CONFIGS, name, small)
    return small


def test_cli_trains_hierarchical_and_hybrid(tmp_path, monkeypatch):
    """landcover at 24² (a side the (3, 2) pools round-trip): the
    hierarchical model with pairwise-merged sub labels, then the hybrid,
    on the same npy chips (32², trimmed) and 16² series."""
    _tiny(monkeypatch, "hierarchical", "hybrid")
    _landcover(monkeypatch)
    fx.make_npy_chip_tree(str(tmp_path / "chips"), sources={"naip": (4, 255.0)}, n_chips=4,
                          dim=32, n_classes=8)
    fx.make_series_chips(str(tmp_path / "series"), n_chips=4, n_time=6, dim=16)
    args = ["--config", "landcover", "--unet-source", f"naip={tmp_path}/chips/naip/*.npy",
            "--series", str(tmp_path / "series/*.npy"), "--series-dim", "16",
            "--labels", str(tmp_path / "chips/label/*.npy")]
    blob, trainer = _run(args + ["--model", "hierarchical"], tmp_path)
    assert blob["arch"] == "hierarchical" and blob["model_kwargs"]["sub_classes"] == 4
    blob, trainer = _run(args, tmp_path / "hybrid")  # the preset's family
    assert blob["arch"] == "hybrid" and blob["model_kwargs"]["factors"] == (3, 2)
    assert trainer.history[0]["train"]["mean_iou"] >= 0.0  # the classes head's counts


def test_cli_trains_wetland_hybrid_with_s1(tmp_path, monkeypatch):
    """wetland: naip (4 bands) + hag (1 band and its NaN mask) into the
    U-Net, S2 (4) + S1 (2) series into the ConvLSTM, 2 classes."""
    _tiny(monkeypatch, "hybrid")
    _landcover(monkeypatch, "wetland")
    tree = fx.make_npy_chip_tree(str(tmp_path / "chips"),
                                 sources={"naip": (4, 255.0), "hag": (1, 100.0)},
                                 n_chips=4, dim=32, n_classes=2)
    hag = np.load(tree["hag"][1])
    hag[0, 10:14, 10:14] = np.nan
    np.save(tree["hag"][1], hag)
    fx.make_series_chips(str(tmp_path / "s2"), n_chips=4, n_time=6, dim=16)
    fx.make_series_chips(str(tmp_path / "s1"), n_chips=4, n_time=6, channels=2, dim=16,
                         seed=1)
    blob, trainer = _run([
        "--config", "wetland", "--unet-source", f"naip={tmp_path}/chips/naip/*.npy",
        "--unet-source", f"hag={tmp_path}/chips/hag/*.npy",
        "--series", str(tmp_path / "s2/*.npy"), "--series-s1", str(tmp_path / "s1/*.npy"),
        "--series-dim", "16", "--labels", str(tmp_path / "chips/label/*.npy")], tmp_path)
    assert blob["arch"] == "hybrid"
    assert blob["model_kwargs"]["in_channels"] == blob["model_kwargs"]["series_channels"] == 6


def _write_landcover_chips(path, n, seed, k=16):
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(n):
        lc = rng.integers(0, 8, (k, k)).astype(np.float32)
        ex = {b: (rng.uniform(0, 1, (k, k)) + 0.1 * lc).astype(np.float32).reshape(-1)
              for b in "RGBN"}
        ex["lc"] = lc.reshape(-1)
        examples.append(ex)
    write_tfrecord_file(str(path), examples)


def test_cli_trains_acnn_then_evaluates(tmp_path, monkeypatch):
    _tiny(monkeypatch, "acnn")
    small = _landcover(monkeypatch, kernel_size=16)
    monkeypatch.setitem(evaluate_cli.CONFIGS, "landcover", small)
    _write_landcover_chips(tmp_path / "train.tfrecord.gz", 4, seed=0)
    _write_landcover_chips(tmp_path / "eval.tfrecord.gz", 3, seed=1)
    blob, trainer = _run(["--config", "landcover", "--model", "acnn", "--train",
                          str(tmp_path / "train.tfrecord.gz"), "--eval",
                          str(tmp_path / "eval.tfrecord.gz")], tmp_path)
    assert blob["arch"] == "acnn" and "val" in trainer.history[0]
    report = evaluate_cli.main(["--config", "landcover", "--model", "acnn", "--ckpt",
                                str(tmp_path / "run"), "--eval",
                                str(tmp_path / "eval.tfrecord.gz"), "--device", "cpu"])
    assert report["counts"].shape == (8, 8) and report["counts"].sum() == 3 * 16 * 16


def test_cli_refusals(tmp_path, monkeypatch):
    """The hybrid at the landcover preset's 256² raises from the meta
    forward (nothing written); the hierarchical family exits below 4
    classes; the npy families exit without their globs; without CUDA and
    without ``--device`` the train and evaluate CLIs raise."""
    chips = ["--unet-source", "naip=x*.npy", "--series", "s*.npy", "--labels", "l*.npy",
             "--ckpt", str(tmp_path / "run"), "--device", "cpu"]
    with pytest.raises(ValueError, match="256x256 does not survive the pool factors"):
        train_cli.main(["--config", "landcover"] + chips)
    with pytest.raises(ValueError, match="does not survive"):
        train_cli.main(["--config", "wetland", "--model", "hybrid"] + chips)
    with pytest.raises(SystemExit, match="hierarchical needs num_classes >= 4"):
        train_cli.main(["--config", "wetland", "--model", "hierarchical"] + chips)
    with pytest.raises(SystemExit, match="lstm_autoencoder needs --series"):
        train_cli.main(["--config", "timeseries", "--model", "lstm_autoencoder",
                        "--device", "cpu"])
    with pytest.raises(SystemExit, match="hybrid needs --unet-source name=glob"):
        train_cli.main(["--config", "landcover", "--series", "s*.npy", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--unet-source wants name=glob"):
        train_cli.main(["--config", "landcover", "--unet-source", "naip"] + chips[2:])
    with pytest.raises(SystemExit, match="--train tfrecord glob is required for acnn"):
        train_cli.main(["--config", "landcover", "--model", "acnn", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # no silent CPU run
        train_cli.main(["--config", "timeseries", "--series", "s*.npy", "--ckpt",
                        str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_cli.main(["--config", "landcover", "--model", "acnn", "--ckpt",
                           str(tmp_path), "--eval", __file__])
    assert not (tmp_path / "run").exists()
    # every family of the JAX package, and the port's own ViT and Swin
    assert set(train_cli.TFRECORD_FAMILIES + train_cli.NPY_FAMILIES) == set(zoo.FAMILIES) \
        == set(jzoo.FAMILIES) | {"prithvi", "satlas"}
    assert set(CONFIGS) == set(JAX_CONFIGS)


def test_evaluate_acnn_matches_jax_cli(tmp_path, monkeypatch, capsys):
    k = 16
    jev, jpredict = _jax_evaluate_cli()
    cfg = dataclasses.replace(CONFIGS["landcover"], kernel_size=k)
    jcfg = dataclasses.replace(JAX_CONFIGS["landcover"], kernel_size=k)
    monkeypatch.setitem(evaluate_cli.CONFIGS, "landcover", cfg)
    monkeypatch.setitem(jev.CONFIGS, "landcover", jcfg)
    _tiny(monkeypatch, "acnn")
    jfam = jzoo.FAMILIES["acnn"]
    monkeypatch.setitem(jzoo.FAMILIES, "acnn", dataclasses.replace(
        jfam, build=lambda cfg, **kw: jfam.build(cfg, **TINY["acnn"], **kw)))
    monkeypatch.setattr(jpredict, "create_train_state", _shaped_state)
    load = jev.load_model
    served = {}

    def jitted_load_model(*args, **kwargs):
        model, variables = load(*args, bf16=served["bf16"], **kwargs)
        return types.SimpleNamespace(apply=jax.jit(model.apply)), variables

    monkeypatch.setattr(jev, "load_model", jitted_load_model)

    # a JAX checkpoint of the narrow ACNN from seeded weights
    jmodel = JaxACNN(n_classes=8, **TINY["acnn"])
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, k, k, 4)))
    v = random_variables(shapes, np.random.default_rng(4))
    tx = optax.adam(1e-3)
    jax_save_checkpoint(str(tmp_path / "ckpt" / "best"), TrainState(
        step=jnp.asarray(5, jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
        opt_state=tx.init(v["params"]), apply_fn=jmodel.apply, tx=tx), step=5)
    data = tmp_path / "eval"
    data.mkdir()
    for i in range(2):
        _write_landcover_chips(data / f"eval-{i}.tfrecord.gz", 3, seed=30 + i, k=k)
    args = ["--config", "landcover", "--model", "acnn", "--ckpt", str(tmp_path / "ckpt"),
            "--eval", str(data / "*.tfrecord.gz"), "--batch-size", "4"]
    got = evaluate_cli.main(args + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    port = json.loads((tmp_path / "port.json").read_text())
    assert json.dumps(port, indent=2) in capsys.readouterr().out
    counts = np.asarray(port["counts"])
    np.testing.assert_array_equal(np.asarray(got["counts"]), counts)
    assert counts.shape == (8, 8) and counts.sum() == 6 * k * k

    served["bf16"] = False  # both in float32: the same report
    jev.main(args + ["--out", str(tmp_path / "jax32.json")])
    assert json.loads((tmp_path / "jax32.json").read_text()) == port

    served["bf16"] = True  # the JAX CLI's own bfloat16
    jev.main(args + ["--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    for name in map(str, range(8)):
        assert port["per_class"][name]["support"] == want["per_class"][name]["support"]
    model = predict.load_model(str(tmp_path / "ckpt"), torch.device("cpu"), cfg=cfg, arch="acnn")
    assert isinstance(model, ACNN)
    names = list(cfg.bands) + [cfg.response]
    preprocess = make_preprocess_fn(list(cfg.bands), cfg.response, axes=cfg.axes,
                                    response_depth=8, augment=False, device="cpu")
    near = 0
    for raw in get_eval_dataset(sorted(map(str, data.glob("*"))), names, kernel_size=k,
                                batch_size=4, device="cpu"):
        x, _ = preprocess(raw, train=False)
        with torch.no_grad():
            top2 = torch.topk(model(x)["probs"], 2, dim=-1).values
        near += int((top2[..., 0] - top2[..., 1] < 1e-2).sum())
    assert near < counts.sum() // 4
    assert np.abs(counts - np.asarray(want["counts"])).sum() <= 2 * near
