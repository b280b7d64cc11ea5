"""The port's convergence twins against the JAX scripts in ``examples/``:
``convergence_common`` (seeding, fields, metrics, the class palette, the
batch order and one ``run_convergence`` epoch from bridged weights:
losses within 1e-5 relative and the confusion matrix equal, in float32),
each twin's ``make_chip`` bit-equal to the JAX script's, the solar and
change scene evals (IoU per mode equal, probabilities within 1e-5), the
parking warm-start round trip and refusal, every twin's flags against
its JAX script's, and each twin's ``main`` at tiny sizes on the CPU."""

import argparse
import functools
import importlib.util
import io
import json
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from satellite_computervision_tpu.models import SiameseUNet as JaxSiamese
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.models import losses as jlosses
from satellite_computervision_tpu.train import create_train_state as jax_create_train_state
from satellite_computervision_tpu.train.trainer import make_eval_step as jax_make_eval_step
from satellite_computervision_tpu.train.trainer import make_train_step as jax_make_train_step
from satellite_computervision_tpu_torch import change_convergence as change_twin
from satellite_computervision_tpu_torch import convergence_common as cc
from satellite_computervision_tpu_torch import parking_convergence as parking_twin
from satellite_computervision_tpu_torch import solar_convergence as solar_twin
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.models import (
    DeepLabV3Plus,
    SiameseUNet,
    UNet,
    flax_to_torch,
    losses,
)
from satellite_computervision_tpu_torch.models.deeplab import load_torch_resnet_weights
from satellite_computervision_tpu_torch.train.trainer import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from test_torch_deeplab import two_torch_threads  # noqa: F401

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def load_example(name):
    """A JAX script of ``examples/`` as a module (its directory on the path,
    for its ``convergence_common`` import)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def narrowed(cls, **widths):
    """``cls`` with ``widths`` forced over the caller's keyword arguments
    (the twins pass their full widths explicitly)."""
    return lambda *a, **kw: cls(*a, **{**kw, **widths})


@pytest.fixture(scope="module")
def jx():
    return SimpleNamespace(**{n: load_example(n) for n in (
        "convergence_common", "solar_convergence", "change_convergence",
        "parking_convergence", "swath_codec_sweep")})


# ------------------------------------------------------- seeding, fields, metrics


def test_stable_seed_and_smooth_field_are_bit_equal(jx):
    jcc = jx.convergence_common
    for split in ("train", "eval", "scene", "x"):
        for index in (0, 1, 77, 10_000):
            for stride in (1_000_003, 2_000_003):
                assert cc.stable_seed(split, index, stride) == jcc.stable_seed(split, index, stride)
    for seed, k, scale in ((0, 256, 16), (3, 512, 32), (9, 96, 16), (5, 1024, 16)):
        got = cc.smooth_field(np.random.default_rng(seed), k, scale)
        want = jcc.smooth_field(np.random.default_rng(seed), k, scale)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_palette_constants_are_equal(jx):
    jcc = jx.convergence_common
    assert (cc.PERIOD, cc.CLASSES, cc.NCLASS, cc.SUBCLASSES, cc.NSUB) == (
        jcc.PERIOD, jcc.CLASSES, jcc.NCLASS, jcc.SUBCLASSES, jcc.NSUB)
    for name in ("SUB_OF", "SIGS", "AMPS"):
        got, want = getattr(cc, name), getattr(jcc, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_are_equal(jx, seed):
    rng = np.random.default_rng(seed)
    cm = rng.integers(0, 10_000, (2, 2)).astype(np.float64)
    assert cc.binary_metrics(cm) == jx.convergence_common.binary_metrics(cm)
    cm6 = rng.integers(0, 500, (6, 6)).astype(np.float64)
    cm6[5] = 0  # an absent class
    for names in (None, cc.CLASSES):
        assert cc.multiclass_metrics(cm6, names) == \
            jx.convergence_common.multiclass_metrics(cm6, names)


def _index_chip(split, index):
    return (np.full((2, 2, 1), index, np.float16),
            np.full((2, 2, 1), cc.stable_seed(split, index) % 2, np.uint8))


@pytest.mark.parametrize("shuffle", [True, False])
def test_chip_batches_yield_the_jax_order(jx, shuffle):
    """The same seed gives the same batches in the same order, over two
    epochs drawn from one rng (a last partial batch dropped)."""
    rngs = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        got = [(x.numpy(), y.numpy()) for x, y in cc.chip_batches(
            _index_chip, "train", 11, 3, rngs[0], shuffle=shuffle, device="cpu")]
        want = [(np.asarray(x), np.asarray(y)) for x, y in jx.convergence_common.chip_batches(
            _index_chip, "train", 11, 3, rngs[1], shuffle=shuffle)]
        assert len(got) == len(want) == 3
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == wx.dtype and np.array_equal(gx, wx)
            assert gy.dtype == wy.dtype and np.array_equal(gy, wy)


# --------------------------------------------------------------- chips


@pytest.mark.parametrize("split,index", [("train", 0), ("train", 13), ("eval", 4),
                                         ("scene", 9)])
@pytest.mark.parametrize("twin", ["solar", "change", "parking"])
def test_make_chip_is_bit_equal(jx, twin, split, index):
    port = {"solar": solar_twin, "change": change_twin, "parking": parking_twin}[twin]
    ref = getattr(jx, f"{twin}_convergence")
    (gx, gy), (wx, wy) = port.make_chip(split, index), ref.make_chip(split, index)
    assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
    assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


@pytest.mark.parametrize("index", [0, 5])
def test_solar_chip_at_another_tile_is_bit_equal(jx, index):
    (gx, gy) = solar_twin.make_chip("train", index, k=320)
    (wx, wy) = jx.solar_convergence.make_chip("train", index, k=320)
    assert gx.shape == (320, 320, 6) and np.array_equal(gx, wx) and np.array_equal(gy, wy)


def test_parking_paved_rect_is_bit_equal(jx):
    for seed in range(5):
        assert parking_twin._paved_rect(np.random.default_rng(seed), 180) == \
            jx.parking_convergence._paved_rect(np.random.default_rng(seed), 180)


def test_change_date_dn_is_bit_equal(jx):
    veg = 0.5 + 0.5 * cc.smooth_field(np.random.default_rng(1), change_twin.K)
    got = change_twin._date_dn(np.random.default_rng(2), veg, 0.7)
    want = jx.change_convergence._date_dn(np.random.default_rng(2), veg, 0.7)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# ------------------------------------------------------- the training loop


def _tiny_chip(split, index, k=64):
    """A learnable 64² chip of 6 bands: class 1 where band 3 is bright."""
    rng = np.random.default_rng(cc.stable_seed(split, index))
    x = rng.random((k, k, 6)).astype(np.float16)
    return x, (x[..., 3:4] > 0.6).astype(np.uint8)


def _narrow_unet_pair(seed=0, threshold=0.9):
    """A JAX U-Net of filters (4, 8) in float32 and its train state, and
    the port's U-Net with the bridged weights."""
    jmodel = JaxUNet(n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
                     threshold=threshold, bn_momentum=0.9, dtype=jnp.float32)
    jstate = jax_create_train_state(jmodel, jax.random.key(seed), jnp.zeros((1, 64, 64, 6)),
                                    tx=optax.adam(9e-4))
    model = UNet(6, n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
                 threshold=threshold, bn_momentum=0.9)
    model.load_state_dict(flax_to_torch(jstate.params, jstate.batch_stats, model))
    return jmodel, jstate, model


def _args(**kw):
    base = dict(seed=0, epochs=2, train_size=12, eval_size=8, batch_size=4, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_run_convergence_matches_jax(jx):
    """Two epochs (3 SGD steps and 2 eval batches each) from bridged
    weights on the same chips: per epoch the train and eval losses within
    1e-5 relative, the eval confusion matrices equal but for pixels at the
    threshold, the record's schema JAX's plus the port's timings. Plain SGD in both: the loop is under
    test; Adam turns the rounding noise in the zero gradient of a conv
    bias before a train-mode BN into steps of the learning rate in either
    package (tests/test_torch_train.py holds Adam's trajectory)."""
    jcc = jx.convergence_common
    loss = lambda y, p: jlosses.weighted_bce(y, p, pos_weight=2.0, logits=True)  # noqa: E731
    tloss = lambda y, p: losses.weighted_bce(y, p, pos_weight=2.0, logits=True)  # noqa: E731
    # threshold 0.5: both classes predicted after a few steps
    _, jstate, model = _narrow_unet_pair(threshold=0.5)

    jcms, tcms = [], []
    jeval = jax_make_eval_step(loss, pred_key="logits", num_classes=2)

    def jax_eval(state, batch):
        out = jeval(state, batch)
        jcms.append(np.asarray(out["cm"], np.float64))
        return out

    teval = make_eval_step(tloss, pred_key="logits", num_classes=2)
    near = []

    def port_eval(state, batch):
        out = teval(state, batch)
        tcms.append(out["cm"].numpy().astype(np.float64))
        with torch.no_grad():
            probs = state.model(batch[0])["probs"]
        near.append(int(((probs - 0.5).abs() < 1e-5).sum()))
        return out

    jstate = jstate.replace(tx=optax.sgd(0.05), opt_state=optax.sgd(0.05).init(jstate.params))
    jlog, tlog = io.StringIO(), io.StringIO()
    jcc.run_convergence(jstate, jax_make_train_step(loss, pred_key="logits", num_classes=2),
                        jax_eval, _tiny_chip, _args(), jlog, extra_record={"tile": 64})
    cc.run_convergence(create_train_state(model, optimizer=torch.optim.SGD(model.parameters(),
                                                                          lr=0.05)),
                       make_train_step(tloss, pred_key="logits", num_classes=2),
                       port_eval, _tiny_chip, _args(), tlog, extra_record={"tile": 64})
    jrecs = [json.loads(line) for line in jlog.getvalue().splitlines()]
    trecs = [json.loads(line) for line in tlog.getvalue().splitlines()]
    assert len(jrecs) == len(trecs) == 2
    for j, t in zip(jrecs, trecs):
        assert set(t) == set(j) | {"chips_per_s", "synth_secs"}
        for key in ("train_loss", "eval_loss"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-5)
        for key in ("iou", "f1", "precision", "recall", "accuracy"):
            assert abs(t[key] - j[key]) <= 1e-3, key
        assert (t["epoch"], t["tile"]) == (j["epoch"], j["tile"])
    # the eval confusion matrices: equal but for pixels whose float32
    # probability lies within 1e-5 of the threshold, where the two
    # packages' rounding may fall on either side
    assert len(jcms) == len(tcms) == len(near) == 4
    for got, want, n in zip(tcms, jcms, near):
        assert got.sum() == want.sum() and got.sum(axis=1).tolist() == want.sum(axis=1).tolist()
        assert np.abs(got - want).sum() / 2 <= n
    assert sum(c[1, 1] for c in tcms) > 0 and sum(c[0, 0] for c in tcms) > 0


def test_keep_best_state_restores_the_best_epoch():
    """A metric that falls each epoch makes epoch 0 the best: the returned
    model holds epoch 0's parameters and BatchNorm buffers, not the last
    epoch's, and ``on_best`` ran once."""
    _, _, model = _narrow_unet_pair()
    tloss = lambda y, p: losses.weighted_bce(y, p, pos_weight=2.0, logits=True)  # noqa: E731
    calls, seen = [], []

    def falling(cm):
        calls.append(1)
        return {"iou": 1.0 / len(calls)}

    def on_best(state, best):
        seen.append(({k: v.clone() for k, v in state.model.state_dict().items()}, best))

    state, best = cc.run_convergence(
        create_train_state(model, 9e-4), make_train_step(tloss), make_eval_step(tloss),
        _tiny_chip, _args(epochs=3), io.StringIO(), metrics_fn=falling,
        keep_best_state=True, on_best=on_best)
    assert best["epoch"] == 0 and len(seen) == 1
    got = state.model.state_dict()
    for k, v in seen[0][0].items():
        assert torch.equal(got[k], v), k


# ------------------------------------------------------------ scene evals


class _Recorder(TiledInferenceEngine):
    """The engine with each ``predict_scene`` output kept."""
    outputs = []

    def predict_scene(self, scene, valid_chips=None):
        out = super().predict_scene(scene, valid_chips)
        _Recorder.outputs.append(out.float().numpy())
        return out


def test_solar_scene_eval_matches_jax(jx, monkeypatch):
    """The solar scene eval (chips, hann, whole over the 1024² scene of
    unseen chips) from bridged weights: each mode's probabilities within
    1e-5 of the JAX engine's and its IoU equal."""
    from satellite_computervision_tpu.inference import TiledInferenceEngine as JaxEngine

    jmodel = JaxUNet(n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
                     threshold=0.9, bn_momentum=0.9, dtype=jnp.float32)
    variables = jmodel.init(jax.random.key(3), jnp.zeros((1, 64, 64, 6)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # a head bias that puts a quarter of a chip's pixels above 0.9
    chip = solar_twin.make_chip("scene", 0)[0][None].astype(np.float32)
    logits = np.asarray(jmodel.apply(variables, chip)["logits"]).ravel()
    variables["params"]["head"]["bias"] = variables["params"]["head"]["bias"] + np.float32(
        np.log(9.0) - np.quantile(logits, 0.75))

    g = 4
    pairs = [jx.solar_convergence.make_chip("scene", i) for i in range(g * g)]
    scene = np.concatenate(
        [np.concatenate([pairs[r * g + c][0] for c in range(g)], 1) for r in range(g)], 0)
    labels = np.concatenate(
        [np.concatenate([pairs[r * g + c][1] for c in range(g)], 1) for r in range(g)], 0
    )[..., 0].astype(bool)
    want_probs, want_iou = [], {}
    for mode, kw in [("chips", dict(blend="overwrite", index_mode="grid")),
                     ("hann", dict(blend="hann", index_mode="grid")),
                     ("whole", dict(tile_mode="whole", whole_multiple=32))]:
        eng = JaxEngine(lambda c: jmodel.apply(variables, c)["probs"], kernel=256, buffer=128,
                        batch_size=8, out_channels=1, **kw)
        prob = np.asarray(eng.predict_scene(jnp.asarray(scene)))[..., 0]
        want_probs.append(prob)
        want_iou[mode] = solar_twin.scene_iou(prob, labels, 0.9)

    model = UNet(6, n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
                 threshold=0.9, bn_momentum=0.9)
    model.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"], model))
    _Recorder.outputs = []
    monkeypatch.setattr(solar_twin, "TiledInferenceEngine", _Recorder)
    got_iou = solar_twin.scene_eval(model, 0.9, False, torch.device("cpu"))
    assert got_iou == want_iou
    assert len(_Recorder.outputs) == 3
    for got, want in zip(_Recorder.outputs, want_probs):
        np.testing.assert_allclose(got[..., 0], want, atol=1e-5)
    assert max(want_iou.values()) > 0  # both classes predicted somewhere


def test_change_scene_eval_matches_jax(jx, monkeypatch):
    """The change scene eval (items -> change_pair_composite -> hann and
    whole engines) from bridged weights of a narrow Siamese U-Net: each
    mode's probabilities within 1e-5 of the JAX script's ``scene_eval`` and
    its IoU equal."""
    import flax.linen as nn
    from satellite_computervision_tpu.inference import TiledInferenceEngine as JaxEngine

    nb = change_twin.NB

    class Stacked(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            core = JaxSiamese(filters=(4, 8), factors=(2, 2), threshold=0.5,
                              dtype=jnp.float32, name="core")
            return core(x[..., :nb], x[..., nb:], train=train)

    jmodel = Stacked()
    variables = jmodel.init(jax.random.key(5), jnp.zeros((1, 64, 64, 2 * nb)))
    variables = jax.tree_util.tree_map(np.asarray, variables)

    want_probs = []

    class JaxRecorder(JaxEngine):
        def predict_scene(self, scene, *a, **kw):
            out = super().predict_scene(scene, *a, **kw)
            want_probs.append(np.asarray(out))
            return out

    monkeypatch.setattr(jx.change_convergence, "TiledInferenceEngine", JaxRecorder)
    want_iou = jx.change_convergence.scene_eval(jmodel, variables, 0.5)

    monkeypatch.setattr(change_twin, "SiameseUNet", narrowed(
        SiameseUNet, filters=(4, 8), factors=(2, 2)))
    model = change_twin.StackedSiamese(threshold=0.5)
    model.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"], model))
    _Recorder.outputs = []
    monkeypatch.setattr(change_twin, "TiledInferenceEngine", _Recorder)
    got_iou = change_twin.scene_eval(model, 0.5, device="cpu")
    assert got_iou == want_iou and set(got_iou) == {"hann", "whole"}
    for got, want in zip(_Recorder.outputs, want_probs):
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert len(_Recorder.outputs) == 2


# ---------------------------------------------------------------- parking


def _narrow_parking(monkeypatch):
    monkeypatch.setattr(parking_twin, "K", 192)
    monkeypatch.setattr(parking_twin, "DeepLabV3Plus", functools.partial(
        DeepLabV3Plus, stage_sizes=(1, 1, 1, 1), aspp_features=16))
    monkeypatch.setattr(parking_twin, "UNet", narrowed(UNet, filters=(4, 8), factors=(2, 2)))


def test_parking_warm_start_round_trip(tmp_path, monkeypatch):
    """``--export-backbone`` writes the trained backbone in torchvision's
    layout; ``--torch-weights`` reads it back into a fresh model."""
    _narrow_parking(monkeypatch)
    pth, out = tmp_path / "backbone.pth", tmp_path / "parking.jsonl"
    flags = ["--model", "deeplab", "--train-size", "2", "--eval-size", "2", "--epochs", "1",
             "--batch-size", "2", "--out", str(out), "--device", "cpu"]
    trained = {}
    real = parking_twin.export_torch_resnet_weights

    def export(model, path):
        trained.update({k: v.clone() for k, v in model.state_dict().items()})
        return real(model, path)

    monkeypatch.setattr(parking_twin, "export_torch_resnet_weights", export)
    parking_twin.main(flags + ["--export-backbone", str(pth)])
    fresh = parking_twin.build_model("deeplab", 1)
    written = load_torch_resnet_weights(fresh, str(pth))
    assert written and all(k.startswith("backbone.") for k in written)
    state = fresh.state_dict()
    for k in written:
        assert torch.equal(state[k], trained[k].float()), k
    summary = parking_twin.main(flags + ["--torch-weights", str(pth)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r.get("warm_start") for r in recs if "epoch" in r] == [False, True]
    assert summary["config"]["torch_weights"] == str(pth)


@pytest.mark.parametrize("flag", ["--torch-weights", "--export-backbone"])
def test_parking_refuses_weights_for_the_unet(tmp_path, monkeypatch, flag):
    _narrow_parking(monkeypatch)
    with pytest.raises(SystemExit, match="apply to --model deeplab"):
        parking_twin.main(["--model", "unet", flag, str(tmp_path / "b.pth"), "--device", "cpu",
                           "--out", str(tmp_path / "p.jsonl")])
    assert not (tmp_path / "p.jsonl").exists()


# -------------------------------------------------------------- the flags


class _Parsed(Exception):
    pass


def _flags(main, monkeypatch):
    """{dest: default} of the parser ``main`` builds."""
    got = {}

    def capture(self, args=None, namespace=None):
        got.update({a.dest: a.default for a in self._actions if a.dest != "help"})
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            main([])
    return got


@pytest.mark.parametrize("name", ["solar_convergence", "change_convergence",
                                  "parking_convergence", "swath_codec_sweep"])
def test_twin_flags_are_the_jax_scripts_plus_device(jx, monkeypatch, name):
    from satellite_computervision_tpu_torch import swath_codec_sweep

    port = {"solar_convergence": solar_twin, "change_convergence": change_twin,
            "parking_convergence": parking_twin, "swath_codec_sweep": swath_codec_sweep}[name]
    want = _flags(getattr(jx, name).main, monkeypatch)
    got = _flags(port.main, monkeypatch)
    assert got.pop("device") == "cuda"
    log = "log" if name == "swath_codec_sweep" else "out"
    assert got.pop(log) == "runs/torch/" + pathlib.Path(want.pop(log)).name
    assert got == want


# --------------------------------------------------------- the twins' runs


def test_solar_twin_runs_on_the_cpu(tmp_path, monkeypatch):
    """main at tiny sizes: two epochs, the best checkpoint saved and
    loadable by the predict CLI's loader, the three scene modes scored."""
    from satellite_computervision_tpu_torch import predict

    monkeypatch.setattr(solar_twin, "UNet", narrowed(UNet, filters=(4, 8), factors=(2, 2)))
    out = tmp_path / "solar.jsonl"
    summary = solar_twin.main(["--train-size", "4", "--eval-size", "2", "--epochs", "2",
                               "--batch-size", "2", "--tile", "128", "--scene-eval",
                               "--out", str(out), "--device", "cpu"])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    epochs = [r for r in lines if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["eval_loss"]) for r in epochs)
    assert all(r["tile"] == 128 and r["space_to_depth"] is False for r in epochs)
    assert set(lines[-2]["scene_eval_iou"]) == {"chips", "hann", "whole"}
    assert summary["final"]["epoch"] in (0, 1)
    served = predict.load_model(str(tmp_path / "solar_ckpt"), torch.device("cpu"),
                                fold_bn=True)
    probs = served(torch.zeros(1, 64, 64, 6))["probs"]
    assert probs.shape == (1, 64, 64, 1) and bool(torch.isfinite(probs).all())


def test_change_twin_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(change_twin, "SiameseUNet", narrowed(
        SiameseUNet, filters=(4, 8), factors=(2, 2)))
    monkeypatch.setattr(change_twin, "K", 128)
    out = tmp_path / "change.jsonl"
    summary = change_twin.main(["--train-size", "4", "--eval-size", "2", "--epochs", "1",
                                "--batch-size", "2", "--scene-eval", "--out", str(out),
                                "--device", "cpu"])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert np.isfinite(lines[0]["train_loss"]) and lines[0]["epoch"] == 0
    assert set(summary["scene_eval_iou"]) == {"hann", "whole"}
    assert lines[-1]["scene_eval_iou"] == summary["scene_eval_iou"]
