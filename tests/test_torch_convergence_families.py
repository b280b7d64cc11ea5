"""The port's convergence twins of the training-only families against the
JAX scripts in ``examples/`` (landcover, hierarchical, hybrid, LSTM-AE,
timeseries forecast), at tiny widths and counts on the CPU:

- every ``make_chip`` and ``batches`` bit-equal to the JAX script's, and
  the landcover palette equal;
- every twin's flags the JAX script's plus ``--device``;
- each twin's ``main`` against the JAX script's ``main`` from bridged
  weights (float32 in both, plain SGD in both, as
  tests/test_torch_convergence.py steps and for the reason it gives): the
  records' losses within 1e-5 relative, their metrics within 1e-3 (rounded
  to 4 places in both), their keys JAX's plus the port's two timings;
- landcover's scene eval (hann: one ``hann_stitch`` of 8 channels; whole)
  with the probabilities within 1e-5 and the per-mode mean IoU equal;
- the hierarchical model's three confusion matrices of one eval batch
  equal but for pixels whose top two probabilities lie within 1e-5, bounded
  by their count.
"""

import functools
import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import satellite_computervision_tpu.inference as jax_inference
from satellite_computervision_tpu.models import HierarchicalACNN as JaxHierarchical
from satellite_computervision_tpu.models import HybridUNetLSTM as JaxHybrid
from satellite_computervision_tpu.models import LSTMAutoencoder as JaxLSTMAE
from satellite_computervision_tpu.models import LSTMModel as JaxLSTMModel
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.models import metrics as jmetrics
from satellite_computervision_tpu_torch import hierarchical_convergence as hier_twin
from satellite_computervision_tpu_torch import hybrid_convergence as hybrid_twin
from satellite_computervision_tpu_torch import landcover_convergence as lc_twin
from satellite_computervision_tpu_torch import lstm_ae_convergence as ae_twin
from satellite_computervision_tpu_torch import timeseries_forecast_convergence as ts_twin
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.kernels import stitch
from satellite_computervision_tpu_torch.models import (
    HierarchicalACNN,
    HybridUNetLSTM,
    LSTMAutoencoder,
    LSTMModel,
    UNet,
    flax_to_torch,
)
from test_torch_convergence import _flags, load_example
from test_torch_deeplab import two_torch_threads  # noqa: F401

TWINS = {"landcover_convergence": lc_twin, "hierarchical_convergence": hier_twin,
         "hybrid_convergence": hybrid_twin, "lstm_ae_convergence": ae_twin,
         "timeseries_forecast_convergence": ts_twin}
PORT_KEYS = {"chips_per_s", "synth_secs"}


@pytest.fixture(scope="module")
def jx():
    return types.SimpleNamespace(**{n: load_example(n) for n in TWINS})


# --------------------------------------------------------------- chips


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w, equal_nan=True)


@pytest.mark.parametrize("split,index", [("train", 3), ("eval", 0), ("scene", 11)])
@pytest.mark.parametrize("name", sorted(TWINS))
def test_make_chip_is_bit_equal(jx, name, split, index):
    _equal(TWINS[name].make_chip(split, index), getattr(jx, name).make_chip(split, index))


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("name", ["hierarchical_convergence", "hybrid_convergence",
                                  "lstm_ae_convergence"])
def test_batches_are_bit_equal(jx, name, shuffle):
    """Two epochs' streams from one rng each: the same nested batches in the
    same order (a last partial batch dropped)."""
    rngs = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        got = list(TWINS[name].batches("train", 5, 2, rngs[0], shuffle=shuffle, device="cpu"))
        want = list(getattr(jx, name).batches("train", 5, 2, rngs[1], shuffle=shuffle))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _equal(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda t: t.numpy(), g)), jax.tree_util.tree_leaves(w))


def test_landcover_palette_is_equal(jx):
    jl = jx.landcover_convergence
    assert (lc_twin.K, lc_twin.CLASSES, lc_twin.NCLASS, lc_twin.NB, lc_twin.NATURAL) == (
        jl.K, jl.CLASSES, jl.NCLASS, jl.NB, jl.NATURAL)
    assert lc_twin.SIGS.dtype == jl.SIGS.dtype and np.array_equal(lc_twin.SIGS, jl.SIGS)
    for name in ("K", "T", "NB"):
        assert getattr(hier_twin, name) == getattr(jx.hierarchical_convergence, name)
    assert (hybrid_twin.K, hybrid_twin.KS) == (jx.hybrid_convergence.K, jx.hybrid_convergence.KS)
    assert (ae_twin.T, ae_twin.K, ae_twin.C, ae_twin.T_IN, ae_twin.PERIOD) == (
        jx.lstm_ae_convergence.T, jx.lstm_ae_convergence.K, jx.lstm_ae_convergence.C,
        jx.lstm_ae_convergence.T_IN, jx.lstm_ae_convergence.PERIOD)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_flags_are_the_jax_scripts_plus_device(jx, monkeypatch, name):
    want = _flags(getattr(jx, name).main, monkeypatch)
    got = _flags(TWINS[name].main, monkeypatch)
    assert got.pop("device") == "cuda"
    assert got.pop("out") == "runs/torch/" + want.pop("out").split("/")[-1]
    assert got == want


# ------------------------------------------------------- main against main


def jitted_init(cls):
    """The flax module ``cls`` with its ``init`` jitted (an eager init of
    these models costs seconds of op-by-op dispatch on the CPU)."""

    class Jitted(cls):
        def init(self, *args, **kwargs):
            return jax.jit(functools.partial(cls.init, self, **kwargs))(*args)

    return Jitted


def narrowed(cls, **fields):
    """The JAX module ``cls``, its ``init`` jitted, with ``fields`` forced
    over the caller's keyword arguments (the scripts pass their widths and
    ``dtype`` explicitly)."""
    jitted = jitted_init(cls)
    return lambda *a, **kw: jitted(*a, **{**kw, **fields})


def _jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cut_chips(monkeypatch, jmod, tmod, **sides):
    """The chip sides ``sides`` (module constants: K, and the hybrid's
    series side KS) set in both the JAX script and its twin."""
    for name, value in sides.items():
        monkeypatch.setattr(jmod, name, value)
        monkeypatch.setattr(tmod, name, value)


def run_jax_main(jmod, argv, tmp_path, monkeypatch, **patches):
    """The JAX script's ``main(argv)`` with plain SGD for Adam and
    ``patches`` on its module -> (JSONL lines, host copy of the initial
    variables)."""
    real = jmod.create_train_state
    init = {}

    def recording(*args, **kwargs):
        state = real(*args, **kwargs)
        init.update(params=_host(state.params), batch_stats=_host(state.batch_stats))
        return state

    monkeypatch.setattr(jmod, "create_train_state", recording)
    monkeypatch.setattr(jmod, "optax", types.SimpleNamespace(adam=optax.sgd))
    for name, value in patches.items():
        monkeypatch.setattr(jmod, name, value)
    out = tmp_path / "jax.jsonl"
    jmod.main(argv + ["--out", str(out)])
    return _jsonl(out), init


def run_port_main(tmod, argv, tmp_path, monkeypatch, model, init):
    """The twin's ``main(argv)`` on the CPU from ``model`` with the bridged
    ``init``, plain SGD for Adam -> (JSONL lines, returned summary)."""
    model.load_state_dict(flax_to_torch(init["params"], init["batch_stats"], model))
    real = tmod.create_train_state
    monkeypatch.setattr(tmod, "build_model", lambda *a, **kw: model)
    monkeypatch.setattr(tmod, "create_train_state", lambda m, lr: real(
        m, optimizer=torch.optim.SGD(m.parameters(), lr=lr)))
    out = tmp_path / "port.jsonl"
    summary = tmod.main(argv + ["--out", str(out), "--device", "cpu"])
    return _jsonl(out), summary


def compare_records(jrecs, trecs, loss_keys, tol_keys=()):
    """Epoch records: keys JAX's plus the port's timings; ``loss_keys``
    within 1e-5 relative (and 1e-6 absolute: 6-place rounding), the other
    numbers within 1e-3 (4-place rounding of near-equal values), and
    ``tol_keys`` held as losses."""
    jep = [r for r in jrecs if "epoch" in r]
    tep = [r for r in trecs if "epoch" in r]
    assert len(jep) == len(tep) > 0
    for j, t in zip(jep, tep):
        assert set(t) == set(j) | PORT_KEYS
        for key, want in j.items():
            if key in ("secs", "epoch") or not isinstance(want, (int, float)):
                assert key == "secs" or t[key] == want, key
            elif key in loss_keys or key in tol_keys:
                np.testing.assert_allclose(t[key], want, rtol=1e-5, atol=1e-6, err_msg=key)
            else:
                assert abs(t[key] - want) <= 1e-3, (key, t[key], want)


FLAGS = ["--train-size", "4", "--eval-size", "4", "--epochs", "2", "--batch-size", "2",
         "--lr", "0.01"]


class _Recorder:
    """An engine class whose ``predict_scene`` outputs are kept."""

    def __init__(self, base):
        self.outputs = []
        recorder = self

        class Engine(base):
            def predict_scene(self, scene, *args, **kwargs):
                out = super().predict_scene(scene, *args, **kwargs)
                recorder.outputs.append(np.asarray(out))
                return out

        self.cls = Engine


@pytest.mark.parametrize("loss,counts,scene", [("wcce", "batch", True),
                                               ("gen_dice", "batch", False),
                                               ("gen_dice", "element", False)])
def test_landcover_main_matches_jax(jx, tmp_path, monkeypatch, loss, counts, scene):
    """One or two epochs of the multiclass U-Net (narrowed to 4/8, 128²
    chips) from bridged weights; with ``--scene-eval`` the best state over
    the 512² scene in
    hann and whole modes: probabilities within 1e-5, one 8-channel
    ``hann_stitch`` held against its plain version, the argmax maps equal
    but where the top two probabilities lie within 1e-5, mean IoU equal."""
    jl = jx.landcover_convergence
    cut_chips(monkeypatch, jl, lc_twin, K=128)
    # one epoch without the scene eval; two with it, so keep-best chooses
    argv = FLAGS + ["--loss", loss, "--gdl-counts", counts] + (
        ["--scene-eval"] if scene else ["--epochs", "1"])
    jrec = _Recorder(jax_inference.TiledInferenceEngine)
    monkeypatch.setattr(jax_inference, "TiledInferenceEngine", jrec.cls)
    jrecs, init = run_jax_main(jl, argv, tmp_path, monkeypatch, UNet=narrowed(
        JaxUNet, filters=(4, 8), factors=(2, 2), dtype=jnp.float32))

    trec = _Recorder(TiledInferenceEngine)
    monkeypatch.setattr(lc_twin, "TiledInferenceEngine", trec.cls)
    stitches = []
    real_stitch = stitch.hann_stitch

    def counted(chips, *args, **kwargs):
        out = real_stitch(chips, *args, **kwargs)
        stitches.append(np.abs(out.numpy() - stitch.hann_stitch_reference(
            chips, *args, **kwargs).numpy()).max())
        return out

    monkeypatch.setattr("satellite_computervision_tpu_torch.inference.tiles.hann_stitch",
                        counted)
    model = UNet(4, n_classes=8, filters=(4, 8), factors=(2, 2), head="softmax")
    trecs, summary = run_port_main(lc_twin, argv, tmp_path, monkeypatch, model, init)
    compare_records(jrecs, trecs, ("train_loss", "eval_loss"))
    assert all(r["loss_name"] == loss for r in trecs if "epoch" in r)
    assert all(("gdl_counts" in r) == (loss == "gen_dice") for r in trecs if "epoch" in r)
    assert trecs[-1]["final"]["epoch"] == jrecs[-1]["final"]["epoch"]
    assert trecs[-1]["loss_name"] == jrecs[-1]["loss_name"] == loss
    if not scene:
        assert not jrec.outputs and not trec.outputs and not stitches
        return
    assert stitches == [0.0]
    want_miou = [r["scene_eval_mean_iou"] for r in jrecs if "scene_eval_mean_iou" in r]
    assert summary["scene_eval_mean_iou"] == want_miou[0] and set(want_miou[0]) == {
        "hann", "whole"}
    assert [r for r in trecs if "scene_eval_mean_iou" in r] == [
        {"scene_eval_mean_iou": want_miou[0], "loss_name": loss}]
    assert len(jrec.outputs) == len(trec.outputs) == 2
    for got, want in zip(trec.outputs, jrec.outputs):
        assert got.shape == want.shape == (512, 512, 8)
        np.testing.assert_allclose(got, want, atol=1e-5)
        top2 = np.sort(want, -1)[..., -2:]
        moved = np.argmax(got, -1) != np.argmax(want, -1)
        assert not (moved & (top2[..., 1] - top2[..., 0] >= 1e-5)).any()


def test_hierarchical_main_matches_jax(jx, tmp_path, monkeypatch):
    cut_chips(monkeypatch, jx.hierarchical_convergence, hier_twin, K=64)
    argv = FLAGS + ["--n-blocks", "3", "--features", "4", "--lstm-features", "4"]
    jrecs, init = run_jax_main(jx.hierarchical_convergence, argv, tmp_path, monkeypatch,
                               HierarchicalACNN=narrowed(JaxHierarchical, dtype=jnp.float32))
    model = HierarchicalACNN(4, 4, 6, 6, 3, n_blocks=3, features=4, lstm_features=4)
    trecs, summary = run_port_main(hier_twin, argv, tmp_path, monkeypatch, model, init)
    compare_records(jrecs, trecs, ("train_loss", "eval_loss"))
    assert summary["final"].keys() == jrecs[-1]["final"].keys()
    assert summary["final"]["epoch"] == jrecs[-1]["final"]["epoch"]


def test_hybrid_main_matches_jax(jx, tmp_path, monkeypatch):
    cut_chips(monkeypatch, jx.hybrid_convergence, hybrid_twin, K=48, KS=16)
    argv = FLAGS + ["--lstm-features", "4"]
    jrecs, init = run_jax_main(jx.hybrid_convergence, argv, tmp_path, monkeypatch,
                               HybridUNetLSTM=narrowed(JaxHybrid, filters=(4, 4, 8, 8),
                                                       dtype=jnp.float32))
    model = HybridUNetLSTM(4, 4, 6, filters=(4, 4, 8, 8), lstm_features=4)
    trecs, summary = run_port_main(hybrid_twin, argv, tmp_path, monkeypatch, model, init)
    compare_records(jrecs, trecs, ("train_loss", "eval_loss"))
    assert summary["final"] == {k: pytest.approx(v, abs=1e-3)
                                for k, v in jrecs[-1]["final"].items()}


def test_lstm_ae_main_matches_jax(jx, tmp_path, monkeypatch):
    # batch 1: the JAX ConvLSTM decoder's step takes seconds on the CPU
    argv = FLAGS + ["--features", "4", "--train-size", "2", "--eval-size", "2",
                    "--batch-size", "1", "--epochs", "1"]
    jrecs, init = run_jax_main(jx.lstm_ae_convergence, argv, tmp_path, monkeypatch,
                               LSTMAutoencoder=narrowed(JaxLSTMAE, dtype=jnp.float32))
    model = LSTMAutoencoder(4, 4, 5, features=4)
    trecs, _ = run_port_main(ae_twin, argv, tmp_path, monkeypatch, model, init)
    compare_records(jrecs, trecs, ("train_loss", "forecast_mse", "reconstruction_mse",
                                   "persistence_mse"))


def test_timeseries_main_matches_jax(jx, tmp_path, monkeypatch):
    argv = FLAGS + ["--features", "4"]
    jrecs, init = run_jax_main(jx.timeseries_forecast_convergence, argv, tmp_path, monkeypatch,
                               LSTMModel=narrowed(JaxLSTMModel, dtype=jnp.float32))
    model = LSTMModel(4, 4, features=4)
    trecs, _ = run_port_main(ts_twin, argv, tmp_path, monkeypatch, model, init)
    compare_records(jrecs, trecs, ("train_loss", "eval_mse", "persistence_mse"))


# -------------------------------------------------- the multi-head eval


def test_hierarchical_confusion_matrices_match_jax(jx):
    """One eval batch of 4 chips through the three heads from bridged
    He-normal weights: the loss within 1e-5 relative; each head's confusion
    matrix equal to the JAX script's (argmax of the truth against the argmax
    of the head's probabilities) but for pixels whose top two probabilities
    lie within 1e-5 in float32, bounded by their count."""
    from test_torch_deeplab import random_variables

    jmodel = JaxHierarchical(n_classes=6, acnn_classes=6, sub_classes=3, n_blocks=3,
                             features=4, lstm_features=4, dtype=jnp.float32)
    (img, ser), (ym, ys) = next(hier_twin.batches("eval", 4, 4, np.random.default_rng(0),
                                                  shuffle=False, device="cpu"))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), img.numpy(), ser.numpy())
    variables = random_variables(shapes, np.random.default_rng(1))
    out = jax.jit(jmodel.apply)(variables, img.numpy(), ser.numpy())
    ymi = np.argmax(ym.numpy(), -1)
    want = {h: np.asarray(jmetrics.confusion_matrix(ymi, np.argmax(out[f"{h}_probs"], -1), 6))
            for h in ("lstm", "acnn")}
    want["sub"] = np.asarray(jmetrics.confusion_matrix(
        np.argmax(ys.numpy(), -1), np.argmax(out["sub_probs"], -1), 3))
    y = (ym.numpy(), ys.numpy())
    wcce = jx.hierarchical_convergence.losses.weighted_categorical_crossentropy
    want_loss = float(wcce(y[0], out["lstm_probs"], hier_twin.W_MAIN, reduce_mean=True)
                      + wcce(y[0], out["acnn_probs"], hier_twin.W_MAIN, reduce_mean=True)
                      + wcce(y[1], out["sub_probs"], hier_twin.W_SUB, reduce_mean=True))

    model = HierarchicalACNN(4, 4, 6, 6, 3, n_blocks=3, features=4, lstm_features=4)
    model.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"], model))
    loss, cms = hier_twin.eval_batch(model, (img, ser), (ym, ys))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    with torch.no_grad():
        probs = model(img, ser)
    for head, cm in cms.items():
        top2 = torch.sort(probs[f"{head}_probs"], -1).values[..., -2:]
        near = int((top2[..., 1] - top2[..., 0] < 1e-5).sum())
        got = cm.numpy()
        assert got.sum() == want[head].sum() == 4 * 128 * 128
        assert (got.sum(1) == want[head].sum(1)).all()
        assert np.abs(got - want[head]).sum() / 2 <= near, head
        assert np.count_nonzero(got) > 1, head  # more than one class predicted
