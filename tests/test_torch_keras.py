"""The port's Keras ``.h5`` bridge against the JAX package's, on the CPU at
narrow widths:

- ``models.bridge.torch_to_flax`` inverts ``flax_to_torch`` on all eight
  families (and a folded U-Net), and gives the JAX model's tree layout;
- import: for each of the five ``.h5`` families, one file written by the
  JAX exporter from a seeded flax tree is loaded by the JAX loader and by
  the port's loader (into a model built on the meta device); the eval
  forwards agree at rtol 1e-4 / atol 1e-5 (test_torch_unet.py's
  tolerance). The random kernels are not symmetric, so a wrong flip of a
  transposed-conv kernel or a wrong ASPP order shows;
- export: the port's exporter and the JAX exporter, given the same bridged
  weights, write equal layer names, equal weight names and bit-equal
  arrays; each package reads the other's file back (bit-equal, the
  ConvLSTM forget bias within one rounding of the +1 stored by Keras, as
  tests/test_keras_export.py holds JAX's own round trip);
- the JAX exporter's two faults are refused in the port with a
  ``ValueError``; unit-count and shape mismatches raise the JAX loader's
  ``ValueError``;
- the ``export`` CLI against ``scripts/export.py``, and ``evaluate --h5``
  against ``scripts/evaluate.py --h5`` (both folded and ``--no-fold``;
  the JAX CLI's U-Net built in float32 so the confusion counts are
  equal).
"""

import dataclasses
import functools
import importlib.util
import io
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

h5py = pytest.importorskip("h5py")

import satellite_computervision_tpu.models as jax_models
from satellite_computervision_tpu.models import HybridUNetLSTM as JaxHybrid
from satellite_computervision_tpu.models import SiameseUNet as JaxSiamese
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.models.convlstm import LSTMAutoencoder as JaxLSTMAE
from satellite_computervision_tpu.models.convlstm import LSTMModel as JaxLSTM
from satellite_computervision_tpu.train import keras_export as jke
from satellite_computervision_tpu.train import keras_import as jki
from satellite_computervision_tpu.train import save_checkpoint as jax_save_checkpoint
from satellite_computervision_tpu.train.config import CONFIGS as JAX_CONFIGS
from satellite_computervision_tpu.train.trainer import TrainState
from satellite_computervision_tpu_torch import evaluate as eval_cli
from satellite_computervision_tpu_torch import export as export_cli
from satellite_computervision_tpu_torch import predict
from satellite_computervision_tpu_torch.data.tfrecord import write_tfrecord_file
from satellite_computervision_tpu_torch.models import (
    ACNN,
    DeepLabV3Plus,
    HierarchicalACNN,
    HybridUNetLSTM,
    LSTMAutoencoder,
    LSTMModel,
    SiameseUNet,
    UNet,
    flax_to_torch,
    fold_unet,
    torch_to_flax,
)
from satellite_computervision_tpu_torch.train import keras_export as tke
from satellite_computervision_tpu_torch.train import keras_import as tki
from satellite_computervision_tpu_torch.train.checkpoint import build_empty, save_checkpoint
from satellite_computervision_tpu_torch.train.config import CONFIGS
from test_torch_deeplab import random_variables, two_torch_threads  # noqa: F401
from test_torch_evaluate import _shaped_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
UX = (2, 16, 16, 3)  # U-Net inputs
SX = (2, 3, 8, 8, 2)  # series inputs


@dataclasses.dataclass
class Family:
    jax_model: callable
    port_model: callable
    inputs: callable  # rng -> tuple of numpy inputs
    jax_export: callable
    jax_load: callable
    port_export: callable
    port_load: callable


FAMILIES = {
    "unet": Family(
        lambda: JaxUNet(n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
                        convs_per_block=1),
        lambda: UNet(3, n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
                     convs_per_block=1),
        lambda rng: (rng.normal(size=UX).astype(np.float32),),
        jke.export_keras_unet_h5, jki.load_keras_unet_h5,
        tke.export_keras_unet_h5, tki.load_keras_unet_h5),
    "siamese": Family(
        lambda: JaxSiamese(filters=(4, 8), factors=(2, 2), convs_per_block=2),
        lambda: SiameseUNet(3, filters=(4, 8), factors=(2, 2), convs_per_block=2),
        lambda rng: (rng.normal(size=UX).astype(np.float32),
                     rng.normal(size=UX).astype(np.float32)),
        jke.export_keras_siamese_h5, jki.load_keras_siamese_h5,
        tke.export_keras_siamese_h5, tki.load_keras_siamese_h5),
    "lstm": Family(
        lambda: JaxLSTM(n_classes=1, features=4),
        lambda: LSTMModel(2, 1, features=4),
        lambda rng: (rng.uniform(0, 1, SX).astype(np.float32),),
        jke.export_keras_lstm_h5, jki.load_keras_lstm_h5,
        tke.export_keras_lstm_h5, tki.load_keras_lstm_h5),
    "lstm_autoencoder": Family(
        lambda: JaxLSTMAE(n_classes=1, n_time=3, features=4),
        lambda: LSTMAutoencoder(2, 1, 3, features=4),
        lambda rng: (rng.uniform(0, 1, SX).astype(np.float32),
                     rng.uniform(-1, 1, (2, 8, 8, 2)).astype(np.float32)),
        jke.export_keras_lstm_autoencoder_h5, jki.load_keras_lstm_autoencoder_h5,
        tke.export_keras_lstm_autoencoder_h5, tki.load_keras_lstm_autoencoder_h5),
    "hybrid": Family(
        lambda: JaxHybrid(n_classes=3, filters=(4, 8), factors=(2, 2), lstm_features=6,
                          convs_per_block=1),
        lambda: HybridUNetLSTM(3, 2, 3, filters=(4, 8), factors=(2, 2), lstm_features=6,
                               convs_per_block=1),
        lambda rng: (rng.normal(size=UX).astype(np.float32),
                     rng.uniform(0, 1, (2, 3, 8, 8, 2)).astype(np.float32)),
        jke.export_keras_hybrid_h5, jki.load_keras_hybrid_h5,
        tke.export_keras_hybrid_h5, tki.load_keras_hybrid_h5),
}
LSTM_FAMILIES = ("lstm", "lstm_autoencoder", "hybrid")


def _jax_variables(fam, inputs, seed):
    jm = fam.jax_model()
    shapes = jax.eval_shape(jm.init, jax.random.key(0), *inputs)
    return jm, random_variables(shapes, np.random.default_rng(seed))


def _bridged(fam, v):
    model = fam.port_model()
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    return model.eval()


def _float_outputs(out):
    """The floating outputs of either package's forward, by name."""
    if not isinstance(out, dict):
        out = {"out": out}
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items() if k != "classes"}


def _assert_trees(a, b, atol=0.0):
    fa = jax.tree_util.tree_flatten_with_path(a)
    fb = jax.tree_util.tree_flatten_with_path(b)
    assert fa[1] == fb[1]
    for (path, x), (_, y) in zip(fa[0], fb[0]):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_states(got, want, atol=0.0):
    assert set(got) == set(want)
    for k in want:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=atol,
                                       err_msg=k)


def _h5_contents(path):
    with h5py.File(path, "r") as f:
        layers = [n.decode() for n in f.attrs["layer_names"]]
        out = []
        for lname in layers:
            wnames = [n.decode() for n in f[lname].attrs["weight_names"]]
            out.append((lname, [(w, np.asarray(f[lname][w])) for w in wnames]))
        return out, {k: f.attrs[k] for k in ("keras_version", "backend")}


def _eight_models():
    return [
        UNet(3, n_classes=2, filters=(4, 8), factors=(2, 2), space_to_depth=True),
        fold_unet(UNet(3, n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid")),
        SiameseUNet(3, filters=(4, 8), factors=(2, 2)),
        DeepLabV3Plus(3, n_classes=1, stage_sizes=(1, 1, 1, 1), aspp_features=8),
        LSTMModel(2, 1, features=4),
        LSTMAutoencoder(2, 1, 3, features=4),
        HybridUNetLSTM(3, 2, 3, filters=(4, 8), factors=(2, 2), lstm_features=4),
        ACNN(4, 3, n_blocks=2, features=4),
        HierarchicalACNN(4, 2, 5, 3, 2, n_blocks=2, features=4, lstm_features=4),
    ]


@pytest.mark.parametrize("index", range(9), ids=[
    "unet_s2d", "unet_folded", "siamese", "deeplab", "lstm", "lstm_autoencoder", "hybrid",
    "acnn", "hierarchical"])
def test_torch_to_flax_inverts_flax_to_torch(index):
    model = _eight_models()[index]
    g = torch.Generator().manual_seed(index)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.rand(t.shape, generator=g) + 0.25)
    params, stats = torch_to_flax(model)
    back = flax_to_torch(params, stats, model)
    _assert_states(back, model.state_dict())
    # a meta-device model gives zeros of its layout
    meta = build_empty(type(model), **model.kwargs) if hasattr(model, "kwargs") else None
    if meta is not None:
        mp, ms = torch_to_flax(meta)
        assert jax.tree_util.tree_structure(mp) == jax.tree_util.tree_structure(params)
        assert all(not a.any() for a in jax.tree_util.tree_leaves((mp, ms)))


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_to_flax_gives_the_jax_tree(family, rng):
    fam = FAMILIES[family]
    inputs = fam.inputs(rng)
    _, v = _jax_variables(fam, inputs, seed=1)
    params, stats = torch_to_flax(_bridged(fam, v))
    _assert_trees(params, v["params"])
    _assert_trees(stats, v["batch_stats"])


@pytest.mark.parametrize("family", FAMILIES)
def test_import_matches_jax_loader(family, rng, tmp_path):
    fam = FAMILIES[family]
    inputs = fam.inputs(rng)
    jm, v = _jax_variables(fam, inputs, seed=3)
    path = str(tmp_path / f"{family}.h5")
    fam.jax_export(v["params"], v["batch_stats"], path)

    _, fresh = _jax_variables(fam, inputs, seed=4)
    jp, js = fam.jax_load(path, fresh["params"], fresh["batch_stats"])
    want = _float_outputs(jm.apply({"params": jp, "batch_stats": js}, *inputs))
    template = fam.port_model()
    model = fam.port_load(path, build_empty(type(template), **template.kwargs))
    assert not any(t.is_meta for t in model.state_dict().values())
    with torch.no_grad():
        got = _float_outputs(model(*map(torch.from_numpy, inputs)))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("family", FAMILIES)
def test_export_matches_jax_exporter(family, rng, tmp_path):
    fam = FAMILIES[family]
    inputs = fam.inputs(rng)
    _, v = _jax_variables(fam, inputs, seed=5)
    jax_path, port_path = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    fam.jax_export(v["params"], v["batch_stats"], jax_path)
    model = _bridged(fam, v)
    fam.port_export(model, port_path)

    (jl, jattrs), (tl, tattrs) = _h5_contents(jax_path), _h5_contents(port_path)
    assert tattrs == jattrs
    assert [n for n, _ in tl] == [n for n, _ in jl]
    for (lname, jw), (_, tw) in zip(jl, tl):
        assert [w for w, _ in tw] == [w for w, _ in jw], lname
        for (wname, a), (_, b) in zip(jw, tw):
            assert a.dtype == b.dtype and a.shape == b.shape, wname
            np.testing.assert_array_equal(b, a, err_msg=wname)

    # each package reads the other's file
    ulp = 3e-7 if family in LSTM_FAMILIES else 0.0
    _, fresh = _jax_variables(fam, inputs, seed=6)
    jp, js = fam.jax_load(port_path, fresh["params"], fresh["batch_stats"])
    _assert_trees(jp, v["params"], atol=ulp)
    _assert_trees(js, v["batch_stats"])
    back = fam.port_load(jax_path, fam.port_model())  # loaded in place
    _assert_states(back.state_dict(), model.state_dict(), atol=ulp)


def test_unet_bytes_and_arch_inference():
    model = UNet(6, n_classes=5, filters=(4, 8, 16), factors=(2, 2, 2), convs_per_block=2)
    blob = tke.export_keras_unet_h5_bytes(model)
    assert tki.infer_unet_arch(blob) == jki.infer_unet_arch(blob) == {
        "bands": 6, "filters": (4, 8, 16), "factors": (2, 2, 2), "convs_per_block": 2,
        "n_classes": 5}
    back = tki.load_keras_unet_h5(blob, UNet(6, n_classes=5, filters=(4, 8, 16),
                                             factors=(2, 2, 2)))
    _assert_states(back.state_dict(), model.state_dict())
    # in memory: the layers the exporter builds load without a file
    layers = tke.keras_unet_layers(model)
    assert tki.infer_unet_arch(layers) == tki.infer_unet_arch(blob)
    siamese = SiameseUNet(3, filters=(4, 8), factors=(2, 2), convs_per_block=1)
    again = tki.load_keras_siamese_h5(tke.export_keras_siamese_h5_bytes(siamese),
                                      SiameseUNet(3, filters=(4, 8), factors=(2, 2),
                                                  convs_per_block=1))
    _assert_states(again.state_dict(), siamese.state_dict())


def test_export_refuses_the_jax_exporters_faults(tmp_path):
    """ADVICE.md's two faults of the JAX exporter: a Siamese U-Net of 4
    convs per block writes encoder groups the importer takes for the ASPP,
    and missing BatchNorm statistics raise a bare KeyError there."""
    deep = SiameseUNet(3, filters=(4, 8), factors=(2, 2), convs_per_block=4)
    jp, js = torch_to_flax(deep)
    jke.export_keras_siamese_h5(jp, js, str(tmp_path / "jax.h5"))  # JAX writes it ...
    with pytest.raises(ValueError):  # ... and cannot read it back
        jki.load_keras_siamese_h5(str(tmp_path / "jax.h5"), jp, js)
    with pytest.raises(ValueError, match="ASPP"):
        tke.export_keras_siamese_h5(deep, str(tmp_path / "port.h5"))
    for cpb in (1, 3):  # up to 3 convs per block round-trips
        ok = SiameseUNet(3, filters=(4, 8), factors=(2, 2), convs_per_block=cpb)
        back = tki.load_keras_siamese_h5(tke.export_keras_siamese_h5_bytes(ok),
                                         SiameseUNet(3, filters=(4, 8), factors=(2, 2),
                                                     convs_per_block=cpb))
        _assert_states(back.state_dict(), ok.state_dict())

    unet = UNet(3, n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid")
    p, s = torch_to_flax(unet)
    with pytest.raises(KeyError):
        jke.export_keras_unet_h5(p, {}, str(tmp_path / "jax_nostats.h5"))
    bn = unet.EncoderBlock_1.ConvBlock_0.ConvBNAct_0.BatchNorm_0
    bn.track_running_stats = False
    bn.running_mean = bn.running_var = None
    with pytest.raises(ValueError, match="export the training checkpoint"):
        tke.export_keras_unet_h5(unet, str(tmp_path / "nostats.h5"))
    lstm = LSTMModel(2, 1, features=4)
    lstm.LSTMStack_0.BatchNorm_1.running_mean = None
    with pytest.raises(ValueError, match="export the training checkpoint"):
        tke.export_keras_lstm_h5(lstm, str(tmp_path / "nostats_lstm.h5"))


def test_export_and_import_refusals(tmp_path):
    unet = UNet(3, n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid")
    with pytest.raises(ValueError, match="space_to_depth"):
        tke.export_keras_unet_h5(UNet(3, filters=(4, 8), factors=(2, 2),
                                      space_to_depth=True), str(tmp_path / "x.h5"))
    with pytest.raises(ValueError, match="fold"):
        tke.export_keras_unet_h5(fold_unet(unet), str(tmp_path / "x.h5"))
    for fn, name in ((tke.export_keras_lstm_h5, "LSTMModel"),
                     (tke.export_keras_lstm_autoencoder_h5, "LSTMAutoencoder"),
                     (tke.export_keras_hybrid_h5, "HybridUNetLSTM"),
                     (tke.export_keras_siamese_h5, "SiameseUNet")):
        with pytest.raises(ValueError, match=name):
            fn(unet, str(tmp_path / "x.h5"))
    blob = tke.export_keras_unet_h5_bytes(unet)  # 2 convs per block
    with pytest.raises(ValueError, match=r"convs_per_block=2"):
        tki.load_keras_unet_h5(blob, UNet(3, n_classes=1, filters=(4, 8), factors=(2, 2),
                                          convs_per_block=1))
    with pytest.raises(ValueError, match="kernel shape mismatch"):
        tki.load_keras_unet_h5(blob, UNet(3, n_classes=1, filters=(4, 16), factors=(2, 2)))
    with pytest.raises(ValueError, match="get_lstm_model"):
        tki.load_keras_lstm_h5(blob, LSTMModel(2, 1, features=4))
    with pytest.raises(ValueError, match="not a Keras HDF5"):
        buf = io.BytesIO()
        with h5py.File(buf, "w") as f:
            f.create_group("x")
        tki.read_keras_h5_units(buf.getvalue())


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}_cli",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # puts scripts/ on sys.path and imports predict
    return mod, sys.modules["predict"]


NARROW = dict(filters=(4, 8), factors=(2, 2))


def test_export_cli_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """One JAX ``state.msgpack`` of a plain-stem solar U-Net (both CLIs
    retry the stem, the solar preset's being space-to-depth) through
    ``scripts/export.py`` and the port's ``export``: the same files and
    the same printed line."""
    jexport, jpredict = _jax_script("export")
    monkeypatch.setattr(jpredict, "UNet", functools.partial(JaxUNet, **NARROW))
    monkeypatch.setattr(jpredict, "create_train_state", _shaped_state)
    monkeypatch.setattr(predict, "UNet", functools.partial(UNet, **NARROW))
    jm = JaxUNet(n_classes=1, head="sigmoid", **NARROW)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 64, 64, 6)))
    v = random_variables(shapes, np.random.default_rng(8))
    tx = optax.adam(1e-3)
    jax_save_checkpoint(str(tmp_path / "ckpt" / "best"), TrainState(
        step=jnp.asarray(3, jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
        opt_state=tx.init(v["params"]), apply_fn=jm.apply, tx=tx), step=3)
    ckpt = str(tmp_path / "ckpt")
    out_j, out_t = tmp_path / "j.h5", tmp_path / "t.h5"
    jexport.main(["--config", "solar", "--ckpt", ckpt, "--out", str(out_j)])
    j_line = capsys.readouterr().out.strip().splitlines()[-1]
    arch = export_cli.main(["--config", "solar", "--ckpt", ckpt, "--out", str(out_t),
                            "--device", "cpu"])
    t_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert t_line == j_line.replace(str(out_j), str(out_t))
    assert arch["filters"] == (4, 8) and arch["bands"] == 6
    (jl, _), (tl, _) = _h5_contents(out_j), _h5_contents(out_t)
    assert [(n, [w for w, _ in ws]) for n, ws in tl] == [(n, [w for w, _ in ws]) for n, ws in jl]
    for (_, jw), (_, tw) in zip(jl, tl):
        for (_, a), (_, b) in zip(jw, tw):
            np.testing.assert_array_equal(b, a)

    # a port checkpoint too; its space-to-depth and folded forms are refused
    model = UNet(6, n_classes=1, head="sigmoid", **NARROW)
    save_checkpoint(str(tmp_path / "port"), model)
    export_cli.main(["--ckpt", str(tmp_path / "port"), "--out", str(tmp_path / "p.h5"),
                     "--device", "cpu"])
    assert tki.infer_unet_arch(str(tmp_path / "p.h5"))["filters"] == (4, 8)
    for bad, msg in ((UNet(6, n_classes=1, head="sigmoid", space_to_depth=True, **NARROW),
                      "space_to_depth"), (fold_unet(model), "fold")):
        save_checkpoint(str(tmp_path / "bad"), bad)
        with pytest.raises(ValueError, match=msg):
            export_cli.main(["--ckpt", str(tmp_path / "bad"), "--out",
                             str(tmp_path / "bad.h5"), "--device", "cpu"])


K = 64


def _solar_eval_chips(path, n, seed):
    rng = np.random.default_rng(seed)
    bands = CONFIGS["solar"].bands
    examples = []
    for _ in range(n):
        ex = {b: rng.uniform(0.05, 0.3, K * K).astype(np.float32) for b in bands}
        label = np.zeros((K, K), np.float32)
        y, x = rng.integers(0, K // 2, 2)
        label[y:y + 20, x:x + 24] = 1.0
        for b in bands:
            ex[b].reshape(K, K)[label > 0] += 0.5
        ex["landcover"] = label.reshape(-1)
        examples.append(ex)
    write_tfrecord_file(str(path), examples)


@pytest.fixture
def small_solar(monkeypatch):
    """The solar preset at 64² chips in both packages; the JAX CLI's h5
    U-Net in float32 (it builds a bfloat16 one), its init from shapes only
    (zeros: the loader overwrites every value; an eager init compiles op
    by op for seconds) and its apply jitted."""
    jev, _ = _jax_script("evaluate")
    init = JaxUNet.init

    def shaped_init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(init, self), rngs, *args, **kwargs)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(JaxUNet, "init", shaped_init)
    monkeypatch.setitem(CONFIGS, "solar", dataclasses.replace(CONFIGS["solar"],
                                                              kernel_size=K))
    monkeypatch.setitem(JAX_CONFIGS, "solar", dataclasses.replace(JAX_CONFIGS["solar"],
                                                                  kernel_size=K))

    def f32_unet(**kw):
        return JaxUNet(**{**kw, "dtype": jnp.float32})

    monkeypatch.setattr(jax_models, "UNet", f32_unet)
    load = jev.load_h5_model

    def jitted(*args, **kwargs):
        model, variables = load(*args, **kwargs)
        return types.SimpleNamespace(apply=jax.jit(model.apply)), variables

    monkeypatch.setattr(jev, "load_h5_model", jitted)
    return jev


def test_evaluate_h5_matches_jax_cli(small_solar, tmp_path, capsys):
    jev = small_solar
    data = tmp_path / "eval"
    data.mkdir()
    for i in range(2):
        _solar_eval_chips(data / f"eval-{i}.tfrecord.gz", 4, seed=30 + i)  # batches of 4
    jm = JaxUNet(n_classes=1, head="sigmoid", convs_per_block=1, **NARROW)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, K, K, 6)))
    v = random_variables(shapes, np.random.default_rng(11))
    v["params"]["head"]["bias"] = np.full_like(v["params"]["head"]["bias"], 2.5)
    h5 = tmp_path / "ref.h5"
    jke.export_keras_unet_h5(v["params"], v["batch_stats"], str(h5))
    common = ["--config", "solar", "--eval", str(data / "*.tfrecord.gz"), "--batch-size", "4"]
    reports = {}
    for fold in ([], ["--no-fold"]):
        jev.main(common + ["--h5", str(h5), "--out", str(tmp_path / "j.json")] + fold)
        # the port reads the file through a file:// URL
        got = eval_cli.main(common + ["--h5", h5.as_uri(), "--device", "cpu",
                                      "--out", str(tmp_path / "t.json")] + fold)
        printed = capsys.readouterr().out
        assert f"fold_bn={not fold}" in printed
        want = json.loads((tmp_path / "j.json").read_text())
        port = json.loads((tmp_path / "t.json").read_text())
        np.testing.assert_array_equal(np.asarray(port["counts"]), np.asarray(want["counts"]))
        np.testing.assert_array_equal(np.asarray(got["counts"]), np.asarray(want["counts"]))
        assert port["per_class"] == want["per_class"]
        counts = np.asarray(port["counts"])
        assert counts.sum() == 8 * K * K and counts[:, 1].sum() > 0 and counts[:, 0].sum() > 0
        reports[bool(fold)] = counts
    np.testing.assert_array_equal(reports[True], reports[False])

    # the same weights as a port checkpoint through --ckpt: the same counts
    model = tki.load_keras_unet_h5(str(h5), UNet(6, n_classes=1, head="sigmoid",
                                                 threshold=0.9, convs_per_block=1, **NARROW))
    save_checkpoint(str(tmp_path / "ckpt"), model)
    by_ckpt = eval_cli.main(common + ["--ckpt", str(tmp_path / "ckpt"), "--device", "cpu"])
    np.testing.assert_array_equal(np.asarray(by_ckpt["counts"]), reports[True])
    # a file whose bands differ from the config's: a note, and the file wins
    other = UNet(4, n_classes=1, head="sigmoid", convs_per_block=1, **NARROW)
    tke.export_keras_unet_h5(other, str(tmp_path / "four.h5"))
    loaded = eval_cli.load_h5_model(str(tmp_path / "four.h5"), CONFIGS["solar"],
                                    torch.device("cpu"))
    assert "h5 expects 4 bands" in capsys.readouterr().out
    assert loaded.kwargs["in_channels"] == 4 and loaded.fold_bn
