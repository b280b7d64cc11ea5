"""The port's twin of ``bench.py`` (satellite_computervision_tpu_torch/
bench.py) on the CPU at a small size: its constants and field names are
the JAX bench's (read with ``ast``: importing ``bench.py`` turns on JAX's
persistent compile cache for the whole process); its reference loop, its
headline engine and its hann engine give the JAX engine's canvas from
bridged weights (a U-Net 8…32, a 320² scene, k64 + b32, float32; within
1e-5 on the probabilities, the uint8 cast within one step); its train
step's first loss is the JAX step's within 1e-5 relative; its FLOP count
is the analytic 2·MAC sum; its LZW ratio is the JAX package's codec's,
exactly; and the emit-once line holds under a budget too small for any
stage and a stage that raises (exit code 1)."""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from satellite_computervision_tpu import native as jax_native
from satellite_computervision_tpu.inference import TiledInferenceEngine as JaxEngine
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.models.losses import weighted_bce as jax_weighted_bce
from satellite_computervision_tpu.train.trainer import TrainState as JaxTrainState
from satellite_computervision_tpu.train.trainer import make_train_step as jax_train_step
from satellite_computervision_tpu_torch import bench
from satellite_computervision_tpu_torch.models import UNet, flax_to_torch, fold_unet
from satellite_computervision_tpu_torch.train.trainer import create_train_state
from test_torch_deeplab import two_torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILTERS = (8, 16, 32)
CPU = torch.device("cpu")


def _jax_bench():
    return ast.parse((ROOT / "bench.py").read_text())


def test_constants_and_fields_are_the_jax_bench():
    """KERNEL, BUFFER, BANDS, SCENE, BATCH and N_SCENES equal bench.py's;
    every field its default path writes (``RESULT[...]`` / ``out[...]``)
    is one of the twin's, but ``hann_ms_pallas``, which has no twin."""
    tree = _jax_bench()
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets[0]
            names = [t.id for t in getattr(targets, "elts", [targets])]
            values = ast.literal_eval(node.value) if len(names) > 1 else [None]
            for name, value in zip(names, values):
                if name in ("KERNEL", "BUFFER", "BANDS"):
                    consts[name] = value
            if names[0] in ("SCENE", "BATCH", "N_SCENES"):
                consts[names[0]] = ast.literal_eval(node.value)
    assert consts == {name: getattr(bench, name) for name in consts} and len(consts) == 6

    default_path = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in (
        "stage_headline", "stage_device_ratios", "stage_train", "stage_extras", "stage_codec",
        "main")]
    fields = set()
    for fn in default_path:
        for node in ast.walk(fn):
            if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                    and getattr(node.value, "id", None) in ("RESULT", "out")):
                key = node.slice
                if isinstance(key, ast.Constant):
                    fields.add(key.value)
                else:  # f"whole_ms{tag}" over the tags "" and "_fold", "" and "_pallas"
                    prefix = key.values[0].value
                    fields |= {prefix, prefix + ("_fold" if prefix == "whole_ms" else "_pallas")}
    assert len(fields) == 34
    assert fields - {"hann_ms_pallas"} == set(bench.DEFAULT_FIELDS)


@pytest.fixture
def narrow(monkeypatch):
    """The bench at a CPU size: a 320² scene, k64 + b32 (batch 12 kept: the
    16 reference-grid chips fill one group and pad a second), the U-Net
    8…32, 32² train tiles, a small LZW plane."""
    for name, value in dict(SCENE=320, KERNEL=64, BUFFER=32, N_SCENES=2, FILTERS=FILTERS,
                            TUNED_KERNEL=128, TUNED_BATCH=4, TRAIN_TILE=32,
                            TRAIN_BATCHES=(2, 4), CODEC_PLANE=(64, 128)).items():
        monkeypatch.setattr(bench, name, value)


@pytest.fixture(scope="module")
def bridged():
    """(JAX U-Net 8…32 on 4 bands, its variables drawn at random, kernels
    at He scale, BatchNorm scales near 1, means near 0 and variances near 1, the port's U-Net with
    the same weights)."""
    jmodel = JaxUNet(n_classes=1, filters=FILTERS, factors=(2, 2, 2), head="sigmoid")
    v = jax.device_get(jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 4))))
    rng = np.random.default_rng(3)
    v["params"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(size=np.shape(a)) * (
            np.sqrt(2.0 / np.prod(np.shape(a)[:-1])) if np.ndim(a) == 4 else 0.1)
            + (path[-1].key == "scale")).astype(np.float32), v["params"])
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(size=np.shape(a)) * 0.05 if path[-1].key == "mean" else
                         np.abs(rng.normal(size=np.shape(a))) * 0.5 + 0.5).astype(np.float32),
        v["batch_stats"])
    model = UNet(4, n_classes=1, filters=FILTERS, factors=(2, 2, 2), head="sigmoid").eval()
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    return jmodel, v, model


def _scene():
    return np.random.default_rng(0).integers(0, 3000, (320, 320, 4)).astype(np.uint16)


def _jax_pre(s):
    return s.astype(jnp.float32) / 10000.0


def test_reference_loop_and_headline_engine_match_jax(narrow, bridged):
    jmodel, v, model = bridged
    scene = _scene()
    want = np.asarray(JaxEngine(
        lambda c: jmodel.apply(v, c)["probs"], kernel=64, buffer=32, batch_size=12,
        out_channels=1, blend="overwrite", index_mode="reference",
        preprocess_fn=_jax_pre).predict_scene(scene))
    assert want.shape == (320, 320, 1) and 0.05 < want[16:-48, 16:-48].std()
    probs = bench.make_engine(model, CPU, torch.float32, output_transform=None)
    np.testing.assert_allclose(probs.predict_scene(scene).numpy(), want, rtol=0, atol=1e-5)
    _, canvas = bench.reference_pattern(bench.predictor(model, torch.float32), scene, CPU)
    np.testing.assert_allclose(canvas, want[..., 0], rtol=0, atol=1e-5)
    # uint8 out: a probability within float noise of a /255 step may land one lower
    got = bench.make_engine(model, CPU, torch.float32).predict_scene(scene).numpy()
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - (want * 255.0).astype(np.uint8)).max() <= 1


def test_hann_engine_of_stage_extras_matches_jax(narrow, bridged):
    jmodel, v, model = bridged
    scene = _scene()
    want = np.asarray(JaxEngine.from_model(
        jmodel, v, kernel=64, buffer=32, batch_size=12, blend="hann", index_mode="grid",
        preprocess_fn=_jax_pre).predict_scene(scene))
    got = bench.hann_engine(fold_unet(model), CPU, bench.KERNEL, bench.BATCH, torch.float32,
                            output_transform=None).predict_scene(scene).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_first_train_step_loss_matches_jax(narrow, bridged, monkeypatch):
    """stage_train's step (weighted BCE on logits, pos_weight 2, Adam 9e-4,
    BN momentum 0.9) from the bridged weights at 4 bands: its first loss is
    the JAX ``make_train_step``'s."""
    _, v, _ = bridged
    monkeypatch.setattr(bench, "TRAIN_BANDS", 4)
    x, y = bench.train_batch(np.random.default_rng(1), 2, CPU)
    jmodel = JaxUNet(n_classes=1, filters=FILTERS, factors=(2, 2, 2), head="sigmoid",
                     bn_momentum=0.9)
    tx = optax.adam(9e-4)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                           apply_fn=jmodel.apply, tx=tx)
    jstep = jax_train_step(lambda t, p: jax_weighted_bce(t, p, pos_weight=2.0, logits=True),
                           donate=False)
    _, jout = jstep(jstate, (jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    model = bench.build_model(CPU, bands=4, bn_momentum=0.9)
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    loss = bench.train_step(None)(create_train_state(model), (x, y))["loss"].item()
    np.testing.assert_allclose(loss, float(jout["loss"]), rtol=1e-5)


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
def test_flop_count_is_the_analytic_mac_sum(narrow, s2d):
    model = bench.build_model(CPU, space_to_depth=s2d)
    macs = []

    def hook(module, inputs, output):
        x = inputs[0]
        kh, kw = module.kernel_size
        if isinstance(module, torch.nn.ConvTranspose2d):  # every input pixel scatters
            n, cin, h, w = x.shape
            macs.append(n * h * w * cin * module.out_channels * kh * kw)
        else:
            n, cout, h, w = output.shape
            macs.append(n * h * w * cout * module.in_channels * kh * kw)

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    x = torch.rand((2, 64, 64, 4))
    with torch.no_grad():
        flops = bench.count_flops(lambda: model(x))
    assert len(macs) == sum(isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
                            for m in model.modules())
    assert flops == 2 * sum(macs)


def test_lzw_ratio_is_the_jax_codecs(narrow, monkeypatch):
    monkeypatch.setattr(bench, "CODEC_PLANE", (2048, 4096))  # the bench's own plane
    result = {}
    bench.stage_codec(result, bench.Repeats(codec=1))
    raw = bench.codec_plane()
    assert len(raw) == 2048 * 4096
    assert result["lzw_ratio"] == len(raw) / len(jax_native.lzw_encode(raw))
    assert result["lzw_enc_mb_s"] > 0 and result["lzw_dec_mb_s"] > 0


def _line(capsys):
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_a_budget_too_small_skips_every_stage(narrow, monkeypatch, capsys):
    monkeypatch.setenv("SCV_BENCH_BUDGET", "1")
    assert bench.main(["--device", "cpu"]) == 0
    out = _line(capsys)
    assert out["skipped"] == ["headline", "device_ratios", "train", "extras", "codec"]
    assert out["value"] is None and "errors" not in out
    assert out["device"] == {"name": "cpu", "power_limit_w": None, "count": 0}


def test_a_stage_that_raises_lands_in_errors_and_exits_1(narrow, monkeypatch, capsys):
    for name in ("stage_headline", "stage_device_ratios", "stage_train", "stage_extras"):
        monkeypatch.setattr(bench, name, lambda *args: None)

    def broken(result, reps):
        raise ValueError("no codec")

    monkeypatch.setattr(bench, "stage_codec", broken)
    assert bench.main(["--device", "cpu"]) == 1
    out = _line(capsys)
    assert out["errors"] == {"codec": "ValueError: no codec"} and "skipped" not in out
    assert set(out["stage_seconds"]) == {"headline", "device_ratios", "train", "extras",
                                         "codec"}
