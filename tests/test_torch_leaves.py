"""The port's library leaves against the JAX package's, on the CPU:

- ``ops.chips``: index generation in both modes equal, chip extraction
  bit-equal, ``stitch_chips`` in the ``overwrite``/``sum`` modes bit-equal
  and ``hann`` within 1e-6 (the window's cosines), mirroring
  tests/test_ops_chips.py; chips reaching outside the scene raise;
- ``data.matching``: equal results on one file tree;
- the HSV pair: against JAX within 1e-6 and against ``tf.image`` within
  1e-5 (tests/test_tf_parity.py's tolerance); ``aug_color_hsv`` against
  JAX's on JAX's own draws within 1e-6;
- ``testing``: every fixture writes the JAX package's files for one numpy
  seed (``.npy`` and mixer JSON byte for byte, GZIP TFRecords equal once
  decompressed: a GZIP header holds a name and a time);
- ``utils``: the timer, the JSONL logger (the JAX logger's records), the
  PNG writer (the JAX writer's pixels), the trace and the memory stats.
"""

import gzip
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu import testing as jfx
from satellite_computervision_tpu.data import matching as jmatch
from satellite_computervision_tpu.ops import augment as jaug
from satellite_computervision_tpu.ops import chips as jchips
from satellite_computervision_tpu.utils import MetricsLogger as JaxLogger
from satellite_computervision_tpu.utils import save_rgb_image as jax_save_rgb
from satellite_computervision_tpu_torch import ops
from satellite_computervision_tpu_torch import testing as tfx
from satellite_computervision_tpu_torch import utils
from satellite_computervision_tpu_torch.data import matching as tmatch
from satellite_computervision_tpu_torch.ops import chips as tchips
from test_torch_deeplab import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("mode", ["reference", "cover"])
@pytest.mark.parametrize("h, w, k, b", [(1024, 1024, 256, 128), (700, 900, 256, 128),
                                        (2048, 1024, 512, 256), (300, 200, 256, 128)])
def test_chip_indices_match_jax(mode, h, w, k, b):
    got = tchips.generate_chip_indices(h, w, kernel=k, buffer=b, mode=mode)
    want = jchips.generate_chip_indices(h, w, kernel=k, buffer=b, mode=mode)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("blend", ["overwrite", "sum", "hann"])
@pytest.mark.parametrize("mode", ["reference", "cover"])
def test_extract_and_stitch_match_jax(rng, blend, mode):
    k, b = 64, 32
    scene = rng.normal(size=(320, 288, 2)).astype(np.float32)
    idx = tchips.generate_chip_indices(320, 288, kernel=k, buffer=b, mode=mode)
    chips = tchips.extract_chips(scene, idx, kernel=k, buffer=b)
    want_chips = np.asarray(jchips.extract_chips(scene, idx, kernel=k, buffer=b))
    np.testing.assert_array_equal(chips.numpy(), want_chips)
    preds = chips[..., :1] * 2.0 + 0.5  # a stand-in model
    got = tchips.stitch_chips(preds, idx, (320, 288, 1), kernel=k, buffer=b, blend=blend)
    want = np.asarray(jchips.stitch_chips(preds.numpy(), idx, (320, 288, 1), kernel=k,
                                          buffer=b, blend=blend))
    if blend == "hann":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tchips.center_crop(chips, k, b).numpy(),
                                  np.asarray(jchips.center_crop(want_chips, k, b)))


def test_chip_ops_edge_cases(rng):
    k, b = 64, 32
    # a constant field blends back to the constant; the empty index set
    idx = tchips.generate_chip_indices(320, 320, kernel=k, buffer=b, mode="cover")
    chips = torch.full((len(idx), k + b, k + b, 1), 3.5)
    out = tchips.stitch_chips(chips, idx, (320, 320, 1), kernel=k, buffer=b, blend="hann")
    inner = out[b // 2 + k // 2: -b // 2 - k // 2, b // 2 + k // 2: -b // 2 - k // 2]
    np.testing.assert_allclose(inner.numpy(), 3.5, rtol=1e-4)
    empty = tchips.generate_chip_indices(50, 50, kernel=k, buffer=b)
    assert empty.shape == (0, 2)
    assert tchips.extract_chips(np.zeros((50, 50, 3), np.float32), empty, k, b).shape == \
        (0, k + b, k + b, 3)
    with pytest.raises(ValueError, match="outside"):
        tchips.extract_chips(np.zeros((100, 100, 1), np.float32), [[0, 0]], k, b)
    with pytest.raises(ValueError, match="outside"):
        tchips.stitch_chips(torch.zeros(1, k + b, k + b, 1), [[80, 0]], (100, 100, 1), k, b)
    with pytest.raises(ValueError, match="blend"):
        tchips.stitch_chips(torch.zeros(1, k + b, k + b, 1), [[16, 16]], (128, 128, 1), k, b,
                            blend="max")
    with pytest.raises(ValueError, match="mode"):
        tchips.generate_chip_indices(100, 100, mode="grid")


def _file_tree(root):
    paths = []
    for var in ("naip", "s2", "label"):
        for i in range(5):
            if var == "s2" and i == 3:
                continue  # one id missing from one source
            p = root / var / f"{var}_site_2021_{i:03d}_x.npy"
            p.parent.mkdir(parents=True, exist_ok=True)
            p.touch()
            paths.append(str(p))
    return paths


def test_matching_matches_jax(tmp_path):
    paths = _file_tree(tmp_path)
    variables = {"naip": {"files": True}, "s2": {"files": True}, "label": {"files": True},
                 "dem": {"files": None}}
    for kw in ({}, {"subset": {("001", "x"), ("003", "x")}}):
        assert tmatch.match_files(paths, variables, **kw) == \
            jmatch.match_files(paths, variables, **kw)
    flat = [p.replace("/naip/", "/x_naip_/").replace("/s2/", "/x_s2_/") for p in paths]
    assert tmatch.match_files(flat, variables, flatdirectory=True) == \
        jmatch.match_files(flat, variables, flatdirectory=True)
    labels = ("label", "naip", "s2")
    assert tmatch.split_files(paths, labels) == jmatch.split_files(paths, labels)
    assert tmatch.get_file_id(paths[0]) == jmatch.get_file_id(paths[0]) == ("000", "x")


def _rgb(rng):
    rgb = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    rgb[0, 0] = 0.0  # black: saturation 0
    rgb[0, 1] = 0.5  # gray: hue 0
    rgb[0, 2] = [0.9, 0.2, 0.9]  # max shared by red and blue
    rgb[0, 3] = [0.3, 0.7, 0.7]
    return rgb


def test_hsv_pair_matches_jax_and_tf(rng):
    rgb = _rgb(rng)
    hsv = ops.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(hsv, np.asarray(jaug.rgb_to_hsv(rgb)), atol=1e-6)
    back = ops.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(back, np.asarray(jaug.hsv_to_rgb(hsv)), atol=1e-6)
    np.testing.assert_allclose(back, rgb, atol=1e-5)
    tf = pytest.importorskip("tensorflow")
    np.testing.assert_allclose(hsv, tf.image.rgb_to_hsv(tf.constant(rgb)).numpy(), atol=1e-5)
    np.testing.assert_allclose(back, tf.image.hsv_to_rgb(tf.constant(hsv)).numpy(), atol=1e-5)


def _jax_hsv_draws(key, dtype=jnp.float32):
    """aug_color_hsv's draws as the JAX function makes them."""
    hkey, skey, bkey, ckey = jax.random.split(key, 4)
    return tuple(float(jax.random.uniform(k, (), minval=lo, maxval=hi, dtype=dtype))
                 for k, (lo, hi) in zip((hkey, skey, bkey, ckey),
                                        ((-0.05, 0.05), (0.6, 1.6), (-0.05, 0.05), (0.7, 1.3))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aug_color_hsv_matches_jax_on_its_draws(rng, seed):
    rgb = rng.uniform(0.2, 0.8, (2, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(seed)
    want = np.asarray(jaug.aug_color_hsv(key, rgb))
    got = ops.aug_color_hsv(torch.from_numpy(rgb), *_jax_hsv_draws(key)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    draws = ops.draw_hsv_params(torch.Generator().manual_seed(seed))
    assert -0.05 <= draws[0] <= 0.05 and 0.6 <= draws[1] <= 1.6
    assert -0.05 <= draws[2] <= 0.05 and 0.7 <= draws[3] <= 1.3
    assert draws == ops.draw_hsv_params(torch.Generator().manual_seed(seed))


def _same_files(a, b):
    a, b = pathlib.Path(a), pathlib.Path(b)
    if a.suffix == ".gz" or a.read_bytes()[:2] == b"\x1f\x8b":
        assert gzip.decompress(a.read_bytes()) == gzip.decompress(b.read_bytes()), a.name
    else:
        assert a.read_bytes() == b.read_bytes(), a.name


def test_fixtures_write_the_jax_files(tmp_path):
    j, t = tmp_path / "jax", tmp_path / "port"
    for root in (j, t):
        root.mkdir()
    for mod, root in ((jfx, j), (tfx, t)):
        mod.make_training_tfrecord(str(root / "train.tfrecord.gz"), n_examples=3, kernel=16,
                                   seed=5)
        mod.make_training_tfrecord(str(root / "plain.tfrecord"), n_examples=2, kernel=8,
                                   seed=6, compression=None)
        mod.make_prediction_export(str(root / "export"), rows=2, cols=3, kernel=16, buffer=8,
                                   files=2, seed=7)
        mod.make_npy_chip_tree(str(root / "tree"), n_chips=3, dim=8, seed=8)
        mod.make_siamese_chip_tree(str(root / "siamese"), n_chips=2, dim=8, seed=9)
        mod.make_series_chips(str(root / "series"), n_chips=2, n_time=3, dim=8, seed=10)
    jfiles = sorted(p.relative_to(j) for p in j.rglob("*") if p.is_file())
    tfiles = sorted(p.relative_to(t) for p in t.rglob("*") if p.is_file())
    assert jfiles == tfiles and len(jfiles) == 2 + 3 + 12 + 6 + 2
    for rel in jfiles:
        _same_files(j / rel, t / rel)
    chip, label = tfx.synth_chip(np.random.default_rng(0), 16, ("B2",))
    jchip, jlabel = jfx.synth_chip(np.random.default_rng(0), 16, ("B2",))
    np.testing.assert_array_equal(chip["B2"], jchip["B2"])
    np.testing.assert_array_equal(label, jlabel)


def test_timer_logger_and_memory_stats(tmp_path):
    t = utils.Timer()
    for _ in range(2):
        with t("a", sync=True):
            torch.ones(4).sum()
    with t("b"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_s"] >= 0 and s["b"]["count"] == 1
    t.reset()
    assert t.summary() == {}
    lines = []
    with utils.stage_timer("stage", log_fn=lines.append):
        pass
    assert lines and lines[0].startswith("[timing] stage: ")

    records = {}
    for name, logger in (("jax", JaxLogger), ("port", utils.MetricsLogger)):
        path = tmp_path / f"{name}.jsonl"
        with logger(str(path)) as log:
            log.log(1, loss=0.5, note="x")
            log.log(2, loss=np.float32(0.25), acc=torch.tensor(0.75).item())
        records[name] = [json.loads(line) for line in path.read_text().splitlines()]
    for rec in records.values():
        for r in rec:
            r.pop("ts")
    assert records["port"] == records["jax"]

    assert utils.device_memory_stats(torch.device("cpu")) is None
    assert utils.device_memory_stats("cpu") is None
    with utils.trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_save_rgb_image_matches_jax(tmp_path, rng):
    Image = pytest.importorskip("PIL.Image")
    for shape in ((3, 16, 12), (16, 12, 4), (1, 8, 8)):
        arr = rng.uniform(-20, 300, shape).astype(np.float32)
        utils.save_rgb_image(arr, str(tmp_path / "t.png"))
        jax_save_rgb(arr, str(tmp_path / "j.png"))
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                      np.asarray(Image.open(tmp_path / "j.png")))
    plt = pytest.importorskip("matplotlib.pyplot")
    fig = plt.figure(figsize=(2, 1), dpi=50)
    img = utils.plot_to_image(fig)
    assert img.shape == (50, 100, 4) and img.dtype == np.uint8
