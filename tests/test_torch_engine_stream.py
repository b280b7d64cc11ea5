"""The port's engine at swath scale — whole mode, banded streaming, nodata
culling, lazy GeoTIFF input and streamed GeoTIFF/COG output — against the
JAX package's engine on the same scenes (mirrors tests/test_inference.py).
Toy models: rtol 1e-5 / atol 1e-6 (the JAX tests' tolerance); the bridged
UNet: atol 1e-5 (float32 convs summed in another order)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax import lax

from satellite_computervision_tpu.geo import GeoTiffScene as JaxScene
from satellite_computervision_tpu.geo import write_geotiff as jax_write_geotiff
from satellite_computervision_tpu.inference import TiledInferenceEngine as JaxEngine
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu_torch.geo import GeoTiffScene, read_geotiff
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine, tiles
from satellite_computervision_tpu_torch.models import UNet, flax_to_torch

TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_mean(chips):
    return chips.mean(axis=-1, keepdims=True)


class Counting:
    """The port's per-pixel mean model, counting the chips it is given."""

    def __init__(self):
        self.chips = 0

    def __call__(self, chips):
        self.chips += chips.shape[0]
        return chips.mean(-1, keepdim=True)


def _jax_context(chips):
    """9x9 box filter over the channel mean: any chip-grid misalignment
    between banded and whole-scene passes changes its output."""
    x = chips.mean(axis=-1, keepdims=True)
    w = jnp.ones((9, 9, 1, 1), x.dtype) / 81.0
    return lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _context(chips):
    x = chips.mean(-1, keepdim=True).permute(0, 3, 1, 2)
    y = F.conv2d(x, torch.ones((1, 1, 9, 9)) / 81.0, padding=4)
    return y.permute(0, 2, 3, 1)


def _jax_avg3(x):
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = out + jnp.roll(x, (dy, dx), axis=(1, 2))
    return out[..., :1] / 9.0


def _avg3(x):
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = out + torch.roll(x, (dy, dx), dims=(1, 2))
    return out[..., :1] / 9.0


def _nodata_scene(rng, h=300, w=260, c=3, nodata=0.0):
    """An all-nodata top-left quadrant and right margin: the swath-edge
    shape culling exists for."""
    scene = rng.normal(size=(h, w, c)).astype(np.float32) + 5.0
    scene[: h // 2, : w // 2] = nodata
    scene[:, -40:] = nodata
    return scene


def _port(engine_fn, **kw):
    return TiledInferenceEngine(engine_fn, device="cpu", **kw)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ------------------------------------------------------------------ whole mode
def test_whole_mode_matches_jax(rng):
    scene = rng.normal(size=(70, 91, 3)).astype(np.float32)
    kw = dict(kernel=32, buffer=16, batch_size=4, out_channels=1, tile_mode="whole",
              whole_multiple=8)
    got = _port(Counting(), preprocess_fn=lambda s: s * 2.0,
                output_transform=lambda p: p + 1.0, **kw)
    want = JaxEngine(_jax_mean, preprocess_fn=lambda s: s * 2.0,
                     output_transform=lambda p: p + 1.0, **kw)
    a = _np(got.predict_scene(scene))
    assert a.shape == (70, 91, 1)
    np.testing.assert_allclose(a, np.asarray(want.predict_scene(scene)), **TOL)
    stack = np.stack([scene, scene * 0.5])
    b = _np(got.predict_scene_batch(stack))
    np.testing.assert_allclose(b, np.asarray(want.predict_scene_batch(stack)), **TOL)
    np.testing.assert_allclose(b[0], a, **TOL)


def test_whole_banded_matches_jax_and_whole(rng):
    """Banded whole mode: bands carry real buffer/2 context, so the banded
    pass equals the unbanded one away from the wrap-around of roll."""
    scene = rng.normal(size=(250, 100, 2)).astype(np.float32)
    kw = dict(kernel=32, buffer=16, out_channels=1, tile_mode="whole", whole_multiple=8)
    whole = _np(_port(_avg3, **kw).predict_scene(scene))
    banded = _np(_port(_avg3, max_rows=96, **kw).predict_scene(scene))
    want = np.asarray(JaxEngine(_jax_avg3, max_rows=96, **kw).predict_scene(scene))
    np.testing.assert_allclose(banded, want, **TOL)
    np.testing.assert_allclose(banded[1:-1, 1:-1], whole[1:-1, 1:-1], **TOL)


def test_whole_banded_rejects_unaligned_bands(rng):
    scene = rng.normal(size=(250, 100, 2)).astype(np.float32)
    engine = _port(_avg3, kernel=32, buffer=16, out_channels=1, tile_mode="whole",
                   whole_multiple=64, max_rows=96)
    with pytest.raises(ValueError, match="whole_multiple"):
        engine.predict_scene(scene)


# ------------------------------------------------------------------ banded
@pytest.mark.parametrize("model,blend,mode", [
    ("mean", "overwrite", "grid"),
    ("context", "overwrite", "grid"),
    ("context", "overwrite", "reference"),
    ("context", "hann", "grid"),
])
def test_banded_matches_jax_and_single_shot(rng, model, blend, mode):
    """Interior bands keep the whole-scene chip grid: with a model whose
    receptive field exceeds buffer/2, a shifted grid changes whole bands."""
    scene = rng.normal(size=(448, 192, 2)).astype(np.float32)
    fns = {"mean": (Counting(), _jax_mean), "context": (_context, _jax_context)}[model]
    kw = dict(kernel=64, buffer=32, batch_size=4, out_channels=1, blend=blend,
              index_mode=mode)
    single = _np(_port(fns[0], **kw).predict_scene(scene))
    banded = _np(_port(fns[0], max_rows=300, **kw).predict_scene(scene))
    np.testing.assert_allclose(banded, single, **TOL)
    for pallas_blend in ([False, "interpret"] if blend == "hann" else [False]):
        want = np.asarray(JaxEngine(fns[1], max_rows=300, pallas_blend=pallas_blend,
                                    **kw).predict_scene(scene))
        np.testing.assert_allclose(banded, want, **TOL)


def test_banded_hann_counts_forwards_with_halo(rng):
    """Banded hann reruns one halo chip row per interior band side, as the
    JAX engine does: 448 rows at k64 is 7 chip rows; max_rows 300 gives
    bands of 4 chip rows advancing 2."""
    scene = rng.normal(size=(448, 192, 2)).astype(np.float32)
    model = Counting()
    _port(model, kernel=64, buffer=32, batch_size=4, out_channels=1, blend="hann",
          max_rows=300).predict_scene(scene)
    # bands over chip rows 0-2, 1-4, 3-6, 5-6 (3 + 4 + 4 + 2 of 7 rows), 3
    # columns, each band in groups of 4 chips: 12 + 12 + 12 + 8
    assert model.chips == 44


# ------------------------------------------------------------------ nodata cull
@pytest.mark.parametrize("blend", ["overwrite", "hann"])
@pytest.mark.parametrize("mode", ["grid", "reference"])
def test_nodata_cull_matches_jax_and_is_exact_on_valid(rng, blend, mode):
    scene = _nodata_scene(rng)
    kw = dict(kernel=64, buffer=32, batch_size=4, out_channels=1, blend=blend,
              index_mode=mode)
    plain_model, culled_model = Counting(), Counting()
    want_plain = _np(_port(plain_model, **kw).predict_scene(scene))
    culled = _port(culled_model, nodata=0.0, **kw)
    got = _np(culled.predict_scene(scene))
    valid_chips = culled.chip_validity(scene)
    n_kept = int(valid_chips.sum())
    assert 0 < n_kept < len(valid_chips)
    # only the kept chips ran, padded to whole batches of 4
    assert culled_model.chips == -(-n_kept // 4) * 4 < plain_model.chips
    valid = (scene != 0.0).any(-1)
    np.testing.assert_allclose(got[valid], want_plain[valid], rtol=1e-5, atol=1e-5)
    jax_engine = JaxEngine(_jax_mean, nodata=0.0, **kw)
    np.testing.assert_array_equal(valid_chips, jax_engine.chip_validity(scene))
    for pallas_blend in ([False, "interpret"] if blend == "hann" else [False]):
        want = np.asarray(JaxEngine(_jax_mean, nodata=0.0, pallas_blend=pallas_blend,
                                    **kw).predict_scene(scene))
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode,prepadded", [("grid", False), ("reference", False),
                                             ("grid", True)])
@pytest.mark.parametrize("nodata", [0.0, float("nan")])
def test_chip_validity_equals_jax(rng, mode, prepadded, nodata):
    """Nodata blocks with lone valid pixels in them, and pixels nodata in
    only some channels, give the JAX engine's validity mask exactly, on
    every grid."""
    scene = rng.normal(size=(203, 171, 3)).astype(np.float32)
    scene[:120, :100] = nodata
    scene[:, 140:] = nodata
    scene[rng.random((203, 171, 3)) < 0.3] = nodata  # some channels only
    scene[50, 50, 2] = scene[10, 150, 0] = 1.0  # one valid channel suffices
    kw = dict(kernel=32, buffer=16, index_mode=mode, nodata=nodata)
    got = _port(Counting(), **kw).chip_validity(scene, prepadded=prepadded)
    want = JaxEngine(_jax_mean, **kw).chip_validity(scene, prepadded=prepadded)
    assert 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, want)


def test_nodata_cull_noop_and_all_nodata(rng, monkeypatch):
    """A fully valid scene runs the full grid; an all-nodata scene returns
    zeros in the output_transform's dtype with no forward and no stitch."""
    stitches = []
    real = tiles.hann_stitch
    monkeypatch.setattr(tiles, "hann_stitch",
                        lambda *a, **k: stitches.append(1) or real(*a, **k))
    kw = dict(kernel=64, buffer=32, batch_size=4, out_channels=1, blend="hann")
    model = Counting()
    engine = _port(model, nodata=0.0,
                   output_transform=lambda p: (p * 255.0).to(torch.uint8), **kw)
    full = rng.uniform(0.1, 0.9, size=(128, 128, 2)).astype(np.float32)
    got = _np(engine.predict_scene(full))
    assert got.dtype == np.uint8 and model.chips == 4 and stitches == [1]
    want = np.asarray(JaxEngine(_jax_mean, nodata=0.0, **kw,
                                output_transform=lambda p: (p * 255.0).astype(jnp.uint8)
                                ).predict_scene(full))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    got = _np(engine.predict_scene(np.zeros((128, 128, 2), np.float32)))
    assert got.dtype == np.uint8 and got.shape == (128, 128, 1)
    np.testing.assert_array_equal(got, 0)
    assert model.chips == 4 and stitches == [1]


def test_nodata_cull_nan_matches_jax(rng):
    scene = rng.normal(size=(200, 200, 2)).astype(np.float32)
    scene[:100] = np.nan
    kw = dict(kernel=64, buffer=0, batch_size=4, out_channels=1, blend="overwrite")
    want_plain = _np(_port(Counting(), **kw).predict_scene(scene))
    got = _np(_port(Counting(), nodata=float("nan"), **kw).predict_scene(scene))
    valid = ~np.isnan(scene).all(-1)
    np.testing.assert_allclose(got[valid], want_plain[valid], rtol=1e-5)
    # rows reached only by culled chips are zero, not NaN
    np.testing.assert_array_equal(got[:64], 0.0)
    want = np.asarray(JaxEngine(_jax_mean, nodata=float("nan"), **kw).predict_scene(scene))
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


@pytest.mark.parametrize("mode", ["grid", "reference"])
def test_nodata_cull_banded_matches_jax(rng, mode):
    """Banded streaming culls per band; an all-nodata band runs no forward."""
    scene = _nodata_scene(rng, 420, 200, 2)
    scene[:130] = 0.0  # the top band is all nodata
    kw = dict(kernel=64, buffer=32, batch_size=4, out_channels=1, blend="hann",
              index_mode=mode, max_rows=160)
    plain_model, culled_model = Counting(), Counting()
    want_plain = _np(_port(plain_model, **kw).predict_scene(scene))
    got = _np(_port(culled_model, nodata=0.0, **kw).predict_scene(scene))
    assert culled_model.chips < plain_model.chips
    valid = (scene != 0.0).any(-1)
    np.testing.assert_allclose(got[valid], want_plain[valid], rtol=1e-5, atol=1e-5)
    want = np.asarray(JaxEngine(_jax_mean, nodata=0.0, **kw).predict_scene(scene))
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------------------ GeoTIFF I/O
def test_banded_lazy_geotiff_equals_in_memory(tmp_path, rng):
    """A file-backed GeoTiffScene streams through the banded path (O(band)
    rows decoded per band) with culling: bit-equal to the in-memory scene."""
    scene = _nodata_scene(rng, 420, 200, 2)
    path = str(tmp_path / "swath.tif")
    jax_write_geotiff(path, scene, nodata=0.0)
    lazy = GeoTiffScene(path)
    assert lazy.lazy and lazy.nodata == 0.0 and lazy.shape == (420, 200, 2)
    np.testing.assert_array_equal(lazy[100:260], JaxScene(path)[100:260])
    assert lazy.meta == JaxScene(path).meta
    engine = _port(Counting(), kernel=64, buffer=32, batch_size=4, out_channels=1,
                   blend="hann", max_rows=160, nodata=0.0)
    want = _np(engine.predict_scene(scene))
    np.testing.assert_array_equal(_np(engine.predict_scene(lazy)), want)
    jax_want = np.asarray(JaxEngine(_jax_mean, kernel=64, buffer=32, batch_size=4,
                                    out_channels=1, blend="hann", max_rows=160,
                                    nodata=0.0).predict_scene(JaxScene(path)))
    np.testing.assert_allclose(want, jax_want, **TOL)


@pytest.mark.parametrize("mode", ["grid", "reference"])
def test_stream_to_geotiff_matches_predict_and_jax(tmp_path, rng, mode):
    """Banded output streams into a striped GeoTIFF that reads back equal to
    predict_scene, with reference-mode zero margins, a uint8 output, the
    nodata tag and the crs."""
    # probabilities in [0, 1]: a uint8 cast of values past 255 wraps in
    # torch and saturates in XLA
    scene = _nodata_scene(rng, 420, 200, 2) / 10.0
    in_path = str(tmp_path / "in.tif")
    jax_write_geotiff(in_path, scene, nodata=0.0)
    kw = dict(kernel=64, buffer=32, batch_size=4, out_channels=1, blend="hann",
              index_mode=mode, max_rows=160, nodata=0.0)
    engine = _port(Counting(), output_transform=lambda p: (p * 255.0).to(torch.uint8), **kw)
    want = _np(engine.predict_scene(scene))
    out_path = str(tmp_path / f"out_{mode}.tif")
    assert engine.predict_scene_to_geotiff(
        GeoTiffScene(in_path), out_path, transform=(10, 0, 5, 0, -10, 7),
        crs="EPSG:32617", nodata_tag=0) == out_path
    sc = GeoTiffScene(out_path)
    assert sc.dtype == np.uint8 and sc.shape == (420, 200, 1)
    assert "32617" in sc.meta["crs"] and sc.nodata == 0.0
    np.testing.assert_array_equal(np.asarray(sc), want)
    jax_want = np.asarray(JaxEngine(
        _jax_mean, output_transform=lambda p: (p * 255.0).astype(jnp.uint8), **kw
    ).predict_scene(scene))
    # a probability within float noise of a /255 step may land one lower
    assert np.abs(np.asarray(sc).astype(int) - jax_want.astype(int)).max() <= 1


def test_stream_to_geotiff_short_scene(tmp_path, rng):
    scene = rng.normal(size=(96, 80, 2)).astype(np.float32)
    kw = dict(kernel=32, buffer=16, batch_size=4, out_channels=1, blend="hann")
    engine = _port(Counting(), **kw)
    path = str(tmp_path / "short.tif")
    engine.predict_scene_to_geotiff(scene, path)
    back, _ = read_geotiff(path)
    np.testing.assert_array_equal(back, _np(engine.predict_scene(scene)))
    np.testing.assert_allclose(back, np.asarray(JaxEngine(_jax_mean, **kw).predict_scene(scene)),
                               **TOL)


@pytest.mark.parametrize("max_rows", [None, 160], ids=["single", "banded"])
def test_stream_to_geotiff_coerces_float16(tmp_path, rng, max_rows):
    """float16 outputs (no TIFF sample format) are written as float32, on
    both routes."""
    scene = rng.normal(size=(420, 200, 2)).astype(np.float32)
    engine = _port(Counting(), kernel=64, buffer=32, batch_size=4, out_channels=1,
                   blend="hann", max_rows=max_rows,
                   output_transform=lambda p: p.to(torch.float16))
    path = str(tmp_path / "f16.tif")
    engine.predict_scene_to_geotiff(scene, path)
    back, _ = read_geotiff(path)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, _np(engine.predict_scene(scene)).astype(np.float32))


def test_stream_to_cog_base_and_overview(tmp_path, rng):
    scene = rng.normal(size=(420, 200, 2)).astype(np.float32)
    kw = dict(kernel=64, buffer=32, batch_size=4, out_channels=1, blend="hann", max_rows=160)
    engine = _port(Counting(), **kw)
    want = _np(engine.predict_scene(scene))
    path = str(tmp_path / "pred_cog.tif")
    engine.predict_scene_to_geotiff(scene, path, transform=(10, 0, 0, 0, -10, 0),
                                    crs="EPSG:32617", cog=True)
    base, meta = read_geotiff(path, page=0)
    np.testing.assert_array_equal(base, want)
    over, over_meta = read_geotiff(path, page=1)
    assert over.shape == (210, 100, 1) and over_meta["transform"][0] == 20.0
    np.testing.assert_allclose(base, np.asarray(JaxEngine(_jax_mean, **kw).predict_scene(scene)),
                               **TOL)


def test_stream_to_geotiff_aborts_on_error(tmp_path, rng):
    scene = rng.normal(size=(420, 200, 2)).astype(np.float32)
    calls = []

    def failing(chips):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("model failed")
        return chips.mean(-1, keepdim=True)

    engine = _port(failing, kernel=64, buffer=32, batch_size=4, out_channels=1,
                   blend="hann", max_rows=160)
    path = str(tmp_path / "partial.tif")
    with pytest.raises(RuntimeError, match="model failed"):
        engine.predict_scene_to_geotiff(scene, path)
    with pytest.raises(Exception):
        GeoTiffScene(path)  # aborted: no IFD, not a readable TIFF


# ------------------------------------------------------------------ bridged UNet
def test_bridged_unet_banded_culled_matches_jax(rng):
    """The port's UNet (weights bridged from flax) through banded, culled
    hann serving equals the JAX engine on the same scene."""
    model_kw = dict(n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
                    space_to_depth=True)
    jmodel = JaxUNet(**model_kw)
    v = jax.device_get(jmodel.init(jax.random.key(0), jnp.zeros((1, 24, 24, 6))))
    v["params"] = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32), v["params"])
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.normal(size=np.shape(a))) + 0.3).astype(np.float32),
        v["batch_stats"])
    model = UNet(6, **model_kw).eval()
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    scene = rng.normal(size=(100, 60, 6)).astype(np.float32)
    scene[:40] = 0.0
    kw = dict(kernel=16, buffer=8, batch_size=4, blend="hann", max_rows=72, nodata=0.0)
    got = _np(TiledInferenceEngine.from_model(model, device="cpu", **kw).predict_scene(scene))
    want = np.asarray(JaxEngine.from_model(jmodel, v, **kw).predict_scene(scene))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
