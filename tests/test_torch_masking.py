"""The port's cloud masking math (cloud/masking.py), ``ops.bands.calc_ndvi``
and ``ops.stats`` against the JAX package's on the same seeded numpy
inputs: raw Sentinel-2 DNs with bright clouds, a dark vegetated block
(raw cloud score below 0), a stripe where B3 + B11 = 0 and B8 + B11 = 0
(NaN indices), every QA60 bit pattern, every SCL class and every Landsat
pixel_qa value.

Tolerances: masks and the uint8 cloud score bit-equal; float outputs
within rtol 1e-6 / atol 1e-6 with NaN positions equal (the same float32
operations; XLA and torch may sum a few planes in another order); CDFs and
densities within atol 2e-6 / rtol 1e-5 (other ``gammainc``/``lgamma``
implementations)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from satellite_computervision_tpu.cloud import masking as jm
from satellite_computervision_tpu.ops import bands as jbands
from satellite_computervision_tpu.ops import stats as jstats
from satellite_computervision_tpu_torch.cloud import masking as tm
from satellite_computervision_tpu_torch.ops import bands as tbands
from satellite_computervision_tpu_torch.ops import stats as tstats
from test_torch_deeplab import two_torch_threads  # noqa: F401

FLOAT = dict(rtol=1e-6, atol=1e-6)
SPECIAL = dict(rtol=1e-5, atol=2e-6)
H, W = 64, 80
# a dark vegetated pixel in raw DN: B2 = 300 gives rescale(0.03, (0.1, 0.5))
# = -0.175, the least of the indicators, so floor(x100) = -18
DARK = {"B1": 700.0, "B2": 300.0, "B3": 500.0, "B4": 300.0, "B8": 3500.0, "B10": 1200.0,
        "B11": 1600.0, "B12": 800.0}


def synth_bands(seed=0, h=H, w=W):
    """Raw DN bands keyed as the masking module keys them."""
    rng = np.random.default_rng(seed)
    names = [b for b in jm.TOA_BANDS]
    bands = {b: rng.uniform(0.0, 4000.0, (h, w)).astype(np.float32) for b in names}
    # bright clouds
    bands["B1"][:12, :16] = bands["B2"][:12, :16] = 6000.0
    bands["B10"][:12, :16] = 900.0
    # dark vegetation (raw cloud score < 0)
    for b, v in DARK.items():
        bands[b][20:36, 20:44] = v + rng.normal(0.0, 20.0, (16, 24))
    # NaN indices: B3 + B11 = 0 and B8 + B11 = 0
    for b in ("B3", "B8", "B11"):
        bands[b][:, 60:62] = 0.0
    # every QA60 bit pattern (12 bits) at least once, bits 10/11 in all four
    qa = rng.integers(0, 4096, (h, w))
    qa.reshape(-1)[:4096] = np.arange(4096)
    bands["QA60"] = qa.astype(np.int32)
    return bands


def _jax(bands):
    return {k: jnp.asarray(v) for k, v in bands.items()}


def _torch(bands):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in bands.items()}


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def test_inputs_hold_the_hard_cases():
    b = synth_bands()
    raw = tm.raw_cloud_score(_torch(b))
    floor = torch.floor(raw * 100.0)
    # scores a wrapping cast would put above the threshold 15
    assert ((floor < -15) & (floor > -241)).any()
    assert torch.isnan(raw).any() and (raw > 0.15).any()
    assert set(np.unique(b["QA60"] & 3072)) == {0, 1024, 2048, 3072}


@pytest.mark.parametrize("name", ["basic_qa_mask", "landsat8_sr_mask", "scl_mask"])
def test_qa_masks_bit_equal(name):
    codes = np.arange(4096, dtype=np.int32).reshape(64, 64)
    got = getattr(tm, name)(torch.from_numpy(codes))
    want = np.asarray(getattr(jm, name)(jnp.asarray(codes)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # float-coded QA planes (an item decoded to float32) take the same path
    np.testing.assert_array_equal(
        getattr(tm, name)(torch.from_numpy(codes.astype(np.float32))).numpy(), want)


def test_cloud_score_uint8_bit_equal():
    b = synth_bands()
    got = tm.sentinel_cloud_score(_torch(b))
    want = np.asarray(jm.sentinel_cloud_score(_jax(b)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_cloud_score_saturates_like_jax(monkeypatch):
    """A dark clear pixel (B2 = 300 DN: rescale gives -0.175, floor x100 =
    -18) scores 0 and is kept, as JAX's saturating cast gives; a wrapping
    ``.to(torch.uint8)`` gives 238 and calls it cloud. A NaN score (B3 =
    B11 = 0) is 0."""
    b = {k: np.full((1, 2), v, np.float32) for k, v in (
        *DARK.items(), ("QA60", 0.0))}
    b["B3"][0, 1] = b["B11"][0, 1] = 0.0
    raw = tm.raw_cloud_score(_torch(b))
    assert torch.floor(raw[0, 0] * 100.0) == -18 and torch.isnan(raw[0, 1])
    want = np.asarray(jm.sentinel_cloud_score(_jax(b)))
    np.testing.assert_array_equal(want, [[0, 0]])
    np.testing.assert_array_equal(tm.sentinel_cloud_score(_torch(b)).numpy(), want)
    np.testing.assert_array_equal(tm.toa_mask(_torch(b)).numpy(),
                                  np.asarray(jm.toa_mask(_jax(b))))
    assert tm.toa_mask(_torch(b)).all()
    # the same score through a plain cast disagrees with JAX
    monkeypatch.setattr(tm, "_saturating_uint8", lambda x: x.to(torch.uint8))
    assert tm.sentinel_cloud_score(_torch(b))[0, 0] != 0


@pytest.mark.parametrize("kw", [{}, {"cdi": True}, {"jrc": True},
                                {"cloud_thresh": 40, "water_thresh": 0.5, "shadow_b11": 300.0}],
                         ids=["default", "cdi", "jrc", "thresholds"])
def test_combined_and_toa_masks_bit_equal(kw):
    b = synth_bands(1)
    rng = np.random.default_rng(2)
    extra = {}
    if kw.pop("cdi", False):
        extra["cdi"] = rng.uniform(-1.0, 1.0, (H, W)).astype(np.float32)
    if kw.pop("jrc", False):
        extra["jrc_water"] = rng.integers(0, 3, (H, W)).astype(np.int32)
    got = tm.combined_mask(_torch(b), **{k: torch.from_numpy(v) for k, v in extra.items()},
                           **kw)
    want = np.asarray(jm.combined_mask(_jax(b), **{k: jnp.asarray(v)
                                                    for k, v in extra.items()}, **kw))
    assert got.dtype == torch.bool and 0 < want.sum() < want.size
    np.testing.assert_array_equal(got.numpy(), want)
    thresh = kw.get("cloud_thresh", 15)
    np.testing.assert_array_equal(tm.toa_mask(_torch(b), thresh).numpy(),
                                  np.asarray(jm.toa_mask(_jax(b), thresh)))


def test_water_score_and_apply_mask():
    b = synth_bands(3)
    got = tm.water_score(_torch(b))
    want = np.asarray(jm.water_score(_jax(b)))
    assert np.isnan(want).any()
    np.testing.assert_allclose(got.numpy(), want, **FLOAT)
    mask = np.asarray(jm.combined_mask(_jax(b)) & jm.basic_qa_mask(b["QA60"]))
    got = tm.apply_mask(_torch(b), torch.from_numpy(mask.copy()))
    want = jm.apply_mask(_jax(b), jnp.asarray(mask))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_toa_rescale_indices_and_channels():
    b = synth_bands(4)
    got, want = tm.sentinel2toa(_torch(b)), jm.sentinel2toa(_jax(b))
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    for th in ((0.1, 0.5), (0.8, 0.6), (-0.1, 0.1)):
        np.testing.assert_array_equal(tm.rescale(torch.from_numpy(b["B2"]), th).numpy(),
                                      np.asarray(jm.rescale(jnp.asarray(b["B2"]), th)))
    toa_t = {k: v for k, v in got.items() if k != "QA60"}
    toa_j = {k: v for k, v in want.items() if k != "QA60"}
    got_c, want_c = tm.cloud_bands(toa_t), jm.cloud_bands(toa_j)
    for k in ("ndmi", "ndsi", "cirrus", "vis"):
        np.testing.assert_allclose(got_c[k].numpy(), np.asarray(want_c[k]), **FLOAT)
    got_d = tm.dark_channels(toa_t["B4"], toa_t["B3"], toa_t["B2"])
    want_d = jm.dark_channels(toa_j["B4"], toa_j["B3"], toa_j["B2"])
    for k in want_d:
        np.testing.assert_allclose(got_d[k].numpy(), np.asarray(want_d[k]), **FLOAT)
    np.testing.assert_allclose(
        tm.normalize_minmax(toa_t["B2"], toa_t["B3"], toa_t["B4"]).numpy(),
        np.asarray(jm.normalize_minmax(toa_j["B2"], toa_j["B3"], toa_j["B4"])), **FLOAT)
    names, coeffs = ("B2", "B8", "B11"), (0.5, -1.25, 2.0)
    np.testing.assert_allclose(tm.lda_score(toa_t, 0.3, names, coeffs).numpy(),
                               np.asarray(jm.lda_score(toa_j, 0.3, names, coeffs)), **FLOAT)


@pytest.mark.parametrize("axes", [(-2, -1), (-1,), (0, 1, 2)])
def test_standardize_is_ddof0(axes):
    img = np.random.default_rng(5).normal(3.0, 2.0, (3, 16, 20)).astype(np.float32)
    got = tm.standardize(torch.from_numpy(img), axes)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.standardize(jnp.asarray(img), axes)),
                               **FLOAT)


def test_probabilities_and_densities():
    rng = np.random.default_rng(6)
    z = rng.normal(0.0, 2.0, 512).astype(np.float32)
    np.testing.assert_allclose(tm.norm_p(torch.from_numpy(z)).numpy(),
                               np.asarray(jm.norm_p(jnp.asarray(z))), **FLOAT)
    stat = rng.uniform(0.0, 30.0, 512).astype(np.float32)
    for df in (1.0, 3.0, 7.5):
        np.testing.assert_allclose(tm.gamma_p(torch.from_numpy(stat), df).numpy(),
                                   np.asarray(jm.gamma_p(jnp.asarray(stat), df)), **SPECIAL)
        np.testing.assert_allclose(tm.chi_p(torch.from_numpy(stat), df).numpy(),
                                   np.asarray(jm.chi_p(jnp.asarray(stat), df)), **SPECIAL)
    x = np.concatenate([[-1.0, 0.0], rng.uniform(0.01, 12.0, 510)]).astype(np.float32)
    for shape, scale in ((2.0, 1.5), (0.7, 3.0), (9.0, 0.5)):
        np.testing.assert_allclose(tstats.gamma_pdf(torch.from_numpy(x), shape, scale).numpy(),
                                   np.asarray(jstats.gamma_pdf(jnp.asarray(x), shape, scale)),
                                   **SPECIAL)
    for mean, sd in ((0.0, 1.0), (1.2, 0.4)):
        np.testing.assert_allclose(tstats.lognormal_pdf(torch.from_numpy(x), mean, sd).numpy(),
                                   np.asarray(jstats.lognormal_pdf(jnp.asarray(x), mean, sd)),
                                   **SPECIAL)


def test_calc_ndvi():
    b = synth_bands(7)
    got = tbands.calc_ndvi(torch.from_numpy(b["B8"]), torch.from_numpy(b["B4"]))
    want = np.asarray(jbands.calc_ndvi(jnp.asarray(b["B8"]), jnp.asarray(b["B4"])))
    np.testing.assert_allclose(got.numpy(), want, **FLOAT)
