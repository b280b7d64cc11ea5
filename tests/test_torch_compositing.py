"""The port's compositing (cloud/compositing.py) against the JAX
package's on the same seeded items, on the CPU (``device="cpu"``).

- ``stack_items`` and ``mosaic_tiles`` (host numpy in both) exactly equal,
  the mosaic's refusals raising the same errors;
- ``median_composite`` exactly equal to ``np.nanmedian`` with odd, even and
  zero valid counts (the even count's mean of the two middle values is
  ``(a + b) / 2`` in float32 in both, so no tolerance is needed);
- ``normalize_composite`` and everything after it within rtol 1e-5 / atol
  1e-6 (NaN-ignoring band moments summed in another order than numpy's).
"""

import numpy as np
import pytest
import torch

from satellite_computervision_tpu.cloud import compositing as jc
from satellite_computervision_tpu_torch.cloud import compositing as tc
from test_torch_deeplab import two_torch_threads  # noqa: F401

NORM = dict(rtol=1e-5, atol=1e-6)
BANDS = ("B02", "B03", "B04", "B08")


def items(rng, n, date, h=24, w=20, bands=BANDS, cloud=True):
    """``n`` decoded items: DNs around 1500-3000 (+1000 after the cutoff),
    a random nodata (0) patch on each, and a per-item masked pixel stripe
    so pixels see every count of valid dates."""
    out = []
    offset = 1000.0 if date >= "2022-01-25" else 0.0
    for i in range(n):
        arrs = {b: (rng.uniform(1500.0, 3000.0, (h, w)) + offset).astype(np.float32)
                for b in bands}
        if cloud:
            y, x = rng.integers(0, h - 6), rng.integers(0, w - 6)
            for b in bands:
                arrs[b][y : y + 6, x : x + 6] = 0.0
            arrs[bands[0]][:, i] = 0.0
        out.append({"datetime": date, "bands": arrs})
    return out


def test_stack_items_nodata_and_harmonize():
    rng = np.random.default_rng(0)
    its = items(rng, 2, "2021-06-01") + items(rng, 2, "2022-06-01")
    its[3]["bands"]["B02"][0, 0] = 500.0  # below the offset: clipped to 0
    for it in its:
        it["bands"]["SCL"] = np.full((24, 20), 4.0, np.float32)  # not an offset band
    bands = BANDS + ("SCL",)
    for kw in ({}, {"harmonize": False}, {"nodata": None}):
        np.testing.assert_array_equal(tc.stack_items(its, bands, **kw),
                                      jc.stack_items(its, bands, **kw))
    got = tc.stack_items(its, bands)
    assert got[3, 0, 0, 0] == 0.0 and (got[..., 4] == 4.0).all()
    assert np.isnan(got[1, :, 1, 0]).all()  # nodata -> NaN
    with pytest.raises(ValueError, match="no items"):
        tc.stack_items([], BANDS)
    its[1]["bands"] = {b: v[:-1] for b, v in its[1]["bands"].items()}
    with pytest.raises(ValueError, match="disagree on shape"):
        tc.stack_items(its, BANDS)


@pytest.mark.parametrize("t", [1, 4, 5, 6])
def test_median_composite_equals_numpy(t):
    rng = np.random.default_rng(t)
    stack = rng.uniform(0.0, 100.0, (t, 16, 12, 3)).astype(np.float32)
    # valid counts 0..t across pixels
    n_valid = rng.integers(0, t + 1, (16, 12, 3))
    order = rng.permuted(np.broadcast_to(np.arange(t)[:, None, None, None], stack.shape), axis=0)
    stack[order >= n_valid[None]] = np.nan
    got = tc.median_composite(stack, device="cpu")
    want = jc.median_composite(stack)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    counts = (~np.isnan(stack)).sum(0)
    assert {0, 1} <= set(np.unique(counts)) and (t < 2 or {2, t} <= set(np.unique(counts)))
    np.testing.assert_array_equal(got.numpy(), want)
    # a tensor input too, and row bands smaller than the scene
    tc._MEDIAN_BAND_ELEMENTS, saved = t * 12 * 3 * 5, tc._MEDIAN_BAND_ELEMENTS
    try:
        np.testing.assert_array_equal(
            tc.median_composite(torch.from_numpy(stack), device="cpu").numpy(), want)
    finally:
        tc._MEDIAN_BAND_ELEMENTS = saved
    with pytest.raises(ValueError, match="expected"):
        tc.median_composite(stack[0], device="cpu")


def test_even_count_median_is_numpys():
    """Clouds leave an even number of valid dates: numpy averages the two
    middle values, ``torch.nanmedian`` takes the lower one."""
    x = np.array([1.0, 2.0, np.nan, 4.0, 5.0], np.float32).reshape(5, 1, 1, 1)
    assert jc.median_composite(x).item() == 3.0
    assert torch.nanmedian(torch.from_numpy(x), dim=0).values.item() == 2.0
    assert tc.median_composite(x, device="cpu").item() == 3.0


def test_normalize_composite():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(10, 12, 4)) * 300 + 2000).astype(np.float32)
    x[0, 0] = np.nan  # every band: stays NaN
    x[1, :, 2] = np.nan  # one band: moments of the other three
    got = tc.normalize_composite(x, device="cpu")
    np.testing.assert_allclose(got.numpy(), jc.normalize_composite(x), **NORM)
    assert torch.isnan(got[0, 0]).all() and torch.isfinite(got[1, :, [0, 1, 3]]).all()
    np.testing.assert_allclose(tc.normalize_composite(x, axis=0, device="cpu").numpy(),
                               jc.normalize_composite(x, axis=0), **NORM)


@pytest.mark.parametrize("normalize,fill", [(False, None), (True, None), (True, 0.0),
                                            (False, -1.0)])
def test_composite_items_and_stack(normalize, fill):
    rng = np.random.default_rng(2)
    its = items(rng, 3, "2021-06-01") + items(rng, 2, "2022-03-01")
    for it in its:  # a pixel masked on every item
        for b in BANDS:
            it["bands"][b][5, 5] = 0.0
    got = tc.composite_items(its, BANDS, normalize=normalize, fill=fill, device="cpu")
    want = jc.composite_items(its, BANDS, normalize=normalize, fill=fill)
    np.testing.assert_allclose(got.numpy(), want, **NORM)
    assert np.isnan(want[5, 5]).all() == (fill is None)
    stacked = tc.composite_stack(jc.stack_items(its, BANDS), normalize, fill, device="cpu")
    np.testing.assert_array_equal(stacked.numpy(), got.numpy())


def test_change_pair_composite():
    rng = np.random.default_rng(3)
    before, after = items(rng, 3, "2021-06-01"), items(rng, 2, "2022-06-01")
    got = tc.change_pair_composite(before, after, device="cpu")
    want = jc.change_pair_composite(before, after)
    assert got.shape == (24, 20, 8) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **NORM)
    short = items(rng, 2, "2022-06-01", h=20)
    with pytest.raises(ValueError, match="disagree"):
        tc.change_pair_composite(before, short, device="cpu")


TILE = (1.0, 0.0, 100.0, 0.0, -1.0, 200.0)


def test_mosaic_tiles_equal():
    a = np.full((4, 4, 2), 1.0, np.float32)
    b = np.full((4, 4, 2), 2.0, np.float32)
    for tiles, nodata in (
        ([{"array": a, "transform": TILE, "crs": "EPSG:32617"},
          {"array": b, "transform": (1.0, 0.0, 104.0, 0.0, -1.0, 198.0), "crs": "EPSG:32617"}],
         None),
        ([{"array": a[..., 0], "transform": TILE, "crs": "EPSG:32617"},
          {"array": b[..., 0], "transform": (1.0, 0.0, 102.0, 0.0, -1.0, 200.0),
           "crs": "EPSG:32617"},
          {"array": b[..., 0], "transform": (1.0, 0.0, 96.0, 0.0, -1.0, 203.0),
           "crs": "EPSG:32617"}], -9.0),
    ):
        got, want = tc.mosaic_tiles(tiles, nodata), jc.mosaic_tiles(tiles, nodata)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("case,match", [
    ("minority", "majority CRS"),
    ("misaligned", "grid-aligned"),
    ("pixel", "pixel size"),
    ("rotated", "rotated"),
    ("channels", "channel count"),
    ("empty", "no tiles"),
])
def test_mosaic_tiles_refusals(case, match):
    z = np.zeros((2, 2), np.float32)
    t = (1.0, 0.0, 0.0, 0.0, -1.0, 0.0)
    tiles = {
        "minority": [{"array": z, "transform": t, "crs": "EPSG:32617"}] * 2
        + [{"array": z, "transform": t, "crs": "EPSG:32618"}],
        "misaligned": [{"array": z, "transform": t, "crs": "a"},
                       {"array": z, "transform": (1.0, 0.0, 0.5, 0.0, -1.0, 0.0), "crs": "a"}],
        "pixel": [{"array": z, "transform": t, "crs": "a"},
                  {"array": z, "transform": (2.0, 0.0, 0.0, 0.0, -2.0, 0.0), "crs": "a"}],
        "rotated": [{"array": z, "transform": (1.0, 0.5, 0.0, 0.0, -1.0, 0.0), "crs": "a"}],
        "channels": [{"array": z, "transform": t, "crs": "a"},
                     {"array": np.zeros((2, 2, 3)), "transform": t, "crs": "a"}],
        "empty": [],
    }[case]
    for mosaic in (jc.mosaic_tiles, tc.mosaic_tiles):
        with pytest.raises(ValueError, match=match):
            mosaic(tiles)
