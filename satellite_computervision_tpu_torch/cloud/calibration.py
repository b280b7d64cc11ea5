"""Cross-scene radiometric calibration (histogram matching).

The port's own numpy copy of ``satellite_computervision_tpu/cloud/
calibration.py``, host-side as there. Reference: utils/calibration.py —
percentile clamp+rescale (:12-45), scene medians (:47-62), overlap
geometry (:64-76), histogram->CDF feature collections (:78-134), and
histogram matching implemented as two chained random-forest regressions
DN->cdf->DN fitted on the overlap region (:136-182), iterated west->east
across a collection (:184-233). All of that runs server-side in EE.

Here the same calibration runs on raw arrays: the DN->CDF->DN mapping is
computed exactly (sorted-quantile interpolation), which is the function the
reference's random forests approximate, per band in NumPy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def clamp_and_scale(img: np.ndarray, percentiles: Tuple[float, float] = (1, 99)):
    """Clamp each band to its percentile range then rescale to [0, 1]
    (utils/calibration.py:12-45). Channels-last; NaNs ignored."""
    img = np.asarray(img, np.float32)
    lo = np.nanpercentile(img, percentiles[0], axis=(0, 1), keepdims=True)
    hi = np.nanpercentile(img, percentiles[1], axis=(0, 1), keepdims=True)
    clamped = np.clip(img, lo, hi)
    return (clamped - lo) / np.maximum(hi - lo, 1e-12)


def scene_median(img: np.ndarray) -> np.ndarray:
    """Per-band nan-median (utils/calibration.py:47-62's reduceRegion)."""
    return np.nanmedian(np.asarray(img, np.float32), axis=(0, 1))


def overlap_mask(valid_a: np.ndarray, valid_b: np.ndarray) -> np.ndarray:
    """Common-footprint mask of two coregistered scenes
    (utils/calibration.py:64-76's geometry intersection)."""
    return np.asarray(valid_a, bool) & np.asarray(valid_b, bool)


def histogram_cdf(values: np.ndarray, n_bins: int = 256):
    """(bin_centers, cdf) of finite values — the hist_to_FC / make_FC
    feature collections (utils/calibration.py:78-134)."""
    values = np.asarray(values, np.float32).ravel()
    values = values[np.isfinite(values)]
    counts, edges = np.histogram(values, bins=n_bins)
    centers = (edges[:-1] + edges[1:]) / 2.0
    cdf = np.cumsum(counts).astype(np.float64)
    cdf /= max(cdf[-1], 1.0)
    return centers, cdf


def match_histogram(
    source: np.ndarray, template: np.ndarray, n_bins: int = 256
) -> np.ndarray:
    """Map ``source`` DNs so their distribution matches ``template``'s.

    The exact DN -> cdf -> DN transform that `equalize`
    (utils/calibration.py:136-182) approximates with chained random-forest
    regressions. NaNs pass through.
    """
    source = np.asarray(source, np.float32)
    src_centers, src_cdf = histogram_cdf(source, n_bins)
    tpl_centers, tpl_cdf = histogram_cdf(template, n_bins)
    flat = source.ravel()
    finite = np.isfinite(flat)
    quantiles = np.interp(flat[finite], src_centers, src_cdf)
    matched = np.interp(quantiles, tpl_cdf, tpl_centers)
    out = flat.copy()
    out[finite] = matched.astype(np.float32)
    return out.reshape(source.shape)


def make_FC(image: np.ndarray, overlap: np.ndarray = None, n_bins: int = 4096):
    """Per-band histogram feature collections of a scene: list (one entry
    per band) of ``(bucket_means, cdf)`` pairs — the array analog of the
    reference's ``make_FC`` (utils/calibration.py:105-134), which maps
    ``hist_to_FC`` over an image's bands inside an AOI. ``overlap`` is the
    AOI mask; ``n_bins`` mirrors the reference's ``maxBuckets = 2**12``."""
    image = np.asarray(image, np.float32)
    out = []
    for b in range(image.shape[-1]):
        band = image[..., b][overlap] if overlap is not None else image[..., b]
        out.append(histogram_cdf(band, n_bins))
    return out


def _rf_regress_1d(
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_query: np.ndarray,
    n_trees: int = 100,
    rng: np.random.Generator = None,
) -> np.ndarray:
    """Bootstrap-aggregated 1-D piecewise-constant regression — the
    mechanism of the reference's ``ee.Classifier.randomForest(100)``
    REGRESSION trained on histogram-bin features (utils/calibration.py:
    155-171). Each tree fits a bootstrap resample of the (x, y) bin
    points; on 1-D data with distinct x a grown regression tree predicts
    the y of the training point whose x-midpoint interval contains the
    query, so a tree reduces exactly to a step interpolant through its
    bootstrap sample; the forest averages 100 such steps."""
    if rng is None:
        rng = np.random.default_rng(0)
    n = len(x_train)
    preds = np.zeros((n_trees, len(x_query)), np.float64)
    for t in range(n_trees):
        take = rng.integers(0, n, n)
        xs, ys = x_train[take], y_train[take]
        # average duplicate x draws (they land in one leaf)
        ux, inv = np.unique(xs, return_inverse=True)
        uy = np.zeros(len(ux))
        np.add.at(uy, inv, ys)
        uy /= np.bincount(inv)
        # step prediction: nearest midpoint interval
        mids = (ux[:-1] + ux[1:]) / 2.0 if len(ux) > 1 else np.empty(0)
        preds[t] = uy[np.searchsorted(mids, x_query)]
    return preds.mean(axis=0)


def equalize_rf(
    source: np.ndarray,
    template: np.ndarray,
    overlap: np.ndarray = None,
    n_bins: int = 4096,
    n_trees: int = 100,
    seed: int = 0,
) -> np.ndarray:
    """The reference's histogram-matching *as implemented*: per band, two
    chained random-forest regressions DN -> cdf (fitted on the source's
    histogram FC) then cdf -> DN (fitted on the template's), each a
    100-tree bootstrap piecewise-constant fit over the histogram-bin
    points (utils/calibration.py:136-182).

    Shipped for the A/B against :func:`equalize_scene`, which computes
    the same DN -> cdf -> DN map by exact sorted-quantile interpolation —
    the function these forests approximate (the JAX package's
    tests/test_cloud.py quantifies the deviation on realistic histograms).
    Prefer ``equalize_scene`` for production."""
    rng = np.random.default_rng(seed)
    source = np.asarray(source, np.float32)
    template = np.asarray(template, np.float32)
    src_fc = make_FC(source, overlap, n_bins)
    tpl_fc = make_FC(template, overlap, n_bins)
    out = np.empty_like(source)
    for b in range(source.shape[-1]):
        src_centers, src_cdf = src_fc[b]
        tpl_centers, tpl_cdf = tpl_fc[b]
        flat = source[..., b].ravel()
        finite = np.isfinite(flat)
        # classifier2: DN -> probability, trained on the source FC
        q = _rf_regress_1d(src_centers, src_cdf, flat[finite], n_trees, rng)
        # classifier1: probability -> DN, trained on the template FC
        mapped = _rf_regress_1d(tpl_cdf, tpl_centers, q, n_trees, rng)
        band = flat.copy()
        band[finite] = mapped.astype(np.float32)
        out[..., b] = band.reshape(source.shape[:-1])
    return out


def equalize_scene(
    source: np.ndarray,
    template: np.ndarray,
    overlap: np.ndarray = None,
    n_bins: int = 256,
) -> np.ndarray:
    """Per-band histogram match of a scene to a reference scene, fitted on
    the overlap region when given (utils/calibration.py:136-182)."""
    source = np.asarray(source, np.float32)
    template = np.asarray(template, np.float32)
    out = np.empty_like(source)
    for b in range(source.shape[-1]):
        src_fit = source[..., b][overlap] if overlap is not None else source[..., b]
        tpl_fit = template[..., b][overlap] if overlap is not None else template[..., b]
        src_centers, src_cdf = histogram_cdf(src_fit, n_bins)
        tpl_centers, tpl_cdf = histogram_cdf(tpl_fit, n_bins)
        flat = source[..., b].ravel()
        finite = np.isfinite(flat)
        q = np.interp(flat[finite], src_centers, src_cdf)
        mapped = np.interp(q, tpl_cdf, tpl_centers).astype(np.float32)
        band = flat.copy()
        band[finite] = mapped
        out[..., b] = band.reshape(source.shape[:-1])
    return out


def equalize_collection(
    scenes: Sequence[np.ndarray],
    overlaps: Sequence[np.ndarray] = None,
    n_bins: int = 256,
):
    """Iteratively equalize an ordered scene sequence to its first member,
    chaining east from the (already-calibrated) western neighbor
    (utils/calibration.py:184-233)."""
    if not scenes:
        return []
    out = [np.asarray(scenes[0], np.float32)]
    for i in range(1, len(scenes)):
        overlap = overlaps[i - 1] if overlaps is not None else None
        out.append(equalize_scene(scenes[i], out[i - 1], overlap, n_bins))
    return out
