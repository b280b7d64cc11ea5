"""Thin Earth Engine client builders (server-side lazy ops).

The port's own copy of ``satellite_computervision_tpu/cloud/ee.py``.
Reference: utils/ee_tools.py (ee.Image expression builders executed on
Google's infrastructure) and utils/calibration.py's EE pipeline. The
per-pixel math runs on arrays in cloud.masking / cloud.calibration; these
wrappers exist for workflows that stay in EE (sampling/export), keeping
the reference's API shape. The ``ee`` package is optional — every function
raises a clear ImportError without it, and nothing here imports ``ee`` at
module load (the reference calls ee.Initialize() at import,
utils/ee_tools.py:4 — an antipattern we drop).
"""

from __future__ import annotations

from typing import Sequence


def _ee():
    try:
        import ee
    except ImportError as e:
        raise ImportError(
            "earthengine-api is not installed; the on-device equivalents "
            "live in satellite_computervision_tpu_torch.cloud.masking"
        ) from e
    return ee


def initialize(**kwargs):
    """ee.Initialize, explicit (not at import)."""
    _ee().Initialize(**kwargs)


def basic_qa(img):
    """QA60 cloud/cirrus mask (utils/ee_tools.py:159-180; math:
    masking.basic_qa_mask)."""
    ee = _ee()
    qa = img.select("QA60").int16()
    mask = qa.bitwiseAnd(1024).eq(0).And(qa.bitwiseAnd(2048).eq(0))
    return img.updateMask(mask)


def mask_l8_sr(img):
    """Landsat-8 pixel_qa mask (utils/ee_tools.py:183-195)."""
    qa = img.select("pixel_qa")
    mask = qa.bitwiseAnd(8).eq(0).And(qa.bitwiseAnd(32).eq(0))
    return img.updateMask(mask)


def mask_sr(img):
    """Sentinel-2 L2A SCL-based mask (utils/ee_tools.py:270-306; math:
    masking.scl_mask)."""
    scored = basic_qa(img)
    scl = img.select("SCL")
    keep = (
        scl.neq(8).And(scl.neq(9)).And(scl.neq(10)).And(scl.neq(11))
        .And(scl.neq(2)).And(scl.neq(3))
    )
    return scored.updateMask(keep)


def sentinel2toa(img):
    """DN -> TOA with solar/viewing metadata (utils/ee_tools.py:90-108)."""
    bands = ["B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B8A", "B9", "B10", "B11", "B12"]
    toa = (
        img.select(bands)
        .divide(10000)
        .set("solar_azimuth", img.get("MEAN_SOLAR_AZIMUTH_ANGLE"))
        .set("solar_zenith", img.get("MEAN_SOLAR_ZENITH_ANGLE"))
    )
    return img.select(["QA60"]).addBands(toa)


def rescale_expression(img, expression: str, thresholds: Sequence[float]):
    """Expression + linear stretch helper (utils/ee_tools.py:110-113)."""
    out = img.expression(expression, {"img": img})
    return out.subtract(thresholds[0]).divide(thresholds[1] - thresholds[0])


def sentinel_cloud_score(img):
    """Min-of-indicators cloud score band (utils/ee_tools.py:218-255; math:
    masking.sentinel_cloud_score)."""
    im = sentinel2toa(img)
    score = _ee().Image(1)
    score = score.min(rescale_expression(im, "img.B2", (0.1, 0.5)))
    score = score.min(rescale_expression(im, "img.B1", (0.1, 0.3)))
    score = score.min(rescale_expression(im, "img.B1 + img.B10", (0.15, 0.2)))
    score = score.min(rescale_expression(im, "img.B4 + img.B3 + img.B2", (0.2, 0.8)))
    score = score.min(rescale_expression(im.normalizedDifference(["B8", "B11"]), "img", (-0.1, 0.1)))
    score = score.min(rescale_expression(im.normalizedDifference(["B3", "B11"]), "img", (0.8, 0.6)))
    return img.addBands(score.multiply(100).byte().rename(["cloudScore"]))


def normalize(img, max_img, min_img):
    """Min-max scaling (utils/ee_tools.py:39-50)."""
    return img.subtract(min_img).divide(max_img.subtract(min_img))


def standardize(img, scale: int = 300):
    """Per-band z-scores via reduceRegion (utils/ee_tools.py:52-70)."""
    ee = _ee()
    mean = img.reduceRegion(reducer=ee.Reducer.mean(), scale=scale).toImage()
    sd = img.reduceRegion(reducer=ee.Reducer.stdDev(), scale=scale).toImage(img.bandNames())
    return img.subtract(mean).divide(sd)


def lda_score(img, intercept, band_names, coefficients):
    """LDA band combination (utils/ee_tools.py:73-88)."""
    ee = _ee()
    bands = img.select(band_names)
    coeffs = ee.Dictionary.fromLists(band_names, coefficients).toImage(band_names)
    return bands.multiply(coeffs).addBands(ee.Image(intercept)).reduce(ee.Reducer.sum())


def export_image_patches(
    image,
    bucket: str,
    path: str,
    base: str,
    region,
    kernel_size: int = 256,
    kernel_buffer: Sequence[int] = (128, 128),
    scale: int = 10,
    max_pixels: float = 1e13,
):
    """Start the TFRecord patch export that feeds batch prediction — the
    solar notebook's doExport (cells 75-83): overlapping
    (kernel + buffer)^2 patches + mixer JSON into GCS. Returns the started
    ee.batch.Task; poll with :func:`wait_for_task`. Consume the results
    with inference.batch.run_batch_prediction."""
    ee = _ee()
    task = ee.batch.Export.image.toCloudStorage(
        image=image,
        description=base,
        bucket=bucket,
        fileNamePrefix=f"{path}/{base}",
        region=region,
        scale=scale,
        fileFormat="TFRecord",
        maxPixels=max_pixels,
        formatOptions={
            "patchDimensions": [kernel_size, kernel_size],
            "kernelSize": list(kernel_buffer),
            "compressed": True,
            "maxFileSize": 104857600,
        },
    )
    task.start()
    return task


def wait_for_task(task, poll_seconds: int = 30, log_fn=print):
    """Block until an EE batch task completes (the notebook's 30 s polling
    loop, solar cell 75); raises on FAILED/CANCELLED."""
    import time as _time

    while task.active():
        log_fn(f"task {task.id}: running...")
        _time.sleep(poll_seconds)
    status = task.status()
    if status.get("state") != "COMPLETED":
        raise RuntimeError(f"EE task {task.id} ended {status.get('state')}: "
                           f"{status.get('error_message')}")
    return status
