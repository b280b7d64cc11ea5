"""Prediction sinks: TFRecord patches for EE ingest, GeoTIFF scenes.

Reference: write_tfrecord_predictions (utils/prediction_tools.py:375-445),
write_geotiff_prediction(s) (utils/prediction_tools.py:447-536). The
TFRecord sink writes per-patch float features ``b1..bC`` exactly as EE's
image-ingest expects; GeoTIFF writing delegates to the self-contained
``geo.geotiff`` writer (rasterio/GDAL are not available here).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from satellite_computervision_tpu_torch.data.tfrecord import TFRecordWriter, build_example
from satellite_computervision_tpu_torch.inference.mixer import MixerInfo


def predictions_to_examples(
    predictions: np.ndarray, kernel_shape=(256, 256), kernel_buffer=(128, 128)
) -> Iterable[dict]:
    """Yield {b1: flat, ..., bC: flat} feature dicts, one per patch, with
    the buffer cropped (utils/prediction_tools.py:406-443)."""
    predictions = np.asarray(predictions)
    if predictions.ndim == 3:
        predictions = predictions[..., None]
    xb = int(kernel_buffer[0]) // 2
    yb = int(kernel_buffer[1]) // 2
    y_size = yb + kernel_shape[0]
    x_size = xb + kernel_shape[1]
    c = predictions.shape[-1]
    for patch in predictions:
        cropped = patch[yb:y_size, xb:x_size, :]
        yield {f"b{i + 1}": cropped[..., i].reshape(-1) for i in range(c)}


def write_tfrecord_predictions(
    predictions: np.ndarray,
    out_path: str,
    kernel_shape: Sequence[int] = (256, 256),
    kernel_buffer: Sequence[int] = (128, 128),
    compression=None,
) -> None:
    """Write patch predictions as an EE-ingestable TFRecord file.

    (EE prediction uploads are uncompressed by default; the reference's
    tf.io.TFRecordWriter likewise, utils/prediction_tools.py:403.)
    """
    with TFRecordWriter(out_path, compression) as writer:
        for ex in predictions_to_examples(predictions, kernel_shape, kernel_buffer):
            writer.write(build_example(ex))


def write_geotiff_predictions(
    image: np.ndarray, mixer: MixerInfo, out_path: str, nodata=None
) -> None:
    """Write a reassembled scene as GeoTIFF with the mixer's georeferencing
    (utils/prediction_tools.py:447-472)."""
    from satellite_computervision_tpu_torch.geo.geotiff import write_geotiff

    write_geotiff(
        out_path, np.asarray(image), transform=mixer.affine, crs=mixer.crs, nodata=nodata
    )
