"""Batch prediction over Earth Engine-exported TFRecord patch files.

Port of ``satellite_computervision_tpu/inference/batch.py`` (the
reference's make_pred_dataset + doPrediction,
utils/prediction_tools.py:159-226, 602-729): list the exported files,
split tfrecords from the mixer json, predict the patches in batches on the
device, write one prediction TFRecord per chunk of files for
``earthengine upload``; ``get_img_bounds`` gives a reassembled
prediction's (optionally reprojected) bounds.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.data.tfrecord import read_float_examples
from satellite_computervision_tpu_torch.geo.crs import transform_bounds
from satellite_computervision_tpu_torch.geo.transforms import array_bounds
from satellite_computervision_tpu_torch.inference.mixer import MixerInfo
from satellite_computervision_tpu_torch.inference.writers import write_tfrecord_predictions
from satellite_computervision_tpu_torch.ops.normalize import rescale_image


def list_export_files(pattern_or_dir: str) -> Tuple[List[str], Optional[str]]:
    """Split an EE export listing into (sorted tfrecord files, mixer json)
    (utils/prediction_tools.py:620-652)."""
    if os.path.isdir(pattern_or_dir):
        entries = [os.path.join(pattern_or_dir, f) for f in os.listdir(pattern_or_dir)]
    else:
        entries = _glob.glob(pattern_or_dir)
    tfrecords = sorted(f for f in entries if ".tfrecord" in os.path.basename(f))
    mixers = [f for f in entries if f.endswith(".json")]
    return tfrecords, (mixers[0] if mixers else None)


def make_pred_batches(
    files: Sequence[str],
    features: Sequence[str],
    kernel_shape=(256, 256),
    kernel_buffer=(128, 128),
    batch_size: int = 8,
    axes=(0, 1),
    moments=None,
    splits=None,
    compression: Optional[str] = "GZIP",
    device="cuda",
):
    """Yield (B, side_y, side_x, C) float32 patch batches on ``device``,
    each patch rescaled on its own per ``axes``/``moments``/``splits`` (the
    reference's make_pred_dataset returns normalized batches,
    utils/prediction_tools.py:159-226)."""
    device = resolve_device(device)
    side_y = kernel_shape[0] + kernel_buffer[1]
    side_x = kernel_shape[1] + kernel_buffer[0]
    # per-patch axes of (H, W, C) shifted past the batch axis
    batch_axes = tuple(a % 3 + 1 for a in axes)

    def batch(buf):
        x = torch.from_numpy(np.stack(buf)).to(device)
        return rescale_image(x, axes=batch_axes, moments=moments, splits=splits)

    buf = []
    for path in files:
        for row in read_float_examples(path, features, compression):
            buf.append(np.stack([row[f].reshape(side_y, side_x) for f in features], axis=-1))
            if len(buf) == batch_size:
                yield batch(buf)
                buf = []
    if buf:
        yield batch(buf)


def run_batch_prediction(
    pattern_or_dir: str,
    predict_fn: Callable,
    features: Sequence[str],
    out_dir: str,
    out_base: str,
    kernel_shape=(256, 256),
    kernel_buffer=(128, 128),
    batch_size: int = 8,
    files_per_chunk: int = 100,
    axes=(0, 1),
    moments=None,
    splits=None,
    compression: Optional[str] = "GZIP",
    device="cuda",
) -> List[str]:
    """The doPrediction flow (utils/prediction_tools.py:602-729) on local
    or mounted storage: chunk the export files, predict each chunk batched
    on ``device`` (``predict_fn``: (B, side, side, C) tensor -> (B, side,
    side, C_out)), write one prediction TFRecord per chunk. Returns the
    written paths (upload with ``earthengine upload image ... {files}
    {mixer}``)."""
    device = resolve_device(device)
    files, _ = list_export_files(pattern_or_dir)
    if not files:
        raise FileNotFoundError(f"no tfrecord files under {pattern_or_dir!r}")
    os.makedirs(out_dir, exist_ok=True)

    written = []
    for ci in range(0, len(files), files_per_chunk):
        chunk = files[ci : ci + files_per_chunk]
        preds = []
        with torch.inference_mode():
            for batch in make_pred_batches(chunk, features, kernel_shape, kernel_buffer,
                                           batch_size, axes, moments, splits, compression,
                                           device):
                preds.append(predict_fn(batch).float().cpu().numpy())
        out_path = os.path.join(out_dir, f"{out_base}-{ci // files_per_chunk:05d}.tfrecords")
        write_tfrecord_predictions(np.concatenate(preds, axis=0), out_path,
                                   kernel_shape=kernel_shape, kernel_buffer=kernel_buffer)
        written.append(out_path)
    return written


def get_img_bounds(image_shape, mixer: MixerInfo, dst_crs=None):
    """[[south, west], [north, east]] bounds of a reassembled prediction
    (utils/prediction_tools.py:560-600). With ``dst_crs`` (e.g.
    ``"EPSG:4326"`` for folium, the reference's transform branch at
    :584-597) bounds are reprojected from the mixer CRS via the
    self-contained ``geo.crs`` transforms (UTM/web-mercator/lon-lat)."""
    h, w = image_shape[:2]
    left, bottom, right, top = array_bounds(h, w, mixer.affine)
    if dst_crs is not None:
        left, bottom, right, top = transform_bounds(
            left, bottom, right, top, mixer.crs, dst_crs
        )
    return [[bottom, left], [top, right]]
