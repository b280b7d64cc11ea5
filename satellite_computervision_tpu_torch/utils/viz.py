"""Visualization helpers.

Reference: plot_to_image (utils/prediction_tools.py:228-243, matplotlib
figure -> PNG tensor for TensorBoard) and rasterio_to_img
(utils/raster_tools.py:333-365, CHW array -> 8-bit image file). The
port's own copy of ``satellite_computervision_tpu/utils/viz.py``:
matplotlib and PIL are imported inside the functions.
"""

from __future__ import annotations

import io

import numpy as np


def plot_to_image(figure) -> np.ndarray:
    """Render a matplotlib figure to an (H, W, 4) uint8 RGBA array and
    close it (utils/prediction_tools.py:228-243)."""
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    figure.savefig(buf, format="png")
    plt.close(figure)
    buf.seek(0)
    from PIL import Image

    img = np.asarray(Image.open(buf).convert("RGBA"))
    return img


def save_rgb_image(array: np.ndarray, out_path: str, nbands: int = 3, vmax=255.0):
    """(C, H, W) or (H, W, C) array -> 8-bit PNG/JPG
    (utils/raster_tools.py:333-365)."""
    from PIL import Image

    arr = np.asarray(array)
    if arr.ndim == 3 and arr.shape[0] <= 8 < arr.shape[-1]:
        arr = arr.transpose(1, 2, 0)
    arr = np.clip(arr[..., :nbands], 0, vmax).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(out_path)
