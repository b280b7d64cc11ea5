"""Scene assembly from chip tiles -> COG.

Port of ``satellite_computervision_tpu/geo/assembly.py`` (reference:
numpy_to_raster / arrays_to_cog, utils/raster_tools.py:367-461): chips
named ``X_Y.npy`` are windowed into a full raster which is then written as
a Cloud-Optimized GeoTIFF. Assembly is NumPy on the host and the files
come from the port's own ``geo.geotiff`` writers.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from satellite_computervision_tpu_torch.geo.geotiff import write_cog, write_geotiff


def numpy_to_raster(
    arr: np.ndarray,
    mixer: Dict,
    out_file: str,
    dtype: str = "float32",
    nodata=255,
    cog: bool = True,
) -> None:
    """(C, H, W) or (H, W, C) array -> (C)OG with mixer georeferencing
    (utils/raster_tools.py:367-409). ``mixer`` carries rows/cols/
    transform/crs as in the reference's dict."""
    arr = np.asarray(arr)
    if arr.ndim == 3 and arr.shape[0] < arr.shape[-1]:
        arr = np.moveaxis(arr, 0, -1)  # CHW -> HWC
    arr = arr.astype(dtype)
    transform = tuple(mixer["transform"][:6])
    writer = write_cog if cog else write_geotiff
    writer(out_file, arr, transform=transform, crs=mixer.get("crs", ""), nodata=nodata)


def arrays_to_cog(
    chip_files: Sequence[str],
    mixer: Dict,
    out_file: str,
    dtype: str = "float32",
    nodata=255,
) -> None:
    """Assemble ``X_Y.npy`` chip tiles into one COG
    (utils/raster_tools.py:411-461). Chip upper-left pixel offsets come
    from the filename stem (X = col_off, Y = row_off); ``mixer['size']``
    is the chip size, rows/cols the scene dims."""
    if not chip_files:
        raise ValueError("no chip files")
    first = np.load(chip_files[0])
    if first.ndim == 2:
        first = first[..., None]
    c = first.shape[-1]
    h, w = round(mixer["rows"]), round(mixer["cols"])
    scene = np.full((h, w, c), nodata, dtype=dtype)
    size = mixer["size"]
    for f in chip_files:
        arr = np.load(f)
        if arr.ndim == 2:
            arr = arr[..., None]
        x_off, y_off = (int(p) for p in Path(f).stem.split("_")[:2])
        ys = min(size, h - y_off)
        xs = min(size, w - x_off)
        scene[y_off : y_off + ys, x_off : x_off + xs] = arr[:ys, :xs].astype(dtype)
    transform = tuple(mixer["transform"][:6])
    write_cog(out_file, scene, transform=transform, crs=mixer.get("crs", ""), nodata=nodata)
