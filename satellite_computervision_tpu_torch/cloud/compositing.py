"""Array-level scene compositing: the Planetary Computer core, minus Dask.

Port of ``satellite_computervision_tpu/cloud/compositing.py``. The
reference composes scenes with stackstac/xarray/GDAL-VRT: ``get_s2_stac``
stacks signed items into a (time, band, y, x) array at 10 m with 0 -> NaN
nodata and post-2022-01-25 harmonization (utils/pc_tools.py:328-386),
``run_local``/``get_pc_imagery`` median it over time and z-normalize per
pixel (:620-668, :564-618), and ``naip_mosaic`` / ``get_naip_stac`` place
multi-CRS NAIP tiles on a majority-CRS grid (:131-186, :264-282). Here:

- :func:`stack_items` and :func:`mosaic_tiles` stay host numpy (the
  decode side, as in the JAX package);
- :func:`median_composite`, :func:`normalize_composite`,
  :func:`composite_stack`, :func:`composite_items` and
  :func:`change_pair_composite` compute on ``device`` (default ``"cuda"``,
  raising without CUDA) and return a tensor there, so a composite flows
  into the tiled engine without a host copy. They reproduce numpy's
  ``nanmedian`` (the mean of the two middle values for an even count,
  where ``torch.nanmedian`` takes the lower) and ``nanmean``/``nanstd``
  (``ddof=0``).

Item convention: a "stac item" here is any mapping with
``{"datetime": "YYYY-MM-DD...", "bands": {name: (H, W) array}}`` plus
optional ``"crs"``/``"transform"`` — i.e. the decoded form of one STAC
asset set. Network fetch + COG decode stay in cloud.pc / geo.geotiff.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.cloud import _exact
from satellite_computervision_tpu_torch.cloud.pc import (
    S2_HARMONIZE_CUTOFF,
    S2_OFFSET,
    S2_OFFSET_BANDS,
)

__all__ = [
    "stack_items",
    "median_composite",
    "normalize_composite",
    "composite_stack",
    "composite_items",
    "change_pair_composite",
    "mosaic_tiles",
]

# Elements of one row band of the median's stack: its sort holds the
# sorted values and their int64 indices, ~3x the band (1.5 GiB for 2**27
# float32 elements), so a full 6 x 4096² x 4 stack sorts in 4 bands.
_MEDIAN_BAND_ELEMENTS = 1 << 27


def stack_items(
    items: Sequence[dict],
    bands: Sequence[str],
    nodata: Optional[float] = 0.0,
    harmonize: bool = True,
) -> np.ndarray:
    """Stack decoded items into (T, H, W, C) float32, matching get_s2_stac
    semantics (utils/pc_tools.py:328-386): ``nodata`` -> NaN, and items
    acquired after the 2022-01-25 baseline cutoff get the +1000 offset
    removed on the Sentinel-2 reflectance bands (harmonize_to_old,
    :284-326 — clip at offset then subtract, so the result floor is 0)."""
    if not items:
        raise ValueError("no items to stack")
    layers = []
    for item in items:
        arrs = [np.asarray(item["bands"][b], np.float32) for b in bands]
        stack = np.stack(arrs, axis=-1)
        if nodata is not None:
            stack = np.where(stack == nodata, np.nan, stack)
        if harmonize and str(item.get("datetime", "")) >= S2_HARMONIZE_CUTOFF:
            offset_cols = [i for i, b in enumerate(bands) if b in S2_OFFSET_BANDS]
            if offset_cols:
                shifted = np.clip(stack[..., offset_cols], S2_OFFSET, None) - S2_OFFSET
                stack[..., offset_cols] = shifted
        layers.append(stack)
    shapes = {l.shape for l in layers}
    if len(shapes) != 1:
        raise ValueError(f"items disagree on shape: {sorted(shapes)}")
    return np.stack(layers, axis=0)


def median_composite(stack, device="cuda") -> torch.Tensor:
    """NaN-aware median over the leading time axis: (T, H, W, C) ->
    (H, W, C) on ``device`` (the ``median(dim='time')`` composites,
    utils/pc_tools.py:641-643, :595-605), as ``np.nanmedian``: with ``n``
    valid values, the mean of sorted positions ``(n-1)//2`` and ``n//2``
    (NaN sorts last). All-NaN pixels stay NaN. Runs in row bands of at
    most ``_MEDIAN_BAND_ELEMENTS`` stack elements."""
    device = resolve_device(device)
    stack = torch.as_tensor(stack, dtype=torch.float32, device=device)
    if stack.ndim != 4:
        raise ValueError(f"expected (T, H, W, C), got {tuple(stack.shape)}")
    t, h, w, c = stack.shape
    out = torch.empty((h, w, c), dtype=torch.float32, device=device)
    rows = max(1, _MEDIAN_BAND_ELEMENTS // max(1, t * w * c))
    for y in range(0, h, rows):
        band = stack[:, y : y + rows]
        ordered = torch.sort(band, dim=0).values
        n = (~torch.isnan(band)).sum(dim=0, keepdim=True)
        lo = torch.gather(ordered, 0, ((n - 1) // 2).clamp(min=0))
        hi = torch.gather(ordered, 0, (n // 2).clamp(max=t - 1))
        out[y : y + rows] = torch.where(n[0] > 0, (lo[0] + hi[0]) / 2.0, float("nan"))
    return out


def normalize_composite(composite, axis: int = -1, epsilon: float = 1e-8,
                        device="cuda") -> torch.Tensor:
    """Z-score along ``axis`` with NaN-ignoring moments (``ddof=0``) on
    ``device`` — the reference's normalize_dataArray over 'band' (per-pixel
    standardization across bands, utils/pc_tools.py:90-107, :646-648).
    Pixels NaN in every band (cloud-masked everywhere) stay NaN. The
    moments go through ``cloud._exact``: bit-equal on the card and the
    CPU."""
    device = resolve_device(device)
    x = torch.as_tensor(composite, dtype=torch.float32, device=device)
    valid = ~torch.isnan(x)
    n = valid.sum(dim=axis, keepdim=True).float()
    mean = _exact.sum_along(torch.where(valid, x, 0.0), axis) / n
    dev = torch.where(valid, x - mean, 0.0)
    std = _exact.sqrt(_exact.sum_along(dev * dev, axis) / n)
    return (x - mean) / (std + epsilon)


def composite_stack(stack, normalize: bool = False, fill: Optional[float] = None,
                    device="cuda") -> torch.Tensor:
    """NaN-median of a (T, H, W, C) stack -> optional per-pixel normalize
    -> optional NaN fill, on ``device``: the composite of items already
    stacked (e.g. masked on the card) into a model-ready (H, W, C) scene."""
    out = median_composite(stack, device)
    if normalize:
        out = normalize_composite(out, device=device)
    if fill is not None:
        out = torch.where(torch.isnan(out), fill, out)
    return out


def composite_items(
    items: Sequence[dict],
    bands: Sequence[str],
    nodata: Optional[float] = 0.0,
    harmonize: bool = True,
    normalize: bool = False,
    fill: Optional[float] = None,
    device="cuda",
) -> torch.Tensor:
    """stack (host) -> NaN-median -> optional per-pixel normalize ->
    optional NaN fill (on ``device``): one call from decoded items to a
    model-ready (H, W, C) scene."""
    device = resolve_device(device)
    return composite_stack(stack_items(items, bands, nodata, harmonize), normalize, fill,
                           device)


def change_pair_composite(
    before_items: Sequence[dict],
    after_items: Sequence[dict],
    bands: Sequence[str] = ("B02", "B03", "B04", "B08"),
    fill: Optional[float] = 0.0,
    device="cuda",
) -> torch.Tensor:
    """The run_local change-detection input (utils/pc_tools.py:620-654):
    median composites of the before/after item sets, each per-pixel
    z-normalized, concatenated to a 2C-band (H, W, 2C) scene on ``device``
    ready for ``cloud.pc.predict_scene`` / the Siamese U-Net."""
    device = resolve_device(device)
    before = composite_items(before_items, bands, normalize=True, fill=fill, device=device)
    after = composite_items(after_items, bands, normalize=True, fill=fill, device=device)
    if before.shape != after.shape:
        raise ValueError(
            f"before/after composites disagree: {tuple(before.shape)} vs {tuple(after.shape)}"
        )
    return torch.cat([before, after], dim=-1)


def _tile_grid_offset(transform, origin, pixel: Tuple[float, float]) -> Tuple[int, int]:
    """Pixel offset of a tile's origin on the mosaic grid; transforms are
    GDAL-order (a, b, c, d, e, f) with b == d == 0."""
    col = (transform[2] - origin[0]) / pixel[0]
    row = (transform[5] - origin[1]) / pixel[1]
    icol, irow = round(col), round(row)
    if abs(col - icol) > 1e-3 or abs(row - irow) > 1e-3:
        raise ValueError(
            f"tile origin {transform[2], transform[5]} is not grid-aligned "
            f"with the mosaic (offset {row}, {col} px)"
        )
    return irow, icol


def mosaic_tiles(tiles: Sequence[dict], nodata: Optional[float] = None):
    """Place pre-warped tiles on one grid in the majority CRS.

    The array-level naip_mosaic / get_naip_stac core
    (utils/pc_tools.py:131-186, :264-282): count tiles per CRS, keep the
    majority EPSG (minority tiles must arrive already warped onto it, as
    GDAL-Warp did in the reference — un-warped minority tiles are
    rejected), compute the union grid from the tile transforms, and place
    tiles in order (later tiles win on overlap, matching VRT source
    order). Each tile: ``{"array": (H, W, C), "transform": (a, b, c, d, e,
    f), "crs": "EPSG:..."}`` with a common pixel size.

    Returns ``(mosaic (H, W, C) float32, transform, crs)``; uncovered cells
    are NaN (or ``nodata``)."""
    if not tiles:
        raise ValueError("no tiles to mosaic")
    crss = [str(t.get("crs", "")) for t in tiles]
    counts: Dict[str, int] = {}
    for c in crss:
        counts[c] = counts.get(c, 0) + 1
    majority = max(counts, key=lambda c: counts[c])
    kept = [t for t in tiles if str(t.get("crs", "")) == majority]
    if len(kept) != len(tiles):
        dropped = len(tiles) - len(kept)
        raise ValueError(
            f"{dropped} tile(s) are not in the majority CRS {majority}; warp "
            "them onto it first (geo.crs handles the supported transforms)"
        )

    t0 = kept[0]["transform"]
    pixel = (float(t0[0]), float(t0[4]))  # (a, e): x size, y size (e < 0)
    for t in kept:
        tr = t["transform"]
        if abs(tr[0] - pixel[0]) > 1e-9 or abs(tr[4] - pixel[1]) > 1e-9:
            raise ValueError("tiles disagree on pixel size; warp to a common grid")
        if tr[1] or tr[3]:
            raise ValueError("rotated transforms are not supported")

    origin_x = min(t["transform"][2] for t in kept)
    origin_y = max(t["transform"][5] for t in kept) if pixel[1] < 0 else min(
        t["transform"][5] for t in kept
    )
    origin = (origin_x, origin_y)

    placements = []
    max_r = max_c = 0
    channels = None
    for t in kept:
        arr = np.asarray(t["array"], np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        if channels is None:
            channels = arr.shape[-1]
        elif arr.shape[-1] != channels:
            raise ValueError("tiles disagree on channel count")
        r, c = _tile_grid_offset(t["transform"], origin, pixel)
        placements.append((r, c, arr))
        max_r = max(max_r, r + arr.shape[0])
        max_c = max(max_c, c + arr.shape[1])

    fill = np.nan if nodata is None else nodata
    mosaic = np.full((max_r, max_c, channels), fill, np.float32)
    for r, c, arr in placements:
        mosaic[r : r + arr.shape[0], c : c + arr.shape[1]] = arr

    transform = (pixel[0], 0.0, origin[0], 0.0, pixel[1], origin[1])
    return mosaic, transform, majority
