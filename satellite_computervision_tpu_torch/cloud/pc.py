"""Planetary Computer / STAC acquisition (host-side, import-gated).

Port of ``satellite_computervision_tpu/cloud/pc.py`` (reference:
utils/pc_tools.py — STAC search -> stackstac composites for NAIP / DEM /
LiDAR-HAG / Sentinel-1 / Sentinel-2 / SSURGO, Azure chip export, and the
Dask scene-inference drivers). The heavy dependencies (pystac-client,
planetary-computer, stackstac, rioxarray, dask) are optional, so every
network/raster function imports them inside itself and nothing is
imported at module load; the array-level pieces (harmonization,
normalization, scene inference) need none of them.

The reference's run_local chip loop (utils/pc_tools.py:620-729) maps to
the port's ``inference.TiledInferenceEngine``: weights live on the device
once (run_dask re-downloads the model per Dask chunk,
utils/model_tools.py:1271-1304 — the pathology this replaces).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from satellite_computervision_tpu_torch.inference import TiledInferenceEngine

PC_STAC_URL = "https://planetarycomputer.microsoft.com/api/stac/v1"

# Post-2022-01-25 Sentinel-2 processing-baseline offset
# (harmonize_to_old, utils/pc_tools.py:284-326).
S2_HARMONIZE_CUTOFF = "2022-01-25"
S2_OFFSET = 1000.0
S2_OFFSET_BANDS = (
    "B01", "B02", "B03", "B04", "B05", "B06", "B07", "B08",
    "B8A", "B09", "B10", "B11", "B12",
)


def _pystac():
    try:
        import planetary_computer
        import pystac_client
    except ImportError as e:
        raise ImportError(
            "pystac-client/planetary-computer are not installed; STAC "
            "acquisition is unavailable"
        ) from e
    return pystac_client, planetary_computer


def retry(fn: Callable, *args, retries: int = 5, delay: float = 2.0, exceptions=(Exception,), **kwargs):
    """Bounded exponential-backoff retry.

    Replaces the reference's unbounded recursion on APIError
    (`recursive_api_try`, utils/pc_tools.py:44-53) which can stack-overflow
    and hammer the service.
    """
    for attempt in range(retries):
        try:
            return fn(*args, **kwargs)
        except exceptions:
            if attempt == retries - 1:
                raise
            time.sleep(delay * (2**attempt))


def harmonize_to_old(data, acquired_after_cutoff: bool):
    """Shift post-baseline-4.0 Sentinel-2 DNs back to the old range
    (utils/pc_tools.py:284-326): subtract the +1000 offset, clamp at 0.
    Array-level core; callers split their stack by acquisition date. A
    tensor stays on its device (float32); anything else becomes a float32
    numpy array."""
    if not acquired_after_cutoff:
        return data
    if isinstance(data, torch.Tensor):
        return torch.clamp(data.float() - S2_OFFSET, min=0.0)
    return np.clip(np.asarray(data, np.float32) - S2_OFFSET, 0.0, None)


def harmonize_s2_stack(stack, times, band_names: Sequence[str]):
    """Apply the baseline-4.0 harmonization trigger across a time stack.

    (T, H, W, B) DN stack + per-slice acquisition times + band names ->
    slices acquired on/after the 2022-01-25 processing-baseline cutoff
    get the 13 offset bands shifted back to the old range (clip at the
    +1000 offset, then subtract — utils/pc_tools.py:284-326). Non-offset
    bands (e.g. SCL) and pre-cutoff slices pass through untouched.

    (The reference's xarray ``slice(cutoff)`` / ``slice(cutoff, None)``
    split duplicates a slice falling exactly ON the cutoff into both
    halves; here at-cutoff counts as new, once.)
    """
    stack = np.array(stack, np.float32, copy=True)

    def _dt64(t):
        if isinstance(t, np.datetime64):
            return t
        s = str(t).strip().replace("Z", "").replace(" ", "T")
        if len(s) >= 6 and s[-6] in "+-" and s[-3] == ":":
            s = s[:-6]  # STAC items carry UTC offsets; DNs don't care
        return np.datetime64(s, "s")

    times = np.asarray([_dt64(t) for t in np.ravel(np.asarray(times, object))])
    if len(times) != stack.shape[0]:
        raise ValueError("times must match the stack's leading (time) dim")
    band_idx = [i for i, b in enumerate(band_names) if b in S2_OFFSET_BANDS]
    cutoff = np.datetime64(S2_HARMONIZE_CUTOFF)
    for t in np.nonzero(times >= cutoff)[0]:
        for b in band_idx:
            stack[t, ..., b] = np.clip(stack[t, ..., b] - S2_OFFSET, 0.0, None)
    return stack


def normalize_xarray(data, dim: str = "time", epsilon: float = 1e-8):
    """Z-score along a dim (normalize_dataArray, utils/pc_tools.py:90-107);
    works on xarray or plain arrays (dim -> axis 0)."""
    if hasattr(data, "mean") and hasattr(data, "dims"):
        mean = data.mean(dim=dim, skipna=True)
        std = data.std(dim=dim, skipna=True)
        return (data - mean) / (std + epsilon)
    arr = np.asarray(data, np.float32)
    mean = np.nanmean(arr, axis=0, keepdims=True)
    std = np.nanstd(arr, axis=0, keepdims=True)
    return (arr - mean) / (std + epsilon)


def trim_to_chunk_multiple(arr: np.ndarray, chunk: int = 256) -> np.ndarray:
    """Trim trailing y/x so dims are chunk multiples (trim_dataArray,
    utils/pc_tools.py:109-129). Channels-last (..., H, W, C) or (H, W, C)."""
    arr = np.asarray(arr)
    h = arr.shape[-3] // chunk * chunk
    w = arr.shape[-2] // chunk * chunk
    return arr[..., :h, :w, :]


def search_stac(
    collection: str,
    bbox: Sequence[float],
    datetime: Optional[str] = None,
    query: Optional[dict] = None,
    stac_url: str = PC_STAC_URL,
):
    """Signed STAC item search (the common core of get_*_stac,
    utils/pc_tools.py:131-542). Gated on pystac-client."""
    pystac_client, planetary_computer = _pystac()
    catalog = pystac_client.Client.open(
        stac_url, modifier=planetary_computer.sign_inplace
    )
    search = catalog.search(collections=[collection], bbox=bbox, datetime=datetime, query=query)
    return list(search.items())


def get_s2_stac(bbox, datetime, max_cloud: float = 10.0, **kwargs):
    """Sentinel-2 L2A items under a cloud-cover ceiling
    (utils/pc_tools.py:328-386)."""
    return search_stac(
        "sentinel-2-l2a", bbox, datetime,
        query={"eo:cloud_cover": {"lt": max_cloud}}, **kwargs,
    )


def get_s1_stac(bbox, datetime, orbit: str = "ascending", **kwargs):
    """Sentinel-1 RTC VV/VH IW items (utils/pc_tools.py:388-440)."""
    return search_stac(
        "sentinel-1-rtc", bbox, datetime,
        query={
            "sat:orbit_state": {"eq": orbit},
            "sar:instrument_mode": {"eq": "IW"},
        },
        **kwargs,
    )


def get_naip_stac(bbox, datetime=None, **kwargs):
    """NAIP items, newest acquisition year (utils/pc_tools.py:131-186)."""
    items = search_stac("naip", bbox, datetime, **kwargs)
    if not items:
        return items
    newest = max(i.datetime.year for i in items)
    return [i for i in items if i.datetime.year == newest]


def get_dem_stac(bbox, **kwargs):
    """3DEP seamless DEM (utils/pc_tools.py:188-222)."""
    return search_stac("3dep-seamless", bbox, **kwargs)


def get_hag_stac(bbox, **kwargs):
    """3DEP LiDAR height-above-ground (utils/pc_tools.py:224-262)."""
    return search_stac("3dep-lidar-hag", bbox, **kwargs)


def get_ssurgo_stac(bbox, **kwargs):
    """gNATSGO/SSURGO soils raster (utils/pc_tools.py:496-542)."""
    return search_stac("gnatsgo-rasters", bbox, **kwargs)


SSURGO_ATTRIBUTES = ("hydclprs", "drclassdcd", "flodfreqdcd", "wtdepannmin")


def join_ssurgo(mukey_raster: np.ndarray, attribute_table: dict) -> np.ndarray:
    """Join per-mukey tabular soil attributes onto the mukey raster
    (utils/pc_tools.py:544-562): (H, W) int mukeys + {attr: {mukey: val}}
    -> (H, W, len(SSURGO_ATTRIBUTES)) float stack; missing keys -> NaN."""
    mukey = np.asarray(mukey_raster)
    out = np.full(mukey.shape + (len(SSURGO_ATTRIBUTES),), np.nan, np.float32)
    for ai, attr in enumerate(SSURGO_ATTRIBUTES):
        table = attribute_table.get(attr, {})
        if not table:
            continue
        keys = np.asarray(list(table.keys()))
        vals = np.asarray([table[k] for k in keys], np.float32)
        order = np.argsort(keys)
        keys, vals = keys[order], vals[order]
        idx = np.searchsorted(keys, mukey)
        idx = np.clip(idx, 0, len(keys) - 1)
        hit = keys[idx] == mukey
        out[..., ai] = np.where(hit, vals[idx], np.nan)
    return out


def predict_scene(
    scene,
    predict_fn: Callable,
    kernel: int = 256,
    buffer: int = 128,
    batch_size: int = 16,
    mesh=None,
    device="cuda",
    **engine_kwargs,
) -> torch.Tensor:
    """Full-scene inference from an in-memory composite (an array, or a
    tensor already on ``device``) — the run_local replacement
    (utils/pc_tools.py:620-729): the port's device-resident tiled engine,
    optionally sharded over a mesh (``parallel.make_mesh``) instead of Dask
    workers: every rank of the mesh calls this on the same scene, forwards
    its share of each chip batch and blends the gathered predictions
    (``parallel.ShardedTiledInference``). Extra keyword arguments pass
    through to the engine (e.g. ``blend="hann"``, or ``tile_mode="whole"``
    without a mesh). Returns the (H, W, C_out) prediction on ``device``.
    """
    if mesh is not None:
        from satellite_computervision_tpu_torch.parallel import ShardedTiledInference

        if engine_kwargs.get("tile_mode") == "whole":
            raise ValueError(
                "tile_mode='whole' shards per-chip batches of 1 and cannot "
                "run under ShardedTiledInference; use "
                "parallel.spatial.make_spatial_inference(tile_mode='whole') "
                "for multi-device whole-band inference"
            )
        engine = ShardedTiledInference(
            predict_fn, mesh, kernel=kernel, buffer=buffer, batch_size=batch_size,
            device=device, **engine_kwargs,
        )
    else:
        engine = TiledInferenceEngine(
            predict_fn, kernel=kernel, buffer=buffer, batch_size=batch_size,
            device=device, **engine_kwargs,
        )
    return engine.predict_scene(scene)


def resign_vrt(
    filename: str,
    element_tag: str = "SourceFilename",
    signer: Optional[Callable[[str], str]] = None,
    suffix: str = "_resigned",
) -> str:
    """Refresh the SAS tokens inside a GDAL VRT's source URLs
    (utils/pc_tools.py:55-81). A VRT is plain XML, so no GDAL is needed:
    every ``element_tag`` element whose text is an http(s) URL is re-signed
    (token query string replaced via ``signer``, default
    planetary_computer.sign on the bare URL), nested ``.vrt`` sources are
    re-signed recursively (warped VRTs use the SourceDataset tag, as the
    reference does), and the rewritten tree is written alongside the input
    as ``<stem><suffix>.vrt``. Returns the written path.
    """
    import os
    import xml.etree.ElementTree as ET

    if signer is None:
        try:
            import planetary_computer
        except ImportError as e:
            raise ImportError(
                "no signer given and planetary-computer is not installed"
            ) from e
        signer = lambda url: planetary_computer.sign(url)

    tree = ET.parse(filename)
    root = tree.getroot()
    parent = os.path.dirname(os.path.abspath(filename))
    stem, _ = os.path.splitext(os.path.basename(filename))

    for item in root.iter(element_tag):
        text = item.text or ""
        if text.startswith("http"):
            item.text = signer(text.split("?")[0])
        elif text.endswith(".vrt"):
            sub = text if os.path.isabs(text) else os.path.join(parent, text)
            sub_tag = "SourceDataset" if "warped" in os.path.basename(sub) else element_tag
            item.text = resign_vrt(sub, sub_tag, signer=signer, suffix=suffix)

    out = os.path.join(parent, f"{stem}{suffix}.vrt")
    tree.write(out)
    return out
