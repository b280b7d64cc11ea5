"""Spatial sharding of full-scene inference with a halo exchange.

Port of ``satellite_computervision_tpu/parallel/spatial.py``. The scene is
split into horizontal row bands, one per rank of the mesh axis: each rank
moves only its band (and, at the top and bottom ranks, the edge strips)
to its device, sends its first and last rows to its neighbours and
receives theirs (``dist.batch_isend_irecv``; ``jax.lax.ppermute`` in
JAX), runs the overlap-tile grid on its haloed band, and the bands'
outputs are all-gathered, so ``run(scene)`` returns the whole
``(H, W, out_channels)`` prediction on every rank. Every rank calls
``run`` on the same scene.

- ``blend="overwrite"`` (``tile_mode="chips"`` or ``"whole"``): each band
  carries ``buffer/2`` halo rows per side and runs as a prepadded band of
  the engine (``inference/tiles.py``).
- ``blend="hann"``: each band carries one halo chip row per side
  (``kernel + buffer/2`` rows), so every core pixel sums its whole chip
  set. Chip rows outside the scene's grid (the edge strips', the bottom
  padding's) are zeroed, and the band's blend is one
  ``kernels/stitch.py::hann_stitch`` launch normalized by the WHOLE grid's
  row weights mapped onto the band's canvas rows (``row_weights``): per
  output pixel the single-device engine's chips, window, quadrant order
  and normalizer.
- ``preprocess_fn`` (row-local: pointwise per pixel) runs on each band on
  its device, ``output_transform`` on each band's output.
- ``max_rows``: taller scenes stream through in full-width bands, each
  band sharded across the mesh.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.inference.tiles import TiledInferenceEngine, _to_numpy
from satellite_computervision_tpu_torch.kernels.stitch import _axis_weight_sum, hann_stitch
from satellite_computervision_tpu_torch.parallel.mesh import axis_size


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s memory as uint8 (every backend sends bytes; not every one
    sends every dtype, e.g. uint16 scenes)."""
    return t.contiguous().view(torch.uint8)


def _rows(scene, start: int, stop: int, left: int, right: int, device) -> torch.Tensor:
    """Rows ``[start, stop)`` of the scene edge-padded by replication (row
    indices clipped into the scene), columns padded ``left``/``right`` the
    same way, on ``device``. Only the scene rows asked for are read (from
    a numpy array, a memory map, a lazy ``geo.GeoTiffScene`` or a tensor)
    and moved; the padding is gathered on the device, as bytes, so any
    dtype pads."""
    h, w = scene.shape[:2]
    idx = np.clip(np.arange(start, stop), 0, h - 1)
    lo, hi = int(idx[0]), int(idx[-1]) + 1
    block = scene[lo:hi]
    if not isinstance(block, torch.Tensor):
        block = torch.from_numpy(np.ascontiguousarray(block))
    block = block.to(device)
    rows = torch.from_numpy(idx - lo).to(device)
    cols = torch.from_numpy(np.clip(np.arange(-left, w + right), 0, w - 1)).to(device)
    out = _as_bytes(block).index_select(0, rows).index_select(1, cols)
    return out.view(block.dtype)


def _haloed_band(scene, rows: int, n: int, half: int, right: int, device, group, index,
                 size) -> torch.Tensor:
    """This rank's ``rows`` scene rows (rank ``i`` holds rows ``[i*rows,
    (i+1)*rows)``) with ``n`` halo rows above and below: the last ``n`` of
    rank ``index - 1`` and the first ``n`` of rank ``index + 1``, sent
    between the ranks, or the scene's edge rows replicated at the ends of
    the axis. Columns edge-padded by ``half`` on the left and ``right`` on
    the right."""
    lo, end = index * rows, size * rows
    local = _rows(scene, lo, lo + rows, half, right, device)
    if n == 0:
        return local
    prev = (_rows(scene, -n, 0, half, right, device) if index == 0
            else torch.empty_like(local[:n]))
    nxt = (_rows(scene, end, end + n, half, right, device) if index == size - 1
           else torch.empty_like(local[:n]))
    ops = []
    for peer, send, recv in ((index - 1, local[:n], prev), (index + 1, local[-n:], nxt)):
        if 0 <= peer < size:
            rank = dist.get_global_rank(group, peer)
            ops += [dist.P2POp(dist.isend, _as_bytes(send), rank, group),
                    dist.P2POp(dist.irecv, recv.view(torch.uint8), rank, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return torch.cat([prev, local, nxt])


def _gather_rows(out: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ranks' equal row bands, concatenated in rank order."""
    parts = [torch.empty_like(out) for _ in range(size)]
    dist.all_gather([p.view(torch.uint8) for p in parts], _as_bytes(out), group=group)
    return torch.cat(parts)


def make_spatial_inference(
    predict_fn: Callable,
    mesh,
    axis: str = "data",
    kernel: int = 256,
    buffer: int = 128,
    out_channels: int = 1,
    batch_size: int = 16,
    tile_mode: str = "chips",
    whole_multiple: Optional[int] = 32,
    blend: str = "overwrite",
    preprocess_fn: Optional[Callable] = None,
    output_transform: Optional[Callable] = None,
    max_rows: Optional[int] = None,
    device="cuda",
):
    """Build ``run(scene) -> prediction`` with rows sharded over ``axis``.

    ``predict_fn``: (B, side, side, C_in) -> (B, side, side, C_out) on
    ``device`` (default ``"cuda"``; raises without it unless ``"cpu"`` is
    given). ``run`` takes any (H, W, C) scene and returns (H, W,
    out_channels) on ``device``.

    ``tile_mode="whole"``: each rank runs ONE fully convolutional forward
    over its haloed band instead of the chip grid (``whole_multiple`` must
    divide the band's dims). ``blend="hann"``: see the module docstring.
    """
    if tile_mode not in ("chips", "whole"):
        raise ValueError(f"unknown tile_mode {tile_mode!r}")
    if blend not in ("overwrite", "hann"):
        raise ValueError(f"unknown blend mode {blend!r}")
    if blend == "hann" and tile_mode == "whole":
        raise ValueError("whole mode has no tiles to blend; use blend='overwrite'")
    if blend == "hann" and buffer > kernel:
        raise ValueError("hann blending requires buffer <= kernel")
    dev = resolve_device(device)
    group, size, index = mesh.get_group(axis), axis_size(mesh, axis), mesh.get_local_rank(axis)
    # the band's grid, preprocess and output transform run through the
    # engine's own prepadded-band path
    engine = TiledInferenceEngine(
        predict_fn, kernel=kernel, buffer=buffer, batch_size=batch_size,
        out_channels=out_channels, tile_mode=tile_mode,
        whole_multiple=whole_multiple or 1, preprocess_fn=preprocess_fn,
        output_transform=output_transform, device=dev)
    run_core = (_hann_core(engine, group, size, index) if blend == "hann"
                else _overwrite_core(engine, group, size, index))
    if max_rows is None:
        return run_core
    # overwrite: one halo chip row per interior side, so band-edge chips
    # read real neighbour rows; hann: two, the inner one completing every
    # kept pixel's chip set, the outer one (its own context edge-replicated)
    # reaching no kept row since buffer <= kernel
    return _banded(run_core, kernel, buffer, out_channels, max_rows, dev,
                   halo_rows=2 if blend == "hann" else 1)


def _overwrite_core(engine, group, size, index):
    kernel, buffer = engine.kernel, engine.buffer
    half = buffer // 2

    def run(scene):
        h, w = scene.shape[:2]
        band_rows = -(-h // (size * kernel)) * kernel  # rows per rank, on the grid
        right = -(-w // kernel) * kernel + half - w
        with torch.inference_mode():
            band = _haloed_band(scene, band_rows, half, half, right, engine.device, group,
                                index, size)
            out = engine._run(band, prepadded=True)
            return _gather_rows(out, group, size)[:h, :w]

    return run


def band_row_weights(rows_total: int, rpd: int, index: int, kernel: int,
                     side: int) -> np.ndarray:
    """The whole grid's row sums of windows on the canvas rows of rank
    ``index``'s hann band (``rpd`` core chip rows and one halo row per
    side): canvas row y is global canvas row y + (index*rpd - 1) * kernel;
    rows off the global canvas (cropped away later) get 1."""
    wy = _axis_weight_sum(rows_total, kernel, side)
    y = np.arange((rpd + 3) * kernel) + (index * rpd - 1) * kernel
    inside = (y >= 0) & (y < len(wy))
    return np.where(inside, wy[np.clip(y, 0, len(wy) - 1)], 1.0).astype(np.float32)


def _hann_core(engine, group, size, index):
    kernel, buffer = engine.kernel, engine.buffer
    side = kernel + buffer
    half = buffer // 2
    halo_px = kernel + half  # one halo chip row and its buffer context

    def run(scene):
        h, w = scene.shape[:2]
        rows_total = -(-h // kernel)  # the engine's chip rows
        rpd = -(-rows_total // size)  # chip rows per rank
        if rpd * kernel < halo_px:
            raise ValueError(
                f"scene of {rows_total} chip rows over {size} devices gives "
                f"{rpd * kernel} rows/device < halo {halo_px}; use fewer "
                "devices or taller scenes"
            )
        cols = -(-w // kernel)
        right = cols * kernel + half - w
        rows_ext = rpd + 2  # core chip rows and one halo row per side
        n_chips = rows_ext * cols
        row_weights = band_row_weights(rows_total, rpd, index, kernel, side)
        # chip rows outside the scene's grid contribute nothing
        g_rows = index * rpd + np.arange(rows_ext) - 1
        row_ok = ((g_rows >= 0) & (g_rows < rows_total)).astype(np.float32)
        with torch.inference_mode():
            dev = engine.device
            band = engine._input(_haloed_band(scene, rpd * kernel, halo_px, half, right, dev,
                                              group, index, size), prepadded=True)
            corners = [(0, r * kernel, c * kernel) for r in range(rows_ext) for c in range(cols)]
            preds = engine._forward([band], corners)[:n_chips]
            mask = torch.from_numpy(np.repeat(row_ok, cols)).to(dev)[:, None, None, None]
            canvas = hann_stitch(preds * mask, kernel, rows_ext, cols, apply_window=True,
                                 row_weights=torch.from_numpy(row_weights).to(dev))
            # core chip rows start at chip row 1: canvas row kernel + half
            out = canvas[kernel + half : kernel + half + rpd * kernel,
                         half : half + cols * kernel]
            out = engine._finish(out.contiguous())
            return _gather_rows(out, group, size)[:h, :w]

    return run


def _banded(run_core, kernel, buffer, c_out, max_rows, device, halo_rows):
    """Stream a tall scene through ``run_core`` in full-width bands cut on
    the chip grid, ``halo_rows`` extra chip rows per interior side; each
    band runs as a standalone sharded scene and only its core rows are
    kept (the argument of the engine's banded path)."""

    def run(scene):
        h, w = scene.shape[:2]
        if h <= max_rows:
            return run_core(scene)
        band_rows = (max_rows - buffer) // kernel
        if band_rows <= 2 * halo_rows:
            raise ValueError("max_rows too small for kernel+buffer+halo")
        rows_total = -(-h // kernel)
        step = band_rows - 2 * halo_rows
        out = None
        r0 = 0
        while r0 < rows_total:
            rb = min(step, rows_total - r0)
            e_top = min(halo_rows, r0)
            e_bot = min(halo_rows, rows_total - r0 - rb)
            y_lo = (r0 - e_top) * kernel
            y_hi = min(h, (r0 + rb + e_bot) * kernel)
            piece = _to_numpy(run_core(scene[y_lo:y_hi]))
            if out is None:
                out = np.zeros((h, w, c_out), piece.dtype)
            y = r0 * kernel
            hi = min(y + rb * kernel, h)
            out[y:hi] = piece[e_top * kernel : e_top * kernel + hi - y]
            r0 += rb
        return torch.from_numpy(out).to(device)

    return run
