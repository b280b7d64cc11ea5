"""Batched, device-resident overlap-tile inference.

Port of ``satellite_computervision_tpu/inference/tiles.py``
``TiledInferenceEngine``:

- chips of side ``kernel + buffer`` on a stride-``kernel`` grid, only the
  central ``kernel`` window kept (the reference's geometry);
- the scene goes to the device once; chips are gathered there and run
  through the model ``batch_size`` at a time;
- ``blend="overwrite"``/``"sum"``: central crops tile disjointly, so the
  stitch is a reshape/permute;
- ``blend="hann"``: the raw chip predictions go to
  ``kernels.stitch.hann_stitch(..., apply_window=True)``, which weights and
  blends them in one pass — the hand-written CUDA kernel on the card, its
  plain PyTorch version on the CPU. Requires ``buffer <= kernel``;
- ``tile_mode="whole"``: one fully convolutional forward over the
  edge-padded scene, no chips;
- ``max_rows``: scenes taller than this stream through in full-width
  bands cut on the whole-scene chip grid (``sink`` receives the output
  rows as each band completes, so a file-backed scene serves disk to disk
  in O(band) memory);
- ``nodata``: chips whose whole window is nodata are culled before the
  forward, exact on valid pixels (per band on the banded path);
- ``predict_scene_batch`` (one chip batch across a stack of scenes) and
  ``predict_scenes`` (scenes staged on a thread while the previous one
  computes, optionally read back on a third).

Each stage is a span (``utils.profiling.span``, recorded only while a
``torch.profiler`` session runs): ``serve.scene`` around one scene, with
``serve.input``, ``serve.forward`` (one per chip batch: ``chips`` real,
``padded`` repeated, ``kernels`` the hand-written kernels it launched,
``kernels.launches``, and ``pooled`` those of them that pooled an encoder's
output, ``epilogue.bias_relu_pool_``) and ``serve.stitch`` inside it; ``predict_scenes`` adds
``serve.host_scene`` on the staging thread, ``serve.readback`` and
``serve.result_ahead`` on the dispatch thread and ``serve.result_wait``
on the caller's, each with the scene's sequence number ``scene``.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, Optional

import numpy as np
import torch

from satellite_computervision_tpu_torch import kernels
from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.geo.geotiff import (
    GeoTiffCogStreamWriter,
    GeoTiffStreamWriter,
    coerce_sample_dtype,
)
from satellite_computervision_tpu_torch.kernels import epilogue
from satellite_computervision_tpu_torch.kernels.stitch import hann_stitch
from satellite_computervision_tpu_torch.staging import run_ahead, stage_to_device
from satellite_computervision_tpu_torch.utils.profiling import span


def _edge_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int):
    """Edge-replicate pad of an (H, W, C) tensor."""
    h, w = x.shape[:2]
    ys = torch.arange(-top, h + bottom, device=x.device).clamp_(0, h - 1)
    xs = torch.arange(-left, w + right, device=x.device).clamp_(0, w - 1)
    return x.index_select(0, ys).index_select(1, xs)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16
        t = t.float()
    return t.cpu().numpy()


def _host_array(scene) -> np.ndarray:
    """A scene as a host numpy array (a lazy file-backed scene decodes)."""
    if isinstance(scene, torch.Tensor):
        return _to_numpy(scene)
    return np.asarray(scene)


class TiledInferenceEngine:
    """Runs a chip-level ``predict_fn`` over arbitrarily sized scenes.

    ``predict_fn(chips) -> preds``: (B, side, side, C_in) float32 tensor on
    the engine's device -> (B, side, side, C_out), typically
    ``lambda x: model(x)["probs"]``.

    index_mode:
    - ``"grid"`` (default): the scene is edge-padded by buffer/2 so the
      stride-kernel grid covers every pixel (output shape == scene shape).
    - ``"reference"``: the reference's grid (utils/prediction_tools.py
      :87-109) — no padding, margins stay zero.
    blend: ``"overwrite"``/``"sum"`` (disjoint central windows) or
    ``"hann"`` (feathered overlap through ``hann_stitch``).
    tile_mode: ``"chips"`` (the overlap-tile grid) or ``"whole"`` (one
    forward over the whole padded scene; ``whole_multiple`` must cover the
    model's total downsampling, 64 for the space-to-depth U-Net).
    ``max_rows``: stream taller scenes in full-width bands.
    ``nodata``: cull chips whose full window holds no valid pixel (a pixel
    is invalid when every channel equals ``nodata``, or is NaN for a NaN
    ``nodata``); chips mode only. The validity test runs on the host.
    ``preprocess_fn`` runs on the device scene before chipping (it may add
    bands but must keep H, W); ``output_transform`` on the stitched result.
    ``device`` defaults to ``"cuda"`` and raises when CUDA is absent.
    """

    def __init__(
        self,
        predict_fn: Callable,
        kernel: int = 256,
        buffer: int = 128,
        batch_size: int = 16,
        out_channels: int = 1,
        blend: str = "overwrite",
        index_mode: str = "grid",
        max_rows: Optional[int] = None,
        preprocess_fn: Optional[Callable] = None,
        output_transform: Optional[Callable] = None,
        tile_mode: str = "chips",
        whole_multiple: int = 32,
        nodata: Optional[float] = None,
        device="cuda",
    ):
        if blend not in ("overwrite", "sum", "hann"):
            raise ValueError(f"unknown blend mode {blend!r}")
        if index_mode not in ("grid", "reference"):
            raise ValueError(f"unknown index mode {index_mode!r}")
        if blend == "hann" and buffer > kernel:
            raise ValueError("hann blending requires buffer <= kernel")
        if buffer % 2:
            raise ValueError("buffer must be even (halo is buffer/2 per side)")
        if kernel <= 0 or batch_size <= 0:
            raise ValueError("kernel and batch_size must be positive")
        if tile_mode not in ("chips", "whole"):
            raise ValueError(f"unknown tile_mode {tile_mode!r}")
        self.device = resolve_device(device)
        self.predict_fn = predict_fn
        self.kernel = kernel
        self.buffer = buffer
        self.batch_size = batch_size
        self.out_channels = out_channels
        self.blend = blend
        self.index_mode = index_mode
        self.max_rows = max_rows
        self.preprocess_fn = preprocess_fn
        self.output_transform = output_transform
        self.tile_mode = tile_mode
        self.whole_multiple = whole_multiple
        self.nodata = nodata

    @classmethod
    def from_model(cls, model: torch.nn.Module, output_key: str = "probs",
                   fold_bn: bool = True, geometry=None, tune_table=None, **kwargs):
        """Build an engine over a model's forward, moved to the engine's
        device and put in eval mode.

        For a ``models.UNet`` with live BatchNorm, ``fold_bn=True``
        (default) serves the BN-folded model (models/fold.py).

        ``geometry`` picks the serving chip geometry:
        - ``None`` (default): the explicit ``kernel``/``buffer`` kwargs;
        - ``(kernel, buffer)``: set both directly;
        - ``"tuned"``: the best row of the tune table at ``tune_table`` (an
          ``inference.tune.save_tune_table`` file), its chip grid or
          whole-scene mode, when every row was measured on the engine's
          device; otherwise (another device's table, a JAX table, whose
          rows name none, or no file) the explicit kwargs, so "tuned" is
          safe to request unconditionally."""
        from satellite_computervision_tpu_torch.models import UNet, fold_unet

        device = resolve_device(kwargs.get("device", "cuda"))
        if geometry == "tuned":
            if tune_table is not None and os.path.exists(tune_table):
                from satellite_computervision_tpu_torch.inference.tune import (
                    device_name,
                    load_tune_table,
                )

                rows = load_tune_table(tune_table)
                if rows and all(r.device == device_name(device) for r in rows):
                    if rows[0].tile_mode == "whole":
                        kwargs["tile_mode"] = "whole"
                    else:
                        kwargs["kernel"], kwargs["buffer"] = rows[0].kernel, rows[0].buffer
        elif geometry is not None:
            kwargs["kernel"], kwargs["buffer"] = geometry
        if fold_bn and isinstance(model, UNet) and not model.fold_bn:
            model = fold_unet(model)
        model = model.to(device).eval()
        return cls(lambda chips: model(chips)[output_key], **kwargs)

    # ------------------------------------------------------------------
    def _grid_geometry(self, h, w, prepadded=False):
        """(rows, cols, pad_bottom, pad_right) of the chip grid for an
        (h, w) scene under the engine's index_mode; ``prepadded``: a band
        that already carries its context (rows*kernel + buffer tall)."""
        kernel, buffer = self.kernel, self.buffer
        side = kernel + buffer
        half = buffer // 2
        if prepadded:
            return (h - buffer) // kernel, (w - buffer) // kernel, 0, 0
        if self.index_mode == "grid":
            # central windows at [r*kernel, r*kernel + kernel) cover [0, h);
            # chips read [r*kernel - half, ... + side) -> pad half on
            # top/left and (rows*kernel + half - h) on bottom/right.
            rows = -(-h // kernel)
            cols = -(-w // kernel)
            return rows, cols, rows * kernel + half - h, cols * kernel + half - w
        rows = len(range(half, h - side, kernel))
        cols = len(range(half, w - side, kernel))
        return rows, cols, 0, 0

    def _to_device(self, scene) -> torch.Tensor:
        if isinstance(scene, torch.Tensor):
            return scene.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(scene)).to(self.device)

    def _input(self, scene, prepadded=False) -> torch.Tensor:
        """The scene on the device, preprocessed, float32 and edge-padded as
        its mode needs (edge replication, so convs near scene borders see
        plausible context): whole mode to a multiple of ``whole_multiple``
        plus buffer/2 per side, grid mode by the chip grid's margins;
        reference mode and prepadded bands as they are."""
        h, w = scene.shape[:2]
        x = self._to_device(scene)
        if self.preprocess_fn is not None:
            x = self.preprocess_fn(x)
            if tuple(x.shape[:2]) != (h, w):
                raise ValueError("preprocess_fn must preserve spatial dims")
        x = x.float()
        half = self.buffer // 2
        if prepadded:
            return x
        if self.tile_mode == "whole":
            mult = self.whole_multiple
            return _edge_pad(x, half, half + (-(h + self.buffer)) % mult,
                             half, half + (-(w + self.buffer)) % mult)
        if self.index_mode == "grid":
            _, _, pad_bottom, pad_right = self._grid_geometry(h, w)
            return _edge_pad(x, half, pad_bottom, half, pad_right)
        return x

    def _finish(self, out: torch.Tensor) -> torch.Tensor:
        return out if self.output_transform is None else self.output_transform(out)

    def _zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _forward(self, padded, corners) -> torch.Tensor:
        """Predictions (float32) of the chips at ``corners`` ((scene index,
        y, x) into the list ``padded``), in groups of ``batch_size``; the
        last group is padded by repeating its final chip, as the JAX engine
        does, and its predictions are returned too."""
        side, bsz = self.kernel + self.buffer, self.batch_size
        corners = list(corners)
        n = len(corners)
        corners += corners[-1:] * ((-n) % bsz)
        preds = []
        for g in range(0, len(corners), bsz):
            real = min(bsz, max(n - g, 0))
            with span("serve.forward", chips=real, padded=bsz - real) as s:
                launched, pooled = kernels.launches(), epilogue.bias_relu_pool_.launches
                chips = torch.stack(
                    [padded[i][y : y + side, x : x + side] for i, y, x in corners[g : g + bsz]]
                )
                preds.append(self.predict_fn(chips).float())
                s.set(kernels=kernels.launches() - launched,
                      pooled=epilogue.bias_relu_pool_.launches - pooled)
        return torch.cat(preds)

    def _stitch(self, preds, h, w, rows, cols, prepadded=False):
        """(rows*cols, side, side, C) predictions -> the scene's (h, w, C)
        output, or for a prepadded band its (rows*k, cols*k, C) grid."""
        k, half, c_out = self.kernel, self.buffer // 2, self.out_channels
        if self.blend in ("overwrite", "sum"):
            crops = preds[:, half : half + k, half : half + k, :]
            region = (
                crops.reshape(rows, cols, k, k, c_out)
                .permute(0, 2, 1, 3, 4)
                .reshape(rows * k, cols * k, c_out)
            )
            if prepadded:
                return region
            if self.index_mode == "grid":
                return region[:h, :w]
        else:
            blended = hann_stitch(preds, k, rows, cols, apply_window=True)
            if prepadded:
                return blended[half : half + rows * k, half : half + cols * k]
            if self.index_mode == "grid":
                # canvas origin == padded-scene origin, (half, half) before
                # original pixel (0, 0)
                return blended[half : half + h, half : half + w]
            region = blended[half : half + rows * k, half : half + cols * k]
        out = self._zeros((h, w, c_out))
        out[half : half + rows * k, half : half + cols * k] = region
        return out

    def _run_whole(self, scene, prepadded=False) -> torch.Tensor:
        """One forward over the whole (edge-padded) scene, or over a
        prepadded band whose central grid it returns."""
        h, w = scene.shape[:2]
        if prepadded:
            # the band already carries real buffer/2 context on every side
            mult = self.whole_multiple
            if h % mult or w % mult:
                raise ValueError(
                    f"whole-mode bands of {h}x{w} are not multiples of "
                    f"whole_multiple={mult}; pick kernel/buffer/max_rows that are")
            rows, cols, _, _ = self._grid_geometry(h, w, prepadded=True)
            h, w = rows * self.kernel, cols * self.kernel
        half = self.buffer // 2
        with span("serve.input"):
            x = self._input(scene, prepadded)
        with span("serve.forward", chips=1, padded=0) as s:
            launched, pooled = kernels.launches(), epilogue.bias_relu_pool_.launches
            pred = self.predict_fn(x[None])[0].float()
            s.set(kernels=kernels.launches() - launched,
                  pooled=epilogue.bias_relu_pool_.launches - pooled)
        return self._finish(pred[half : half + h, half : half + w])

    def _run(self, scene, prepadded=False, cull=False, valid_chips=None) -> torch.Tensor:
        """One scene (or prepadded band) through the chip grid: culled when
        ``cull`` (``valid_chips`` or :meth:`chip_validity`), the full grid
        otherwise or when every chip is valid."""
        if self.tile_mode == "whole":
            return self._run_whole(scene, prepadded)
        k, side, c_out = self.kernel, self.kernel + self.buffer, self.out_channels
        h, w = scene.shape[:2]
        rows, cols, _, _ = self._grid_geometry(h, w, prepadded)
        n = rows * cols
        if n == 0:
            return self._zeros((h, w, c_out))
        corners = [(0, r * k, c * k) for r in range(rows) for c in range(cols)]
        kept = None
        if cull:
            valid = (self.chip_validity(scene, prepadded) if valid_chips is None
                     else np.asarray(valid_chips))
            kept = np.flatnonzero(valid)
            if len(kept) == n:
                kept = None  # fully valid: the full grid, no scatter
            elif len(kept) == 0:
                # no forward and no stitch: zeros in the output dtype
                shape = (rows * k, cols * k, c_out) if prepadded else (h, w, c_out)
                return self._finish(self._zeros(shape))
        with span("serve.input"):
            x = self._input(scene, prepadded)
        if kept is None:
            preds = self._forward([x], corners)[:n]
        else:
            # kept chips only; their predictions scatter onto the full grid
            # (dropped chips stay zero: no contribution in either blend),
            # the padding of the last group to the throwaway slot n
            kept_preds = self._forward([x], [corners[i] for i in kept])
            slots = np.full(len(kept_preds), n, np.int64)
            slots[: len(kept)] = kept
            full = torch.zeros((n + 1, side, side, c_out), dtype=torch.float32,
                               device=self.device)
            full.index_copy_(0, torch.from_numpy(slots).to(self.device), kept_preds)
            preds = full[:n]
        with span("serve.stitch"):
            out = self._stitch(preds, h, w, rows, cols, prepadded)
        return self._finish(out)

    # ------------------------------------------------------------------
    def chip_validity(self, scene, prepadded: bool = False) -> np.ndarray:
        """Boolean (rows*cols,) mask in grid order: True where the chip's
        full (side x side) window holds at least one valid pixel. A pixel
        is invalid when EVERY channel equals ``self.nodata`` (or is NaN,
        for a NaN nodata). Host-side (NumPy, O(H*W)), equal to the JAX
        engine's integral-image test; pass
        the result to ``predict_scene(valid_chips=...)`` to avoid a
        device-to-host copy when the scene is already on the device."""
        scene = _host_array(scene)
        h, w, c = scene.shape
        rows, cols, _, _ = self._grid_geometry(h, w, prepadded)
        side = self.kernel + self.buffer
        half = self.buffer // 2
        # valid pixels, one channel at a time over blocks of rows that stay
        # in cache (a reduction over the short channel axis is ~4x slower)
        valid2d = np.empty((h, w), bool)
        for y in range(0, h, 32):
            blk, out = scene[y : y + 32], valid2d[y : y + 32]
            for ch in range(c):
                v = ~np.isnan(blk[..., ch]) if np.isnan(self.nodata) else blk[..., ch] != self.nodata
                if ch:
                    out |= v
                else:
                    out[...] = v
        # chip windows in scene coords: grid mode gathers from a scene
        # edge-padded by half (corner - half); reference mode and
        # prepadded bands gather as-is (corner). Edge replication copies
        # in-range pixels, so clipping to the scene preserves the
        # any-valid answer exactly.
        off = 0 if (prepadded or self.index_mode == "reference") else -half
        ys = np.arange(rows) * self.kernel + off
        xs = np.arange(cols) * self.kernel + off
        y0, y1 = np.clip(ys, 0, h), np.clip(ys + side, 0, h)
        x0, x1 = np.clip(xs, 0, w), np.clip(xs + side, 0, w)
        mask = np.zeros((rows, cols), bool)
        for r in range(rows):
            # columns with a valid pixel in the chip row's window, then one
            # prefix sum over them for every chip window along the row
            counts = np.concatenate([[0], np.cumsum(valid2d[y0[r] : y1[r]].any(0))])
            mask[r] = counts[x1] > counts[x0]
        return mask.ravel()

    def predict_scene(self, scene, valid_chips=None) -> torch.Tensor:
        """(H, W, C_in) scene (numpy array, memory map, tensor or lazy
        ``geo.GeoTiffScene``) -> (H, W, out_channels) stitched prediction on
        the engine's device. A scene with no chip on the grid gives zeros.

        Taller than ``max_rows``: banded. With ``nodata`` set (chips mode)
        chips whose full window is nodata are culled before the forward;
        ``valid_chips`` optionally supplies a precomputed
        :meth:`chip_validity` mask."""
        return self._scene(scene, valid_chips, {})

    def _scene(self, scene, valid_chips, ids: dict) -> torch.Tensor:
        """:meth:`predict_scene` in a ``serve.scene`` span carrying ``ids``."""
        with span("serve.scene", **ids):
            h = scene.shape[0]
            if self.max_rows is not None and h > self.max_rows:
                return self._predict_banded(scene)
            if getattr(scene, "lazy", False):
                # a file-backed scene without banding: nothing bounds memory
                # anyway, so decode it
                scene = np.asarray(scene)
            with torch.inference_mode():
                return self._run(scene, cull=self.nodata is not None, valid_chips=valid_chips)

    def predict_scene_to_geotiff(self, scene, path, transform=None,
                                 crs: str = "", nodata_tag=None,
                                 compress=True,
                                 cog: bool = False,
                                 bigtiff=None,
                                 predictor: int = 1) -> str:
        """Predict a scene and stream the result into a GeoTIFF at ``path``.

        On the banded path (``max_rows`` set, scene taller) output rows
        are written as each band completes, so with a file-backed input
        (geo.GeoTiffScene) host memory stays O(band) end to end. Shorter
        scenes take one :meth:`predict_scene` pass, then one write.

        ``nodata_tag`` only stamps GDAL_NODATA on the output file (the
        engine's own ``nodata`` controls chip culling). ``cog=True``
        writes tiles with mean-pooled overview pyramids
        (geo.GeoTiffCogStreamWriter), still O(band) memory. ``bigtiff``
        None = auto. An output dtype TIFF cannot hold (float16, bfloat16)
        is written as float32. On any error the writer aborts, leaving a
        file with no IFD (not a readable TIFF). Returns ``path``."""
        h, w = scene.shape[:2]
        writer = None
        cast = None

        def sink(block):
            nonlocal writer, cast
            if writer is None:
                target = coerce_sample_dtype(block.dtype)
                cast = target if target != block.dtype else None
                cls = GeoTiffCogStreamWriter if cog else GeoTiffStreamWriter
                writer = cls(path, h, w, self.out_channels, target,
                             transform=transform, crs=crs, nodata=nodata_tag,
                             compress=compress, bigtiff=bigtiff, predictor=predictor)
            writer.write_rows(block.astype(cast) if cast else block)

        try:
            if self.max_rows is not None and h > self.max_rows:
                self._predict_banded(scene, sink=sink)
            else:
                sink(_to_numpy(self.predict_scene(scene)))
            writer.close()
        except BaseException:
            if writer is not None:
                writer.abort()
            raise
        return path

    def predict_scene_batch(self, scenes) -> torch.Tensor:
        """(S, H, W, C) scene stack -> (S, H, W, out_channels) on the
        engine's device: the S scenes' chips feed the model as one chip
        batch (groups of ``batch_size`` may span scenes), then one stitch
        per scene; whole mode runs one forward over the S padded scenes.
        No culling, no banding. Memory scales with S; use
        :meth:`predict_scenes` to stream instead."""
        s, h, w = scenes.shape[:3]
        k, half = self.kernel, self.buffer // 2
        with torch.inference_mode():
            stack = self._to_device(scenes)
            if self.tile_mode == "whole":
                preds = self.predict_fn(torch.stack([self._input(sc) for sc in stack])).float()
                return self._finish(preds[:, half : half + h, half : half + w])
            rows, cols, _, _ = self._grid_geometry(h, w)
            n = rows * cols
            if n == 0:
                return self._zeros((s, h, w, self.out_channels))
            padded = [self._input(sc) for sc in stack]
            corners = [(i, r * k, c * k) for i in range(s)
                       for r in range(rows) for c in range(cols)]
            preds = self._forward(padded, corners)
            return self._finish(torch.stack(
                [self._stitch(preds[i * n : (i + 1) * n], h, w, rows, cols)
                 for i in range(s)]))

    def predict_scenes(self, scenes, prefetch: int = 2, readback: bool = False):
        """Pipelined multi-scene inference (the multi-state sweep): a
        staging thread decodes scene N+1, computes its chip validity (with
        ``nodata`` set) and stages it on the device (pinned ring, side
        stream) while scene N computes.

        With ``readback=True`` a third stage copies each prediction into
        pinned host memory while the dispatch thread already launches the
        next scene, and ``np.ndarray`` results are yielded; otherwise device
        tensors. Results come back in order; an error on any stage
        re-raises in the consumer; abandoning the stream stops and joins
        every thread."""
        cull = self.nodata is not None and self.tile_mode == "chips"

        def host_scenes():
            for n, s in enumerate(scenes):
                if isinstance(s, torch.Tensor) and not cull:
                    yield s, None
                    continue
                with span("serve.host_scene", scene=n):
                    s = _host_array(s)
                    valid = self.chip_validity(s) if cull else None
                yield s, valid

        def compute():
            staged = stage_to_device(host_scenes(), prefetch, self.device)
            try:
                for n, (scene, valid) in enumerate(staged):
                    yield self._scene(scene, valid, {"scene": n})
            finally:
                staged.close()

        if not readback:
            yield from compute()
            return

        def read_back():
            # the device-to-host copy goes into pinned memory without
            # waiting; the consumer waits on its event
            for n, pred in enumerate(compute()):
                with span("serve.readback", scene=n, bytes=pred.nbytes):
                    host, event = pred, None
                    if pred.device.type == "cuda":
                        host = torch.empty(pred.shape, dtype=pred.dtype, pin_memory=True)
                        host.copy_(pred, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record()
                yield host, event

        results = run_ahead(read_back(), prefetch, self.device, ahead="serve.result_ahead")
        try:
            for n in itertools.count():
                with span("serve.result_wait", scene=n):
                    got = next(results, None)
                    if got is None:
                        return
                    host, event = got
                    if event is not None:
                        event.synchronize()
                    out = _to_numpy(host)
                yield out
        finally:
            results.close()

    # ------------------------------------------------------------------
    def _predict_banded(self, scene, sink=None):
        """Stream a tall scene in full-width bands, bounding device memory.

        Bands are cut on the whole-scene chip grid and carry real scene
        rows as halo (edge padding only at true scene borders), so interior
        chips see the same context as in a whole-scene pass: ``overwrite``
        is bit-identical. With ``blend="hann"`` each band also includes one
        halo chip row per interior side so every output pixel sums its
        full chip set — equal to the whole-scene result up to
        floating-point summation order. A staging thread slices, pads,
        validity-tests and stages band N+1 while band N computes.

        With ``sink`` (a callable receiving consecutive full-width
        ``(rows, W, out_channels)`` numpy blocks in row order, covering the
        scene exactly) nothing is accumulated and the return is ``None``;
        otherwise the (H, W, out_channels) result on the engine's
        device."""
        h, w = scene.shape[:2]
        kernel, buffer = self.kernel, self.buffer
        half = buffer // 2
        side = kernel + buffer
        band_rows = (self.max_rows - buffer) // kernel
        if band_rows <= 0:
            raise ValueError("max_rows too small for kernel+buffer")
        whole = self.tile_mode == "whole"
        halo = 1 if (self.blend == "hann" and not whole) else 0
        step = max(1, band_rows - 2 * halo)
        if isinstance(scene, torch.Tensor):
            scene = _host_array(scene)
        elif not getattr(scene, "lazy", False):
            scene = np.asarray(scene)
        # else: a file-backed scene (geo.GeoTiffScene) — the band jobs slice
        # it directly, so only O(band) rows are ever decoded

        # (band_of() -> host band, y, hi, extract(piece) -> sink block,
        # place(out, piece))
        jobs = []
        # whole mode predicts every pixel regardless of index_mode, so its
        # bands always use the full-cover grid geometry
        if self.index_mode == "grid" or whole:
            rows_total = -(-h // kernel)
            cols = -(-w // kernel)
            pad_right = cols * kernel + half - w
            r0 = 0
            while r0 < rows_total:
                rb = min(step, rows_total - r0)
                e_top = min(halo, r0)
                e_bot = min(halo, rows_total - r0 - rb)
                ry = (r0 - e_top) * kernel
                n_rows = rb + e_top + e_bot
                src_lo = max(0, ry - half)
                src_hi = min(h, ry + n_rows * kernel + half)
                top = half - (ry - src_lo)
                bottom = (ry + n_rows * kernel + half) - src_hi

                def band_of(src_lo=src_lo, src_hi=src_hi, top=top, bottom=bottom):
                    return np.pad(scene[src_lo:src_hi],
                                  ((top, bottom), (half, pad_right), (0, 0)), mode="edge")

                y = r0 * kernel
                hi = min(y + rb * kernel, h)

                def extract(piece, y=y, hi=hi, e_top=e_top):
                    return piece[e_top * kernel : e_top * kernel + hi - y, :w]

                def place(out, piece, y=y, hi=hi, extract=extract):
                    out[y:hi] = extract(piece)

                jobs.append((band_of, y, hi, extract, place))
                r0 += rb
        else:
            # reference grid: chip (r, c) reads scene[r*k : r*k+side, ...];
            # outputs land at offset (half, half), margins stay zero.
            rows_total = len(range(half, h - side, kernel))
            cols_total = len(range(half, w - side, kernel))
            if rows_total > 0 and cols_total > 0:
                w_used = cols_total * kernel + buffer
                r0 = 0
                while r0 < rows_total:
                    rb = min(step, rows_total - r0)
                    e_top = min(halo, r0)
                    e_bot = min(halo, rows_total - r0 - rb)
                    ry = (r0 - e_top) * kernel
                    n_rows = rb + e_top + e_bot

                    def band_of(ry=ry, n_rows=n_rows):
                        return np.asarray(scene[ry : ry + n_rows * kernel + buffer, :w_used])

                    y = r0 * kernel + half

                    def extract(piece, rb=rb, e_top=e_top, cols_total=cols_total):
                        # sink blocks are full-width; margins stay zero in
                        # the piece dtype (e.g. a uint8 output_transform's)
                        block = np.zeros((rb * kernel, w, self.out_channels), piece.dtype)
                        block[:, half : half + cols_total * kernel] = piece[
                            e_top * kernel : (e_top + rb) * kernel]
                        return block

                    def place(out, piece, y=y, rb=rb, e_top=e_top, cols_total=cols_total):
                        out[y : y + rb * kernel, half : half + cols_total * kernel] = piece[
                            e_top * kernel : (e_top + rb) * kernel]

                    jobs.append((band_of, y, y + rb * kernel, extract, place))
                    r0 += rb

        out = None
        next_row = 0  # sink mode: rows emitted so far
        block_dtype = np.float32

        def emit(y, hi, block):
            nonlocal next_row, block_dtype
            block_dtype = block.dtype
            if y > next_row:  # reference-mode top margin
                sink(np.zeros((y - next_row, w, self.out_channels), block.dtype))
            sink(block)
            next_row = hi

        if jobs:
            # nodata culling applies per band: validity is computed on the
            # host band on the staging thread, before it ships
            cull = self.nodata is not None and not whole

            def host_bands():
                for band_of, _, _, _, _ in jobs:
                    band = band_of()
                    yield band, (self.chip_validity(band, prepadded=True) if cull else None)

            # one band staged ahead: peak residency 2 band inputs (max_rows
            # exists to bound device memory)
            staged = stage_to_device(host_bands(), 1, self.device, key="band")
            try:
                for (band, valid), (_, y, hi, extract, place) in zip(staged, jobs):
                    with torch.inference_mode():
                        piece = _to_numpy(self._run(band, prepadded=True, cull=cull,
                                                    valid_chips=valid))
                    if sink is not None:
                        emit(y, hi, extract(piece))
                    else:
                        if out is None:
                            out = np.zeros((h, w, self.out_channels), piece.dtype)
                        place(out, piece)
            finally:
                staged.close()
        if sink is not None:
            # trailing margin (reference mode) / chipless scene: zeros in
            # band-sized blocks so the sink never sees O(scene) memory
            step_rows = max(1, self.max_rows or h)
            while next_row < h:
                n = min(step_rows, h - next_row)
                sink(np.zeros((n, w, self.out_channels), block_dtype))
                next_row += n
            return None
        if out is None:
            out = np.zeros((h, w, self.out_channels), np.float32)
        return torch.from_numpy(out).to(self.device)
