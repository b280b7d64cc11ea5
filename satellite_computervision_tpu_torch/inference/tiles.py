"""Batched, device-resident overlap-tile inference (chips mode).

Port of ``satellite_computervision_tpu/inference/tiles.py``
``TiledInferenceEngine``, chips mode:

- chips of side ``kernel + buffer`` on a stride-``kernel`` grid, only the
  central ``kernel`` window kept (the reference's geometry);
- the scene goes to the device once; chips are gathered there and run
  through the model ``batch_size`` at a time;
- ``blend="overwrite"``/``"sum"``: central crops tile disjointly, so the
  stitch is a reshape/permute;
- ``blend="hann"``: the raw chip predictions go to
  ``kernels.stitch.hann_stitch(..., apply_window=True)``, which weights and
  blends them in one pass — the hand-written CUDA kernel on the card, its
  plain PyTorch version on the CPU. Requires ``buffer <= kernel``.

Not ported yet: whole-scene mode, banded streaming (``max_rows``), nodata
culling, ``predict_scenes`` and ``predict_scene_batch``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.geo.geotiff import (
    GeoTiffStreamWriter,
    coerce_sample_dtype,
)
from satellite_computervision_tpu_torch.kernels.stitch import hann_stitch


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
        preprocess_fn: Optional[Callable] = None,
        output_transform: Optional[Callable] = None,
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
        self.device = resolve_device(device)
        self.predict_fn = predict_fn
        self.kernel = kernel
        self.buffer = buffer
        self.batch_size = batch_size
        self.out_channels = out_channels
        self.blend = blend
        self.index_mode = index_mode
        self.preprocess_fn = preprocess_fn
        self.output_transform = output_transform

    @classmethod
    def from_model(cls, model: torch.nn.Module, output_key: str = "probs",
                   fold_bn: bool = True, **kwargs):
        """Build an engine over a model's forward, moved to the engine's
        device and put in eval mode.

        For a ``models.UNet`` with live BatchNorm, ``fold_bn=True``
        (default) serves the BN-folded model (models/fold.py)."""
        from satellite_computervision_tpu_torch.models import UNet, fold_unet

        if fold_bn and isinstance(model, UNet) and not model.fold_bn:
            model = fold_unet(model)
        model = model.to(resolve_device(kwargs.get("device", "cuda"))).eval()
        return cls(lambda chips: model(chips)[output_key], **kwargs)

    def _grid_geometry(self, h, w):
        """(rows, cols, pad_bottom, pad_right) of the chip grid for an
        (h, w) scene under the engine's index_mode."""
        kernel, buffer = self.kernel, self.buffer
        side = kernel + buffer
        half = buffer // 2
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

    def _prep(self, scene: torch.Tensor, pad_bottom: int, pad_right: int):
        h, w = scene.shape[:2]
        if self.preprocess_fn is not None:
            scene = self.preprocess_fn(scene)
            if tuple(scene.shape[:2]) != (h, w):
                raise ValueError("preprocess_fn must preserve spatial dims")
        scene = scene.float()
        if self.index_mode != "grid":
            return scene
        # edge-replicate so convs near scene borders see plausible context
        half = self.buffer // 2
        ys = torch.arange(-half, h + pad_bottom, device=scene.device).clamp_(0, h - 1)
        xs = torch.arange(-half, w + pad_right, device=scene.device).clamp_(0, w - 1)
        return scene.index_select(0, ys).index_select(1, xs)

    def _forward(self, padded: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
        """All chip predictions (rows*cols, side, side, C_out) float32, in
        groups of ``batch_size`` (the last group padded by repeating its
        final chip, as the JAX engine does)."""
        k, side, bsz = self.kernel, self.kernel + self.buffer, self.batch_size
        corners = [(r * k, c * k) for r in range(rows) for c in range(cols)]
        n = len(corners)
        corners += corners[-1:] * ((-n) % bsz)
        preds = []
        for g in range(0, len(corners), bsz):
            chips = torch.stack(
                [padded[y : y + side, x : x + side] for y, x in corners[g : g + bsz]]
            )
            preds.append(self.predict_fn(chips).float())
        return torch.cat(preds)[:n]

    def _stitch(self, preds, h, w, rows, cols):
        k, half, c_out = self.kernel, self.buffer // 2, self.out_channels
        if self.blend in ("overwrite", "sum"):
            crops = preds[:, half : half + k, half : half + k, :]
            region = (
                crops.reshape(rows, cols, k, k, c_out)
                .permute(0, 2, 1, 3, 4)
                .reshape(rows * k, cols * k, c_out)
            )
            if self.index_mode == "grid":
                return region[:h, :w]
        else:
            blended = hann_stitch(preds.contiguous(), k, rows, cols, apply_window=True)
            if self.index_mode == "grid":
                # canvas origin == padded-scene origin, (half, half) before
                # original pixel (0, 0)
                return blended[half : half + h, half : half + w]
            region = blended[half : half + rows * k, half : half + cols * k]
        out = torch.zeros((h, w, c_out), dtype=torch.float32, device=preds.device)
        out[half : half + rows * k, half : half + cols * k] = region
        return out

    def predict_scene(self, scene) -> torch.Tensor:
        """(H, W, C_in) scene (numpy array or tensor) -> (H, W,
        out_channels) stitched prediction on the engine's device. A scene
        with no chip on the grid gives zeros."""
        h, w = scene.shape[:2]
        rows, cols, pad_bottom, pad_right = self._grid_geometry(h, w)
        if rows * cols == 0:
            return torch.zeros((h, w, self.out_channels), dtype=torch.float32,
                               device=self.device)
        if isinstance(scene, np.ndarray):
            scene = torch.from_numpy(np.ascontiguousarray(scene))
        with torch.inference_mode():
            padded = self._prep(scene.to(self.device), pad_bottom, pad_right)
            out = self._stitch(self._forward(padded, rows, cols), h, w, rows, cols)
            if self.output_transform is not None:
                out = self.output_transform(out)
        return out

    def predict_scene_to_geotiff(self, scene, path, transform=None,
                                 crs: str = "", compress=True) -> str:
        """Predict a scene and write the result as a striped GeoTIFF at
        ``path`` (one pass, then one write; BigTIFF when the raster needs
        it). Returns ``path``."""
        pred = self.predict_scene(scene)
        if pred.dtype == torch.bfloat16:  # numpy has no bfloat16
            pred = pred.float()
        pred = pred.cpu().numpy()
        target = coerce_sample_dtype(pred.dtype)
        h, w = pred.shape[:2]
        with GeoTiffStreamWriter(path, h, w, self.out_channels, target,
                                 transform=transform, crs=crs,
                                 compress=compress) as writer:
            writer.write_rows(pred.astype(target, copy=False))
        return path
